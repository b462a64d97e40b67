// RWKV-6 WKV recurrence for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ../wkv.py).
//
// Replaces the Pallas TPU kernel wkv (body _kernel) of
// src/repro/kernels/rwkv6/rwkv6.py:68. Per (batch, head), with a D x D
// state S:
//
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,          w_t = exp(logw_t)
//
// over r, k, v (B,S,H,D) in float32 or bfloat16, logw (B,S,H,D), u (H,D)
// and h0 (B,H,D,D) in float32; writes out (B,S,H,D) and hT (B,H,D,D) in
// float32. The TPU kernel walks 16-token chunks in closed form with
// (C x C) matmuls for its matrix unit and exp(-cumsum) rescaling; here the
// recurrence runs token by token, which is exact in its own order and
// needs no rescaling.
//
// Bound: each input read once and each output written once is 16 bytes
// per (b, t, h, d) element with bf16 r/k/v (28 with float32) -- 0.30 GB at
// B=2, S=4096, H=40, D=64, 0.088 ms at 3.35 TB/s -- against 5 float32
// operations per state entry and token (the read-out r.S and the update
// w*S + k^T v; 6.7e9 at that shape, 0.10 ms at 67 TFLOP/s): bound by
// operations on the CUDA cores. The chain over S is sequential, so the
// card fills only through the (batch, head, column) parallelism, and the
// time goes to the latency of each step.
//
// Design. Column e of S needs only r_t, k_t, w_t and v_t[e], so a block
// takes kCols = 16 columns of one (b, h): grid (D/16, H, B) = 320 blocks
// of 128 threads at the path shape. A thread keeps R = D/8 rows of one
// column in registers; a warp holds 16 columns of two row groups, so a
// shared read of r, k or w serves 16 lanes at once. Tokens are staged
// kT = 16 at a time in shared memory, double buffered: the next run's
// global loads are issued before the current run is computed, as
// unconditional 16-byte vector loads (the token index is clamped at the
// ragged end, whose tokens are never read) kept raw in registers, so
// that no load waits on another; the bf16 widening and exp(logw) are
// done once per element when the run is stored to shared memory. Each
// step of a full run is unrolled. A thread's partial sums of
// r . (S + u k v) go to shared memory, and the 8 row groups are summed
// once per run, so no step waits on a cross-lane reduction; the outputs
// leave as runs of 16 consecutive floats.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 8;    // row groups: threads per column
constexpr int kCols = 16;     // columns of S per block
constexpr int kThreads = kGroups * kCols;
constexpr int kT = 16;        // tokens staged per run

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N contiguous elements moved as aligned vector accesses of at most 16
// bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T x[N];
};

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
  const Pack<float, N> t = *reinterpret_cast<const Pack<float, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = t.x[i];
}

template <int D, typename In>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const In* __restrict__ r, const In* __restrict__ k,
           const In* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ h0,
           float* __restrict__ out, float* __restrict__ hT, int S, int H) {
  static_assert(D % kCols == 0 && D % (2 * kGroups) == 0, "D");
  constexpr int R = D / kGroups;          // rows per thread
  constexpr int V = R < 4 ? R : 4;        // vector width of a row read
  constexpr int NV = R / V;               // row reads per operand
  constexpr int PER = kT * D / kThreads;  // staged r/k/w elements a thread
  constexpr int PERV = kT * kCols / kThreads;   // staged v, and outputs
  static_assert(PER * kThreads == kT * D && PERV * kThreads == kT * kCols,
                "staging split");

  __shared__ __align__(16) float rs[2][kT][D];
  __shared__ __align__(16) float ks[2][kT][D];
  __shared__ __align__(16) float ws[2][kT][D];
  __shared__ __align__(16) float vs[2][kT][kCols];
  __shared__ float part[2][kT][kGroups][kCols];

  const int tid = threadIdx.x;
  const int col = tid % kCols;
  const int j = tid / kCols;              // row group
  const int e0 = blockIdx.x * kCols;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t tok = static_cast<int64_t>(H) * D;   // stride of a token
  const int64_t head = (static_cast<int64_t>(b) * S * H + h) * D;

  // thread's rows: V * (c * kGroups + j) + q, c < NV, q < V
  float st[NV][V], uu[NV][V];
  const int64_t sbase = (static_cast<int64_t>(b) * H + h) * D * D;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int d = V * (c * kGroups + j) + q;
      st[c][q] = h0[sbase + static_cast<int64_t>(d) * D + e0 + col];
      uu[c][q] = u[h * D + d];
    }
  }

  // this thread stages elements [tid * PER, tid * PER + PER) of a run's
  // (kT, D) slab of r, k and logw, and [tid * PERV, ...) of its (kT, kCols)
  // slab of v
  const int st_t = tid * PER / D, st_d = tid * PER % D;
  const int sv_t = tid * PERV / kCols, sv_c = tid * PERV % kCols;
  Pack<In, PER> pr, pk;
  Pack<float, PER> pw;
  Pack<In, PERV> pv;
  auto fetch = [&](int t0) {
    const int t = min(t0 + st_t, S - 1);
    const int64_t o = head + t * tok + st_d;
    pr = *reinterpret_cast<const Pack<In, PER>*>(r + o);
    pk = *reinterpret_cast<const Pack<In, PER>*>(k + o);
    pw = *reinterpret_cast<const Pack<float, PER>*>(logw + o);
    const int tv = min(t0 + sv_t, S - 1);
    pv = *reinterpret_cast<const Pack<In, PERV>*>(v + head + tv * tok + e0
                                                   + sv_c);
  };
  auto stash = [&](int buf) {
    Pack<float, PER> fr, fk, fw;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      fr.x[i] = to_f(pr.x[i]);
      fk.x[i] = to_f(pk.x[i]);
      fw.x[i] = expf(pw.x[i]);
    }
    *reinterpret_cast<Pack<float, PER>*>(&rs[buf][st_t][st_d]) = fr;
    *reinterpret_cast<Pack<float, PER>*>(&ks[buf][st_t][st_d]) = fk;
    *reinterpret_cast<Pack<float, PER>*>(&ws[buf][st_t][st_d]) = fw;
    Pack<float, PERV> fv;
#pragma unroll
    for (int i = 0; i < PERV; ++i) fv.x[i] = to_f(pv.x[i]);
    *reinterpret_cast<Pack<float, PERV>*>(&vs[buf][sv_t][sv_c]) = fv;
  };
  auto step = [&](int buf, int tt) {
    const float vv = vs[buf][tt][col];
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int d0 = V * (c * kGroups + j);
      float rv[V], kv[V], wv[V];
      load_vec<V>(&rs[buf][tt][d0], rv);
      load_vec<V>(&ks[buf][tt][d0], kv);
      load_vec<V>(&ws[buf][tt][d0], wv);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float kvq = kv[q] * vv;
        acc = fmaf(rv[q], fmaf(uu[c][q], kvq, st[c][q]), acc);
        st[c][q] = fmaf(wv[q], st[c][q], kvq);
      }
    }
    part[buf][tt][j][col] = acc;
  };

  fetch(0);
  stash(0);
  __syncthreads();
  const int runs = (S + kT - 1) / kT;
  for (int run = 0; run < runs; ++run) {
    const int buf = run & 1;
    const int t0 = run * kT;
    if (run + 1 < runs) fetch(t0 + kT);
    const int nt = S - t0 < kT ? S - t0 : kT;
    if (nt == kT) {
#pragma unroll
      for (int tt = 0; tt < kT; ++tt) step(buf, tt);
    } else {
      for (int tt = 0; tt < nt; ++tt) step(buf, tt);
    }
    if (run + 1 < runs) stash(buf ^ 1);
    __syncthreads();
    // sum the row groups' partials of this run; the next run writes the
    // other buffer, and the barrier after it orders this read before the
    // run after that overwrites this one
#pragma unroll
    for (int i = 0; i < PERV; ++i) {
      const int idx = tid + i * kThreads;
      const int tt = idx / kCols, c = idx % kCols;
      float o = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) o += part[buf][tt][g][c];
      if (tt < nt) out[head + (t0 + tt) * tok + e0 + c] = o;
    }
  }

#pragma unroll
  for (int c = 0; c < NV; ++c) {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int d = V * (c * kGroups + j) + q;
      hT[sbase + static_cast<int64_t>(d) * D + e0 + col] = st[c][q];
    }
  }
}

template <int D, typename In>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* h0, void* out, void* hT, int B, int S,
           int H, cudaStream_t stream) {
  const dim3 grid(D / kCols, H, B);
  wkv_kernel<D, In><<<grid, kThreads, 0, stream>>>(
      static_cast<const In*>(r), static_cast<const In*>(k),
      static_cast<const In*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(h0),
      static_cast<float*>(out), static_cast<float*>(hT), S, H);
  return cudaGetLastError();
}

template <typename In>
int launch_d(const void* r, const void* k, const void* v, const void* logw,
             const void* u, const void* h0, void* out, void* hT, int B,
             int S, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, In>(r, k, v, logw, u, h0, out, hT, B, S, H,
                                   stream);
    case 32: return launch<32, In>(r, k, v, logw, u, h0, out, hT, B, S, H,
                                   stream);
    case 64: return launch<64, In>(r, k, v, logw, u, h0, out, hT, B, S, H,
                                   stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// All operands contiguous, r, k, v and logw 16-byte aligned; r, k, v
// bfloat16 when bf16 != 0, else float32; logw, u, h0, out, hT float32.
// D is 16, 32 or 64; S >= 1. Returns the launch's cudaError_t.
extern "C" int wkv_launch(const void* r, const void* k, const void* v,
                          const void* logw, const void* u, const void* h0,
                          void* out, void* hT, int B, int S, int H, int D,
                          int bf16, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(r, k, v, logw, u, h0, out, hT, B, S,
                                        H, D, s)
              : launch_d<float>(r, k, v, logw, u, h0, out, hT, B, S, H, D,
                                s);
}
