// Flash attention forward for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ../flash_attention.py).
//
// Replaces the Pallas TPU kernel flash_attention (body _kernel) of
// src/repro/kernels/flash_attention/flash_attention.py:86: GQA attention
// forward with online softmax in float32, causal and sliding-window masks,
// fully masked kv tiles skipped. q (B,H,S,hd), k/v (B,K,T,hd) with kv head
// = h / (H/K); out (B,H,S,hd) in q's dtype. The reference's constants are
// kept: masked scores are -1e30 (not -inf), the scale is hd**-0.5 (passed
// in), and the row sum l is floored at 1e-20 before the division.
//
// Design: one block of 256 threads per (q tile of 64 rows, q head, batch).
// The block stages its q tile once and then walks the kv tiles of 32 rows
// that hold at least one unmasked key for the q tile -- [q0 - window + 1,
// q0 + 63] under a causal sliding window -- so skipped tiles cost nothing.
// Tiles live in shared memory as float32 (bf16 inputs are widened on load),
// rows padded by one word so the per-lane column reads hit distinct banks.
// Thread (ty, tx) = (tid / 16, tid % 16) owns q rows ty + 16 i (i < 4), key
// columns tx + 16 j (j < 2) of the 64x32 score tile and head-dim columns
// tx + 16 c (c < hd/16) of the output, so a row's max and sum are 16-lane
// shuffles inside one half-warp and the rescale by the online-softmax
// correction needs no exchange. Rows past S and keys past T are masked, so
// any S and T work; hd is a template parameter (16, 32, 64, 96, 128 or 256).
//
// Bound: at the prefill shape (B=2, H=10, K=1, S=T=4096, hd=256, causal,
// window 2048) the unmasked work is 6,292,480 (q, k) pairs per (b, h) at
// 4*hd FLOPs each: 1.29e11 FLOPs, 0.130 ms at the bf16 tensor-core peak,
// while the bytes take 0.028 ms -- bound by operations. This first kernel
// computes in float32 on the CUDA cores (no tensor cores, no TMA), so it
// runs far from that bound; wgmma tiles fed by TMA are the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 32;       // kv rows per tile
constexpr int kThreads = 256;
constexpr int kRows = kBQ / 16;   // q rows per thread
constexpr int kCols = kBK / 16;   // score columns per thread
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as JAX's astype
}

// max / sum over the 16 lanes of a half-warp (lanes that share ty)
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

struct Strides {   // element strides of (batch, head, position); hd is 1
  long long b, h, s;
};

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides sq,
                 Strides sk, Strides sv, Strides so, int group, int S,
                 int T_len, int causal, int window, float scale) {
  constexpr int LDQ = HD + 1, LDK = HD + 1, LDV = HD, LDP = kBK + 1;
  constexpr int kDCols = HD / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // [kBQ][LDQ]
  float* Ks = Qs + kBQ * LDQ;       // [kBK][LDK]
  float* Vs = Ks + kBK * LDK;       // [kBK][LDV]
  float* Ps = Vs + kBK * LDV;       // [kBQ][LDP]

  const int q0 = blockIdx.x * kBQ;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / group;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* qb = q + batch * sq.b + head * sq.h;
  const T* kb = k + batch * sk.b + kv_head * sk.h;
  const T* vb = v + batch * sv.b + kv_head * sv.h;
  T* ob = o + batch * so.b + head * so.h;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, qp = q0 + r;
    Qs[r * LDQ + d] = qp < S ? widen(qb[qp * sq.s + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDCols; ++c) acc[i][c] = 0.f;
  }

  // kv tiles that hold an unmasked key for some row of this q tile
  const int k_hi = causal ? min(T_len, q0 + kBQ) : T_len;   // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kBK, t_hi = (k_hi + kBK - 1) / kBK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile's Ks/Vs/Ps are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD, kp = k0 + r;
      const bool in = kp < T_len;
      Ks[r * LDK + d] = in ? widen(kb[kp * sk.s + d]) : 0.f;
      Vs[r * LDV + d] = in ? widen(vb[kp * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool keep = kp < T_len;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        sc[i][j] = keep ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < kDCols; ++c) {
        const float vv = Vs[j * LDV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < kDCols; ++c)
      narrow(&ob[qp * so.s + tx + 16 * c], acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides sq, Strides sk, Strides sv, Strides so, int B,
                   int H, int group, int S, int T_len, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD>();
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, group,
      S, T_len, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, Strides sq, Strides sk, Strides sv,
                        Strides so, int B, int H, int group, int S,
                        int T_len, int causal, int window, float scale,
                        cudaStream_t stream) {
  switch (hd) {
#define FA_CASE(D)                                                          \
  case D:                                                                   \
    return launch<T, D>(q, k, v, o, sq, sk, sv, so, B, H, group, S, T_len, \
                        causal, window, scale, stream);
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(96)
    FA_CASE(128)
    FA_CASE(256)
#undef FA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head-dim
// stride must be 1. Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, long long q_b,
    long long q_h, long long q_s, long long k_b, long long k_h, long long k_s,
    long long v_b, long long v_h, long long v_s, long long o_b, long long o_h,
    long long o_s, int B, int H, int KH, int S, int T_len, int hd, int dtype,
    int causal, int window, float scale, void* stream) {
  const Strides sq{q_b, q_h, q_s}, sk{k_b, k_h, k_s}, sv{v_b, v_h, v_s},
      so{o_b, o_h, o_s};
  const int group = H / KH;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, sq, sk, sv, so, B, H, group, S,
                              T_len, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, sq, sk, sv, so, B, H,
                                      group, S, T_len, causal, window, scale,
                                      st);
  return cudaErrorInvalidValue;
}
