// RG-LRU linear recurrence for Hopper (sm_90a) as a tile-chained parallel
// scan, bound to Python through a plain C interface (ctypes; see
// ../rglru.py).
//
// Replaces the Pallas TPU kernel rglru_scan (body _kernel) of
// src/repro/kernels/rglru/rglru.py:55:
//
//     h_t = exp(log_a_t) * h_{t-1} + b_t      per (batch, channel)
//
// over log_a, b (B,S,W) float32 and h0 (B,W) float32, returning every h_t
// (B,S,W) and the last one (B,W), both float32. The TPU kernel solved each
// chunk of 128 steps in closed form with exp(-cumsum) factors for its
// matrix unit; here the steps compose as pairs,
//
//     (A1, B1) then (A2, B2) = (A2 A1, A2 B1 + B2),   h -> A h + B,
//
// so no exp(-cumsum) factor (which can overflow) is ever formed.
//
// Bound: 12 bytes per element (read log_a and b, write h) -- 252 MB at
// B=2, S=4096, W=2560, 0.075 ms at 3.35 TB/s -- against ~2 operations per
// element (exp, multiply-add): bound by bytes. The sequence is cut so that
// every element is read and written once, by enough threads to keep
// memory busy.
//
// Design. A tile is kL = 128 tokens x 32 channels of one batch row: 5120
// tiles at the path shape, one block of 9 warps each. Thread (channel
// lane, sub-chunk warp) of the first 8 loads its 16 tokens into registers
// (all loads in flight at once; a warp's load is one 128-byte line) and
// forms its pair (A = prod exp(log_a), B = its h from 0); the ninth warp
// composes the 8 pairs of each channel in order (the exclusive prefix of
// each sub-chunk and the tile's aggregate) and finds the carry into the
// tile, with no data of its own held across the wait. Tiles along S chain
// by a decoupled look-back:
//
// - a block takes its tile from an atomic ticket, tile-major, so that a
//   tile's predecessors hold earlier tickets and are running or done: no
//   block waits on one that has not been scheduled;
// - each (tile, channel) publishes its aggregate (A, B), flag 1, and then
//   its inclusive h, flag 2, in a scratch zeroed before every launch;
//   values are stored before the flag (st.release), read after it
//   (ld.acquire);
// - a channel walks back to the nearest tile with an inclusive h (tile 0
//   publishes one at once, from h0) and applies the aggregates after it
//   in order, h = fma(A, h, B). That is exactly how each of those tiles
//   forms its own inclusive h, so the carry does not depend on how far
//   the others had got: two calls give identical results.
//
// Each thread then runs its 16 steps from its carry-in and writes them:
// every h_t is an exact sequential step from the carry.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 32;                  // channels per tile
constexpr int kSub = 16;                 // tokens per thread
constexpr int kWarps = 8;                // sub-chunks per tile
constexpr int kL = kSub * kWarps;        // tokens per tile
constexpr int kThreads = kCh * (kWarps + 1);   // + the look-back warp

__device__ __forceinline__ void publish(unsigned* flag, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(flag), "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned observe(const unsigned* flag) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(flag)
               : "memory");
  return v;
}

// The look-back warp of a tile (lane = channel): composes the 8 sub-chunk
// pairs in order (their exclusive prefixes replace them in pa, pb),
// publishes the tile's aggregate, finds the carry into the tile and
// publishes the inclusive h. Returns the carry.
__device__ __forceinline__ float look_back(
    float (&pa)[kWarps][kCh], float (&pb)[kWarps][kCh], int lane,
    int64_t slot, int64_t step, int tile, float h0, unsigned* flag,
    float* agg_a, float* agg_b, float* incl) {
  float ta = 1.f, tb = 0.f;
#pragma unroll
  for (int s = 0; s < kWarps; ++s) {
    const float a = pa[s][lane], bv = pb[s][lane];
    pa[s][lane] = ta;
    pb[s][lane] = tb;
    ta *= a;
    tb = fmaf(a, tb, bv);
  }
  float h = h0;
  if (tile > 0) {
    agg_a[slot] = ta;
    agg_b[slot] = tb;
    publish(flag + slot, 1u);
    // back to the nearest tile with an inclusive h, then forward through
    // the aggregates after it
    int back = 1;
    for (unsigned f; (f = observe(flag + slot - back * step)) != 2u;) {
      if (f == 1u)
        ++back;
      else
        __nanosleep(32);
    }
    h = __ldcg(incl + slot - back * step);
    for (--back; back > 0; --back)
      h = fmaf(__ldcg(agg_a + slot - back * step), h,
               __ldcg(agg_b + slot - back * step));
  }
  incl[slot] = fmaf(ta, h, tb);
  publish(flag + slot, 2u);
  return h;
}

// scratch: counter[1], flag[tiles][chains][32]; values A, B, H alike
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ b, const float* __restrict__ h0,
                  float* __restrict__ h_all, float* __restrict__ h_last,
                  unsigned* __restrict__ counter, unsigned* flag,
                  float* agg_a, float* agg_b, float* incl, int S, int W,
                  int groups, int chains) {
  __shared__ unsigned ticket;
  __shared__ float pa[kWarps][kCh], pb[kWarps][kCh];
  __shared__ float carry[kCh];
  const int lane = threadIdx.x % kCh, sub = threadIdx.x / kCh;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
  __syncthreads();
  const int tile = ticket / chains, chain = ticket % chains;
  const int batch = chain / groups, w = (chain % groups) * kCh + lane;
  const bool live = w < W;

  if (sub == kWarps) {                   // the look-back warp
    __syncthreads();
    if (live)
      carry[lane] = look_back(
          pa, pb, lane, (static_cast<int64_t>(tile) * chains + chain) * kCh
          + lane, static_cast<int64_t>(chains) * kCh, tile,
          h0[static_cast<int64_t>(batch) * W + w], flag, agg_a, agg_b, incl);
    __syncthreads();
    return;
  }
  const int t0 = tile * kL + sub * kSub;
  const int64_t base = (static_cast<int64_t>(batch) * S + t0) * W + w;
  float e[kSub], bb[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const bool ok = live && t0 + i < S;
    e[i] = ok ? log_a[base + static_cast<int64_t>(i) * W] : 0.f;
    bb[i] = ok ? b[base + static_cast<int64_t>(i) * W] : 0.f;
  }
  float A = 1.f, Bv = 0.f;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    e[i] = expf(e[i]);
    A *= e[i];
    Bv = fmaf(e[i], Bv, bb[i]);
  }
  pa[sub][lane] = A;
  pb[sub][lane] = Bv;
  __syncthreads();
  __syncthreads();                       // the look-back warp's carry
  if (!live) return;
  float h = fmaf(pa[sub][lane], carry[lane], pb[sub][lane]);
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    h = fmaf(e[i], h, bb[i]);
    if (t0 + i < S) {
      h_all[base + static_cast<int64_t>(i) * W] = h;
      if (t0 + i == S - 1) h_last[static_cast<int64_t>(batch) * W + w] = h;
    }
  }
}

}  // namespace

// The look-back's scratch for (B, S, W), in 32-bit words: the ticket
// counter, one flag per (tile, chain, channel), then the tiles' values A,
// B and inclusive h alike.
extern "C" int64_t rglru_scan_scratch_words(int B, int S, int W) {
  const int64_t tiles = (S + kL - 1) / kL, groups = (W + kCh - 1) / kCh;
  return 1 + 4 * tiles * B * groups * kCh;
}

// All operands contiguous float32; scratch holds
// rglru_scan_scratch_words(B, S, W) words, of which the counter and the
// flags are zeroed here, on the stream, before the launch. Returns the
// first cudaError_t.
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const void* h0, void* h_all, void* h_last,
                                 void* scratch, int B, int S, int W,
                                 void* stream) {
  const int groups = (W + kCh - 1) / kCh, chains = B * groups;
  const int tiles = (S + kL - 1) / kL;
  const int64_t n = static_cast<int64_t>(tiles) * chains * kCh;
  const auto st = static_cast<cudaStream_t>(stream);
  unsigned* counter = static_cast<unsigned*>(scratch);
  unsigned* flag = counter + 1;
  float* agg_a = reinterpret_cast<float*>(flag + n);
  int err = cudaMemsetAsync(counter, 0, (1 + n) * sizeof(unsigned), st);
  if (err) return err;
  rglru_scan_kernel<<<tiles * chains, kThreads, 0, st>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h_all),
      static_cast<float*>(h_last), counter, flag, agg_a, agg_a + n,
      agg_a + 2 * n, S, W, groups, chains);
  return cudaGetLastError();
}
