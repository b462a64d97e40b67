// RG-LRU linear recurrence for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes; see ../rglru.py).
//
// Replaces the Pallas TPU kernel rglru_scan (body _kernel) of
// src/repro/kernels/rglru/rglru.py:55:
//
//     h_t = exp(log_a_t) * h_{t-1} + b_t      per (batch, channel)
//
// over log_a, b (B,S,W) float32 and h0 (B,W) float32, returning every h_t
// (B,S,W) and the last one (B,W), both float32. The TPU kernel solved each
// chunk of 128 steps in closed form with lower-triangular matmuls to keep
// its matrix unit busy; that form buys nothing here and costs exp(-cumsum)
// factors that can overflow, so it is not carried over.
//
// Design: one thread per (batch, channel), sequential over S with the
// carry in a register; a warp covers 32 neighbouring channels, so every
// load and store of a step is one coalesced 128-byte line. The loads of
// kUnroll steps are issued before their dependent multiply-adds, so that
// many lines per thread are in flight while the carry chain runs.
//
// Bound: 12 bytes per element (read log_a and b, write h) -- 252 MB at
// B=2, S=4096, W=2560, 0.075 ms at 3.35 TB/s -- against ~2 operations per
// element (exp, multiply-add): bound by bytes. With only B*W = 5120
// threads the card is far from full, so this kernel is bound by the
// latency of the sequential chain; a chunked parallel scan over S is the
// later step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ b, const float* __restrict__ h0,
                  float* __restrict__ h_all, float* __restrict__ h_last,
                  int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int batch = blockIdx.y;
  if (w >= W) return;
  const int64_t row = static_cast<int64_t>(W);
  const int64_t base = static_cast<int64_t>(batch) * S * row + w;
  float h = h0[static_cast<int64_t>(batch) * W + w];
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float la[kUnroll], bb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      la[u] = log_a[base + (t + u) * row];
      bb[u] = b[base + (t + u) * row];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(expf(la[u]), h, bb[u]);
      h_all[base + (t + u) * row] = h;
    }
  }
  for (; t < S; ++t) {
    h = fmaf(expf(log_a[base + t * row]), h, b[base + t * row]);
    h_all[base + t * row] = h;
  }
  h_last[static_cast<int64_t>(batch) * W + w] = h;
}

}  // namespace

// All operands contiguous float32. Returns the launch's cudaError_t.
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const void* h0, void* h_all, void* h_last,
                                 int B, int S, int W, void* stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h_all),
      static_cast<float*>(h_last), S, W);
  return cudaGetLastError();
}
