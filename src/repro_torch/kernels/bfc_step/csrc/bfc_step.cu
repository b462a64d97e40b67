// BFC switch decision kernels for Hopper (sm_90a), bound to Python through
// a plain C interface (ctypes; see ../bfc_step.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bfc_step/bfc_step.py:
//   bfc_fused  (body _fused_kernel, bfc_step.py:146) -- per port row: the
//              active-queue count N_active (non-empty, unpaused, >= 1), the
//              pause threshold th = ceil(pause_window / N_active), the pause
//              mask occ > th, the DRR or SRF pick as the argmin of the packed
//              key*nq + q over eligible queues (sentinel (max_key + 1) * nq),
//              can_tx, sel (-1 when none) and occ_after with the picked queue
//              decremented;
//   bfc_decide (body _kernel, bfc_step.py:75) -- the same threshold and DRR
//              pick with no blocked mask and no occupancy update.
//
// Design: one warp per port row. Lane l holds queues l, l + 32, l + 64, ...,
// so any queue count works (1, 32, 64 in the presets; 1025 in the sentinel
// regression case). The active count is a __reduce_add_sync, the packed
// minimum a __shfl_xor_sync butterfly. Rows are independent, so a batch of
// lanes can be passed as B*P rows unchanged.
//
// Bound: at P=384, Q=32 (DRR) the kernel reads ~63 KB and writes ~66 KB per
// tick -- well under a microsecond of DRAM time at 3.35 TB/s -- so one call
// is bound by launch latency, not by bytes or integer operations. A CUDA
// graph over a 512-tick segment, or fusing more of the tick into this
// kernel, is what would move it; neither is done here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// kSrf: key = srf_key[row, q] (pre-clamped by the caller) instead of the DRR
// rotation. kFused: honour `blocked` and write can_tx / occ_after.
template <bool kSrf, bool kFused>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bfc_step_kernel(const int32_t* __restrict__ occ,
                const uint8_t* __restrict__ qpaused,
                const int32_t* __restrict__ ptr,
                const uint8_t* __restrict__ blocked,
                const int32_t* __restrict__ srf_key,
                int n_rows, int nq, int pause_window, int sentinel,
                int32_t* __restrict__ o_nact, int32_t* __restrict__ o_th,
                uint8_t* __restrict__ o_pause, int32_t* __restrict__ o_sel,
                uint8_t* __restrict__ o_cantx,
                int32_t* __restrict__ o_occ_after) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // warp-uniform: every lane of a warp shares row

  const int64_t base = static_cast<int64_t>(row) * nq;
  const int p = ptr[row];
  const bool row_blocked = kFused && blocked[row] != 0;

  int n_active = 0;
  int best = sentinel;
  for (int q = lane; q < nq; q += 32) {
    const bool active = occ[base + q] > 0 && qpaused[base + q] == 0;
    n_active += active ? 1 : 0;
    int key;
    if (kSrf) {
      key = srf_key[base + q];
    } else {
      key = (q - p) % nq;  // C++ % truncates; the reference floors
      if (key < 0) key += nq;
    }
    if (active && !row_blocked) best = min(best, key * nq + q);
  }
  n_active = __reduce_add_sync(kFullMask, n_active);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = min(best, __shfl_xor_sync(kFullMask, best, off));

  n_active = max(n_active, 1);
  const int th = (pause_window + n_active - 1) / n_active;
  const bool can_tx = best < sentinel;
  const int sel = can_tx ? best % nq : -1;

  for (int q = lane; q < nq; q += 32) {
    const int o = occ[base + q];
    o_pause[base + q] = o > th ? 1 : 0;
    if (kFused) o_occ_after[base + q] = o - (q == sel ? 1 : 0);
  }
  if (lane == 0) {
    o_nact[row] = n_active;
    o_th[row] = th;
    o_sel[row] = sel;
    if (kFused) o_cantx[row] = can_tx ? 1 : 0;
  }
}

inline dim3 grid_for(int n_rows) {
  return dim3((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// Every entry point launches on `stream`, does not synchronise, and returns
// the cudaError_t of the launch (0 = success).
extern "C" int bfc_fused_launch(const void* occ, const void* qpaused,
                                const void* ptr, const void* blocked,
                                const void* srf_key, int n_rows, int nq,
                                int pause_window, int srf, int sentinel,
                                void* o_nact, void* o_th, void* o_pause,
                                void* o_sel, void* o_cantx, void* o_occ_after,
                                void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel =
      srf ? bfc_step_kernel<true, true> : bfc_step_kernel<false, true>;
  kernel<<<grid_for(n_rows), block, 0, s>>>(
      static_cast<const int32_t*>(occ), static_cast<const uint8_t*>(qpaused),
      static_cast<const int32_t*>(ptr), static_cast<const uint8_t*>(blocked),
      static_cast<const int32_t*>(srf_key), n_rows, nq, pause_window,
      sentinel, static_cast<int32_t*>(o_nact), static_cast<int32_t*>(o_th),
      static_cast<uint8_t*>(o_pause), static_cast<int32_t*>(o_sel),
      static_cast<uint8_t*>(o_cantx), static_cast<int32_t*>(o_occ_after));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bfc_decide_launch(const void* occ, const void* qpaused,
                                 const void* ptr, int n_rows, int nq,
                                 int pause_window, int sentinel, void* o_nact,
                                 void* o_th, void* o_pause, void* o_sel,
                                 void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bfc_step_kernel<false, false><<<grid_for(n_rows), block, 0, s>>>(
      static_cast<const int32_t*>(occ), static_cast<const uint8_t*>(qpaused),
      static_cast<const int32_t*>(ptr), nullptr, nullptr, n_rows, nq,
      pause_window, sentinel, static_cast<int32_t*>(o_nact),
      static_cast<int32_t*>(o_th), static_cast<uint8_t*>(o_pause),
      static_cast<int32_t*>(o_sel), nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}
