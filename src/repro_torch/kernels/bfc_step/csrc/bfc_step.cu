// BFC switch kernels for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes; see ../bfc_step.py).
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
// On the simulator's main path the same body, in its kDerive mode, also
// takes in the work of the phase that feeds bfc_fused
// (src/repro/sim/phases/ctx.py::derive): occ = qtail - qhead, the port and
// switch occupancy sums, the head-of-queue Bloom lookup (qhead -> qbuf ->
// fpos -> bloom_rx) that makes qpaused, PFC hysteresis against the fed
// switch's free buffer, and this tick's flow arrivals at the sources. One
// launch per simulated tick replaces ~25 small eager ops.
//
// Design: a block owns a range of port rows. Stage A walks the block's
// (port, queue) entries, 32 consecutive entries per warp and kUnroll such
// chunks per warp at once, so that the dependent loads of different chunks
// are in flight together. It reduces each row's active count, packed pick
// and (kDerive) occupancy with a segmented warp shuffle (a warp may straddle
// rows: any queue count works) and one shared-memory atomic per row segment;
// integer atomics make the sums independent of order. Stage B works per row:
// threshold, blocked mask, pick. kDecide / kFused write the pause mask and
// occ_after in a stage C over the entries again. kDerive runs a fabric as
// ONE thread block cluster of kClusterBlocks blocks (512 threads each) over
// every port, because PFC at port p reads the occupancy of the switch that p
// feeds, which sums ports of other switches: each block sums its own rows
// per switch in shared memory, and after a cluster barrier every block adds
// up all blocks' partial sums through distributed shared memory before any
// PFC decision. (A first version ran kDerive as one block of 512 threads on
// one SM: 35.5 us per call at the paper shape, more than half of it the
// per-entry instructions of 12288 entries on one SM.) occ_after is written
// as occ in stage A and the picked queue is decremented in stage B.
//
// Lanes. A sweep batch is K fabrics laid side by side (sim/phases/ctx.py):
// lane k owns rows [k*P, (k+1)*P), flows [k*F, (k+1)*F) and switches
// [k*NSW, (k+1)*NSW), and the flow ids in qbuf and the switch ids in
// port_switch and feeds are already the batch's. kDerive launches one
// cluster per lane; the cluster index is the lane, the block's rank in its
// cluster and the cluster size split the lane's rows and flows, and the
// switch sums are exchanged inside the cluster only. Clusters never wait on
// each other, so K beyond the clusters the card holds at once runs in waves.
// A non-NIC port that no switch owns adds to its lane's switch 0, and an
// empty head slot reads its lane's flow 0, as the reference does per lane.
//
// Bound: at the paper shape (P=384, Q=32, F=4000) one kDerive call must move
// ~0.3 MB (the qhead/qtail/occ/occ_after planes, the flow vectors, and per
// non-empty queue one qbuf entry, S fpos entries and S Bloom bytes), under
// 0.1 us at 3.35 TB/s, so a call is bound by launch latency and by the chain
// of dependent loads, not by bytes or integer operations. What moves the tick
// is the CUDA graph that the engine replays (sim/engine.py::TickGraph): the
// host no longer issues each of the tick's launches.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBig = 1 << 20;          // ref.BIG: SRF keys are clamped here
constexpr int kStageGroup = 4;         // Bloom stages looked up at once
constexpr int kUnroll = 4;             // 32-entry chunks a warp has in flight
constexpr int kThreads = 256;          // kDecide / kFused block
constexpr int kRowsPerBlock = 8;       // kDecide / kFused rows per block
constexpr int kDeriveThreads = 512;    // kDerive block
constexpr int kClusterBlocks = 8;      // kDerive: one cluster of this many

enum Mode : int { kDecide = 0, kFused = 1, kDerive = 2 };

}  // namespace

// Operands of one launch. Python fills it through a ctypes mirror
// (bfc_step._Params) in the same field order; a field a mode does not use is
// left null / 0. `rows_per_block` is set by the entry point.
struct Params {
  // decision operands (kDecide, kFused)
  const int32_t* occ;
  const uint8_t* qpaused;
  const int32_t* ptr;           // DRR pointer; kDerive reads qptr here too
  const uint8_t* blocked;
  const int32_t* srf_key;
  // state and operands (kDerive)
  const int32_t* qhead;
  const int32_t* qtail;
  const int32_t* qbuf;          // (P, Q, cap)
  const int32_t* qsrf;
  const uint8_t* bloom_rx;      // (P, n_stages, stage_bits)
  const int32_t* ing_occ;
  const uint8_t* pfc_prev;
  const int32_t* rem_src;
  const int32_t* fpos;          // (F, n_stages)
  const int32_t* arrival;
  const int32_t* size;
  const int32_t* port_switch;
  const uint8_t* port_is_nic;
  const int32_t* feeds;
  const int32_t* buffer_limit;  // 0-d
  const int32_t* t;             // 0-d: read on the device, so a replayed
                                // graph sees each tick's own t
  // outputs
  int32_t* o_nact;
  int32_t* o_th;
  uint8_t* o_pause;
  int32_t* o_sel;
  uint8_t* o_cantx;
  int32_t* o_occ_after;
  int32_t* o_occ;
  int32_t* o_port_occ;
  int32_t* o_sw_occ;
  uint8_t* o_qpaused;
  uint8_t* o_pfc;
  int32_t* o_rem_src;
  // sizes and static flags; kDerive: n_rows, n_switches and n_flows are one
  // lane's, and buffer_limit holds one value per lane if limit_per_lane
  int n_rows, nq, rows_per_block, pause_window, sentinel;
  int cap, n_stages, stage_bits, n_switches, n_flows, lanes, limit_per_lane;
  int backpressure, pfc;
  float pfc_frac;
};

namespace {

// In-warp sum / min over each run of lanes with equal `seg` (runs are
// contiguous): afterwards the first lane of a run holds the run's totals.
__device__ __forceinline__ void segment_reduce(int seg, int lane, int& cnt,
                                               int& best, int& sum) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int s2 = __shfl_down_sync(kFullMask, seg, off);
    const int c2 = __shfl_down_sync(kFullMask, cnt, off);
    const int b2 = __shfl_down_sync(kFullMask, best, off);
    const int u2 = __shfl_down_sync(kFullMask, sum, off);
    if (lane + off < 32 && s2 == seg) {
      cnt += c2;
      best = min(best, b2);
      sum += u2;
    }
  }
}

// A kDerive row's operands of stage B.
struct RowOperands {
  int nic, owner, feeds, ing, pfc_prev;
};

__device__ __forceinline__ RowOperands load_row(const Params& a, int r) {
  return {__ldg(a.port_is_nic + r), __ldg(a.port_switch + r),
          __ldg(a.feeds + r), __ldg(a.ing_occ + r), __ldg(a.pfc_prev + r)};
}

// kSrf: the key is the SRF key (kFused: srf_key, pre-clamped by the caller;
// kDerive: min(qsrf, BIG)) instead of the DRR rotation (q - ptr) mod nq.
template <int kMode, bool kSrf>
__global__ void __launch_bounds__(kMode == kDerive ? kDeriveThreads
                                                     : kThreads, 1)
bfc_step_kernel(const Params a) {
  extern __shared__ int smem[];
  const int rpb = a.rows_per_block;
  int* s_nact = smem;          // per row: active queues, then th (stage C)
  int* s_best = smem + rpb;    // per row: packed pick, then sel (stage C)
  int* s_pocc = s_best + rpb;  // kDerive: per row port occupancy
  int* s_sw = s_pocc + rpb;    // kDerive: this block's rows per switch
  int* s_swt = s_sw + a.n_switches;  // kDerive: the whole cluster's
  const int nq = a.nq;
  // kDerive: the lane is the cluster, its blocks split the lane's rows;
  // kDecide / kFused: one lane, a block per kRowsPerBlock rows
  namespace cg = cooperative_groups;
  unsigned rank = blockIdx.x, n_blocks = gridDim.x, lane_k = 0;
  if constexpr (kMode == kDerive) {
    const cg::cluster_group cluster = cg::this_cluster();
    rank = cluster.block_rank();
    n_blocks = cluster.num_blocks();
    lane_k = blockIdx.x / n_blocks;
  }
  const int lane_row0 = lane_k * a.n_rows, lane_f0 = lane_k * a.n_flows;
  const int sw0 = lane_k * a.n_switches;
  const int row0 = lane_row0 + rank * rpb;
  const int row1 = min(lane_row0 + a.n_rows, row0 + rpb);
  const int nr = max(row1 - row0, 0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const bool derive = kMode == kDerive;
  const bool lookup = derive && a.backpressure;

  for (int i = tid; i < nr; i += nthr) {
    s_nact[i] = 0;
    s_best[i] = a.sentinel;
    if (derive) s_pocc[i] = 0;
  }
  if (derive)
    for (int i = tid; i < a.n_switches; i += nthr) s_sw[i] = 0;
  // kDerive: stage B's first row and the first arrival of each thread are
  // loaded now, so that their round trips overlap stage A's
  RowOperands mine = {};
  int tick = 0, buffer_limit = 0, f_first = 0, rem0 = 0, arr0 = 0, size0 = 0;
  if constexpr (kMode == kDerive) {
    if (tid < nr) mine = load_row(a, row0 + tid);
    tick = __ldg(a.t);
    buffer_limit = __ldg(a.buffer_limit + (a.limit_per_lane ? lane_k : 0));
    const int per_block = (a.n_flows + n_blocks - 1) / n_blocks;
    f_first = lane_f0 + rank * per_block + tid;
    if (tid < per_block && f_first < lane_f0 + a.n_flows) {
      rem0 = __ldg(a.rem_src + f_first);
      arr0 = __ldg(a.arrival + f_first);
      size0 = __ldg(a.size + f_first);
    }
  }
  __syncthreads();

  // ---- stage A: every (port, queue) entry of the block's rows ----
  const int e0 = row0 * nq, e1 = row1 * nq;
  for (int c0 = e0 + warp * 32; c0 < e1; c0 += nwarps * 32 * kUnroll) {
    int e[kUnroll], row[kUnroll], o[kUnroll], head[kUnroll], kv[kUnroll];
    bool valid[kUnroll], qp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      e[u] = c0 + u * nwarps * 32 + lane;
      valid[u] = e[u] < e1;
      row[u] = valid[u] ? e[u] / nq : -1 - lane;  // distinct past the end
      if (derive) {
        head[u] = valid[u] ? __ldg(a.qhead + e[u]) : 0;
        o[u] = valid[u] ? __ldg(a.qtail + e[u]) - head[u] : 0;
        qp[u] = false;
      } else {
        o[u] = valid[u] ? __ldg(a.occ + e[u]) : 0;
        qp[u] = valid[u] && __ldg(a.qpaused + e[u]) != 0;
      }
      // the key's operand, in the same round of loads
      kv[u] = !valid[u] ? 0
          : kSrf ? __ldg((derive ? a.qsrf : a.srf_key) + e[u])
                 : __ldg(a.ptr + row[u]);
    }
    if (lookup) {
      // qpaused = every stage's bit of the head packet's flow is set, and
      // the queue is non-empty: three rounds of loads, each issued for all
      // kUnroll chunks before the next, only for non-empty queues; an empty
      // head slot reads the lane's flow 0, as the reference does
      int hf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int slot = head[u] % a.cap;
        if (slot < 0) slot += a.cap;
        const int entry = o[u] > 0
            ? __ldg(a.qbuf + (static_cast<int64_t>(e[u]) * a.cap + slot))
            : -1;
        hf[u] = entry >= 0 ? entry >> 1 : lane_f0;
      }
      bool all[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) all[u] = o[u] > 0;
      for (int s0 = 0; s0 < a.n_stages; s0 += kStageGroup) {
        int pos[kUnroll][kStageGroup];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int g = 0; g < kStageGroup; ++g)
            pos[u][g] = (o[u] > 0 && s0 + g < a.n_stages)
                ? __ldg(a.fpos + (static_cast<int64_t>(hf[u]) * a.n_stages
                                  + s0 + g))
                : 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t base =
              (static_cast<int64_t>(row[u]) * a.n_stages + s0) * a.stage_bits;
#pragma unroll
          for (int g = 0; g < kStageGroup; ++g) {
            // no short circuit: every stage's load is issued at once
            const bool bit = (o[u] > 0 && s0 + g < a.n_stages)
                ? __ldg(a.bloom_rx + (base + g * a.stage_bits + pos[u][g])) != 0
                : true;
            all[u] &= bit;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) qp[u] = all[u];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = valid[u] ? e[u] - row[u] * nq : 0;
      if (derive && valid[u]) {
        a.o_occ[e[u]] = o[u];
        a.o_occ_after[e[u]] = o[u];
        a.o_qpaused[e[u]] = qp[u] ? 1 : 0;
      }
      const bool active = valid[u] && o[u] > 0 && !qp[u];
      int key;
      if (kSrf) {
        key = derive ? min(kv[u], kBig) : kv[u];
      } else {
        key = (q - kv[u]) % nq;  // C++ % truncates; the reference floors
        if (key < 0) key += nq;
      }
      int cnt = active ? 1 : 0;
      int best = active ? key * nq + q : a.sentinel;
      int sum = o[u];
      segment_reduce(row[u], lane, cnt, best, sum);
      const int prev = __shfl_up_sync(kFullMask, row[u], 1);
      if (valid[u] && (lane == 0 || prev != row[u])) {
        const int i = row[u] - row0;
        if (cnt) atomicAdd(s_nact + i, cnt);
        if (best < a.sentinel) atomicMin(s_best + i, best);
        if (derive && sum) atomicAdd(s_pocc + i, sum);
      }
    }
  }
  __syncthreads();

  // ---- kDerive: port and switch occupancy, arrivals at the sources ----
  if constexpr (kMode == kDerive) {
    for (int i = tid; i < nr; i += nthr) {
      const RowOperands ro = i == tid ? mine : load_row(a, row0 + i);
      a.o_port_occ[row0 + i] = s_pocc[i];
      if (!ro.nic) atomicAdd(s_sw + max(ro.owner - sw0, 0), s_pocc[i]);
    }
    const int per_block = (a.n_flows + n_blocks - 1) / n_blocks;
    const int f1 = lane_f0 + min(a.n_flows, static_cast<int>(rank) * per_block
                                                + per_block);
    for (int f = f_first; f < f1; f += nthr) {
      const bool first = f == f_first;
      const int rem = first ? rem0 : __ldg(a.rem_src + f);
      const int arr = first ? arr0 : __ldg(a.arrival + f);
      const int size = first ? size0 : __ldg(a.size + f);
      a.o_rem_src[f] = rem + (arr == tick ? size : 0);
    }
    // every block's partial switch sums, read through distributed shared
    // memory once the cluster has them all; the second barrier keeps each
    // block's shared memory alive until every block has read it
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int i = tid; i < a.n_switches; i += nthr) {
      int total = 0;
      for (unsigned b = 0; b < n_blocks; ++b)
        total += cluster.map_shared_rank(s_sw, b)[i];
      s_swt[i] = total;
      if (rank == 0) a.o_sw_occ[sw0 + i] = total;
    }
    cluster.sync();
  }

  // ---- stage B: per row threshold, blocked mask and pick ----
  for (int i = tid; i < nr; i += nthr) {
    const int r = row0 + i;
    const int n_active = max(s_nact[i], 1);
    const int th = (a.pause_window + n_active - 1) / n_active;
    bool blocked = false;
    if (kMode == kFused) blocked = __ldg(a.blocked + r) != 0;
    if (derive) {
      // PFC hysteresis: pause above the fed switch's threshold, resume
      // below half of it; the threshold is float32(pfc_frac) times the
      // free buffer converted round-to-nearest, truncated, at least 2
      const RowOperands ro = i == tid ? mine : load_row(a, r);
      bool pfc = false;
      if (a.pfc) {
        int th_here = 1 << 30;
        if (ro.feeds >= 0) {
          const int free_buf = max(buffer_limit - s_swt[ro.feeds - sw0], 0);
          th_here = max(__float2int_rz(__fmul_rn(
                            a.pfc_frac, __int2float_rn(free_buf))), 2);
        }
        pfc = ro.pfc_prev ? ro.ing > th_here / 2 : ro.ing > th_here;
      }
      a.o_pfc[r] = pfc ? 1 : 0;
      blocked = pfc || ro.nic;
    }
    const int best = blocked ? a.sentinel : s_best[i];
    const bool can_tx = best < a.sentinel;
    const int sel = can_tx ? best % nq : -1;
    a.o_th[r] = th;
    a.o_sel[r] = sel;
    if (kMode != kDecide) a.o_cantx[r] = can_tx ? 1 : 0;
    if (derive) {
      if (can_tx) {
        const int j = r * nq + sel;
        a.o_occ_after[j] = __ldg(a.qtail + j) - __ldg(a.qhead + j) - 1;
      }
    } else {
      a.o_nact[r] = n_active;
      s_nact[i] = th;
      s_best[i] = sel;
    }
  }
  if (derive) return;
  __syncthreads();

  // ---- stage C (kDecide, kFused): pause mask and occ_after ----
  for (int e = e0 + tid; e < e1; e += nthr) {
    const int r = e / nq, i = r - row0;
    const int o = __ldg(a.occ + e);
    a.o_pause[e] = o > s_nact[i] ? 1 : 0;
    if (kMode == kFused) a.o_occ_after[e] = o - (e - r * nq == s_best[i]);
  }
}

// kDerive: rows of a lane per block, and the dynamic shared memory of a block
// (per row: active count, pick, port occupancy; per switch of the lane: this
// block's and the cluster's sums).
int derive_rows_per_block(int n_rows) {
  return (n_rows + kClusterBlocks - 1) / kClusterBlocks;
}

size_t derive_smem_bytes(int n_rows, int n_switches) {
  return sizeof(int) * (3 * static_cast<size_t>(derive_rows_per_block(n_rows))
                        + 2 * static_cast<size_t>(n_switches));
}

template <int kMode, bool kSrf>
int launch(Params a, cudaStream_t s) {
  if (kMode == kDerive) {
    // one cluster per lane: the lane's rows split over its blocks
    a.rows_per_block = derive_rows_per_block(a.n_rows);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kClusterBlocks * a.lanes);
    cfg.blockDim = dim3(kDeriveThreads);
    cfg.dynamicSmemBytes = derive_smem_bytes(a.n_rows, a.n_switches);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kClusterBlocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, bfc_step_kernel<kMode, kSrf>, a);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  a.rows_per_block = kRowsPerBlock;
  const dim3 grid((a.n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  bfc_step_kernel<kMode, kSrf><<<grid, kThreads,
                                 sizeof(int) * 2 * kRowsPerBlock, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory (bytes) of a kDerive block for one lane of n_rows
// ports and n_switches switches.
extern "C" size_t bfc_step_derive_smem_bytes(int n_rows, int n_switches) {
  return derive_smem_bytes(n_rows, n_switches);
}

// mode: 0 decide, 1 fused, 2 derive. Launches on `stream`, does not
// synchronise, and returns the cudaError_t of the launch (0 = success).
extern "C" int bfc_step_launch(int mode, int srf, const Params* p,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDecide:
      return launch<kDecide, false>(*p, s);
    case kFused:
      return srf ? launch<kFused, true>(*p, s) : launch<kFused, false>(*p, s);
    case kDerive:
      return srf ? launch<kDerive, true>(*p, s) : launch<kDerive, false>(*p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
