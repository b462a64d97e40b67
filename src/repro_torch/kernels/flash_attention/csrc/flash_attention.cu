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
// Bound: at the prefill shape (B=2, H=10, K=1, S=T=4096, hd=256, causal,
// window 2048) the unmasked work is 6,292,480 (q, k) pairs per (b, h) at
// 4*hd FLOPs each: 1.29e11 FLOPs, 0.130 ms at the bf16 tensor-core peak,
// while the bytes take 0.028 ms -- bound by operations, so the products
// have to run on the tensor cores.
//
// Two kernels, one per dtype; each (dtype, hd) has exactly one instance.
//
// bfloat16: flash_fwd_bf16_kernel, wgmma fed by TMA. One block of three
// warpgroups per (128-row q tile, q head, batch); q tiles launch in
// reverse order, so the blocks with the most unmasked kv tiles go first,
// and a block loads only the kv tiles of [q0 - window + 1, q0 + 127].
// Warpgroup 0 is the producer: it gives up registers (setmaxnreg) and one
// thread issues the TMA loads -- the q tile once, then the K and V tiles
// of 64 rows through a ring of stages (two at hd = 256, three below), K
// and V each with their own full and empty mbarriers. Tiles land in shared
// memory in 128-byte swizzled boxes of 64 columns, so a 256-wide row is
// four boxes and the wgmma descriptors walk the same 64-column chunks;
// head dims below a multiple of 64 are zero-filled by TMA to the next one.
// Warpgroups 1 and 2 are consumers of 64 q rows each (setmaxnreg up):
// S = Q K^T by wgmma m64n64k16 with both operands in shared memory
// (K-major); the online softmax in registers in the accumulator layout
// (row max by quad shuffles; masks only on kv tiles that cross the causal
// diagonal, the window's lower edge or the end of T); P rounded to bf16 in
// registers as wgmma's A operand and V read from shared memory as an
// MN-major B (the transpose bit), O += P V into float32 accumulators that
// stay in registers for the whole kv loop. Inside a consumer, P V of tile
// n-1 runs on the tensor cores while the softmax of tile n runs on the
// CUDA cores: an iteration issues S of tile n and P V of tile n-1
// together, waits for S only, and waits for P V before rescaling O. The
// first tile is peeled and no tile is skipped, so no wgmma issue or wait
// sits in a branch: ptxas serialises wgmma across divergent paths (C7520),
// and that made the overlap slower than none. The epilogue divides by
// max(l, 1e-20), rounds to bf16 (nearest even) and stores into the
// (B,S,H,hd) buffer. TMA descriptors are built on the host for each call
// over the strided views and passed as __grid_constant__ parameters;
// masked rows keep the -1e30 convention (p = 1 until the first unmasked
// key, then wiped by the correction), and TMA's zero fill covers the rows
// past S and T.
//
// float32: flash_fwd_kernel, on the CUDA cores (TF32 tensor cores would
// not hold the float32 checks): one block of 256 threads per (q tile of
// 64 rows, q head, batch), staging q once and walking the kv tiles of 32
// rows that hold an unmasked key -- [q0 - window + 1, q0 + 63] -- through
// shared memory, rows padded by one word.
// Thread (ty, tx) = (tid / 16, tid % 16) owns q rows ty + 16 i (i < 4),
// key columns tx + 16 j (j < 2) of the 64x32 score tile and head-dim
// columns tx + 16 c of the output, so a row's max and sum are 16-lane
// shuffles inside one half-warp. Rows past S and keys past T are masked.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {   // element strides of (batch, head, position); hd is 1
  long long b, h, s;
};

// ---------------------------------------------------------------- float32

constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 32;       // kv rows per tile
constexpr int kThreads = 256;
constexpr int kRows = kBQ / 16;   // q rows per thread
constexpr int kCols = kBK / 16;   // score columns per thread

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }

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


// --------------------------------------------------------------- bfloat16

constexpr int kBK16 = 64;           // kv rows per tile
constexpr int kBQ16 = 128;          // q rows per block: two consumers of 64
constexpr int kThreads16 = 384;     // producer + two consumer warpgroups
constexpr int kConsumers = 256;     // threads of the two consumers
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskLog2 = kNegInf * kLog2e;   // -1e30 in the log2 domain

template <int HD>
struct Cfg {
  static constexpr int kChunks = (HD + 63) / 64;   // 64-column swizzle boxes
  static constexpr int kQkSteps = (HD + 15) / 16;  // k16 steps of Q K^T
  static constexpr int kPvSteps = kBK16 / 16;      // k16 steps of P V
  static constexpr int kStages = kChunks <= 2 ? 3 : 2;
  static constexpr int kQBytes = kChunks * kBQ16 * 128;
  static constexpr int kTileBytes = kChunks * kBK16 * 128;   // a K or V tile
  static constexpr int kBarBytes = 8 * (1 + 4 * kStages);
  // + 1024: the dynamic buffer is aligned up to the 1024-byte swizzle atom
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kTileBytes + kBarBytes;
  static_assert(kSmem <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map (hd, position, head, batch) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// 128B swizzle. Rows are 128 bytes, 8-row groups 1024 bytes apart (SBO);
// K-major operands ignore LBO, the MN-major V takes 1024 there as well.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1024 >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins register values at this point of the instruction stream, so the
// compiler moves no read or write of an accumulator across a fence/wait.
template <int N>
__device__ __forceinline__ void pin(float* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* x) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, float32) [+]= A (64 x 16, bf16, smem) * B (16 x 64, bf16, smem)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, float32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16,
// smem, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 64 kChunks) += P (64 x kBK16, registers) V (kBK16 x 64 kChunks,
// the stage's tile at v_tile), committed as one group.
template <int kChunks>
__device__ __forceinline__ void issue_pv(float (&acc)[kChunks][32],
                                         uint32_t (&p)[kBK16 / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int j = 0; j < kBK16 / 16; ++j)
      wgmma_rs_n64(acc[c], p[j],
                   sw128_desc(v_tile + c * kBK16 * 128 + j * 16 * 128));
  wgmma_commit();
}

template <int HD>
__global__ void __launch_bounds__(kThreads16, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, Strides so, int H,
                      int group, int S, int T_len, int causal, int window,
                      float scale_log2) {
  using C = Cfg<HD>;
  constexpr int kSAcc = kBK16 / 2;   // score accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + C::kQBytes;                // kStages K tiles
  const uint32_t sv = sk + C::kStages * C::kTileBytes;   // kStages V tiles
  // barriers: q; K full, V full, K empty, V empty for each stage
  const uint32_t bar_q = sv + C::kStages * C::kTileBytes;
  const uint32_t k_full = bar_q + 8, v_full = k_full + 8 * C::kStages;
  const uint32_t k_empty = v_full + 8 * C::kStages;
  const uint32_t v_empty = k_empty + 8 * C::kStages;

  const int head = blockIdx.x % H, batch = blockIdx.x / H;
  const int kv_head = head / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ16;   // heaviest first
  // kv tiles that hold an unmasked key for some row of this q tile
  const int k_hi = causal ? min(T_len, q0 + kBQ16) : T_len;   // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = k_lo / kBK16;
  const int n_tiles = (k_hi + kBK16 - 1) / kBK16 - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, kConsumers);
      mbar_init(v_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        tma_load(sq + c * kBQ16 * 128, &tm_q, bar_q, 64 * c, q0, head, batch);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % C::kStages;
        const uint32_t parity = (n / C::kStages) & 1;
        const int k0 = (t_lo + n) * kBK16;
        // K and V have their own slots: a tile's K is free once its S is
        // done, its V once its P V product is, an iteration later
        mbar_wait(k_empty + 8 * st, parity ^ 1);
        mbar_expect_tx(k_full + 8 * st, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(sk + st * C::kTileBytes + c * kBK16 * 128, &tm_k,
                   k_full + 8 * st, 64 * c, k0, kv_head, batch);
        mbar_wait(v_empty + 8 * st, parity ^ 1);
        mbar_expect_tx(v_full + 8 * st, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load(sv + st * C::kTileBytes + c * kBK16 * 128, &tm_v,
                   v_full + 8 * st, 64 * c, k0, kv_head, batch);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = (threadIdx.x - 128) / 128;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r_lo = q0 + 64 * wg, r_hi = r_lo + 63;   // this warpgroup's rows
    // accumulator layout: element i of a thread is row row0 + 8*((i>>1)&1),
    // column 8*(i>>2) + 2*(lane&3) + (i&1)
    const int row0 = r_lo + 16 * warp + lane / 4;
    const int col0 = 2 * (lane & 3);

    float acc[C::kChunks][32];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    float m[2] = {kMaskLog2, kMaskLog2}, l[2] = {0.f, 0.f};   // l: partial
    const uint32_t q_rows = sq + wg * 64 * 128;

    // S = Q K^T of the tile in stage st into s, committed as one group
    auto issue_qk = [&](float* sacc, int st) {
      const uint32_t k_tile = sk + st * C::kTileBytes;
#pragma unroll
      for (int ks = 0; ks < C::kQkSteps; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        wgmma_ss_n64(sacc,
                     sw128_desc(q_rows + (ks / 4) * kBQ16 * 128 + off),
                     sw128_desc(k_tile + (ks / 4) * kBK16 * 128 + off),
                     ks > 0);
      }
      wgmma_commit();
    };
    // the online softmax of the tile at k0: s becomes p, m and l move on,
    // corr is the factor for everything accumulated before this tile
    auto softmax = [&](float* sacc, int k0, float* corr) {
      const bool edge = k0 + kBK16 > T_len ||
                        (causal && k0 + kBK16 - 1 > r_lo) ||
                        (window > 0 && k0 <= r_hi - window);
#pragma unroll
      for (int i = 0; i < kSAcc; ++i) sacc[i] *= scale_log2;
      if (edge) {
#pragma unroll
        for (int i = 0; i < kSAcc; ++i) {
          const int qp = row0 + 8 * ((i >> 1) & 1);
          const int kp = k0 + 8 * (i >> 2) + col0 + (i & 1);
          bool keep = kp < T_len;
          if (causal) keep = keep && kp <= qp;
          if (window > 0) keep = keep && kp > qp - window;
          if (!keep) sacc[i] = kMaskLog2;
        }
      }
      float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kSAcc; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        corr[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < kSAcc; ++i) {
        sacc[i] = ex2(sacc[i] - m[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += sacc[i];
      }
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
    };
    // P in bf16 as the A operand: k16 step j is accumulators 8j..8j+7
    uint32_t p[C::kPvSteps][4];
    auto pack = [&](const float* sacc) {
#pragma unroll
      for (int j = 0; j < C::kPvSteps; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] = pack_bf16(sacc[8 * j + 2 * e], sacc[8 * j + 2 * e + 1]);
      pin<4 * C::kPvSteps>(&p[0][0]);
    };

    // Every tile is computed, so the wgmma issues and waits below take no
    // branch (ptxas serialises wgmma across divergent paths). The P V
    // product of tile n-1 runs on the tensor cores while this warpgroup
    // computes the softmax of tile n.
    float s[kSAcc], corr[2];
    mbar_wait(bar_q, 0);
    mbar_wait(k_full, 0);
#pragma unroll
    for (int i = 0; i < kSAcc; ++i) s[i] = 0.f;
    pin<kSAcc>(s);
    wgmma_fence();
    issue_qk(s, 0);
    wgmma_wait<0>();
    pin<kSAcc>(s);
    mbar_arrive(k_empty);
    softmax(s, t_lo * kBK16, corr);
    pack(s);
    for (int n = 1; n < n_tiles; ++n) {
      const int st = n % C::kStages, p_st = (n - 1) % C::kStages;
      mbar_wait(k_full + 8 * st, (n / C::kStages) & 1);
      mbar_wait(v_full + 8 * p_st, ((n - 1) / C::kStages) & 1);
#pragma unroll
      for (int i = 0; i < kSAcc; ++i) s[i] = 0.f;
      pin<kSAcc>(s);
      wgmma_fence();
      issue_qk(s, st);
      issue_pv<C::kChunks>(acc, p, sv + p_st * C::kTileBytes);
      wgmma_wait<1>();   // S is done; P V may still run
      pin<kSAcc>(s);
      mbar_arrive(k_empty + 8 * st);
      softmax(s, (t_lo + n) * kBK16, corr);
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) pin<32>(acc[c]);
      pin<4 * C::kPvSteps>(&p[0][0]);   // P stayed live until here
      mbar_arrive(v_empty + 8 * p_st);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) pin<32>(acc[c]);
      pack(s);
    }
    const int last = (n_tiles - 1) % C::kStages;
    mbar_wait(v_full + 8 * last, ((n_tiles - 1) / C::kStages) & 1);
    wgmma_fence();
    issue_pv<C::kChunks>(acc, p, sv + last * C::kTileBytes);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) pin<32>(acc[c]);
    mbar_arrive(v_empty + 8 * last);

    // epilogue: O / max(l, 1e-20), bf16, into the (B,S,H,hd) buffer
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
    }
    __nv_bfloat16* ob = o + batch * so.b + head * so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = row0 + 8 * r;
      if (qp >= S) continue;
      const float denom = fmaxf(l[r], 1e-20f);
      __nv_bfloat16* orow = ob + qp * so.s;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * c + 8 * j + col0;
          if (col < HD)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(acc[c][4 * j + 2 * r] / denom,
                                      acc[c][4 * j + 2 * r + 1] / denom);
        }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (hd, position, head, batch) bf16 view with element strides st, read in
// boxes of (64 columns, rows) with 128-byte swizzle; out-of-range elements
// (columns past hd, positions past len) read as zero.
CUresult encode(CUtensorMap* map, const void* ptr, int hd, int len, int heads,
                int batch, Strides st, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Error codes past cudaError_t's range: 10000 + the CUresult of a failed
// tensor-map encoding.
constexpr int kEncodeError = 10000;

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                int KH, int S, int T_len, int causal, int window, float scale,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  CUresult res = encode(&tq, q, HD, S, H, B, sq, kBQ16);
  if (res == CUDA_SUCCESS) res = encode(&tk, k, HD, T_len, KH, B, sk, kBK16);
  if (res == CUDA_SUCCESS) res = encode(&tv, v, HD, T_len, KH, B, sv, kBK16);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  auto kern = flash_fwd_bf16_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<HD>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBQ16 - 1) / kBQ16);
  kern<<<grid, kThreads16, Cfg<HD>::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), so, H, H / KH, S, T_len,
      causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Strides are
// in elements; the head-dim stride must be 1, and for bfloat16 the bases
// must be 16-byte aligned and the strides multiples of 8 elements (TMA).
// Returns 0 on success, else the launch's cudaError_t, or 10000 + the
// CUresult of a failed tensor-map encoding.
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
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (hd) {
#define FA_CASE(D)                                                           \
  case D:                                                                    \
    return dtype == 0                                                        \
               ? launch<float, D>(q, k, v, o, sq, sk, sv, so, B, H, group,   \
                                  S, T_len, causal, window, scale, st)       \
               : launch_bf16<D>(q, k, v, o, sq, sk, sv, so, B, H, KH, S,     \
                                T_len, causal, window, scale, st);
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
