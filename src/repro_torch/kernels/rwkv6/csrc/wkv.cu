// RWKV-6 WKV recurrence for Hopper (sm_90a) in chunked form on the tensor
// cores, bound to Python through a plain C interface (ctypes; see
// ../wkv.py).
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
// float32. It computes the TPU kernel's chunked form (C = 16 tokens, as
// ../ref.py::wkv_chunked_ref): with cs the chunk's running sum of logw,
//
//     r_dec = r e^{cs_{i-1}}, k_sc = k e^{-cs},  k_dec = k (e^{cs_C} e^{-cs})
//     att   = r_dec k_sc^T, strictly lower (j < i), u-bonus r.u.k on the
//             diagonal, masked by select (e^{-cs} reaches e^80 at the
//             model's clip of logw to [-5, 0), so the masked half may be
//             inf or NaN: it is never multiplied, only replaced)
//     out   = r_dec S + att v
//     S'    = diag(e^{cs_C}) S + k_dec^T v.
//
// Bound: each input read once and each output written once is 16 bytes
// per (b, t, h, d) element with bf16 r/k/v -- 0.30 GB at B=2, S=4096,
// H=40, D=64, 0.088 ms at 3.35 TB/s -- against the chunked form's
// 4 C D + 4 D^2 operations per token and head (6.7e9 at that shape,
// 0.014 ms at the 495 TFLOP/s dense TF32 tensor rate): bound by bytes.
//
// Design. One block per (head, batch), all D columns of S (80 blocks at
// the path shape; splitting S's columns over two blocks is slower, as
// every block repeats the work that does not depend on S). Everything
// about a chunk but two products is independent of S, so producer warps
// compute it ahead of the chain and consumer warps carry S:
//
// - producers: two groups of 4 warps take the chunks in turn, each into
//   stage c % 3 of a ring the consumers read (named barriers full/empty
//   per stage). A group's cp.async copies (the ragged tail zero-filled:
//   k = v = 0 and logw = 0, so S passes through unchanged) land one of
//   its chunks ahead in its own two raw slots. Per chunk its 128 threads
//   form cs (sequentially per channel, as a cumsum), r_dec, k_sc, k_dec,
//   e^{cs_C} and r.u.k; then warp w takes att over half w / 2 of d for
//   token tile w % 2, and v^T's fragments for column block w (warp 0 also
//   the u-bonus); after a barrier, intra = att v for column block w.
// - consumers: a pair of warps per 16 columns e, each holding its half of
//   d of those columns of S^T (e x d) as mma accumulator fragments, in
//   registers for the whole sequence. Per chunk each forms its half of
//   out^T = S^T r_dec^T (+ intra^T) on the tensor cores -- an accumulator
//   fragment of m16n8k8 is an A fragment with its k index permuted
//   (k = t, t+4 <-> columns 2t, 2t+1), so S^T feeds the product straight
//   from registers -- and both take the carried step
//   S^T <- S^T diag(e^{cs_C}) + v^T k_dec, one FMA per entry of the state
//   (v^T k_dec does not depend on S: its products are issued first, in
//   fragments of the state's layout, and run while the state waits). The
//   two warps then swap halves of their partials through shared memory,
//   each finishing one token tile of out. Dependent mma chains are kept
//   short (separate accumulators per pass and per parity of the d tile):
//   the kernel is bound by latency more than by issue.
//
// Precision: every product is mma.sync.m16n8k8 TF32 in the 3xTF32 split,
// a = a_hi + a_lo with a_hi rounded as cvt.rna.tf32.f32 rounds (tf32_rna)
// and a_lo = a - a_hi, which the tensor cores read truncated to TF32;
// a b = a_hi b_hi + a_hi b_lo + a_lo b_hi accumulated in float32. A bf16
// operand is exact in TF32 (8 of its 10 mantissa bits), so with bf16
// r/k/v the two products whose other side is v -- intra = att v and
// v^T k_dec -- drop the a_lo term of v (kExactV).
// Single-pass TF32 keeps ~3 digits and misses the 1e-5 tolerance
// (tests/test_torch_rwkv6.py).
#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;                    // tokens per chunk
constexpr int kGroups = 2;                // producer groups, alternate chunks
constexpr int kGroupWarps = 4;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kProducers = kGroups * kGroupThreads;
constexpr int kStages = 3;                // chunk c goes through stage c % 3
constexpr int kRaw = 2;                   // raw input slots per group
// named barriers (0 is __syncthreads), each + group / stage / pair
constexpr int kBarGroup = 1;
constexpr int kBarFull = kBarGroup + kGroups;
constexpr int kBarEmpty = kBarFull + kStages;
constexpr int kBarPair = kBarEmpty + kStages;    // + 4 consumer pairs

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// cvt.rna.tf32.f32 on a finite float: round to nearest, ties away from
// zero, to a 10-bit mantissa (the low 13 bits come out zero)
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// (hi, lo) of the 3xTF32 split: lo = x - hi is exact in float32, and the
// tensor cores read it as TF32, its low 13 bits dropped
__device__ __forceinline__ float2 split(float x) {
  const float hi = tf32_rna(x);
  return make_float2(hi, x - hi);
}

// d += a b on the tensor cores; a is 16x8 (rows g, g+8; k t, t+4), b 8x8
// (k t, t+4; column g), d 16x8 (rows g, g+8; columns 2t, 2t+1) for lane
// 4g + t
__device__ __forceinline__ void mma(float (&d)[4], const float (&a)[4],
                                    float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait_1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T lds(const float* p) {
  return *reinterpret_cast<const T*>(p);
}

// Rows of D floats are padded to D + 8, so that every fragment load is
// conflict-free; k_sc is stored split, (hi, lo) interleaved, since one
// warp reads it once, and r_dec and k_dec whole, split where read
template <int D, typename In>
struct Smem {
  static constexpr int RS = D + 8;        // rows of whole values
  static constexpr int RQ = 2 * D + 16;   // rows of (hi, lo) pairs
  static constexpr int NCW = D / 16;      // consumer column blocks
  static constexpr int NV = sizeof(In) == 2 ? 2 : 4;   // v^T fragments
  struct alignas(16) Stage {
    float4 vfrag[NCW][NV][32];            // v^T A fragments (hi, [lo])
    float4 intra[NCW][2][32];             // intra^T, consumer fragment order
    float rdec[kC][RS];                   // r_dec
    float kdec[kC][RS];                   // k_dec
    float decay[D];                       // e^{cs_C}
  };
  struct alignas(16) Raw {
    In r[kC][D], k[kC][D];
    float lw[kC][D];
    In v[kC][D];
  };
  struct alignas(16) Group {              // one producer group's own
    Raw raw[kRaw];
    float ksc[kC][RQ];                    // k_sc (hi, lo)
    float p[kC][D + 4];                   // r u k, summed into the diagonal
    float att[2][kC][kC + 1];             // r_dec k_sc^T, two halves of d
    float bonus[kC];                      // sum over d of r u k
  };
  Stage st[kStages];
  Group grp[kGroups];
  float4 red[2][NCW][2][32];              // consumer pairs' partial out^T
};

template <typename In>
struct Args {
  const In* r;
  const In* k;
  const In* v;
  const float* logw;
  const float* u;
  const float* h0;
  float* out;
  float* hT;
  int S, H;
};

// Chunks g, g + 2, g + 4, ... of one (head, batch) through producer group
// g (4 warps), each into stage c % 3. Per chunk: the cs prefix and decays
// (all 128 threads); then warp w takes att over half w / 2 of d for token
// tile w % 2 and the A fragments of v^T for consumer column block w (warp
// 0 also the u-bonus); then intra for column block w. The raw slots: a
// chunk's r, k, logw are read before the first barrier, its v (held in
// registers to intra) before the second, after which its slot takes the
// group's chunk after next.
template <int D, typename In>
__device__ void produce(Smem<D, In>& sm, const Args<In>& a) {
  using Sm = Smem<D, In>;
  constexpr int NCW = Sm::NCW;
  constexpr int NT = kGroupThreads + 64 * NCW;     // full / empty barriers
  constexpr bool kExactV = sizeof(In) == 2;
  constexpr int TPT = kC * D / kGroupThreads;      // tokens per thread
  constexpr int NG = kC / TPT;                     // token groups
  static_assert(TPT * kGroupThreads == kC * D, "producer split");
  const int gi = threadIdx.x / kGroupThreads;
  const int tid = threadIdx.x % kGroupThreads, warp = tid / 32,
            lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = a.S, nc = (S + kC - 1) / kC;
  const int64_t tok = static_cast<int64_t>(a.H) * D;
  const int64_t head = (static_cast<int64_t>(b) * S * a.H + h) * D;
  typename Sm::Group& gs = sm.grp[gi];
  const int bar = kBarGroup + gi;

  // chunk c's r, k, logw and v, 16 bytes a copy, rows past S zero-filled
  auto fetch = [&](int c, typename Sm::Raw& rw) {
    if (c >= nc) return;
    auto rows = [&](auto* dst, const auto* src) {
      constexpr int per = 16 / sizeof(*src);      // elements per copy
      constexpr int n = D / per;                  // copies per row
      for (int p = tid; p < kC * n; p += kGroupThreads) {
        const int j = p / n, x = p % n, tt = c * kC + j;
        const int64_t row = head + static_cast<int64_t>(tt < S ? tt : 0)
                                   * tok;
        cp_async16(dst + j * D + x * per, src + row + x * per, tt < S);
      }
    };
    rows(&rw.r[0][0], a.r);
    rows(&rw.k[0][0], a.k);
    rows(&rw.lw[0][0], a.logw);
    rows(&rw.v[0][0], a.v);
  };

  const int d = tid % D, tg = tid / D, i0 = tg * TPT;
  const float ud = a.u[h * D + d];
  fetch(gi, gs.raw[0]);
  cp_commit();
  fetch(gi + kGroups, gs.raw[1]);
  cp_commit();
  for (int c = gi, m = 0; c < nc; c += kGroups, ++m) {
    const typename Sm::Raw& rw = gs.raw[m % kRaw];
    typename Sm::Stage& st = sm.st[c % kStages];
    cp_wait_1();
    // this chunk's slot is complete for the whole group, and (from the
    // fourth chunk on) the consumers are done with the stage
    if (c >= kStages)
      bar_sync(kBarEmpty + c % kStages, NT);
    else
      bar_sync(bar, kGroupThreads);

    // -- the decays. cs is a sequential running sum, as a cumsum; the
    // state before token i has decayed by e^{cs_{i-1}}, token j's k by
    // e^{-cs_j} into the chunk and e^{cs_C - cs_j} to its end
    float pre[kC];
    float cs = 0.f;
#pragma unroll
    for (int i = 0; i < kC; ++i) pre[i] = cs += rw.lw[i][d];
    float before = 0.f, csv[TPT];                  // cs_{i0 - 1}, cs_i
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      if (tg == q) {
        if (q > 0) before = pre[q * TPT - 1];
#pragma unroll
        for (int m2 = 0; m2 < TPT; ++m2) csv[m2] = pre[q * TPT + m2];
      }
    }
    const float ec = expf(cs);                      // e^{cs_C}
    float eprev = expf(before);
#pragma unroll
    for (int m2 = 0; m2 < TPT; ++m2) {
      const int i = i0 + m2;
      const float rv = to_f(rw.r[i][d]), kv = to_f(rw.k[i][d]);
      const float fi = expf(-csv[m2]);
      const float rd = rv * eprev;
      const float ks = kv * fi;
      const float kd = kv * (ec * fi);
      eprev = expf(csv[m2]);
      st.rdec[i][d] = rd;
      *reinterpret_cast<float2*>(&gs.ksc[i][2 * d]) = split(ks);
      st.kdec[i][d] = kd;
      gs.p[i][d] = rv * ud * kv;
    }
    if (tg == 0) st.decay[d] = ec;
    bar_sync(bar, kGroupThreads);

    // -- att(i, j) over one half of d for token tile n, the k index of
    // both fragments permuted to d = 8 kk + 2t (+1)
    {
      const int n = warp & 1, half = warp >> 1;
      float hh[4] = {}, cr[4] = {}, cl[4] = {};
#pragma unroll
      for (int kk = half * (D / 16); kk < (half + 1) * (D / 16); ++kk) {
        const int dd = 8 * kk + 2 * t;
        const float2 x0 = lds<float2>(&st.rdec[g][dd]);
        const float2 x1 = lds<float2>(&st.rdec[g + 8][dd]);
        const float4 kb = lds<float4>(&gs.ksc[8 * n + g][2 * dd]);
        const float2 r00 = split(x0.x), r01 = split(x0.y);
        const float2 r10 = split(x1.x), r11 = split(x1.y);
        const float ah[4] = {r00.x, r10.x, r01.x, r11.x};
        const float al[4] = {r00.y, r10.y, r01.y, r11.y};
        mma(hh, ah, kb.x, kb.z);
        mma(cr, ah, kb.y, kb.w);
        mma(cl, al, kb.x, kb.z);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
        gs.att[half][g + 8 * (x >> 1)][8 * n + 2 * t + (x & 1)] =
            hh[x] + (cr[x] + cl[x]);
    }
    if (warp == 0) {
      // -- the u-bonus: sum over d of r u k, token i = lane % 16
      const int i = lane % 16, part = lane / 16;
      float bonus = 0.f;
#pragma unroll
      for (int x = 0; x < D / 2; x += 4) {
        const float4 q4 = lds<float4>(&gs.p[i][part * (D / 2) + x]);
        bonus += (q4.x + q4.y) + (q4.z + q4.w);
      }
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 16);
      if (part == 0) gs.bonus[i] = bonus;
    }
    // -- the A fragments of v^T for column block cw = warp (rows e =
    // 16 cw + g (+8), k = tokens 8 kk + t (+4)), split unless exact
    const bool owner = warp < NCW;
    float vh[2][4], vl[2][4];
    if (owner) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int e = 16 * warp + g, j = 8 * kk + t;
        const float x4[4] = {to_f(rw.v[j][e]), to_f(rw.v[j][e + 8]),
                             to_f(rw.v[j + 4][e]), to_f(rw.v[j + 4][e + 8])};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          vh[kk][x] = kExactV ? x4[x] : tf32_rna(x4[x]);
          vl[kk][x] = kExactV ? 0.f : x4[x] - vh[kk][x];
        }
      }
      // for the consumers' v^T k_dec
      st.vfrag[warp][0][lane] =
          make_float4(vh[0][0], vh[0][1], vh[0][2], vh[0][3]);
      st.vfrag[warp][1][lane] =
          make_float4(vh[1][0], vh[1][1], vh[1][2], vh[1][3]);
      if constexpr (!kExactV) {
        st.vfrag[warp][2][lane] =
            make_float4(vl[0][0], vl[0][1], vl[0][2], vl[0][3]);
        st.vfrag[warp][3][lane] =
            make_float4(vl[1][0], vl[1][1], vl[1][2], vl[1][3]);
      }
    }
    bar_sync(bar, kGroupThreads);
    // the slot is free: it takes the group's chunk after next
    fetch(c + 2 * kGroups, gs.raw[m % kRaw]);
    cp_commit();

    if (owner) {
      // -- intra^T (e x i) = v^T A^T, A(i, j) = att for j < i, the
      // u-bonus for j == i, 0 above (a select: the masked products may
      // be inf or NaN)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int i = 8 * n + g;
        const float bonus = gs.bonus[i];
        float hh[4] = {0.f, 0.f, 0.f, 0.f}, cr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          float2 bv[2];
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int j = 8 * kk + t + 4 * y;
            bv[y] = split(j < i ? gs.att[0][i][j] + gs.att[1][i][j]
                                : (j == i ? bonus : 0.f));
          }
          mma(hh, vh[kk], bv[0].x, bv[1].x);
          mma(cr, vh[kk], bv[0].y, bv[1].y);
          if (!kExactV) mma(cr, vl[kk], bv[0].x, bv[1].x);
        }
        st.intra[warp][n][lane] = make_float4(hh[0] + cr[0], hh[1] + cr[1],
                                              hh[2] + cr[2], hh[3] + cr[3]);
      }
    }
    bar_arrive(kBarFull + c % kStages, NT);
  }
}

// Consumer warp pair (column block cw, half of d): each warp holds its
// half of 16 columns of S^T as accumulator fragments for the whole
// sequence, forms its half of out^T = S^T r_dec^T (+ intra^T in the first
// warp), takes the carried step S^T <- S^T diag(e^{cs_C}) + v^T k_dec,
// and the two swap halves of their partials through shared memory, each
// finishing one token tile of out.
template <int D, typename In>
__device__ void consume(Smem<D, In>& sm, const Args<In>& a) {
  using Sm = Smem<D, In>;
  constexpr int NT = kGroupThreads + 64 * Sm::NCW;
  constexpr int NQ = D / 16;                       // d tiles per warp
  constexpr bool kExactV = sizeof(In) == 2;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int cwp = (threadIdx.x - kProducers) / 32;
  const int cw = cwp / 2, half = cwp % 2;
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = a.S, nc = (S + kC - 1) / kC;
  const int64_t tok = static_cast<int64_t>(a.H) * D;
  const int64_t head = (static_cast<int64_t>(b) * S * a.H + h) * D;
  const int64_t sb = (static_cast<int64_t>(b) * a.H + h) * D * D;
  const int ec = 16 * cw + g;                     // columns ec, ec + 8
  const int q0 = half * NQ;

  // S^T (e x d) as accumulator fragments: d tile q holds (ec, 8q+2t),
  // (ec, 8q+2t+1), (ec+8, 8q+2t), (ec+8, 8q+2t+1)
  float st_[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int64_t o =
        sb + static_cast<int64_t>(8 * (q0 + q) + 2 * t) * D + ec;
    st_[q][0] = a.h0[o];
    st_[q][1] = a.h0[o + D];
    st_[q][2] = a.h0[o + 8];
    st_[q][3] = a.h0[o + D + 8];
  }
  for (int c = 0; c < nc; ++c) {
    const int s = c % kStages;
    const typename Sm::Stage& st = sm.st[s];
    bar_sync(kBarFull + s, NT);
    // v^T k_dec first: it does not depend on S, so its products run
    // while the state waits
    float u[NQ][4] = {};
    {
      float vh[2][4], vl[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float4 f = st.vfrag[cw][kk][lane];
        vh[kk][0] = f.x;
        vh[kk][1] = f.y;
        vh[kk][2] = f.z;
        vh[kk][3] = f.w;
        if constexpr (!kExactV) {
          const float4 l = st.vfrag[cw][2 + kk][lane];
          vl[kk][0] = l.x;
          vl[kk][1] = l.y;
          vl[kk][2] = l.z;
          vl[kk][3] = l.w;
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int j = 8 * kk + t, dd = 8 * (q0 + q) + g;
          const float2 b0 = split(st.kdec[j][dd]);
          const float2 b1 = split(st.kdec[j + 4][dd]);
          mma(u[q], vh[kk], b0.x, b1.x);
          mma(u[q], vh[kk], b0.y, b1.y);
          if (!kExactV) mma(u[q], vl[kk], b0.x, b1.x);
        }
      }
    }
    // out^T = S^T r_dec^T (+ intra^T): the hi*hi terms and the two
    // correction terms in separate accumulators for even and odd q
    float acc[4][2][4] = {};
    if (half == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float4 f = st.intra[cw][n][lane];
        acc[0][n][0] = f.x;
        acc[0][n][1] = f.y;
        acc[0][n][2] = f.z;
        acc[0][n][3] = f.w;
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float sh[4], sl[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float2 p = split(st_[q][x]);
        sh[x] = p.x;
        sl[x] = p.y;
      }
      // an accumulator fragment read as an A fragment: k = t <-> column
      // 2t, k = t + 4 <-> column 2t + 1
      const float ah[4] = {sh[0], sh[2], sh[1], sh[3]};
      const float al[4] = {sl[0], sl[2], sl[1], sl[3]};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 x =
            lds<float2>(&st.rdec[8 * n + g][8 * (q0 + q) + 2 * t]);
        const float2 b0 = split(x.x), b1 = split(x.y);
        mma(acc[q & 1][n], ah, b0.x, b1.x);
        mma(acc[2 + (q & 1)][n], ah, b0.y, b1.y);
        mma(acc[2 + (q & 1)][n], al, b0.x, b1.x);
      }
    }
    // the carried step: S^T <- S^T diag(e^{cs_C}) + v^T k_dec
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float2 dc = lds<float2>(&st.decay[8 * (q0 + q) + 2 * t]);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        st_[q][x] = fmaf(x & 1 ? dc.y : dc.x, st_[q][x], u[q][x]);
    }
    if (c + kStages < nc) bar_arrive(kBarEmpty + s, NT);
    float o[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        o[n][x] = (acc[0][n][x] + acc[1][n][x])
                  + (acc[2][n][x] + acc[3][n][x]);
    // each warp of the pair hands its partial of the other's token tile
    // over, and finishes and stores token tile n = half (selects, not an
    // index, so that o stays in registers)
    float mine[4], theirs[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      mine[x] = half ? o[1][x] : o[0][x];
      theirs[x] = half ? o[0][x] : o[1][x];
    }
    sm.red[c & 1][cw][1 - half][lane] =
        make_float4(theirs[0], theirs[1], theirs[2], theirs[3]);
    bar_sync(kBarPair + cw, 64);
    const float4 p = sm.red[c & 1][cw][half][lane];
    const float r4[4] = {mine[0] + p.x, mine[1] + p.y, mine[2] + p.z,
                         mine[3] + p.w};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int tt = c * kC + 8 * half + 2 * t + (x & 1);
      if (tt < S) a.out[head + tt * tok + ec + 8 * (x >> 1)] = r4[x];
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int64_t o =
        sb + static_cast<int64_t>(8 * (q0 + q) + 2 * t) * D + ec;
    a.hT[o] = st_[q][0];
    a.hT[o + D] = st_[q][1];
    a.hT[o + 8] = st_[q][2];
    a.hT[o + D + 8] = st_[q][3];
  }
}

template <bool kBf16>
struct InOf {
  using T = float;
};
template <>
struct InOf<true> {
  using T = __nv_bfloat16;
};

// r, k, v in bfloat16 when kBf16, else float32 (a bool, not a type, so
// that the instance's name reads back from its symbol)
template <int D, bool kBf16>
__global__ void __launch_bounds__(kProducers + 4 * D, 1)
wkv_kernel(const Args<typename InOf<kBf16>::T> a) {
  static_assert(D % 16 == 0, "column blocks of 16");
  using In = typename InOf<kBf16>::T;
  using Sm = Smem<D, In>;
  extern __shared__ __align__(16) unsigned char smem[];
  Sm& sm = *reinterpret_cast<Sm*>(smem);
  if (threadIdx.x < kProducers)
    produce<D, In>(sm, a);
  else
    consume<D, In>(sm, a);
}

template <int D, typename In>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* h0, void* out, void* hT, int B, int S,
           int H, cudaStream_t stream) {
  using Sm = Smem<D, In>;
  const Args<In> a{
      static_cast<const In*>(r), static_cast<const In*>(k),
      static_cast<const In*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(h0),
      static_cast<float*>(out), static_cast<float*>(hT), S, H};
  const int bytes = static_cast<int>(sizeof(Sm));
  constexpr bool kBf16 = sizeof(In) == 2;
  // the shared-memory ceiling, set once per device for this instance
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  int err = cudaGetDevice(&dev);
  if (err) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(wkv_kernel<D, kBf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  wkv_kernel<D, kBf16><<<dim3(H, B), kProducers + 4 * D, bytes, stream>>>(a);
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
