// Kernel 1's forward for Hopper (sm_90a) at head dims 64, 128 and 256:
// TMA-fed wgmma.
//
// The instances of attention_fwd.cu (head dims 64 and 128),
// attention_fwd_hd256.cu (256), attention_fwd_masked.cu and
// attention_fwd_masked_hd256.cu (the same with MASKED), and
// attention_fwd_preq.cu and attention_fwd_preq_hd256.cu (pre-quantized Q,
// with masks or without): causal x q dtype (PREQ: causal; its output type
// is an argument).  At 384 and 512 the instances are
// attention_fwd_sm90_wide.cuh's kernel, built on this header's pieces with
// O's columns split between the two consumer warpgroups of one CTA.
// attention_fwd_kernel.cuh says what kernel 1 computes, the masks
// included, and holds the masks' pieces.  This kernel computes it a score
// at a time (its exp2 is ex2.approx.ftz, exp2f's instruction without the
// denormal fix-up: a p under 2^-126 is 0):
//   - Q quantized per row in the kernel (max(amax, 1e-30) / 127, roundf,
//     clipped), sm_scale * log2(e) folded into the row scale as qs_mul, or
//     with PREQ the caller's codes and scales;
//   - S = int8 Q.K^T to int32, dequantized as s * (q_scale * k_scale), or
//     with PREQ (s * q_scale * k_scale) * col_scale + col_bias from a
//     column pair's staged (scale, scale, bias, bias);
//   - a base-2 online softmax from NEG_INIT, P rounded to bf16, P.V in bf16
//     with fp32 accumulation (int8, e4m3 and e5m2 V codes widened to bf16
//     by widen_v.cu before the launch, exactly: bf16 holds each code's
//     value; an e4m3 product would round P to fp8, which the TPU kernel
//     never does);
//   - o = (acc / l) * v_scale + v_mean and lse2 = log2(l) + m; causal is
//     top-left, GQA by h / (hq / hkv), ragged sq and sk, one K scale a
//     128-column group (BN).
// Replaces attention_pallas.py:sage_attention_fused (_kernel :918,
// _kernel_single :1207, _compute_parts :393) for these instances.
//
// Bound: operations.  At the CogVideoX-2B layer (1, 30, 17,776, 64) Q.K^T
// is 1.21e12 int8 ops and P.V 1.21e12 bf16 FLOP; at head dim 64 the 9.45e9
// exp2 of the softmax take about as long as the products on the
// special-function units (PERF.md, "Measured rates"), so the design runs
// a warpgroup's exponentials while its own P.V runs.
//
// A CTA is two consumer warpgroups of 64 Q rows each (128 rows) and one
// producer warpgroup:
//   - the producer's first thread issues every TMA load: K codes (a 3-D
//     map [b hkv, sk, D], 128-byte swizzled panels, rows past sk zero) and
//     bf16 V, a KV tile of KT columns a stage, and with PREQ the tile's
//     per-row K scales and column bias (1-D boxes from the 16-byte aligned
//     element at or below the tile's first: a box at an unaligned element
//     faults), through a ring of STAGES stages on mbarriers: `loaded` (the
//     bytes landed) and `empty` (both consumers are done);
//   - a consumer stages its 64 rows of Q codes in shared memory (quantized
//     by its own threads, or PREQ's copied), then loops over the KV tiles:
//     S = Q.K^T by wgmma (Q's codes in registers at D <= 128, the A
//     fragment of a K step, but with MASKED at 128; read from shared
//     memory at 256, where O's
//     accumulator alone takes 128 registers a thread), the softmax in
//     registers, and O += P.V by wgmma with P from registers and V read
//     MN-major.
// V codes are not widened here: the producer's spare warps did it a stage
// at a time at first, once for every 128-row Q tile, which held the code
// instances well behind the bf16 one; one widening pass over V before the
// launch moves 3 bytes a code once (PERF.md, PR 13).
// A step issues tile j's S and tile j - 1's P.V as two wgmma groups, waits
// for S alone and runs tile j's softmax while P.V runs, then waits for P.V,
// rescales O and packs tile j's P: each warpgroup overlaps its own
// exponentials with its own products (FlashAttention-3's intra-warpgroup
// schedule), and the two warpgroups run unsynchronised.  (The two
// warpgroups in ping-pong on named barriers, FlashAttention-3's other
// schedule, measured no faster on top of the overlap: PERF.md, PR 13.)
// So a tile's stage is released one step after its S, when its P.V is
// done.
// Registers: the producer warpgroup gives its own up (setmaxnreg, to 24) so
// that each consumer thread holds 240.  (Staging PREQ's row vectors in the
// producer's spare warps spilled at 24 registers, and the consumers at d
// 128 spilled at 232 beside a producer at 40, so TMA brings them; a vector
// the call has not is 1s or 0s written once, so that a consumer reads both
// without a choice, which spilled.)
//
// KV tiles are the K-scale group (128 columns), or from D = 256 on (and for
// the masked pre-quantized instances at 128) half of it (kKvTile), two
// tiles reading the group's one scale.  The grid's
// fastest axis is the Q tile, so the CTAs of a wave share a head's K and V
// in L2, the longest causal tiles first; a causal launch of at most two
// waves puts the tile on the slowest axis (heads_first) so that every
// head's longest tiles start in the first wave.  Every tile of a CTA's
// range is computed by both warpgroups (a row past sq, or a tile right of
// a row's diagonal, masks to 0): at D <= 128 both need every tile, and at
// 256 the first warpgroup computes one fully masked tile more.
//
// With MASKED every thread of the CTA first works out its KV tiles (a
// window's first, the range form's span over the CTA's 128 rows, the
// causal last) and the walk over those the liveness table lists (a tile
// dead for both warpgroups' table rows is skipped), before the roles part:
// the producer loads the listed tiles only, the i-th into stage i %
// STAGES, and both consumers compute every listed tile and release its
// stage.  A consumer whose own table row marks a tile dead takes it as
// -inf whole (P = 0).  The masks act on S in registers after its product
// (mask_scores), so no wgmma sits on a path that part of a warpgroup
// takes.  The unmasked instances take the same walk over every tile.

#pragma once

#include "attention_fwd_kernel.cuh"
#include "wgmma_sm90.cuh"

namespace {

constexpr int kFwdWG = kWarpgroup;                // threads a warpgroup
constexpr int kFwdConsumers = 2;                  // consumer warpgroups
constexpr int kFwdRows = 64 * kFwdConsumers;      // Q rows a CTA
constexpr int kFwdThreads = kFwdWG * (kFwdConsumers + 1);
// setmaxnreg moves registers inside the CTA's launch allocation, 384 x 168
// (the launch bound's count): 24 x 128 + 240 x 256 is all of it
constexpr int kFwdProducerRegs = 24;
constexpr int kFwdConsumerRegs = 240;
constexpr int kSmemOptin = 232448;                // the most a CTA may ask for

// 2^x, ex2.approx.ftz: one special-function op (exp2f adds a denormal
// fix-up of three more a call; a p below 2^-126 is 0 here)
__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a [ROWS][D] tile of ELEM-byte elements as TMA lays it out: panels of ROWB
// bytes a row (the swizzle's span), each ROWS x ROWB bytes
template <int ROWS, int D, int ELEM>
struct FwdTile {
  static constexpr int ROWB = D * ELEM < 128 ? D * ELEM : 128;
  static constexpr int COLS = ROWB / ELEM;  // elements a panel row (a box)
  static constexpr int PANELS = D * ELEM / ROWB;
  static constexpr int BYTES = ROWS * D * ELEM;
};

// The offset of byte x of row r in such a tile: the 16-byte chunk of a
// 128-byte panel row moves by r mod 8 (128-byte swizzle), of a 64-byte one
// by (r / 2) mod 4 (64-byte swizzle), counted from a 1024-byte aligned base
template <int ROWS, int ROWB>
__device__ inline int tile_off(int r, int x) {
  const int sw = ROWB == 128 ? (r & 7) : ((r >> 1) & 3);
  return (x / ROWB) * ROWS * ROWB + r * ROWB + ((((x % ROWB) >> 4) ^ sw) << 4) + (x & 15);
}

// shared memory: the consumers' Q codes and row scales, then the ring, each
// stage K's codes and bf16 V; with PREQ a stage's row vectors (the K scales
// and the column bias of its KT columns: VEC values from the 16-byte
// aligned element at or below the first, in a VSLOT each); with SBIAS each
// consumer warpgroup's staged bias (kBiasStageBytes, which leaves room for
// 3 stages at 128 and 256); the barriers
template <int D, bool PREQ, bool MASKED = false, bool SBIAS = false>
struct FwdSm90 {
  static constexpr int KT = kKvTile<D, PREQ, MASKED>;
  using TQ = FwdTile<64, D, 1>;
  using TK = FwdTile<KT, D, 1>;
  using TV = FwdTile<KT, D, 2>;
  static constexpr int VEC = KT + 4;
  static constexpr int VSLOT = (VEC * 4 + 127) / 128 * 128;  // 128-byte aligned slots
  static constexpr int q = 0;
  static constexpr int qs = kFwdConsumers * TQ::BYTES;  // fp32 [kFwdRows]
  static constexpr int ring = qs + 1024;
  static constexpr int k = 0, v = TK::BYTES;  // in a stage
  static constexpr int stage = v + TV::BYTES;  // also the bytes a stage's tiles post
  static constexpr int vec_bytes = PREQ ? 2 * VSLOT : 0;  // K scales, column bias
  static constexpr int bias_bytes = SBIAS ? kFwdConsumers * kBiasStageBytes<KT> : 0;
  static constexpr int FIT = (kSmemOptin - 1024 - ring - bias_bytes) / (stage + vec_bytes + 16);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int vecs = ring + STAGES * stage;
  static constexpr int sbias = vecs + STAGES * vec_bytes;
  static constexpr int bars = sbias + bias_bytes;  // loaded, empty [STAGES]
  static constexpr int bytes = bars + 2 * STAGES * 8 + 1024;  // + the base's alignment
  static_assert(STAGES >= 2 && bytes <= kSmemOptin, "the forward's ring does not fit");
};

struct FwdSm90Args {
  const void* q;          // bf16 / fp32 [b, hq, sq, D], or with PREQ int8 codes
  const float* q_scale;   // PREQ: fp32 [b, hq, sq], sm_scale * log2(e) folded in
  const float* k_scale;   // fp32 [b, hkv, n_groups], or (ks_per_row) [b, hkv, sk]
  const float* col_bias;  // PREQ: fp32 [b, hq, sk] (base 2) or null
  const float* v_scale;   // fp32 [b, hkv, D] or null
  const float* v_mean;
  void* o;                // q's dtype, or with PREQ fp32 (o_f32) or bf16
  float* lse2;            // fp32 [b, hq, sq] or null
  int hq, hkv, sq, sk;
  float qs_mul;           // f32(1/127) * f32(sm_scale * log2(e)), without PREQ
  int ks_per_row, o_f32;  // PREQ
};

struct FwdMaps {
  CUtensorMap k, v;   // K's codes, bf16 V
  CUtensorMap ks, cb; // PREQ: per-row K scales, the column bias (1-D; where given)
  int shift_ks, shift_cb;  // offset of element 0 in the two (tensor_map_f32)
  int heads_first;    // the grid is (heads, b, tiles), not (tiles, heads, b)
};

__device__ inline unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// rows [row0, row0 + ROWS) of plane `plane` into dst, one box a panel
template <typename TT, int ROWS>
__device__ inline void fwd_load_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                     int row0, int plane) {
#pragma unroll
  for (int p = 0; p < TT::PANELS; ++p)
    tma_load_3d(dst + p * ROWS * TT::ROWB, map, bar, p * TT::COLS, row0, plane);
}

template <int D, bool CAUSAL, typename T, bool PREQ, bool MASKED, bool SBIAS>
__global__ void __launch_bounds__(kFwdThreads, 1)
sage_attn_fwd_sm90_kernel(const FwdSm90Args a, const __grid_constant__ FwdMaps m,
                          const __grid_constant__ MaskOf<MASKED> mk) {
  using L = FwdSm90<D, PREQ, MASKED, SBIAS>;
  using TQ = typename L::TQ;
  constexpr int KT = L::KT, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* loaded = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = loaded + STAGES;

  const int hq = a.hq, sq = a.sq, sk = a.sk;
  int tile, n_qt, h, bi;
  if (m.heads_first) {
    tile = blockIdx.z, n_qt = gridDim.z, h = blockIdx.x, bi = blockIdx.y;
  } else {
    tile = blockIdx.x, n_qt = gridDim.x, h = blockIdx.y, bi = blockIdx.z;
  }
  const int q0 = (CAUSAL ? n_qt - 1 - tile : tile) * kFwdRows;  // causal: longest first
  const int hk = h / (hq / a.hkv);
  const int plane_kv = bi * a.hkv + hk;
  int n_j = (sk + KT - 1) / KT;  // KV tiles of this CTA
  if (CAUSAL) n_j = min(n_j, (q0 + kFwdRows - 1) / KT + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&empty[s], kFwdConsumers * kFwdWG);
    }
    mbar_init_fence();
  }
  if constexpr (PREQ) {
    // a row vector the call has not (K scales per tile, no column bias)
    // reads as 1 or 0 in every stage; TMA never writes its slots
    for (int i = threadIdx.x; i < STAGES * 2 * L::VEC; i += kFwdThreads) {
      const int bias = i / L::VEC % 2;
      if (bias ? a.col_bias == nullptr : !a.ks_per_row)
        reinterpret_cast<float*>(smem + L::vecs + i / (2 * L::VEC) * L::vec_bytes +
                                 bias * L::VSLOT)[i % L::VEC] = bias ? 0.f : 1.f;
    }
  }
  __syncthreads();
  // the CTA's KV tiles [j_first, j_end) and the walk over the listed ones
  // (with MASKED; else every tile), the same in the producer and in both
  // consumers
  int j_first = 0, j_end = n_j;
  TileWalk<KT> walk{};
  if constexpr (MASKED) {
    __shared__ int s_range[2];
    mask_range<KT, CAUSAL>(mk, bi, q0, kFwdRows, sq, sk, s_range, &j_first, &j_end);
    walk = TileWalk<KT>(mk, bi, h, q0, kFwdRows, sq, sk, j_end);
  }

  const int wg = threadIdx.x / kFwdWG;
  if (wg == kFwdConsumers) {  // the producer warpgroup
    regs_dec<kFwdProducerRegs>();
    if (threadIdx.x % kFwdWG == 0) {
      const bool ks_rows = PREQ && a.ks_per_row, cbias = PREQ && a.col_bias != nullptr;
      const uint32_t posted = L::stage + (ks_rows + cbias) * L::VEC * 4;
      // the i-th loaded tile, KV tile j, into stage i % STAGES
      auto load = [&](int i, int j) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        unsigned char* st = smem + L::ring + s * L::stage;
        mbar_expect_tx(&loaded[s], posted);
        fwd_load_tile<typename L::TK, KT>(st + L::k, &m.k, &loaded[s], j * KT, plane_kv);
        fwd_load_tile<typename L::TV, KT>(st + L::v, &m.v, &loaded[s], j * KT, plane_kv);
        if constexpr (PREQ) {
          // the row vectors from the aligned element at or below the tile's
          // first (a box at an unaligned element faults)
          unsigned char* vs = smem + L::vecs + s * L::vec_bytes;
          if (ks_rows)
            tma_load_1d(vs, &m.ks, &loaded[s],
                        (int)(((long long)plane_kv * sk + j * KT + m.shift_ks) & ~3LL));
          if (cbias)
            tma_load_1d(vs + L::VSLOT, &m.cb, &loaded[s],
                        (int)((((long long)bi * hq + h) * sk + j * KT + m.shift_cb) & ~3LL));
        }
      };
      for (int i = 0, j = walk.next(j_first); j < j_end; ++i, j = walk.next(j + 1)) load(i, j);
    }
    return;
  }
  regs_inc<kFwdConsumerRegs>();

  // ---- a consumer: rows [q0w, q0w + 64), 16 a warp, two a thread ---------
  const int tid = threadIdx.x % kFwdWG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma groupID, thread in group
  const int q0w = q0 + wg * 64;
  unsigned char* sQ = smem + L::q + wg * TQ::BYTES;
  float* sQs = reinterpret_cast<float*>(smem + L::qs) + wg * 64;
  const size_t q_base = (((size_t)bi * hq + h) * sq) * D;

  // 1. this warpgroup's Q codes into sQ (swizzled as wgmma reads them) and
  // its row scales into sQs; rows >= sq are zero
  if constexpr (PREQ) {
    const int8_t* qc = static_cast<const int8_t*>(a.q) + q_base;
    for (int i = tid; i < 64 * (D / 16); i += kFwdWG) {
      const int r = i / (D / 16), c = i % (D / 16) * 16;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (q0w + r < sq) val = *reinterpret_cast<const uint4*>(qc + (size_t)(q0w + r) * D + c);
      *reinterpret_cast<uint4*>(sQ + tile_off<64, TQ::ROWB>(r, c)) = val;
    }
    if (tid < 64)
      sQs[tid] = q0w + tid < sq ? a.q_scale[((size_t)bi * hq + h) * sq + q0w + tid] : 0.f;
  } else {
    const T* qp = static_cast<const T*>(a.q) + q_base;
    for (int rr = 0; rr < 16; ++rr) {
      const int row = warp * 16 + rr;
      const int gr = q0w + row;
      float x[D / 32];
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) {
        x[e] = gr < sq ? to_f32(qp[(size_t)gr * D + lane + 32 * e]) : 0.f;
        amax = fmaxf(amax, fabsf(x[e]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float scale = fmaxf(amax, 1e-30f) * kInvQmax;
      const float r = 1.0f / scale;
#pragma unroll
      for (int e = 0; e < D / 32; ++e)
        reinterpret_cast<int8_t*>(sQ)[tile_off<64, TQ::ROWB>(row, lane + 32 * e)] =
            (int8_t)fminf(fmaxf(roundf(x[e] * r), -127.f), 127.f);
      if (lane == 0) sQs[row] = fmaxf(amax, 1e-30f) * a.qs_mul;
    }
  }
  fence_proxy_async();  // at D = 256 wgmma reads sQ
  named_sync(1 + wg, kFwdWG);
  const float qs0 = sQs[warp * 16 + g], qs1 = sQs[warp * 16 + g + 8];
  const int row0 = q0w + warp * 16 + g, row1 = row0 + 8;  // this thread's rows
  // Q's codes in registers (QREG) or read from shared memory by the
  // product: the masked instances at 128 read them (the 16 registers they
  // hold go to the masks' pass), as every instance at 256 does
  constexpr bool QREG = D == 64 || (D == 128 && !MASKED);
  // with QREG the A fragments of Q's K steps, held for every tile
  uint32_t qa[QREG ? D / 32 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      const int r = warp * 16 + g, x = kk * 32 + 4 * t;
      qa[kk][0] = ld32(sQ + tile_off<64, TQ::ROWB>(r, x));
      qa[kk][1] = ld32(sQ + tile_off<64, TQ::ROWB>(r + 8, x));
      qa[kk][2] = ld32(sQ + tile_off<64, TQ::ROWB>(r, x + 16));
      qa[kk][3] = ld32(sQ + tile_off<64, TQ::ROWB>(r + 8, x + 16));
    }
  }

  const int n_groups = (sk + BN - 1) / BN;
  const float* ks_row = a.k_scale + (size_t)plane_kv * n_groups;
  const bool per_row = PREQ && a.ks_per_row;
  const int oks = (int)(((long long)plane_kv * sk + m.shift_ks) & 3);
  const int ocb = (int)((((long long)bi * hq + h) * sk + m.shift_cb) & 3);
  const uint32_t ring = smem_u32(smem + L::ring), sQa = smem_u32(sQ);
  // SBIAS: this thread's slots of its warpgroup's staged bias
  uint32_t sb = 0;
  if constexpr (SBIAS)
    sb = smem_u32(smem + L::sbias + wg * kBiasStageBytes<KT>) + tid * (mk.bias_bf16 ? 4 : 8);

  float m0 = NEG_INIT, m1 = NEG_INIT;  // running max (base 2)
  float l0 = 0.f, l1 = 0.f;            // this thread's partial row sums
  float acc[D / 2];                    // O: acc[4i + e] is column group i's C fragment
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  int s_i[KT / 2];          // S of the current tile
  uint32_t pf[KT / 16][4];  // bf16 P of the previous tile, the A fragments of its K steps

  // tile j's scores into sf, dequantized (and with MASK, -inf right of the
  // causal diagonal and past sk), and their row maxima
  float sf[KT / 2];
  auto scores = [&](auto mask, int j, int s, float& mx0, float& mx1) {
    const int kv0 = j * KT;
    const float ks = per_row ? 1.f : ks_row[kv0 / BN];
    const float rs0 = qs0 * ks, rs1 = qs1 * ks;
    // PREQ: the tile's row vectors (tile-aligned elements share one offset)
    const float* vks = reinterpret_cast<const float*>(smem + L::vecs + s * L::vec_bytes) + oks;
    const float* vcb =
        reinterpret_cast<const float*>(smem + L::vecs + s * L::vec_bytes + L::VSLOT) + ocb;
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      float4 cv{};  // PREQ: (scale, scale, bias, bias) of the thread's column pair
      if constexpr (PREQ) {
        const int c = n * 8 + t * 2;
        cv = make_float4(vks[c], vks[c + 1], vcb[c], vcb[c + 1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = PREQ ? preq_score(s_i[4 * n + e], e < 2 ? rs0 : rs1, cv, e)
                         : (float)s_i[4 * n + e] * (e < 2 ? rs0 : rs1);
        if constexpr (decltype(mask)::value) {
          const int cl = kv0 + n * 8 + t * 2 + (e & 1);
          if (cl >= sk || (CAUSAL && cl > (e < 2 ? row0 : row1))) val = -INFINITY;
        }
        sf[4 * n + e] = val;
      }
      mx0 = fmaxf(mx0, fmaxf(sf[4 * n], sf[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sf[4 * n + 2], sf[4 * n + 3]));
    }
  };
  float al0 = 1.f, al1 = 1.f;  // the current tile's rescale of O
  // One step: S = Q.K^T of tile j (SC) and O += P.V of tile j - 1 (PV)
  // issued as two groups, then tile j's softmax as soon as S is done, while
  // P.V runs; O is rescaled and P repacked once P.V is done too.  The first
  // step has no P.V and the last no S: every wgmma below sits on a path that
  // all of the warpgroup takes.
  // i counts the CTA's tiles (its stage and phase), j is the KV tile
  auto step = [&](auto pv, auto sc, int i, int j) {
    constexpr bool PV = decltype(pv)::value, SC = decltype(sc)::value;
    const int s = i % STAGES;
    if constexpr (SC) {
      mbar_wait(&loaded[s], (i / STAGES) & 1);
    }
    wgmma_fence();
    auto issue_pv = [&] {
      const uint32_t vt = ring + ((i + STAGES - 1) % STAGES) * L::stage + L::v;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_bf16_rs_mn<D>(acc, pf[kk], desc_mnmajor<KT>(vt, kk));
    };
    auto issue_s = [&] {
      const uint32_t kt = ring + s * L::stage + L::k;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        if constexpr (QREG)
          wgmma_s8_rs128(s_i, qa[kk], desc_kmajor<KT, L::TK::ROWB>(kt, kk), kk > 0);
        else
          wgmma_s8_ss<KT>(s_i, desc_kmajor<64, TQ::ROWB>(sQa, kk),
                          desc_kmajor<KT, L::TK::ROWB>(kt, kk), kk > 0);
      }
    };
    if constexpr (SC) issue_s();  // the older group: it completes first
    wgmma_commit();
    if constexpr (PV) issue_pv();
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(s_i, KT / 2);
    if constexpr (SC) {
      // ---- tile j: dequantize, mask, online softmax (base 2) ------------
      const int kv0 = j * KT;
      float mx0 = -INFINITY, mx1 = -INFINITY;
      const bool edge = (kv0 + KT > sk) || (CAUSAL && kv0 + KT - 1 > q0w);
      if constexpr (MASKED) {
        float u0 = -INFINITY, u1 = -INFINITY;  // the unmasked maxima, not read
        scores(std::false_type{}, j, s, u0, u1);
        mask_scores<KT, CAUSAL, SBIAS>(sf, mk, bi, h, row0, row1, t, kv0, sq, sk,
                                       walk.state(j, wg), edge, mx0, mx1, sb);
      } else if (edge) {
        scores(std::true_type{}, j, s, mx0, mx1);
      } else {
        scores(std::false_type{}, j, s, mx0, mx1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      al0 = ex2(m0 - mn0);
      al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        sf[4 * n] = ex2(sf[4 * n] - mn0);
        sf[4 * n + 1] = ex2(sf[4 * n + 1] - mn0);
        sf[4 * n + 2] = ex2(sf[4 * n + 2] - mn1);
        sf[4 * n + 3] = ex2(sf[4 * n + 3] - mn1);
        sum0 += sf[4 * n] + sf[4 * n + 1];
        sum1 += sf[4 * n + 2] + sf[4 * n + 3];
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
    }
    wgmma_wait<0>();
    reg_fence(acc, D / 2);
    if constexpr (PV) mbar_arrive(&empty[(i + STAGES - 1) % STAGES]);
    if constexpr (SC) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= al0;
        acc[4 * i + 1] *= al0;
        acc[4 * i + 2] *= al1;
        acc[4 * i + 3] *= al1;
      }
      // column groups 2kk and 2kk + 1 are the A fragment of P.V's K step kk
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        pf[kk][0] = pack_bf16(sf[8 * kk], sf[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sf[8 * kk + 2], sf[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sf[8 * kk + 4], sf[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sf[8 * kk + 6], sf[8 * kk + 7]);
      }
      if constexpr (SBIAS) {
        // the next listed tile's bias, in flight while its S is computed
        // (issued here, where S and the scores hold no registers: issued
        // after the scores, one instance spilled)
        const int jn = walk.next(j + 1);
        if (jn < j_end) bias_stage<KT>(mk, sb, bi, h, row0, row1, t, jn * KT, sq, sk);
      }
    }
  };
  int j = walk.next(j_first);
  if (j < j_end) {  // the same in every thread of the CTA
    if constexpr (SBIAS) bias_stage<KT>(mk, sb, bi, h, row0, row1, t, j * KT, sq, sk);
    step(std::false_type{}, std::true_type{}, 0, j);
    int i = 1;
    for (j = walk.next(j + 1); j < j_end; j = walk.next(j + 1), ++i)
      step(std::true_type{}, std::true_type{}, i, j);
    step(std::true_type{}, std::false_type{}, i, 0);
  }

  // ---- epilogue: o = (acc / l) * v_scale + v_mean, lse2 = log2(l) + m -----
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const size_t vc = (size_t)plane_kv * D;  // this kv head's channels
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int cl = i * 8 + t * 2;
    float o0[2] = {acc[4 * i] / l0, acc[4 * i + 1] / l0};
    float o1[2] = {acc[4 * i + 2] / l1, acc[4 * i + 3] / l1};
    if constexpr (MASKED) {  // a row with no live key writes 0
      if (!(l0 > 0.f)) o0[0] = o0[1] = 0.f;
      if (!(l1 > 0.f)) o1[0] = o1[1] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (a.v_scale != nullptr) {
        o0[e] *= a.v_scale[vc + cl + e];
        o1[e] *= a.v_scale[vc + cl + e];
      }
      if (a.v_mean != nullptr) {
        o0[e] += l0 > 0.f ? a.v_mean[vc + cl + e] : 0.f;
        o1[e] += l1 > 0.f ? a.v_mean[vc + cl + e] : 0.f;
      }
    }
    if (PREQ && a.o_f32) {  // the pre-quantized instantiation's fp32 output
      float* of = static_cast<float*>(a.o);
      if (row0 < sq) store2(of + q_base + (size_t)row0 * D + cl, o0[0], o0[1]);
      if (row1 < sq) store2(of + q_base + (size_t)row1 * D + cl, o1[0], o1[1]);
    } else {
      using TO = std::conditional_t<PREQ, __nv_bfloat16, T>;
      TO* ot = static_cast<TO*>(a.o);
      if (row0 < sq) store2(ot + q_base + (size_t)row0 * D + cl, o0[0], o0[1]);
      if (row1 < sq) store2(ot + q_base + (size_t)row1 * D + cl, o1[0], o1[1]);
    }
  }
  if (a.lse2 != nullptr && t == 0) {
    const size_t lbase = ((size_t)bi * hq + h) * sq;
    float ls0 = log2f(l0) + m0, ls1 = log2f(l1) + m1;
    if constexpr (MASKED) {  // and its LSE is -inf
      if (!(l0 > 0.f)) ls0 = -INFINITY;
      if (!(l1 > 0.f)) ls1 = -INFINITY;
    }
    if (row0 < sq) a.lse2[lbase + row0] = ls0;
    if (row1 < sq) a.lse2[lbase + row1] = ls1;
  }
}

// The launch grid of n_tiles Q tiles x heads x b, with the tile on the
// fastest axis, or on the slowest (*heads_first) for a causal launch that
// fills at most two waves of one CTA an SM
inline dim3 fwd_grid(int n_tiles, int heads, int b, bool causal, int* heads_first) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *heads_first = causal && (long long)n_tiles * heads * b <= 2LL * sms;
  return *heads_first ? dim3(heads, b, n_tiles) : dim3(n_tiles, heads, b);
}

template <int D, bool CAUSAL, typename T, bool PREQ, bool MASKED, bool SBIAS>
int fwd_sm90_launch_one(const FwdSm90Args& a, const FwdMaps& m, const MaskOf<MASKED>& mk,
                        dim3 grid, cudaStream_t st) {
  auto kern = sage_attn_fwd_sm90_kernel<D, CAUSAL, T, PREQ, MASKED, SBIAS>;
  constexpr int smem = FwdSm90<D, PREQ, MASKED, SBIAS>::bytes;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kFwdThreads, smem, st>>>(a, m, mk);
  return (int)cudaGetLastError();
}

// whether the masks' bias is staged by cp.async (SBIAS): its column pairs
// contiguous and aligned in every row (unit column stride, even other
// strides, a base aligned to a pair)
inline bool bias_stageable(const MaskArgs& mk) {
  const long long* st = mk.bias_st;
  return mk.bias != nullptr && st[3] == 1 && st[0] % 2 == 0 && st[1] % 2 == 0 &&
         st[2] % 2 == 0 && (reinterpret_cast<uintptr_t>(mk.bias) & (mk.bias_bf16 ? 3 : 7)) == 0;
}

// the instance of (D, CAUSAL, T, PREQ, MASKED); with masks, the one that
// stages the bias where the bias allows it
template <int D, bool CAUSAL, typename T, bool PREQ, bool MASKED>
int fwd_sm90_launch(const FwdSm90Args& a, const FwdMaps& m, const MaskOf<MASKED>& mk, dim3 grid,
                    cudaStream_t st) {
  if constexpr (MASKED) {
    if (bias_stageable(mk))
      return fwd_sm90_launch_one<D, CAUSAL, T, PREQ, true, true>(a, m, mk, grid, st);
  }
  return fwd_sm90_launch_one<D, CAUSAL, T, PREQ, MASKED, false>(a, m, mk, grid, st);
}

// The instances of head dim D (PREQ: causal, the output type an argument;
// else causal x q dtype), with the masks mk or without (NoMask): checks
// the shape arguments, builds the tensor maps of K and V and launches.  k,
// v: the codes and bf16 V of the entry points, [b, hkv, sk, D]; V codes are
// widened to bf16 before the call (widen_v.cu), so v_kind must be bf16 (0)
template <int D, bool PREQ, bool MASKED = false>
int launch_fwd_sm90(const FwdSm90Args& a, const void* k, const void* v, int b, int d,
                    int causal, int q_is_f32, int v_kind, int group, void* stream,
                    const MaskOf<MASKED>& mk = {}) {
  using L = FwdSm90<D, PREQ, MASKED>;
  if (group != BN || a.hkv <= 0 || a.hq % a.hkv != 0 || d != D || v_kind != kVBf16 ||
      a.sq <= 0 || a.sk <= 0 || b <= 0)
    return (int)cudaErrorInvalidValue;
  FwdMaps m{};
  const long long planes = (long long)b * a.hkv;
  if (!tensor_map_3d(&m.k, k, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, planes, a.sk, D, L::KT,
                     L::TK::COLS) ||
      !tensor_map_3d(&m.v, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, planes, a.sk, D, L::KT,
                     L::TV::COLS))
    return (int)cudaErrorInvalidValue;
  if (PREQ && a.ks_per_row &&
      !tensor_map_f32(&m.ks, a.k_scale, planes * a.sk, L::VEC, &m.shift_ks))
    return (int)cudaErrorInvalidValue;
  if (PREQ && a.col_bias != nullptr &&
      !tensor_map_f32(&m.cb, a.col_bias, (long long)b * a.hq * a.sk, L::VEC, &m.shift_cb))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = fwd_grid((a.sq + kFwdRows - 1) / kFwdRows, a.hq, b, causal, &m.heads_first);
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (PREQ) {
    return causal ? fwd_sm90_launch<D, true, __nv_bfloat16, true, MASKED>(a, m, mk, grid, st)
                  : fwd_sm90_launch<D, false, __nv_bfloat16, true, MASKED>(a, m, mk, grid, st);
  } else {
    if (q_is_f32)
      return causal ? fwd_sm90_launch<D, true, float, false, MASKED>(a, m, mk, grid, st)
                    : fwd_sm90_launch<D, false, float, false, MASKED>(a, m, mk, grid, st);
    return causal ? fwd_sm90_launch<D, true, __nv_bfloat16, false, MASKED>(a, m, mk, grid, st)
                  : fwd_sm90_launch<D, false, __nv_bfloat16, false, MASKED>(a, m, mk, grid, st);
  }
}

}  // namespace
