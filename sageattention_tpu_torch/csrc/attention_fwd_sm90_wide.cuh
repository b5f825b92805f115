// Kernel 1's forward at head dims 384 and 512 for Hopper (sm_90a):
// TMA-fed wgmma, O's columns split between the two consumer warpgroups of
// one CTA.
//
// The instances of attention_fwd_wide.cu (causal x q dtype),
// attention_fwd_masked_wide.cu (the same with MASKED) and
// attention_fwd_preq_wide.cu (pre-quantized Q: causal x masked; the output
// type an argument), which kernel 1 (attention_pallas.py:sage_attention_fused,
// _kernel :918, _kernel_single :1207) runs for every head dim in (256,
// 512], padded to 384 or 512 (core.py:70-75 of the JAX package).  It
// computes what attention_fwd_sm90.cuh computes at 64-256, in the same
// order a score at a time (that header lists it): per-row int8 Q with
// qs_mul folded in (or PREQ's codes and scales), S = int8 Q.K^T to int32
// dequantized once, a base-2 online softmax, P rounded to bf16, P.V in
// bf16 with fp32 accumulation, o = (acc / l) * v_scale + v_mean and lse2;
// V codes are widened to bf16 before the launch (widen_v.cu).  With MASKED
// both warpgroups walk the CTA's listed KV tiles and run the masks' pass
// (attention_fwd_kernel.cuh) on the same S, so m, l and lse2 still agree
// bit for bit.
//
// Why the split: a consumer thread's fp32 O accumulator over a 64-row tile
// is 64 D / 128 registers, 192 at 384 and 256 at 512, more than a thread
// holds beside S and P.  So a CTA takes 64 Q rows, and its consumer
// warpgroup c owns O's columns [c D/2, (c + 1) D/2): 96 or 128 registers
// a thread.  P.V is one wgmma of N = D/2 (192 or 256) a K step, P from
// registers, V read MN-major from the warpgroup's own 64-column panels.
//
// S: each warpgroup computes the whole S of the tile itself, Q and K read
// from shared memory, and runs the softmax on it; the two warpgroups run
// the same instructions on the same operands, so m, l and lse2 agree bit
// for bit, and warpgroup 0 writes lse2.  The int8 products run twice.  S
// computed once instead (each warpgroup's int32 Q.K^T over its half of
// the head dim, exchanged through shared memory on a named barrier and
// added) was slower at every timed shape (PERF.md): its exchange moves
// 64 x KT x 4 bytes out and in for each warpgroup a tile, more
// shared-memory traffic than the second Q.K^T reads, and at 512 it leaves
// room for 32-column KV tiles only.  A step issues tile j's S and tile
// j - 1's P.V as two wgmma groups and runs tile j's softmax while that P.V
// runs (attention_fwd_sm90.cuh's in-warpgroup overlap); O's rescale is
// skipped where no row's max moved (times 1 changes nothing).
//
// Two rings: K codes and bf16 V tiles in stages of their own, filled by two
// producer threads, a K stage freed once its S and scores are done and a V
// stage once its P.V is, so a load starts a step before its tile is needed
// (one ring of both, freed after the P.V, left two stages no room to load
// ahead).  A 2-CTA cluster sharing each K/V tile by TMA multicast, which
// halves what the CTAs read from L2, ran no faster than one CTA (PERF.md),
// so it is not used.
//
// Shared memory sets the KV tile (kKvWide): Q's codes 64 x D, the rings,
// with PREQ each K stage's row vectors, Q's row scales.  64 columns in two
// stages at 384 (173,376 bytes; PREQ 174,912) and 512 (230,720); PREQ at
// 512 takes 32 columns in three (183,136), as 64 spilled, and MASKED at 512
// 32 columns in four.  A 32-column
// tile is a quarter of a 128-column K-scale group and reads its scale.
// The rest follows attention_fwd_sm90.cuh: a producer warpgroup, setmaxnreg
// 24 / 240, the grid of fwd_grid with the Q tile on the fastest axis.
//
// Bound: operations.  At (4, 16/16, 4096, d) causal (537 M live pairs)
// Q.K^T is 2 x 537e6 x d int8 ops and P.V as many bf16 FLOP: 0.63 ms at
// 384 and 0.83 ms at 512 on the H100 SXM's data-sheet peaks; the bytes
// (bf16 Q, K codes, bf16 V, O) about 0.06 and 0.08 ms.  What the CTAs
// read from L2 is more, a whole K/V tile for 64 rows: about 9.8 GB at 384
// and 13.1 GB at 512 in that call.

#pragma once

#include "attention_fwd_sm90.cuh"

namespace {

constexpr int kWideRows = 64;  // Q rows a CTA; each consumer warpgroup takes all of them
constexpr int kWideQBar = 1;   // named barrier: Q staged by both consumer warpgroups

// stages of `stage` bytes each that fit after `base` bytes and the base's
// alignment
constexpr int wide_stages_fit(int base, int stage) {
  return (kSmemOptin - 1024 - base) / stage;
}

// the shared memory of a KV tile of KT columns: Q's codes (swizzled as
// wgmma reads them); two rings of STAGES stages, K's codes and bf16 V;
// with PREQ a K stage's row vectors (attention_fwd_sm90.cuh's FwdSm90);
// Q's row scales; the barriers
template <int D, bool PREQ, int KT_>
struct FwdWideAt {
  static constexpr int KT = KT_;
  using TQ = FwdTile<kWideRows, D, 1>;
  using TK = FwdTile<KT, D, 1>;
  using TV = FwdTile<KT, D, 2>;
  static constexpr int VEC = KT + 4;
  static constexpr int VSLOT = (VEC * 4 + 127) / 128 * 128;
  static constexpr int vec_bytes = PREQ ? 2 * VSLOT : 0;
  // a K stage, a V stage, the row vectors and their four barriers
  static constexpr int stage = TK::BYTES + TV::BYTES + vec_bytes + 32;
  static constexpr int QS = kWideRows * 4;  // Q's row scales, fp32
  static constexpr int FIT = wide_stages_fit(TQ::BYTES + QS, stage);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int q = 0;
  static constexpr int kring = TQ::BYTES;
  static constexpr int vring = kring + STAGES * TK::BYTES;
  static constexpr int vecs = vring + STAGES * TV::BYTES;
  static constexpr int qs = vecs + STAGES * vec_bytes;  // fp32 [kWideRows]
  static constexpr int bars = qs + QS;  // kfull, kfree, vfull, vfree [STAGES]
  static constexpr int bytes = bars + 4 * STAGES * 8 + 1024;  // + the base's alignment
  static constexpr bool fits = STAGES >= 2 && bytes <= kSmemOptin;
};

// the KV tile: 64 columns where two stages of them fit, else 32; 32 for the
// pre-quantized and the masked instances at 512 too, whose row vectors or
// masks' pass beside 64-column S, P and O tiles spilled (16-24 bytes of
// stack)
template <int D, bool PREQ, bool MASKED>
constexpr int kKvWide =
    FwdWideAt<D, PREQ, 64>::fits && !((PREQ || MASKED) && D == 512) ? 64 : 32;

template <int D, bool PREQ, bool MASKED = false>
using FwdWide = FwdWideAt<D, PREQ, kKvWide<D, PREQ, MASKED>>;

template <int D, bool CAUSAL, typename T, bool PREQ, bool MASKED>
__global__ void __launch_bounds__(kFwdThreads, 1)
sage_attn_fwd_wide_kernel(const FwdSm90Args a, const __grid_constant__ FwdMaps m,
                          const __grid_constant__ MaskOf<MASKED> mk) {
  using L = FwdWide<D, PREQ, MASKED>;
  using TQ = typename L::TQ;
  constexpr int KT = L::KT, STAGES = L::STAGES, DH = D / 2;
  static_assert(L::fits, "the wide forward's ring does not fit");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* kfull = reinterpret_cast<uint64_t*>(smem + L::bars);  // a K tile landed
  uint64_t* kfree = kfull + STAGES;                               // its S and scores done
  uint64_t* vfull = kfree + STAGES;                               // a V tile landed
  uint64_t* vfree = vfull + STAGES;                               // its P.V done

  const int hq = a.hq, sq = a.sq, sk = a.sk;
  int tile, n_qt, h, bi;
  if (m.heads_first) {
    tile = blockIdx.z, n_qt = gridDim.z, h = blockIdx.x, bi = blockIdx.y;
  } else {
    tile = blockIdx.x, n_qt = gridDim.x, h = blockIdx.y, bi = blockIdx.z;
  }
  const int q0 = (CAUSAL ? n_qt - 1 - tile : tile) * kWideRows;  // causal: longest first
  const int hk = h / (hq / a.hkv);
  const int plane_kv = bi * a.hkv + hk;
  int n_j = (sk + KT - 1) / KT;  // KV tiles of this CTA
  if (CAUSAL) n_j = min(n_j, (q0 + kWideRows - 1) / KT + 1);
  // the consumer warps release a stage, one arrival each
  constexpr int kReleases = kFwdConsumers * kFwdWG / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kfree[s], kReleases);
      mbar_init(&vfull[s], 1);
      mbar_init(&vfree[s], kReleases);
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
  // (with MASKED; else every tile), the same in both producer threads and
  // both consumers
  int j_first = 0, j_end = n_j;
  TileWalk<KT> walk{};
  if constexpr (MASKED) {
    __shared__ int s_range[2];
    mask_range<KT, CAUSAL>(mk, bi, q0, kWideRows, sq, sk, s_range, &j_first, &j_end);
    walk = TileWalk<KT>(mk, bi, h, q0, kWideRows, sq, sk, j_end);
  }
  // every loaded tile by `load(i, j)`: the i-th, KV tile j, into stage i % STAGES
  auto walk_tiles = [&](auto load) {
    for (int i = 0, j = walk.next(j_first); j < j_end; ++i, j = walk.next(j + 1)) load(i, j);
  };

  const int wg = threadIdx.x / kFwdWG;
  if (wg == kFwdConsumers) {  // the producer warpgroup: K by one thread, V by another
    regs_dec<kFwdProducerRegs>();
    if (threadIdx.x % kFwdWG == 32) {
      walk_tiles([&](int i, int j) {
        const int s = i % STAGES;
        mbar_wait(&vfree[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&vfull[s], L::TV::BYTES);
        fwd_load_tile<typename L::TV, KT>(smem + L::vring + s * L::TV::BYTES, &m.v, &vfull[s],
                                          j * KT, plane_kv);
      });
    }
    if (threadIdx.x % kFwdWG == 0) {
      const bool ks_rows = PREQ && a.ks_per_row, cbias = PREQ && a.col_bias != nullptr;
      const uint32_t posted = L::TK::BYTES + (ks_rows + cbias) * L::VEC * 4;
      walk_tiles([&](int i, int j) {
        const int s = i % STAGES;
        mbar_wait(&kfree[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&kfull[s], posted);
        fwd_load_tile<typename L::TK, KT>(smem + L::kring + s * L::TK::BYTES, &m.k, &kfull[s],
                                          j * KT, plane_kv);
        if constexpr (PREQ) {
          // the row vectors from the aligned element at or below the tile's
          // first (a box at an unaligned element faults)
          unsigned char* vs = smem + L::vecs + s * L::vec_bytes;
          if (ks_rows)
            tma_load_1d(vs, &m.ks, &kfull[s],
                        (int)(((long long)plane_kv * sk + j * KT + m.shift_ks) & ~3LL));
          if (cbias)
            tma_load_1d(vs + L::VSLOT, &m.cb, &kfull[s],
                        (int)((((long long)bi * hq + h) * sk + j * KT + m.shift_cb) & ~3LL));
        }
      });
    }
    return;
  }
  regs_inc<kFwdConsumerRegs>();

  // ---- a consumer: every row of [q0, q0 + 64), 16 a warp, two a thread;
  // O's columns [wg DH, (wg + 1) DH) ------------------------------------
  const int tid = threadIdx.x % kFwdWG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma groupID, thread in group
  unsigned char* sQ = smem + L::q;
  float* sQs = reinterpret_cast<float*>(smem + L::qs);
  const size_t q_base = (((size_t)bi * hq + h) * sq) * D;

  // 1. the CTA's Q codes into sQ (swizzled as wgmma reads them) and its
  // row scales into sQs, by both consumer warpgroups; rows >= sq are zero
  const int ct = threadIdx.x;  // 0 .. 255 over the two consumer warpgroups
  if constexpr (PREQ) {
    const int8_t* qc = static_cast<const int8_t*>(a.q) + q_base;
    for (int i = ct; i < kWideRows * (D / 16); i += kFwdConsumers * kFwdWG) {
      const int r = i / (D / 16), c = i % (D / 16) * 16;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (q0 + r < sq) val = *reinterpret_cast<const uint4*>(qc + (size_t)(q0 + r) * D + c);
      *reinterpret_cast<uint4*>(sQ + tile_off<kWideRows, TQ::ROWB>(r, c)) = val;
    }
    if (ct < kWideRows)
      sQs[ct] = q0 + ct < sq ? a.q_scale[((size_t)bi * hq + h) * sq + q0 + ct] : 0.f;
  } else {
    const T* qp = static_cast<const T*>(a.q) + q_base;
    constexpr int kRowsAWarp = kWideRows / (kFwdConsumers * kFwdWG / 32);
    for (int rr = 0; rr < kRowsAWarp; ++rr) {
      const int row = ct / 32 * kRowsAWarp + rr;
      const int gr = q0 + row;
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
        reinterpret_cast<int8_t*>(sQ)[tile_off<kWideRows, TQ::ROWB>(row, lane + 32 * e)] =
            (int8_t)fminf(fmaxf(roundf(x[e] * r), -127.f), 127.f);
      if (lane == 0) sQs[row] = fmaxf(amax, 1e-30f) * a.qs_mul;
    }
  }
  fence_proxy_async();  // wgmma reads sQ
  named_sync(kWideQBar, kFwdConsumers * kFwdWG);
  const float qs0 = sQs[warp * 16 + g], qs1 = sQs[warp * 16 + g + 8];
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this thread's rows

  const int n_groups = (sk + BN - 1) / BN;
  const float* ks_row = a.k_scale + (size_t)plane_kv * n_groups;
  const bool per_row = PREQ && a.ks_per_row;
  const int oks = (int)(((long long)plane_kv * sk + m.shift_ks) & 3);
  const int ocb = (int)((((long long)bi * hq + h) * sk + m.shift_cb) & 3);
  const uint32_t kring = smem_u32(smem + L::kring), vring = smem_u32(smem + L::vring);
  const uint32_t sQa = smem_u32(sQ);

  float m0 = NEG_INIT, m1 = NEG_INIT;  // running max (base 2)
  float l0 = 0.f, l1 = 0.f;            // this thread's partial row sums
  float acc[DH / 2];                   // O's columns of this warpgroup, as C fragments
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
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
  // a stage's barrier told that this warp is done with it
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float al0 = 1.f, al1 = 1.f;  // the current tile's rescale of O
  // One step: S = Q.K^T of tile j (SC) and O += P.V of tile j - 1 (PV)
  // issued as two groups, then tile j's softmax as soon as S is done,
  // while P.V runs; O is rescaled and P repacked once P.V is done too.
  // The first step has no P.V and the last no S: every wgmma below
  // sits on a path that all of the warpgroup takes.
  // i counts the CTA's tiles (its stages and phases), j is the KV tile
  auto step = [&](auto pv, auto sc, int i, int j) {
    constexpr bool PV = decltype(pv)::value, SC = decltype(sc)::value;
    const int s = i % STAGES, sp = (i + STAGES - 1) % STAGES;  // tile i's, tile i - 1's
    if constexpr (SC) mbar_wait(&kfull[s], (i / STAGES) & 1);
    if constexpr (PV) mbar_wait(&vfull[sp], ((i - 1) / STAGES) & 1);
    wgmma_fence();
    auto issue_pv = [&] {
      // this warpgroup's DH / 64 panels of the V tile
      const uint32_t vt = vring + sp * L::TV::BYTES + wg * (DH / 64) * KT * 128;
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_bf16_rs_mn<DH>(acc, pf[kk], desc_mnmajor<KT>(vt, kk));
    };
    auto issue_s = [&] {
      const uint32_t kt = kring + s * L::TK::BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        wgmma_s8_ss<KT>(s_i, desc_kmajor<kWideRows, TQ::ROWB>(sQa, kk),
                        desc_kmajor<KT, L::TK::ROWB>(kt, kk), kk > 0);
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
      const bool edge = (kv0 + KT > sk) || (CAUSAL && kv0 + KT - 1 > q0);
      if constexpr (MASKED) {
        // both warpgroups run the same rule on the same operands
        float u0 = -INFINITY, u1 = -INFINITY;  // the unmasked maxima, not read
        scores(std::false_type{}, j, s, u0, u1);
        mask_scores<KT, CAUSAL>(sf, mk, bi, h, row0, row1, t, kv0, sq, sk, walk.state(j, 0),
                                edge, mx0, mx1);
      } else if (edge) {
        scores(std::true_type{}, j, s, mx0, mx1);
      } else {
        scores(std::false_type{}, j, s, mx0, mx1);
      }
      release(&kfree[s]);  // S and the row vectors read
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
    reg_fence(acc, DH / 2);
    if constexpr (PV) release(&vfree[sp]);
    if constexpr (SC) {
      if (al0 != 1.f || al1 != 1.f) {  // O times 1 is O: skipped where no max moved
#pragma unroll
        for (int i = 0; i < DH / 8; ++i) {
          acc[4 * i] *= al0;
          acc[4 * i + 1] *= al0;
          acc[4 * i + 2] *= al1;
          acc[4 * i + 3] *= al1;
        }
      }
      // column groups 2kk and 2kk + 1 are the A fragment of P.V's K step kk
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        pf[kk][0] = pack_bf16(sf[8 * kk], sf[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sf[8 * kk + 2], sf[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sf[8 * kk + 4], sf[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sf[8 * kk + 6], sf[8 * kk + 7]);
      }
    }
  };
  int j = walk.next(j_first);
  if (j < j_end) {  // the same in every thread of the CTA
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
  for (int i = 0; i < DH / 8; ++i) {
    const int cl = wg * DH + i * 8 + t * 2;
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
  if (a.lse2 != nullptr && wg == 0 && t == 0) {  // both warpgroups hold the same m and l
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

template <int D, bool CAUSAL, typename T, bool PREQ, bool MASKED>
int fwd_wide_launch(const FwdSm90Args& a, const FwdMaps& m, const MaskOf<MASKED>& mk, dim3 grid,
                    cudaStream_t st) {
  auto kern = sage_attn_fwd_wide_kernel<D, CAUSAL, T, PREQ, MASKED>;
  constexpr int smem = FwdWide<D, PREQ, MASKED>::bytes;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kFwdThreads, smem, st>>>(a, m, mk);
  return (int)cudaGetLastError();
}

// The instances of head dim D (PREQ: causal, the output type an argument;
// else causal x q dtype), with the masks mk or without (NoMask): checks
// the shape arguments, builds the tensor maps of K and V and launches.  k,
// v: the codes and bf16 V of the entry points, [b, hkv, sk, D]; V codes are
// widened to bf16 before the call (widen_v.cu), so v_kind must be bf16 (0)
template <int D, bool PREQ, bool MASKED = false>
int launch_fwd_wide(const FwdSm90Args& a, const void* k, const void* v, int b, int d,
                    int causal, int q_is_f32, int v_kind, int group, void* stream,
                    const MaskOf<MASKED>& mk = {}) {
  using L = FwdWide<D, PREQ, MASKED>;
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
  const dim3 grid = fwd_grid((a.sq + kWideRows - 1) / kWideRows, a.hq, b, causal, &m.heads_first);
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (PREQ) {
    return causal ? fwd_wide_launch<D, true, __nv_bfloat16, true, MASKED>(a, m, mk, grid, st)
                  : fwd_wide_launch<D, false, __nv_bfloat16, true, MASKED>(a, m, mk, grid, st);
  } else {
    if (q_is_f32)
      return causal ? fwd_wide_launch<D, true, float, false, MASKED>(a, m, mk, grid, st)
                    : fwd_wide_launch<D, false, float, false, MASKED>(a, m, mk, grid, st);
    return causal ? fwd_wide_launch<D, true, __nv_bfloat16, false, MASKED>(a, m, mk, grid, st)
                  : fwd_wide_launch<D, false, __nv_bfloat16, false, MASKED>(a, m, mk, grid, st);
  }
}

}  // namespace
