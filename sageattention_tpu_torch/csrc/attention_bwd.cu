// SageAttention backward for Hopper (sm_90a): the straight-through gradient
// of the quantized forward (attention_fwd.cu), in two kernels.
//
// Replaces the TPU kernels attention_bwd_pallas.py:sage_attention_bwd ->
// _dq_kernel and _dkv_kernel.  Both recompute the base-2 logits from the
// same int8 codes as the forward, l2 = s_i32 * (q_scale * k_scale) in the
// forward's operand order, and P = exp2(l2 - lse2) from the forward's saved
// LSE; there is no online softmax, so every (Q tile, KV tile) pair is
// independent work.  With D = rowsum(dO * O) - dlse (computed outside):
//
//   dP = dO.V^T     dS = bf16(P * (dP - D))     dQ = dS.K_sm * sm_scale
//   dV = bf16(P)^T.dO                           dK = dS^T.Q * sm_scale
//
// rounded to bf16 where the TPU kernels round (P before P^T.dO, dS before
// both products; dO, V, K_sm = bf16(K - km) and Q in bf16), fp32 sums.
//
// sage_attn_bwd_dq: one CTA of 4 warps per (b, hq, 64-row Q tile), 16 rows a
//   warp.  It loops over KV tiles of 128 columns (the K-scale group, one
//   k_scale a tile) as the forward does; this loop replaces the TPU's
//   sequential n_kv grid axis and its VMEM accumulator, and dQ accumulates
//   in registers.  Each tile is computed in column chunks (64 at d=64, 32
//   at d=128 and 256) to bound the live S/dP registers.  Causal: stops at the
//   diagonal tile; with a sliding window (causal only) it starts at the
//   window's first tile, (q0 - window + 1) / 128, the counterpart of the
//   TPU's band grid (attention_bwd_pallas.py:117-143).
// sage_attn_bwd_dkv: one CTA of 4 warps per (b, hkv, 64-row KV tile), 16 KV
//   rows a warp.  It loops over every q head of its GQA group and every
//   64-row Q tile (causal: from the diagonal; with a window, up to the
//   last Q row that sees the tile, kv0 + 63 + window - 1,
//   attention_bwd_pallas.py:274-287), so dK and dV sum over the
//   group in registers, with no atomics and no repeat of K/V: the port's
//   form of the TPU's rep*n_q fourth grid axis.  It works on the transposed
//   scores S^T = K.Q^T so that a KV row is an MMA row.  64 KV rows, not
//   128: the fp32 dK and dV accumulators of 16 rows a warp take 2*D/2 = D
//   registers a thread (128 at d=128), and 32 rows a warp would not fit
//   beside the score chunk in 255 registers.  A 64-row KV tile lies inside
//   one 128-row K-scale group, so it reads one k_scale.
//
// A window keeps col > row - window wherever causal keeps col <= row, in
// instances of its own (WINDOW), so the others keep their registers.
//
// Head dim 256 (every head dim in (128, 256], padded; with a bias too).  dQ
// keeps its fp32 accumulator of 16 x 256 / 32 = 128 registers a thread and
// reads Q's and dO's A fragments from shared memory for each chunk, where
// the smaller head dims hold them (96 registers more at 256); its layout
// takes 221 KB of shared memory, so one CTA runs on an SM.  dKV's two
// accumulators would take 256 registers a thread, more than a thread may
// hold, so it runs in two launches of instances that each keep one: PART
// kDV (S, P, dV; V is not read) and then kDK (S and P again, dP, dS, dK),
// 137 KB of shared memory each.  The second pass repeats Q.K^T's 2d int8
// operations a pair, against 8d int8 and bf16 operations of the two.
// Every (causal, window) combination has both parts, and so has each causal
// flag of the bias instances.
//
// An additive bias (BIAS instances, attention_bwd_pallas.py:146-204,
// 311-316): a per-head [b, hq, sq, sk] fp32 or bf16 tensor, which the
// forward added to the base-2 logits as bias * log2(e).  Both kernels add it
// to the recomputed logits too and clamp them at -1e30, and a row whose
// lse2 is -inf (every key biased to -inf; the forward gave o = 0) takes 0 in
// its place, so its P is exactly 0 and no NaN arises.  dQ writes dBias = dS
// = P * (dP - D) in fp32, before the bf16 rounding, in the bias's type
// (when asked: a fixed bias costs no write), and writes the zeros of every
// tile its causal loop never visits itself, so the wrapper allocates dBias
// uninitialised.  dKV reads bias[q row, kv col] straight from device
// memory for its transposed tile: for one fragment element a warp reads 8
// consecutive KV columns of each of 4 Q rows, whole 32-byte sectors in fp32,
// so the bias needs no transposed copy (the TPU launcher's one XLA
// transpose, :931-940).  A window with a bias is not taken: the JAX package
// sends it to its exact backward (:423-426), and so does the port.  At D =
// 256 the bias instances keep this design: dQ (fragments from shared memory)
// writes dBias as at 64 and 128, so the backward has one interface at every
// head dim, and each of the two dK/dV passes reads the bias for its P: the
// bias is read three times (dQ, dV, dK) and dBias written once, by dQ.
//
// Ragged edges: K/V rows past sk and Q rows past sq are zero-filled in
// shared memory, their P is set to 0 by a select (no inf - inf and no
// inf * 0: the exp2 of a masked entry is never used), and no row past
// sq (dQ) or sk (dK, dV) is stored.  No padding of the sequence in memory.
//
// Bound: operations.  Per score pair dQ does one int8 Q.K^T (2d ops) and
// three bf16 products' worth of 4d FLOP (dO.V^T, dS.K), dKV 2d int8 and 6d
// bf16 (dO.V^T, P^T.dO, dS^T.Q).  At the CogVideoX-2B layer shape (b=1,
// h=30, s=17,776, d=64; 9.48e9 pairs) that is about 3.1 ms for dQ and 4.3 ms
// for dKV on the H100 SXM's data-sheet peaks; the bytes take well under
// 0.1 ms, and the two exp2 passes (2 x 9.48e9 MUFU operations) are a second
// floor of a few ms.  With a bias, bytes: each live pair's bias is read once
// by each kernel and dQ writes its dBias (and the causal zeros), 8 to 12
// bytes a pair in fp32 against 6d-10d operations.  At the llm-8b-gqa layer
// (b=1, hq=32, s=4096, d=128, causal: 268.5 M live pairs) that is about
// 0.96 ms for dQ with its dBias and 0.32 ms for dKV at 3.35 TB/s, against
// 0.17 and 0.24 ms of operations.  Like the forward, this first version is
// written to be right: mma.sync, synchronous tile loads, no pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int KGROUP = 128;  // K-scale group
constexpr int DQ_BM = 64;    // dq: Q rows per CTA
constexpr int DQ_BN = 128;   // dq: KV columns per tile (== KGROUP)
constexpr int KV_BM = 64;    // dkv: KV rows per CTA
constexpr int KV_BQ = 64;    // dkv: Q rows per tile

template <int D>
struct Cfg {
  static constexpr int QS = D + 16;  // int8 row stride (bytes)
  static constexpr int HS = D + 8;   // bf16 row stride (elements)
  static constexpr int CH = D == 64 ? 64 : 32;  // score columns a chunk
};

// the operands of both kernels (shapes at the extern "C" entry points)
struct BwdArgs {
  const int8_t* q_i8;
  const float* q_scale;
  const __nv_bfloat16* q_bf;
  const int8_t* k_i8;
  const float* k_scale;
  const __nv_bfloat16* k_sm;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse2;
  const float* dvec;
  float* dq;
  float* dk;
  float* dv;
  int hq, hkv, sq, sk;
  float sm_scale;
  int window;  // 0: none (causal only)
};

// the BIAS instances' operands, a parameter of their own (an empty one
// elsewhere): the same three fields appended to BwdArgs moved the registers
// of every instance without a bias
struct BiasArgs {
  const void* bias;  // [b, hq, sq, sk], fp32 or bf16 (bias_bf16)
  void* dbias;       // dS in the bias's type, or null (dQ only)
  int bias_bf16;
};
struct NoBias {};
template <bool BIAS>
using BiasOf = std::conditional_t<BIAS, BiasArgs, NoBias>;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLogitFloor = -1e30f;  // the TPU kernels' clamp of biased logits

// element e of the bias, in fp32
__device__ inline float bias_at(const void* bias, int bf16, size_t e) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[e])
              : static_cast<const float*>(bias)[e];
}

// dS (fp32) into element e of dBias, in the bias's type
__device__ inline void dbias_put(void* dbias, int bf16, size_t e, float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(dbias)[e] = __float2bfloat16(x);
  else
    static_cast<float*>(dbias)[e] = x;
}

// rows [r0, r0 + n) of a [*, D] row-major tensor into shared memory with
// row stride `stride_bytes`, 16 bytes a thread, zero past row `limit`
template <int D, int ELEM>
__device__ inline void load_rows(unsigned char* dst, const unsigned char* src, int r0,
                                 int n, int limit, int stride_bytes) {
  constexpr int VECS = D * ELEM / 16;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < n * VECS; i += NTHREADS) {
    const int r = i / VECS, c = i % VECS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + ((size_t)(r0 + r) * D) * ELEM + c * 16);
    *reinterpret_cast<uint4*>(dst + r * stride_bytes + c * 16) = val;
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqLayout {
  using C = Cfg<D>;
  static constexpr int q_off = 0;                                // int8 [BM][QS]
  static constexpr int do_off = q_off + DQ_BM * C::QS;           // bf16 [BM][HS]
  static constexpr int k_off = do_off + DQ_BM * C::HS * 2;       // int8 [BN][QS]
  static constexpr int ksm_off = k_off + DQ_BN * C::QS;          // bf16 [BN][HS]
  static constexpr int v_off = ksm_off + DQ_BN * C::HS * 2;      // bf16 [BN][HS]
  static constexpr int bytes = v_off + DQ_BN * C::HS * 2;
};

template <int D, bool CAUSAL, bool WINDOW, bool BIAS>
__global__ void __launch_bounds__(NTHREADS)
sage_attn_bwd_dq_kernel(const BwdArgs a, const BiasOf<BIAS> ba) {
  const int8_t* __restrict__ q_i8 = a.q_i8;
  const float* __restrict__ q_scale = a.q_scale;
  const int8_t* __restrict__ k_i8 = a.k_i8;
  const float* __restrict__ k_scale = a.k_scale;
  const __nv_bfloat16* __restrict__ k_sm = a.k_sm;
  const __nv_bfloat16* __restrict__ v = a.v;
  const __nv_bfloat16* __restrict__ dout = a.dout;
  const float* __restrict__ lse2 = a.lse2;
  const float* __restrict__ dvec = a.dvec;
  float* __restrict__ dq = a.dq;
  const int hq = a.hq, hkv = a.hkv, sq = a.sq, sk = a.sk;
  const float sm_scale = a.sm_scale;
  const int window = WINDOW ? a.window : 0;
  using C = Cfg<D>;
  using L = DqLayout<D>;
  constexpr int CH = C::CH, NT = CH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sQ = smem + L::q_off;
  unsigned char* sDo = smem + L::do_off;
  unsigned char* sK = smem + L::k_off;
  unsigned char* sKsm = smem + L::ksm_off;
  unsigned char* sV = smem + L::v_off;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * DQ_BM;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const size_t row_base = ((size_t)bi * hq + h) * sq;
  const size_t kv_base = (((size_t)bi * hkv + hk) * sk) * D;
  const int n_tiles_all = (sk + DQ_BN - 1) / DQ_BN;
  const float* ks_row = k_scale + ((size_t)bi * hkv + hk) * n_tiles_all;

  load_rows<D, 1>(sQ, (const unsigned char*)q_i8 + row_base * D, q0, DQ_BM, sq, C::QS);
  load_rows<D, 2>(sDo, (const unsigned char*)(dout + row_base * D), q0, DQ_BM, sq, C::HS * 2);
  __syncthreads();

  // this thread's two rows; rows past sq get neutral values (P = 1 there,
  // but dO = 0 makes their dS 0, and they are never stored)
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float qs0 = row0 < sq ? q_scale[row_base + row0] : 0.f;
  const float qs1 = row1 < sq ? q_scale[row_base + row1] : 0.f;
  float ls0 = row0 < sq ? lse2[row_base + row0] : 0.f;
  float ls1 = row1 < sq ? lse2[row_base + row1] : 0.f;
  const float dv0 = row0 < sq ? dvec[row_base + row0] : 0.f;
  const float dv1 = row1 < sq ? dvec[row_base + row1] : 0.f;
  // BIAS: a row biased to -inf everywhere has lse2 -inf; 0 gives it P = 0.
  // The bias rows of the thread's two rows (rows past sq read the last row,
  // never stored)
  size_t brow0 = 0, brow1 = 0;
  if constexpr (BIAS) {
    if (ls0 == -INFINITY) ls0 = 0.f;
    if (ls1 == -INFINITY) ls1 = 0.f;
    brow0 = (row_base + min(row0, sq - 1)) * (size_t)sk;
    brow1 = (row_base + min(row1, sq - 1)) * (size_t)sk;
  }

  // the warp's A fragments of Q (int8) and dO (bf16), kept for all tiles
  // where they fit: at D = 256 they would take 96 registers beside dQ's 128,
  // so each chunk reads them from shared memory (HOLD false)
  constexpr bool HOLD = D <= 128;
  const unsigned char* qa_row = sQ + (warp * 16 + g) * C::QS + t * 4;
  const unsigned char* da_row = sDo + (warp * 16 + g) * C::HS * 2 + t * 4;
  uint32_t qa[HOLD ? D / 32 : 1][4], da[HOLD ? D / 16 : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      load_a(qa[kk], sQ + (warp * 16 + g) * C::QS + kk * 32 + t * 4, C::QS);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      load_a(da[kk], sDo + (warp * 16 + g) * C::HS * 2 + (kk * 16 + t * 2) * 2, C::HS * 2);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int n_tiles = n_tiles_all;
  if (CAUSAL) n_tiles = min(n_tiles, (q0 + DQ_BM - 1) / DQ_BN + 1);
  const int j_first = window > 0 ? max(0, q0 - window + 1) / DQ_BN : 0;

  for (int j = j_first; j < n_tiles; ++j) {
    const int kv0 = j * DQ_BN;
    __syncthreads();  // the previous tile is no longer read
    load_rows<D, 1>(sK, (const unsigned char*)(k_i8 + kv_base), kv0, DQ_BN, sk, C::QS);
    load_rows<D, 2>(sKsm, (const unsigned char*)(k_sm + kv_base), kv0, DQ_BN, sk, C::HS * 2);
    load_rows<D, 2>(sV, (const unsigned char*)(v + kv_base), kv0, DQ_BN, sk, C::HS * 2);
    __syncthreads();

    const float ks = ks_row[j];
    const float rs0 = qs0 * ks, rs1 = qs1 * ks;  // the forward's order
    const bool need_mask = (kv0 + DQ_BN > sk) || (CAUSAL && kv0 + DQ_BN - 1 > q0) ||
                           (window > 0 && kv0 <= q0 + DQ_BM - 1 - window);

#pragma unroll
    for (int c = 0; c < DQ_BN / CH; ++c) {
      const int c0 = c * CH;  // first column of the chunk within the tile
      // S = Q.K^T (int8 -> int32)
      int s_i[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s_i[n][0] = s_i[n][1] = s_i[n][2] = s_i[n][3] = 0;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        const uint32_t* qf = qa[HOLD ? kk : 0];
        uint32_t q_ld[4];
        if constexpr (!HOLD) {
          load_a(q_ld, qa_row + kk * 32, C::QS);
          qf = q_ld;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const unsigned char* kb = sK + (c0 + n * 8 + g) * C::QS + kk * 32 + t * 4;
          mma_s8(s_i[n], qf, ld32(kb), ld32(kb + 16));
        }
      }
      // dP = dO.V^T (bf16 -> fp32)
      float dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t* df = da[HOLD ? kk : 0];
        uint32_t d_ld[4];
        if constexpr (!HOLD) {
          load_a(d_ld, da_row + kk * 32, C::HS * 2);
          df = d_ld;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const unsigned char* vb = sV + (c0 + n * 8 + g) * C::HS * 2 + (kk * 16 + t * 2) * 2;
          mma_bf16(dp[n], df, ld32(vb), ld32(vb + 16));
        }
      }
      // P = exp2(l2 - lse2), masked; dS = P * (dP - D), kept in dp.  BIAS:
      // l2 + bias * log2(e), clamped, and dS in fp32 into dBias when asked
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          float l2 = (float)s_i[n][e] * (lo ? rs0 : rs1);
          if constexpr (BIAS) {
            const int col = min(kv0 + c0 + n * 8 + t * 2 + (e & 1), sk - 1);
            l2 = fmaxf(l2 + bias_at(ba.bias, ba.bias_bf16, (lo ? brow0 : brow1) + col) * kLog2e,
                       kLogitFloor);
          }
          float p = exp2f(l2 - (lo ? ls0 : ls1));
          if (need_mask) {
            const int col = kv0 + c0 + n * 8 + t * 2 + (e & 1);
            const int row = lo ? row0 : row1;
            if (col >= sk || (CAUSAL && col > row) || (window > 0 && col <= row - window))
              p = 0.f;
          }
          dp[n][e] = p * (dp[n][e] - (lo ? dv0 : dv1));
          if constexpr (BIAS) {
            const int col = kv0 + c0 + n * 8 + t * 2 + (e & 1);
            if (ba.dbias != nullptr && (lo ? row0 : row1) < sq && col < sk)
              dbias_put(ba.dbias, ba.bias_bf16, (lo ? brow0 : brow1) + col, dp[n][e]);
          }
        }
      }
      // dQ += bf16(dS) . K_sm
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk) {
        uint32_t a[4];
        c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
        mma_a_rows<D>(acc, a, reinterpret_cast<const __nv_bfloat16*>(sKsm), c0 + kk * 16,
                      C::HS, lane);
      }
    }
  }

  // BIAS, causal: the tiles right of the diagonal read 0 in dBias, a warp a
  // row, the lanes on consecutive columns
  if constexpr (BIAS && CAUSAL) {
    const int c_lo = n_tiles * DQ_BN;
    if (ba.dbias != nullptr && c_lo < sk) {
      for (int r = warp; r < DQ_BM && q0 + r < sq; r += NWARPS) {
        const size_t base = (row_base + q0 + r) * (size_t)sk;
        for (int c = c_lo + lane; c < sk; c += 32) dbias_put(ba.dbias, ba.bias_bf16, base + c, 0.f);
      }
    }
  }

  // epilogue: dq = acc * sm_scale, rows < sq
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + t * 2;
    if (row0 < sq)
      *reinterpret_cast<float2*>(dq + (row_base + row0) * D + col) =
          make_float2(acc[i][0] * sm_scale, acc[i][1] * sm_scale);
    if (row1 < sq)
      *reinterpret_cast<float2*>(dq + (row_base + row1) * D + col) =
          make_float2(acc[i][2] * sm_scale, acc[i][3] * sm_scale);
  }
}

// ---------------------------------------------------------------------------
// dK, dV
// ---------------------------------------------------------------------------

template <int D>
struct DkvLayout {
  using C = Cfg<D>;
  static constexpr int k_off = 0;                               // int8 [KV_BM][QS]
  static constexpr int v_off = k_off + KV_BM * C::QS;           // bf16 [KV_BM][HS]
  static constexpr int q_off = v_off + KV_BM * C::HS * 2;       // int8 [KV_BQ][QS]
  static constexpr int qb_off = q_off + KV_BQ * C::QS;          // bf16 [KV_BQ][HS]
  static constexpr int do_off = qb_off + KV_BQ * C::HS * 2;     // bf16 [KV_BQ][HS]
  static constexpr int qs_off = do_off + KV_BQ * C::HS * 2;     // fp32 [KV_BQ]
  static constexpr int lse_off = qs_off + KV_BQ * 4;            // fp32 [KV_BQ]
  static constexpr int dv_off = lse_off + KV_BQ * 4;            // fp32 [KV_BQ]
  static constexpr int bytes = dv_off + KV_BQ * 4;
};

// which of dK and dV a dKV instance computes: both (D <= 128), or at D = 256
// one of them, in two launches
enum DkvPart { kDV = 1, kDK = 2, kDKV = 3 };

template <int D, bool CAUSAL, bool WINDOW, bool BIAS, int PART = kDKV>
__global__ void __launch_bounds__(NTHREADS)
sage_attn_bwd_dkv_kernel(const BwdArgs a, const BiasOf<BIAS> ba) {
  constexpr bool WANT_V = PART & kDV, WANT_K = PART & kDK;
  const int8_t* __restrict__ q_i8 = a.q_i8;
  const float* __restrict__ q_scale = a.q_scale;
  const __nv_bfloat16* __restrict__ q_bf = a.q_bf;
  const int8_t* __restrict__ k_i8 = a.k_i8;
  const float* __restrict__ k_scale = a.k_scale;
  const __nv_bfloat16* __restrict__ v = a.v;
  const __nv_bfloat16* __restrict__ dout = a.dout;
  const float* __restrict__ lse2 = a.lse2;
  const float* __restrict__ dvec = a.dvec;
  float* __restrict__ dk = a.dk;
  float* __restrict__ dv = a.dv;
  const int hq = a.hq, hkv = a.hkv, sq = a.sq, sk = a.sk;
  const float sm_scale = a.sm_scale;
  const int window = WINDOW ? a.window : 0;
  using C = Cfg<D>;
  using L = DkvLayout<D>;
  constexpr int CH = C::CH, NT = CH / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sK = smem + L::k_off;
  unsigned char* sV = smem + L::v_off;
  unsigned char* sQ = smem + L::q_off;
  unsigned char* sQb = smem + L::qb_off;
  unsigned char* sDo = smem + L::do_off;
  float* sQs = reinterpret_cast<float*>(smem + L::qs_off);
  float* sLse = reinterpret_cast<float*>(smem + L::lse_off);
  float* sDv = reinterpret_cast<float*>(smem + L::dv_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kv0 = blockIdx.x * KV_BM;
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int rep = hq / hkv;
  const size_t kv_row_base = ((size_t)bi * hkv + hk) * sk;
  const int n_groups = (sk + KGROUP - 1) / KGROUP;
  const float ks = k_scale[((size_t)bi * hkv + hk) * n_groups + kv0 / KGROUP];

  load_rows<D, 1>(sK, (const unsigned char*)(k_i8 + kv_row_base * D), kv0, KV_BM, sk, C::QS);
  if constexpr (WANT_K)  // V enters dP, which only dK needs
    load_rows<D, 2>(sV, (const unsigned char*)(v + kv_row_base * D), kv0, KV_BM, sk, C::HS * 2);

  const int kr0 = kv0 + warp * 16 + g, kr1 = kr0 + 8;  // this thread's KV rows
  const unsigned char* ka_row = sK + (warp * 16 + g) * C::QS + t * 4;
  const unsigned char* va_row = sV + (warp * 16 + g) * C::HS * 2 + t * 4;

  float acc_k[WANT_K ? D / 8 : 1][4], acc_v[WANT_V ? D / 8 : 1][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (WANT_K) acc_k[i][e] = 0.f;
      if constexpr (WANT_V) acc_v[i][e] = 0.f;
    }

  int n_qt = (sq + KV_BQ - 1) / KV_BQ;
  const int qt0 = CAUSAL ? kv0 / KV_BQ : 0;  // causal: from the diagonal
  if (window > 0)  // up to the last Q row whose window reaches this tile
    n_qt = min(n_qt, (kv0 + KV_BM - 1 + window - 1) / KV_BQ + 1);

  for (int hh = 0; hh < rep; ++hh) {
    const size_t row_base = ((size_t)bi * hq + hk * rep + hh) * sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * KV_BQ;
      __syncthreads();  // the previous Q tile is no longer read
      load_rows<D, 1>(sQ, (const unsigned char*)q_i8 + row_base * D, q0, KV_BQ, sq, C::QS);
      if constexpr (WANT_K)
        load_rows<D, 2>(sQb, (const unsigned char*)(q_bf + row_base * D), q0, KV_BQ, sq, C::HS * 2);
      load_rows<D, 2>(sDo, (const unsigned char*)(dout + row_base * D), q0, KV_BQ, sq, C::HS * 2);
      for (int i = tid; i < KV_BQ; i += NTHREADS) {
        const bool live = q0 + i < sq;
        sQs[i] = live ? q_scale[row_base + q0 + i] : 0.f;
        sLse[i] = live ? lse2[row_base + q0 + i] : 0.f;
        if constexpr (BIAS) {  // see the dQ kernel
          if (sLse[i] == -INFINITY) sLse[i] = 0.f;
        }
        sDv[i] = live ? dvec[row_base + q0 + i] : 0.f;
      }
      __syncthreads();

      const bool need_mask = (q0 + KV_BQ > sq) || (kv0 + KV_BM > sk) ||
                             (CAUSAL && kv0 + KV_BM - 1 > q0) ||
                             (window > 0 && kv0 <= q0 + KV_BQ - 1 - window);

#pragma unroll
      for (int c = 0; c < KV_BQ / CH; ++c) {
        const int c0 = c * CH;  // first Q row of the chunk within the tile
        // S^T = K.Q^T (int8 -> int32): rows are KV rows, columns Q rows
        int s_i[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) s_i[n][0] = s_i[n][1] = s_i[n][2] = s_i[n][3] = 0;
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk) {
          uint32_t a[4];
          load_a(a, ka_row + kk * 32, C::QS);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const unsigned char* qb = sQ + (c0 + n * 8 + g) * C::QS + kk * 32 + t * 4;
            mma_s8(s_i[n], a, ld32(qb), ld32(qb + 16));
          }
        }
        // P^T = exp2(l2 - lse2), masked, in fp32
        float p[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = c0 + n * 8 + t * 2 + (e & 1);  // Q row within the tile
            float l2 = (float)s_i[n][e] * (sQs[ql] * ks);
            if constexpr (BIAS) {  // bias[q row, kv col]; rows past sq, sk read the last
              const size_t be = (row_base + min(q0 + ql, sq - 1)) * (size_t)sk +
                                min(e < 2 ? kr0 : kr1, sk - 1);
              l2 = fmaxf(l2 + bias_at(ba.bias, ba.bias_bf16, be) * kLog2e, kLogitFloor);
            }
            float pv = exp2f(l2 - sLse[ql]);
            if (need_mask) {
              const int qr = q0 + ql, kr = e < 2 ? kr0 : kr1;
              if (qr >= sq || kr >= sk || (CAUSAL && kr > qr) ||
                  (window > 0 && kr <= qr - window))
                pv = 0.f;
            }
            p[n][e] = pv;
          }
        }
        // dV += bf16(P^T) . dO
        if constexpr (WANT_V) {
#pragma unroll
          for (int kk = 0; kk < CH / 16; ++kk) {
            uint32_t a[4];
            c_to_a(a, p[2 * kk], p[2 * kk + 1]);
            mma_a_rows<D>(acc_v, a, reinterpret_cast<const __nv_bfloat16*>(sDo), c0 + kk * 16,
                          C::HS, lane);
          }
        }
        if constexpr (WANT_K) {  // dK: dP, dS and dS^T.Q
          // dP^T = V.dO^T (bf16 -> fp32)
          float dp[NT][4];
#pragma unroll
          for (int n = 0; n < NT; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            load_a(a, va_row + kk * 32, C::HS * 2);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const unsigned char* ob = sDo + (c0 + n * 8 + g) * C::HS * 2 + (kk * 16 + t * 2) * 2;
              mma_bf16(dp[n], a, ld32(ob), ld32(ob + 16));
            }
          }
          // dS^T = P^T * (dP^T - D), kept in dp
#pragma unroll
          for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[n][e] = p[n][e] * (dp[n][e] - sDv[c0 + n * 8 + t * 2 + (e & 1)]);
          }
          // dK += bf16(dS^T) . Q
#pragma unroll
          for (int kk = 0; kk < CH / 16; ++kk) {
            uint32_t a[4];
            c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
            mma_a_rows<D>(acc_k, a, reinterpret_cast<const __nv_bfloat16*>(sQb), c0 + kk * 16,
                          C::HS, lane);
          }
        }
      }
    }
  }

  // epilogue: dk = acc_k * sm_scale, dv = acc_v, rows < sk
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + t * 2;
    if (kr0 < sk) {
      const size_t o = (kv_row_base + kr0) * D + col;
      if constexpr (WANT_K)
        *reinterpret_cast<float2*>(dk + o) = make_float2(acc_k[i][0] * sm_scale, acc_k[i][1] * sm_scale);
      if constexpr (WANT_V)
        *reinterpret_cast<float2*>(dv + o) = make_float2(acc_v[i][0], acc_v[i][1]);
    }
    if (kr1 < sk) {
      const size_t o = (kv_row_base + kr1) * D + col;
      if constexpr (WANT_K)
        *reinterpret_cast<float2*>(dk + o) = make_float2(acc_k[i][2] * sm_scale, acc_k[i][3] * sm_scale);
      if constexpr (WANT_V)
        *reinterpret_cast<float2*>(dv + o) = make_float2(acc_v[i][2], acc_v[i][3]);
    }
  }
}

template <typename Kern, typename B>
int launch(Kern kern, int smem, dim3 grid, cudaStream_t st, const BwdArgs& a, const B& ba) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, NTHREADS, smem, st>>>(a, ba);
  return (int)cudaGetLastError();
}

// The instance for (causal, window) or, with BIAS, (causal): the window
// band and the bias have instances of their own, so the others compile to
// the code they have without them.
template <int D, bool BIAS>
int launch_dq(int causal, int window, dim3 grid, cudaStream_t st, const BwdArgs& a,
              const BiasOf<BIAS>& ba) {
  constexpr int smem = DqLayout<D>::bytes;
  if constexpr (BIAS) {
    return causal ? launch(sage_attn_bwd_dq_kernel<D, true, false, true>, smem, grid, st, a, ba)
                  : launch(sage_attn_bwd_dq_kernel<D, false, false, true>, smem, grid, st, a, ba);
  } else {
    if (window > 0)
      return launch(sage_attn_bwd_dq_kernel<D, true, true, false>, smem, grid, st, a, ba);
    return causal ? launch(sage_attn_bwd_dq_kernel<D, true, false, false>, smem, grid, st, a, ba)
                  : launch(sage_attn_bwd_dq_kernel<D, false, false, false>, smem, grid, st, a, ba);
  }
}

// the dKV instance of PART for (causal, window) or, with BIAS, (causal)
template <int D, bool BIAS, int PART>
int launch_dkv_part(int causal, int window, dim3 grid, cudaStream_t st, const BwdArgs& a,
                    const BiasOf<BIAS>& ba) {
  constexpr int smem = DkvLayout<D>::bytes;
  if constexpr (BIAS) {
    return causal
               ? launch(sage_attn_bwd_dkv_kernel<D, true, false, true, PART>, smem, grid, st, a, ba)
               : launch(sage_attn_bwd_dkv_kernel<D, false, false, true, PART>, smem, grid, st, a, ba);
  } else {
    if (window > 0)
      return launch(sage_attn_bwd_dkv_kernel<D, true, true, false, PART>, smem, grid, st, a, ba);
    return causal
               ? launch(sage_attn_bwd_dkv_kernel<D, true, false, false, PART>, smem, grid, st, a, ba)
               : launch(sage_attn_bwd_dkv_kernel<D, false, false, false, PART>, smem, grid, st, a, ba);
  }
}

template <int D, bool BIAS>
int launch_dkv(int causal, int window, dim3 grid, cudaStream_t st, const BwdArgs& a,
              const BiasOf<BIAS>& ba) {
  if constexpr (D == 256) {
    // dV, then dK: the two fp32 accumulators together would take 256
    // registers a thread; the dK launch computes S and P again
    const int e = launch_dkv_part<D, BIAS, kDV>(causal, window, grid, st, a, ba);
    return e != 0 ? e : launch_dkv_part<D, BIAS, kDK>(causal, window, grid, st, a, ba);
  } else {
    return launch_dkv_part<D, BIAS, kDKV>(causal, window, grid, st, a, ba);
  }
}

// head dims 64, 128 and 256, with a bias or without
bool bad_shape(int hq, int hkv, int d, int group, int causal, int window) {
  return group != KGROUP || hkv <= 0 || hq % hkv != 0 || (d != 64 && d != 128 && d != 256) ||
         window < 0 || (window > 0 && !causal);
}

// The entry points' common body: check, grid, instance
template <bool BIAS>
int run_dq(const BwdArgs& a, const BiasOf<BIAS>& ba, int b, int d, int causal, int group,
           void* stream) {
  if (bad_shape(a.hq, a.hkv, d, group, causal, a.window)) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.sq + DQ_BM - 1) / DQ_BM, a.hq, b);
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64) return launch_dq<64, BIAS>(causal, a.window, grid, st, a, ba);
  if (d == 256) return launch_dq<256, BIAS>(causal, a.window, grid, st, a, ba);
  return launch_dq<128, BIAS>(causal, a.window, grid, st, a, ba);
}

template <bool BIAS>
int run_dkv(const BwdArgs& a, const BiasOf<BIAS>& ba, int b, int d, int causal, int group,
            void* stream) {
  if (bad_shape(a.hq, a.hkv, d, group, causal, a.window)) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.sk + KV_BM - 1) / KV_BM, a.hkv, b);
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64) return launch_dkv<64, BIAS>(causal, a.window, grid, st, a, ba);
  if (d == 256) return launch_dkv<256, BIAS>(causal, a.window, grid, st, a, ba);
  return launch_dkv<128, BIAS>(causal, a.window, grid, st, a, ba);
}

}  // namespace

// Shapes (all contiguous, d in {64, 128, 256}, hq a multiple of hkv):
//   q_i8 int8 [b,hq,sq,d]; q_scale fp32 [b,hq,sq] (sm_scale*log2e folded);
//   k_i8 int8 [b,hkv,sk,d]; k_scale fp32 [b,hkv,ceil(sk/group)], group 128;
//   k_sm, v bf16 [b,hkv,sk,d]; q_bf, dout bf16 [b,hq,sq,d];
//   lse2 (base 2), dvec fp32 [b,hq,sq]; dq fp32 [b,hq,sq,d]; dk, dv fp32
//   [b,hkv,sk,d]; window > 0 (with causal only) keeps col > row - window.
extern "C" int sage_attn_bwd_dq(const void* q_i8, const void* q_scale, const void* k_i8,
                                const void* k_scale, const void* k_sm, const void* v,
                                const void* dout, const void* lse2, const void* dvec,
                                void* dq, int b, int hq, int hkv, int sq, int sk, int d,
                                int causal, int window, int group, float sm_scale,
                                void* stream) {
  const BwdArgs a{(const int8_t*)q_i8, (const float*)q_scale, nullptr, (const int8_t*)k_i8,
                  (const float*)k_scale, (const __nv_bfloat16*)k_sm, (const __nv_bfloat16*)v,
                  (const __nv_bfloat16*)dout, (const float*)lse2, (const float*)dvec,
                  (float*)dq, nullptr, nullptr, hq, hkv, sq, sk, sm_scale, window};
  return run_dq<false>(a, NoBias{}, b, d, causal, group, stream);
}

extern "C" int sage_attn_bwd_dkv(const void* q_i8, const void* q_scale, const void* q_bf,
                                 const void* k_i8, const void* k_scale, const void* v,
                                 const void* dout, const void* lse2, const void* dvec,
                                 void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
                                 int d, int causal, int window, int group, float sm_scale,
                                 void* stream) {
  const BwdArgs a{(const int8_t*)q_i8, (const float*)q_scale, (const __nv_bfloat16*)q_bf,
                  (const int8_t*)k_i8, (const float*)k_scale, nullptr, (const __nv_bfloat16*)v,
                  (const __nv_bfloat16*)dout, (const float*)lse2, (const float*)dvec, nullptr,
                  (float*)dk, (float*)dv, hq, hkv, sq, sk, sm_scale, window};
  return run_dkv<false>(a, NoBias{}, b, d, causal, group, stream);
}

// The bias instances: the operands of sage_attn_bwd_dq / sage_attn_bwd_dkv
// without the window, d 64, 128 or 256, and the bias: fp32 or bf16 (bias_bf16) [b,hq,sq,sk],
// contiguous, indexed by the query head; dbias (dQ only) its shape and type,
// or null for no dBias.  Every element of dbias is written: dS where the
// kernel computes it, 0 right of the causal diagonal.
extern "C" int sage_attn_bwd_dq_bias(const void* q_i8, const void* q_scale, const void* k_i8,
                                     const void* k_scale, const void* k_sm, const void* v,
                                     const void* dout, const void* lse2, const void* dvec,
                                     void* dq, const void* bias, void* dbias, int b, int hq,
                                     int hkv, int sq, int sk, int d, int causal, int bias_bf16,
                                     int group, float sm_scale, void* stream) {
  const BwdArgs a{(const int8_t*)q_i8, (const float*)q_scale, nullptr, (const int8_t*)k_i8,
                  (const float*)k_scale, (const __nv_bfloat16*)k_sm, (const __nv_bfloat16*)v,
                  (const __nv_bfloat16*)dout, (const float*)lse2, (const float*)dvec,
                  (float*)dq, nullptr, nullptr, hq, hkv, sq, sk, sm_scale, 0};
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  return run_dq<true>(a, BiasArgs{bias, dbias, bias_bf16}, b, d, causal, group, stream);
}

extern "C" int sage_attn_bwd_dkv_bias(const void* q_i8, const void* q_scale, const void* q_bf,
                                      const void* k_i8, const void* k_scale, const void* v,
                                      const void* dout, const void* lse2, const void* dvec,
                                      void* dk, void* dv, const void* bias, int b, int hq,
                                      int hkv, int sq, int sk, int d, int causal, int bias_bf16,
                                      int group, float sm_scale, void* stream) {
  const BwdArgs a{(const int8_t*)q_i8, (const float*)q_scale, (const __nv_bfloat16*)q_bf,
                  (const int8_t*)k_i8, (const float*)k_scale, nullptr, (const __nv_bfloat16*)v,
                  (const __nv_bfloat16*)dout, (const float*)lse2, (const float*)dvec, nullptr,
                  (float*)dk, (float*)dv, hq, hkv, sq, sk, sm_scale, 0};
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  return run_dkv<true>(a, BiasArgs{bias, nullptr, bias_bf16}, b, d, causal, group, stream);
}
