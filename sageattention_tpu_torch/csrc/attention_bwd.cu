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
// sage_attn_bwd_dq: a CTA owns Q rows and loops over 64-column KV tiles;
//   this loop replaces the TPU's sequential n_kv grid axis and its VMEM
//   accumulator, and dQ accumulates in registers.  Causal: it stops at the
//   diagonal tile; with a sliding window (causal only) it starts at the
//   window's first tile, the counterpart of the TPU's band grid
//   (attention_bwd_pallas.py:117-143).
// sage_attn_bwd_dkv: a CTA owns KV rows and loops over every q head of its
//   GQA group and every 64-row Q tile (causal: from the diagonal; with a
//   window, up to the last Q row that sees the tile,
//   attention_bwd_pallas.py:274-287), so dK and dV sum over the group in
//   registers, with no atomics and no repeat of K/V: the port's form of
//   the TPU's rep*n_q fourth grid axis.  It works on the transposed scores
//   S^T = K.Q^T so that a KV row is a product's row.  A KV tile of 64 rows
//   lies inside one 128-row K-scale group, so it reads one k_scale.
//
// The instances without a bias (every sageattn gradient) are Hopper
// kernels: TMA loads through a ring of shared-memory stages, one producer
// warp, wgmma for all five products (their section below has the design).
// A sliding window keeps col > row - window wherever causal keeps
// col <= row, in instances of its own (WINDOW).
//
// The bias instances (BIAS, attention_bwd_pallas.py:146-204, 311-316) are
// the first design: mma.sync, synchronous tile loads, no pipeline; 64-row
// Q tiles a CTA of 4 warps, 16 rows a warp, 128-column KV tiles in column
// chunks (64 at d=64, 32 at d=128 and 256) for dQ; 64 KV rows a CTA for
// dK/dV.  A bias is a per-head [b, hq, sq, sk] fp32 or bf16 tensor, which
// the forward added to the base-2 logits as bias * log2(e).  Both kernels
// add it to the recomputed logits too and clamp them at -1e30, and a row
// whose lse2 is -inf (every key biased to -inf; the forward gave o = 0)
// takes 0 in its place, so its P is exactly 0 and no NaN arises.  dQ
// writes dBias = dS = P * (dP - D) in fp32, before the bf16 rounding, in
// the bias's type (when asked: a fixed bias costs no write), and writes
// the zeros of every tile its causal loop never visits itself, so the
// wrapper allocates dBias uninitialised.  dKV reads bias[q row, kv col]
// straight from device memory for its transposed tile: for one fragment
// element a warp reads 8 consecutive KV columns of each of 4 Q rows, whole
// 32-byte sectors in fp32, so the bias needs no transposed copy (the TPU
// launcher's one XLA transpose, :931-940).  A window with a bias is not
// taken: the JAX package sends it to its exact backward (:423-426), and so
// does the port.  At D = 256 dQ reads Q's and dO's A fragments from
// shared memory for each chunk (they would take 96 registers beside dQ's
// 128), and dK/dV runs in two launches, dV (PART kDV) then dK (kDK), each
// reading the bias: it is read three times (dQ, dV, dK) and dBias written
// once, by dQ.
//
// Ragged edges: K/V rows past sk and Q rows past sq are zero-filled in
// shared memory, their P is set to 0 by a select (no inf - inf and no
// inf * 0: the exp2 of a masked entry is never used), and no row past
// sq (dQ) or sk (dK, dV) is stored.  No padding of the sequence in memory.
//
// Bound: operations.  Per score pair dQ does one int8 Q.K^T (2d ops) and
// two bf16 products' worth of 4d FLOP (dO.V^T, dS.K), dKV 2d int8 and 6d
// bf16 (dO.V^T, P^T.dO, dS^T.Q).  At the CogVideoX-2B layer shape (b=1,
// h=30, s=17,776, d=64; 9.48e9 pairs) that is about 3.1 ms for dQ and 4.3 ms
// for dKV on the H100 SXM's data-sheet peaks; the bytes take well under
// 0.1 ms, and the two exp2 passes (2 x 9.48e9 MUFU operations) are a second
// floor of a few ms.  With a bias, bytes: each live pair's bias is read once
// by each kernel and dQ writes its dBias (and the causal zeros), 8 to 12
// bytes a pair in fp32 against 6d-10d operations.  At the llm-8b-gqa layer
// (b=1, hq=32, s=4096, d=128, causal: 268.5 M live pairs) that is about
// 0.96 ms for dQ with its dBias and 0.32 ms for dKV at 3.35 TB/s, against
// 0.17 and 0.24 ms of operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

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

// ---------------------------------------------------------------------------
// The instances without a bias: TMA-fed wgmma, one producer warp
// ---------------------------------------------------------------------------
//
// A CTA is NWG consumer warpgroups and one producer warpgroup, of which one
// thread issues every load.  What a CTA keeps (dQ: its Q codes and dO;
// dK/dV: its K codes and V) lands once; what it walks over (dQ: the K
// codes, K_sm and V of each 64-column KV tile; dK/dV: the Q codes, bf16 Q
// and dO of each 64-row Q tile with their rows of q_scale, lse2 and dvec)
// streams through a ring of STAGES buffers: the producer waits for a
// buffer to be released (`empty`), posts its bytes on `full` and issues
// the TMA loads; a consumer waits on `full`, computes and arrives on
// `empty`.  Every tile is [64 rows][D] in panels of up to 128 bytes a row,
// swizzled as wgmma reads it; rows past the sequence land as zeros (a
// 3-D map [b h, s, d], so no box reads the next head's rows).
//
// Products, each a warpgroup's 64 rows:
//   dQ:   S = Q.K^T (int8, both from shared memory, K-major), dP = dO.V^T
//         (bf16, the same), then dQ += bf16(dS) . K_sm with dS from
//         registers and K_sm read MN-major;
//   dKV:  S^T = K.Q^T, dP^T = V.dO^T, then dV += bf16(P^T) . dO and
//         dK += bf16(dS^T) . Q, dO and Q read MN-major from the tile that
//         dP^T read K-major.
// The consumers hold their rows' q_scale, lse2 and dvec (dQ) in registers
// or read a Q tile's from the stage, a fragment's two columns at a time
// (dK/dV).  Registers: the producer warpgroup gives its own up (setmaxnreg,
// to 24) so that a consumer thread holds 240 beside one other consumer
// warpgroup, 160 beside two.  dQ runs three consumer warpgroups at d 64
// (192 Q rows share each streamed KV tile), two at 128 and one at 256,
// where its 64 x 256 fp32 accumulator takes 128 registers a thread.  dK/dV
// runs three at d 64 and two at 128, a 64-row KV slice each, keeping dK and
// dV (D registers a thread), and two at 256 on one slice, one keeping dV
// and one dK (one launch; Q, dO and the row vectors read once, S^T
// computed by both).  Except at 256 with a causal mask, a Q tile goes
// through dK/dV in two passes of 32 Q rows, so that S^T and dP^T take 16
// registers each beside the accumulators.
//
// The grid's fastest axis is the tile, so that the CTAs of a wave share one
// head's K and V (dQ) or Q and dO (dK/dV) in L2; along it the longest work
// comes first: causal dQ from the last Q tile, causal dK/dV from the first
// KV tile.  A causal launch of at most two waves puts the tile on the
// slowest axis instead (heads_first), so that every head's longest tiles
// start in the first wave (llm-8b-gqa's causal dK/dV: 256 CTAs, each
// walking 4 heads).

constexpr int WG = 128;  // threads a warpgroup
constexpr int TILE = 64;  // rows of a staged tile; KV columns a dQ step, Q rows a dK/dV step
// A Q tile's rows of q_scale, lse2 or dvec, as dK/dV stages them: a TMA box
// starts 16-byte aligned in device memory (a box at another element faults),
// so each vector lands from its first row rounded down to a multiple of 4,
// VEC values, in a slot of VSLOT bytes (128-byte aligned, as TMA writes)
constexpr int VEC = TILE + 4;
constexpr int VSLOT = 384;

// a [TILE][D] tile of ELEM-byte elements as TMA lays it out
template <int D, int ELEM>
struct Tile {
  static constexpr int ROWB = D * ELEM < 128 ? D * ELEM : 128;  // bytes a panel row
  static constexpr int COLS = ROWB / ELEM;                       // columns a panel (a box)
  static constexpr int PANELS = D * ELEM / ROWB;
  static constexpr int BYTES = TILE * D * ELEM;
};
template <int D>
using TI8 = Tile<D, 1>;
template <int D>
using TBF = Tile<D, 2>;

// registers a thread of a consumer warpgroup beside a producer one at 24
template <int NWG>
constexpr int kConsumerRegs = NWG == 2 ? 240 : 160;  // (65536 - 24 x 128) / (128 NWG)

// rows [row0, row0 + TILE) of plane `plane` into dst, one box a panel
template <typename T>
__device__ inline void load_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                 int row0, int plane) {
#pragma unroll
  for (int p = 0; p < T::PANELS; ++p)
    tma_load_3d(dst + p * TILE * T::ROWB, map, bar, p * T::COLS, row0, plane);
}

__device__ inline unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// heads_first: the grid is (heads, b, tiles), not (tiles, heads, b) (see
// grid_of)
struct DqMaps {
  CUtensorMap q, dout, k, k_sm, v;
  int heads_first;
};

struct DkvMaps {
  CUtensorMap k, v, q, q_bf, dout, q_scale, lse2, dvec;
  int shift[3];  // offset of element 0 in the three 1-D maps (tensor_map_f32)
  int heads_first;
};

// this CTA's (tile, head, batch) and the tiles a head
struct GridPos {
  int tile, n_tiles, h, bi;
};
__device__ inline GridPos grid_pos(int heads_first) {
  return heads_first ? GridPos{(int)blockIdx.z, (int)gridDim.z, (int)blockIdx.x, (int)blockIdx.y}
                     : GridPos{(int)blockIdx.x, (int)gridDim.x, (int)blockIdx.y, (int)blockIdx.z};
}

template <int D, int NWG, int STAGES>
struct DqTma {
  static constexpr int q = 0;                          // NWG x int8 [64][D]
  static constexpr int dout = q + NWG * TI8<D>::BYTES;  // NWG x bf16 [64][D]
  static constexpr int ring = dout + NWG * TBF<D>::BYTES;
  static constexpr int k = 0, k_sm = TI8<D>::BYTES, v = k_sm + TBF<D>::BYTES;  // in a stage
  static constexpr int stage = v + TBF<D>::BYTES;       // also the bytes a stage posts
  static constexpr int bars = ring + STAGES * stage;    // full[STAGES], empty[STAGES], rows
  static constexpr int bytes = bars + (2 * STAGES + 1) * 8 + 1024;  // + the base's alignment
};

template <int D, int NWG, int STAGES, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(WG*(NWG + 1), 1)
sage_attn_bwd_dq_tma_kernel(const BwdArgs a, const __grid_constant__ DqMaps m) {
  using L = DqTma<D, NWG, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* rows_bar = empty + STAGES;

  const int hq = a.hq, sq = a.sq, sk = a.sk;
  const int window = WINDOW ? a.window : 0;
  const GridPos gp = grid_pos(m.heads_first);
  const int h = gp.h, bi = gp.bi;
  const int qt = CAUSAL ? gp.n_tiles - 1 - gp.tile : gp.tile;
  const int q0 = qt * TILE * NWG;
  const int plane_q = bi * hq + h, plane_kv = bi * a.hkv + h / (hq / a.hkv);
  int j_end = (sk + TILE - 1) / TILE;
  if (CAUSAL) j_end = min(j_end, (q0 + TILE * NWG - 1) / TILE + 1);
  const int j_first = window > 0 ? max(0, q0 - window + 1) / TILE : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * WG);
    }
    mbar_init(rows_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == NWG) {  // the producer
    if constexpr (NWG > 1) regs_dec<24>();
    if (threadIdx.x % WG == 0) {
      int live = 0;  // warpgroups with a row below sq
      for (int w = 0; w < NWG; ++w) live += q0 + w * TILE < sq;
      mbar_expect_tx(rows_bar, live * (TI8<D>::BYTES + TBF<D>::BYTES));
      for (int w = 0; w < live; ++w) {
        load_tile<TI8<D>>(smem + L::q + w * TI8<D>::BYTES, &m.q, rows_bar, q0 + w * TILE, plane_q);
        load_tile<TBF<D>>(smem + L::dout + w * TBF<D>::BYTES, &m.dout, rows_bar, q0 + w * TILE,
                          plane_q);
      }
      int s = 0, ph = 0;
      for (int j = j_first; j < j_end; ++j) {
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = smem + L::ring + s * L::stage;
        mbar_expect_tx(&full[s], L::stage);
        load_tile<TI8<D>>(st + L::k, &m.k, &full[s], j * TILE, plane_kv);
        load_tile<TBF<D>>(st + L::k_sm, &m.k_sm, &full[s], j * TILE, plane_kv);
        load_tile<TBF<D>>(st + L::v, &m.v, &full[s], j * TILE, plane_kv);
        if (++s == STAGES) s = 0, ph ^= 1;
      }
    }
    return;
  }
  if constexpr (NWG > 1) regs_inc<kConsumerRegs<NWG>>();

  // a consumer: rows [q0w, q0w + 64), 16 a warp, two a thread
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0w = q0 + wg * TILE;
  const size_t row_base = (size_t)plane_q * sq;
  const int row0 = q0w + warp * 16 + g, row1 = row0 + 8;
  // rows past sq: P = 1 there, but dO = 0 makes their dS 0, and they are never stored
  const float qs0 = row0 < sq ? a.q_scale[row_base + row0] : 0.f;
  const float qs1 = row1 < sq ? a.q_scale[row_base + row1] : 0.f;
  const float ls0 = row0 < sq ? a.lse2[row_base + row0] : 0.f;
  const float ls1 = row1 < sq ? a.lse2[row_base + row1] : 0.f;
  const float dv0 = row0 < sq ? a.dvec[row_base + row0] : 0.f;
  const float dv1 = row1 < sq ? a.dvec[row_base + row1] : 0.f;
  const float* ks_row = a.k_scale + (size_t)plane_kv * ((sk + KGROUP - 1) / KGROUP);
  const uint32_t sQ = smem_u32(smem + L::q + wg * TI8<D>::BYTES);
  const uint32_t sDo = smem_u32(smem + L::dout + wg * TBF<D>::BYTES);

  float acc[D / 2];  // dQ: acc[4i + e] is column group i's C fragment
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const bool live = q0w < sq;
  if (live) mbar_wait(rows_bar, 0);
  // tile j sits in stage (j - j_first) % STAGES; a tile right of this
  // warpgroup's causal diagonal or left of its window is only waited for
  // and released
  auto skip = [&](int j) {
    const int kv0 = j * TILE;
    return !live || (CAUSAL && kv0 > q0w + TILE - 1) ||
           (window > 0 && kv0 + TILE - 1 <= q0w - window);
  };
  auto stage = [&](int j) {
    return smem_u32(smem + L::ring + ((j - j_first) % STAGES) * L::stage);
  };
  // S = Q.K^T (int8) and dP = dO.V^T (bf16) of tile j, issued
  auto issue = [&](int j, int (&s_i)[32], float (&dp)[32]) {
    const int i = j - j_first;
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    if (skip(j)) return;
    const uint32_t st = stage(j);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      wgmma_s8_ss<64>(s_i, desc_kmajor<TILE, TI8<D>::ROWB>(sQ, kk),
                      desc_kmajor<TILE, TI8<D>::ROWB>(st + L::k, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16_ss<64>(dp, desc_kmajor<TILE, 128>(sDo, kk), desc_kmajor<TILE, 128>(st + L::v, kk),
                        kk > 0);
    wgmma_commit();
  };
  // tile j's S and dP complete: P = exp2(l2 - lse2), masked, dS = P * (dP -
  // D) a column group at a time into bf16 A fragments, and dQ += bf16(dS) .
  // K_sm issued
  auto finish = [&](int j, int (&s_i)[32], float (&dp)[32]) {
    if (skip(j)) return;
    const int kv0 = j * TILE;
    const float ks = ks_row[kv0 / KGROUP];
    const float rs0 = qs0 * ks, rs1 = qs1 * ks;  // the forward's order
    const bool need_mask = (kv0 + TILE > sk) || (CAUSAL && kv0 + TILE - 1 > q0w) ||
                           (window > 0 && kv0 <= q0w + TILE - 1 - window);
    uint32_t af[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float p = exp2f((float)s_i[4 * n + e] * (lo ? rs0 : rs1) - (lo ? ls0 : ls1));
        if (need_mask) {
          const int col = kv0 + n * 8 + t * 2 + (e & 1);
          const int row = lo ? row0 : row1;
          if (col >= sk || (CAUSAL && col > row) || (window > 0 && col <= row - window)) p = 0.f;
        }
        ds[e] = p * (dp[4 * n + e] - (lo ? dv0 : dv1));
      }
      // column group n is half (n & 1) of the A fragment of K step n / 2
      af[n / 2][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
      af[n / 2][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
    }
    const uint32_t st = stage(j);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_rs_mn<D>(acc, af[kk], desc_mnmajor<TILE>(st + L::k_sm, kk));
    wgmma_commit();
  };
  // (the same loop with the tile's work written in place ran the causal
  // instances at d 128 and 256 1.46-1.52x slower on an H100 80GB HBM3 at
  // 700 W, tools/ab_attention_bwd.py, with no cause the source shows)
  int s_i[32];
  float dp[32];
  for (int j = j_first; j < j_end; ++j) {
    issue(j, s_i, dp);
    wgmma_wait<0>();
    reg_fence(s_i, 32);
    reg_fence(dp, 32);
    finish(j, s_i, dp);
    wgmma_wait<0>();
    mbar_arrive(&empty[(j - j_first) % STAGES]);
  }
  reg_fence(acc, D / 2);

  // epilogue: dq = acc * sm_scale, rows < sq
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + t * 2;
    if (row0 < sq)
      *reinterpret_cast<float2*>(a.dq + (row_base + row0) * D + col) =
          make_float2(acc[4 * i] * a.sm_scale, acc[4 * i + 1] * a.sm_scale);
    if (row1 < sq)
      *reinterpret_cast<float2*>(a.dq + (row_base + row1) * D + col) =
          make_float2(acc[4 * i + 2] * a.sm_scale, acc[4 * i + 3] * a.sm_scale);
  }
}

// dK/dV: KV = the 64-row KV slices a CTA owns, one a consumer warpgroup, or
// at D = 256 one shared by the dV and the dK warpgroup
template <int D, int STAGES>
struct DkvTma {
  static constexpr int KV = D == 256 ? 1 : D == 64 ? 3 : 2;
  static constexpr int NWG = D == 256 ? 2 : KV;  // consumer warpgroups
  static constexpr int k = 0;                           // KV x int8 [64][D]
  static constexpr int v = k + KV * TI8<D>::BYTES;       // KV x bf16 [64][D]
  static constexpr int ring = v + KV * TBF<D>::BYTES;
  // in a stage: int8 Q, bf16 Q, dO, then q_scale, lse2, dvec [VEC] fp32
  static constexpr int q = 0, q_bf = TI8<D>::BYTES, dout = q_bf + TBF<D>::BYTES;
  static constexpr int vec = dout + TBF<D>::BYTES;
  static constexpr int posted = vec + 3 * VEC * 4;       // the bytes a stage posts
  static constexpr int stage = vec + 3 * VSLOT + 896;    // 1024-byte aligned stages
  static constexpr int bars = ring + STAGES * stage;
  static constexpr int bytes = bars + (2 * STAGES + 1) * 8 + 1024;
};

// One consumer warpgroup's dK/dV work for KV rows [kvs, kvs + 64): PART
// kDV, kDK or both
template <int D, int STAGES, bool CAUSAL, bool WINDOW, int PART>
__device__ __forceinline__ void dkv_consumer(const BwdArgs& a, unsigned char* smem, uint64_t* full,
                                    uint64_t* empty, uint64_t* rows_bar, const int* shift,
                                    int hk, int bi, int slice, int kv0, int qt0, int n_qt) {
  using L = DkvTma<D, STAGES>;
  constexpr bool WANT_V = PART & kDV, WANT_K = PART & kDK;
  // Q rows a pass over a Q tile: 64 where one pass holds no stack (causal
  // and windowed at 256), else two passes of 32, so that S^T and dP^T take
  // 16 registers each (one pass spilled 8-40 bytes at 128 and at 256
  // without a mask; three warpgroups at d 64 hold 160 registers a thread)
  constexpr int NQ = D == 256 && CAUSAL ? TILE : TILE / 2;
  const int hq = a.hq, hkv = a.hkv, sq = a.sq, sk = a.sk;
  const int window = WINDOW ? a.window : 0;
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rep = hq / hkv;
  const int kvs = kv0 + slice * TILE;
  const int kr0 = kvs + warp * 16 + g, kr1 = kr0 + 8;  // this thread's KV rows
  const size_t kv_row_base = ((size_t)bi * hkv + hk) * sk;
  const float ks = a.k_scale[((size_t)bi * hkv + hk) * ((sk + KGROUP - 1) / KGROUP) + kvs / KGROUP];
  const uint32_t sK = smem_u32(smem + L::k + slice * TI8<D>::BYTES);
  const uint32_t sV = smem_u32(smem + L::v + slice * TBF<D>::BYTES);

  float acc_v[WANT_V ? D / 2 : 1], acc_k[WANT_K ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    if constexpr (WANT_V) acc_v[i] = 0.f;
    if constexpr (WANT_K) acc_k[i] = 0.f;
  }

  const bool live = kvs < sk;
  if (live) mbar_wait(rows_bar, 0);
  // this thread's KV rows past sk (masked), and its rows relative to
  // column 2t of a Q tile (the causal and window masks)
  const bool kr0_out = kr0 >= sk, kr1_out = kr1 >= sk;
  const int nq = n_qt - qt0;  // Q tiles a head
  int s = 0, ph = 0;
  for (int it = 0; it < rep * nq; ++it) {  // every q head of the group, every Q tile
    const int q0 = (qt0 + it % nq) * TILE;
    mbar_wait(&full[s], ph);
    const bool skip = !live || (CAUSAL && q0 + TILE - 1 < kvs) ||
                      (window > 0 && kvs + TILE - 1 <= q0 - window);
    if (!skip) {
      unsigned char* stp = smem + L::ring + s * L::stage;
      const uint32_t st = smem_u32(stp);
      // the tile's row vectors, q_scale, lse2 and dvec of Q row q0 + i at
      // [i] (each landed from the 16-byte aligned element at or before row q0)
      const int r = (bi * hq + hk * rep + it / nq) * sq + q0;
      const float* vqs = reinterpret_cast<const float*>(stp + L::vec) + ((r + shift[0]) & 3);
      const float* vls =
          reinterpret_cast<const float*>(stp + L::vec + VSLOT) + ((r + shift[1]) & 3);
      const float* vdv =
          reinterpret_cast<const float*>(stp + L::vec + 2 * VSLOT) + ((r + shift[2]) & 3);
      const bool need_mask = (q0 + TILE > sq) || (kvs + TILE > sk) ||
                             (CAUSAL && kvs + TILE - 1 > q0) ||
                             (window > 0 && kvs <= q0 + TILE - 1 - window);
      // for element (n, e) of a pass: Q row q0 + c0 + 2t + 8n + (e & 1), KV
      // row kr0 or kr1
      const int q_left = sq - q0 - 2 * t;  // Q rows past sq: c0 + 8n + (e & 1) >= q_left
      const int rel = kr0 - q0 - 2 * t;    // kr - qr = rel + 8 (e >= 2) - c0 - 8n - (e & 1)
#pragma unroll
      for (int c0 = 0; c0 < TILE; c0 += NQ) {  // the tile's Q rows, NQ a pass
        int s_i[NQ / 2];
        float dp[WANT_K ? NQ / 2 : 1];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)  // S^T = K.Q^T
          wgmma_s8_ss<NQ>(s_i, desc_kmajor<TILE, TI8<D>::ROWB>(sK, kk),
                          desc_kmajor<TILE, TI8<D>::ROWB>(st + L::q + c0 * TI8<D>::ROWB, kk),
                          kk > 0);
        if constexpr (WANT_K) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V.dO^T
            wgmma_bf16_ss<NQ>(dp, desc_kmajor<TILE, 128>(sV, kk),
                              desc_kmajor<TILE, 128>(st + L::dout + c0 * 128, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s_i, NQ / 2);
        if constexpr (WANT_K) reg_fence(dp, NQ / 2);
        // P^T = exp2(l2 - lse2), masked, and dS^T = P^T * (dP^T - D), a
        // column group at a time (so P^T never takes a whole tile of fp32
        // registers), into bf16 A fragments; the Q tile's row vectors as
        // float2 pairs of the fragment's two columns
        uint32_t pa[WANT_V ? NQ / 16 : 1][4], da[WANT_K ? NQ / 16 : 1][4];
#pragma unroll
        for (int n = 0; n < NQ / 8; ++n) {
          const int c = c0 + n * 8 + t * 2;  // Q row within the tile
          const float2 qs2 = make_float2(vqs[c], vqs[c + 1]);
          const float2 ls2 = make_float2(vls[c], vls[c + 1]);
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            float pv = exp2f((float)s_i[4 * n + e] * ((odd ? qs2.y : qs2.x) * ks) -
                             (odd ? ls2.y : ls2.x));
            if (need_mask) {
              const int d_kq = rel + (e < 2 ? 0 : 8) - c0 - 8 * n - odd;  // kr - qr
              if (c0 + 8 * n + odd >= q_left || (e < 2 ? kr0_out : kr1_out) ||
                  (CAUSAL && d_kq > 0) || (window > 0 && d_kq <= -window))
                pv = 0.f;
            }
            p[e] = pv;
          }
          // column group n is half (n & 1) of the A fragment of K step n / 2
          if constexpr (WANT_V) {
            pa[n / 2][2 * (n & 1)] = pack_bf16(p[0], p[1]);
            pa[n / 2][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
          }
          if constexpr (WANT_K) {
            const float2 dv2 = make_float2(vdv[c], vdv[c + 1]);
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ds[e] = p[e] * (dp[4 * n + e] - ((e & 1) ? dv2.y : dv2.x));
            da[n / 2][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
            da[n / 2][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
          }
        }
        // dV += bf16(P^T) . dO, dK += bf16(dS^T) . Q over the pass's Q rows
        wgmma_fence();
        if constexpr (WANT_V) {
#pragma unroll
          for (int kk = 0; kk < NQ / 16; ++kk)
            wgmma_bf16_rs_mn<D>(acc_v, pa[kk], desc_mnmajor<TILE>(st + L::dout, c0 / 16 + kk));
        }
        if constexpr (WANT_K) {
#pragma unroll
          for (int kk = 0; kk < NQ / 16; ++kk)
            wgmma_bf16_rs_mn<D>(acc_k, da[kk], desc_mnmajor<TILE>(st + L::q_bf, c0 / 16 + kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
      if constexpr (WANT_V) reg_fence(acc_v, D / 2);
      if constexpr (WANT_K) reg_fence(acc_k, D / 2);
    }
    mbar_arrive(&empty[s]);
    if (++s == STAGES) s = 0, ph ^= 1;
  }

  // epilogue: dk = acc_k * sm_scale, dv = acc_v, rows < sk
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + t * 2;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int kr = hi ? kr1 : kr0;
      if (kr >= sk) continue;
      const size_t o = (kv_row_base + kr) * D + col;
      if constexpr (WANT_K)
        *reinterpret_cast<float2*>(a.dk + o) =
            make_float2(acc_k[4 * i + 2 * hi] * a.sm_scale, acc_k[4 * i + 2 * hi + 1] * a.sm_scale);
      if constexpr (WANT_V)
        *reinterpret_cast<float2*>(a.dv + o) = make_float2(acc_v[4 * i + 2 * hi], acc_v[4 * i + 2 * hi + 1]);
    }
  }
}

template <int D, int STAGES, bool CAUSAL, bool WINDOW>
__global__ void __launch_bounds__(WG*(DkvTma<D, STAGES>::NWG + 1), 1)
sage_attn_bwd_dkv_tma_kernel(const BwdArgs a, const __grid_constant__ DkvMaps m) {
  using L = DkvTma<D, STAGES>;
  constexpr int KV = L::KV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* rows_bar = empty + STAGES;

  const int hq = a.hq, hkv = a.hkv, sq = a.sq, sk = a.sk;
  const int window = WINDOW ? a.window : 0;
  const GridPos gp = grid_pos(m.heads_first);
  const int hk = gp.h, bi = gp.bi, rep = hq / hkv;
  const int kv0 = gp.tile * TILE * KV;  // causal: the longest columns first
  const int qt0 = CAUSAL ? kv0 / TILE : 0;
  int n_qt = (sq + TILE - 1) / TILE;
  if (window > 0)  // up to the last Q row whose window reaches this tile
    n_qt = min(n_qt, (kv0 + TILE * KV - 1 + window - 1) / TILE + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::NWG * WG);
    }
    mbar_init(rows_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == L::NWG) {  // the producer
    regs_dec<24>();
    if (threadIdx.x % WG == 0) {
      const int plane_kv = bi * hkv + hk;
      int live = 0;  // KV slices with a row below sk
      for (int x = 0; x < KV; ++x) live += kv0 + x * TILE < sk;
      mbar_expect_tx(rows_bar, live * (TI8<D>::BYTES + TBF<D>::BYTES));
      for (int x = 0; x < live; ++x) {
        load_tile<TI8<D>>(smem + L::k + x * TI8<D>::BYTES, &m.k, rows_bar, kv0 + x * TILE, plane_kv);
        load_tile<TBF<D>>(smem + L::v + x * TBF<D>::BYTES, &m.v, rows_bar, kv0 + x * TILE, plane_kv);
      }
      int s = 0, ph = 0;
      for (int hh = 0; hh < rep; ++hh) {
        const int plane = bi * hq + hk * rep + hh;
        for (int qt = qt0; qt < n_qt; ++qt) {
          mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = smem + L::ring + s * L::stage;
          mbar_expect_tx(&full[s], L::posted);
          load_tile<TI8<D>>(st + L::q, &m.q, &full[s], qt * TILE, plane);
          load_tile<TBF<D>>(st + L::q_bf, &m.q_bf, &full[s], qt * TILE, plane);
          load_tile<TBF<D>>(st + L::dout, &m.dout, &full[s], qt * TILE, plane);
          const int r = plane * sq + qt * TILE;
          tma_load_1d(st + L::vec, &m.q_scale, &full[s], (r + m.shift[0]) & ~3);
          tma_load_1d(st + L::vec + VSLOT, &m.lse2, &full[s], (r + m.shift[1]) & ~3);
          tma_load_1d(st + L::vec + 2 * VSLOT, &m.dvec, &full[s], (r + m.shift[2]) & ~3);
          if (++s == STAGES) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs<L::NWG>>();
  if constexpr (KV == 1) {  // D = 256: warpgroup 0 keeps dV, warpgroup 1 dK
    if (wg == 0)
      dkv_consumer<D, STAGES, CAUSAL, WINDOW, kDV>(a, smem, full, empty, rows_bar, m.shift, hk, bi, 0, kv0, qt0, n_qt);
    else
      dkv_consumer<D, STAGES, CAUSAL, WINDOW, kDK>(a, smem, full, empty, rows_bar, m.shift, hk, bi, 0, kv0, qt0, n_qt);
  } else {
    dkv_consumer<D, STAGES, CAUSAL, WINDOW, kDKV>(a, smem, full, empty, rows_bar, m.shift, hk,
                                                  bi, wg, kv0, qt0, n_qt);
  }
}

template <int D>
constexpr int dq_nwg() { return D == 256 ? 1 : D == 64 ? 3 : 2; }
template <int D>
constexpr int dq_stages() { return D == 256 ? 2 : 4; }
template <int D>
constexpr int dkv_stages() { return D == 256 ? 2 : 4; }

// the tensor maps of a [planes, rows, D] operand, in the boxes of its tile
template <int D, int ELEM>
bool tile_map(CUtensorMap* map, const void* p, long long planes, int rows) {
  return tensor_map_3d(map, p, ELEM == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       ELEM, planes, rows, D, TILE, Tile<D, ELEM>::COLS);
}

template <typename Kern, typename B>
int launch(Kern kern, int smem, dim3 grid, cudaStream_t st, const BwdArgs& a, const B& ba) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, NTHREADS, smem, st>>>(a, ba);
  return (int)cudaGetLastError();
}

// The bias instances (mma.sync): (causal) picks the instance
template <int D>
int launch_dq_bias(int causal, dim3 grid, cudaStream_t st, const BwdArgs& a, const BiasArgs& ba) {
  constexpr int smem = DqLayout<D>::bytes;
  return causal ? launch(sage_attn_bwd_dq_kernel<D, true, false, true>, smem, grid, st, a, ba)
                : launch(sage_attn_bwd_dq_kernel<D, false, false, true>, smem, grid, st, a, ba);
}

// the bias dKV instance of PART
template <int D, int PART>
int launch_dkv_part(int causal, dim3 grid, cudaStream_t st, const BwdArgs& a, const BiasArgs& ba) {
  constexpr int smem = DkvLayout<D>::bytes;
  return causal
             ? launch(sage_attn_bwd_dkv_kernel<D, true, false, true, PART>, smem, grid, st, a, ba)
             : launch(sage_attn_bwd_dkv_kernel<D, false, false, true, PART>, smem, grid, st, a, ba);
}

template <int D>
int launch_dkv_bias(int causal, dim3 grid, cudaStream_t st, const BwdArgs& a, const BiasArgs& ba) {
  if constexpr (D == 256) {
    // dV, then dK: the two fp32 accumulators together would take 256
    // registers a thread; the dK launch computes S and P again
    const int e = launch_dkv_part<D, kDV>(causal, grid, st, a, ba);
    return e != 0 ? e : launch_dkv_part<D, kDK>(causal, grid, st, a, ba);
  } else {
    return launch_dkv_part<D, kDKV>(causal, grid, st, a, ba);
  }
}

// The launch grid of n_tiles tiles x heads x b, with the tile on the
// fastest axis, or on the slowest (*heads_first) for a causal launch without
// a window that fills at most two waves of one CTA an SM
inline dim3 grid_of(int n_tiles, int heads, int b, bool causal_band, int* heads_first) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *heads_first = causal_band && (long long)n_tiles * heads * b <= 2LL * sms;
  return *heads_first ? dim3(heads, b, n_tiles) : dim3(n_tiles, heads, b);
}

// The instances without a bias: (causal, window) picks the instance
template <typename Kern, typename M>
int launch_tma(Kern kern, int smem, dim3 grid, int threads, cudaStream_t st, const BwdArgs& a,
               const M& m) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, st>>>(a, m);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_tma(int b, int causal, cudaStream_t st, const BwdArgs& a) {
  constexpr int NWG = dq_nwg<D>(), STAGES = dq_stages<D>();
  constexpr int smem = DqTma<D, NWG, STAGES>::bytes;
  const long long pq = (long long)b * a.hq, pk = (long long)b * a.hkv;
  DqMaps m;
  if (!tile_map<D, 1>(&m.q, a.q_i8, pq, a.sq) || !tile_map<D, 2>(&m.dout, a.dout, pq, a.sq) ||
      !tile_map<D, 1>(&m.k, a.k_i8, pk, a.sk) || !tile_map<D, 2>(&m.k_sm, a.k_sm, pk, a.sk) ||
      !tile_map<D, 2>(&m.v, a.v, pk, a.sk))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of((a.sq + TILE * NWG - 1) / (TILE * NWG), a.hq, b,
                            causal && a.window == 0, &m.heads_first);
  const int threads = WG * (NWG + 1);
  if (a.window > 0)
    return launch_tma(sage_attn_bwd_dq_tma_kernel<D, NWG, STAGES, true, true>, smem, grid, threads,
                      st, a, m);
  return causal ? launch_tma(sage_attn_bwd_dq_tma_kernel<D, NWG, STAGES, true, false>, smem, grid,
                             threads, st, a, m)
                : launch_tma(sage_attn_bwd_dq_tma_kernel<D, NWG, STAGES, false, false>, smem, grid,
                             threads, st, a, m);
}

template <int D>
int launch_dkv_tma(int b, int causal, cudaStream_t st, const BwdArgs& a) {
  constexpr int STAGES = dkv_stages<D>();
  using L = DkvTma<D, STAGES>;
  const long long pq = (long long)b * a.hq, pk = (long long)b * a.hkv;
  DkvMaps m;
  if (!tile_map<D, 1>(&m.k, a.k_i8, pk, a.sk) || !tile_map<D, 2>(&m.v, a.v, pk, a.sk) ||
      !tile_map<D, 1>(&m.q, a.q_i8, pq, a.sq) || !tile_map<D, 2>(&m.q_bf, a.q_bf, pq, a.sq) ||
      !tile_map<D, 2>(&m.dout, a.dout, pq, a.sq) ||
      !tensor_map_f32(&m.q_scale, a.q_scale, pq * a.sq, VEC, &m.shift[0]) ||
      !tensor_map_f32(&m.lse2, a.lse2, pq * a.sq, VEC, &m.shift[1]) ||
      !tensor_map_f32(&m.dvec, a.dvec, pq * a.sq, VEC, &m.shift[2]))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of((a.sk + TILE * L::KV - 1) / (TILE * L::KV), a.hkv, b,
                            causal && a.window == 0, &m.heads_first);
  if (a.window > 0)
    return launch_tma(sage_attn_bwd_dkv_tma_kernel<D, STAGES, true, true>, L::bytes, grid, WG * (L::NWG + 1),
                      st, a, m);
  return causal ? launch_tma(sage_attn_bwd_dkv_tma_kernel<D, STAGES, true, false>, L::bytes, grid,
                             WG * (L::NWG + 1), st, a, m)
                : launch_tma(sage_attn_bwd_dkv_tma_kernel<D, STAGES, false, false>, L::bytes, grid,
                             WG * (L::NWG + 1), st, a, m);
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
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (BIAS) {
    const dim3 grid((a.sq + DQ_BM - 1) / DQ_BM, a.hq, b);
    if (d == 64) return launch_dq_bias<64>(causal, grid, st, a, ba);
    if (d == 256) return launch_dq_bias<256>(causal, grid, st, a, ba);
    return launch_dq_bias<128>(causal, grid, st, a, ba);
  } else {
    if (d == 64) return launch_dq_tma<64>(b, causal, st, a);
    if (d == 256) return launch_dq_tma<256>(b, causal, st, a);
    return launch_dq_tma<128>(b, causal, st, a);
  }
}

template <bool BIAS>
int run_dkv(const BwdArgs& a, const BiasOf<BIAS>& ba, int b, int d, int causal, int group,
            void* stream) {
  if (bad_shape(a.hq, a.hkv, d, group, causal, a.window)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if constexpr (BIAS) {
    const dim3 grid((a.sk + KV_BM - 1) / KV_BM, a.hkv, b);
    if (d == 64) return launch_dkv_bias<64>(causal, grid, st, a, ba);
    if (d == 256) return launch_dkv_bias<256>(causal, grid, st, a, ba);
    return launch_dkv_bias<128>(causal, grid, st, a, ba);
  } else {
    if (d == 64) return launch_dkv_tma<64>(b, causal, st, a);
    if (d == 256) return launch_dkv_tma<256>(b, causal, st, a);
    return launch_dkv_tma<128>(b, causal, st, a);
  }
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
