// Kernel 1's fused SageAttention forward for Hopper (sm_90a): what it
// computes, and the operand types and helpers its TMA-fed wgmma kernels
// share, the masks' pieces among them.  The kernels are
// attention_fwd_sm90.cuh's at head dims 64, 128 and 256 (two consumer
// warpgroups of 64 Q rows a CTA) and attention_fwd_sm90_wide.cuh's at 384
// and 512 (O's columns split between the two warpgroups of a 64-row CTA),
// each with and without masks (MASKED) and on pre-quantized Q (PREQ); every
// source instantiates only its own, so the sources build in parallel.
//
// Replaces the TPU kernel attention_pallas.py:sage_attention_fused
// (_kernel / _kernel_single, bodies _compute_parts, _merge_parts,
// _merge_into_scratch): non-causal and causal (top-left, col <= row), GQA,
// the base-2 LSE, per-row Q quantization inside the kernel, ragged sq / sk,
// and V stored as bf16 or as int8 / fp8 e4m3 / fp8 e5m2 codes with a
// per-channel scale and the smooth-v mean in the epilogue (the TPU
// kernel's default pv_compute="bf16").  Codes are widened to bf16 before
// the launch (widen_v.cu; every int8, e4m3 and e5m2 value is exact in
// bf16), so P.V runs on the bf16 tensor cores for every V type.  Native
// fp8 P.V would round P to fp8, which the JAX kernel does not do.
//
// The pre-quantized instantiation (PREQ) is kernel 1's slices (h), (i) and
// (k) (attention_pallas.py:661-680, 1455-1457, 1837-1845): Q arrives as
// int8 codes with per-row fp32 scales that hold sm_scale*log2(e) (from
// csrc/quant_q.cu at 8 or 4 bits, or the qk_quant_gran granularities
// quantized in PyTorch); K comes with one scale per 128-row group or one
// per row, and an optional per-(b, q head) column bias in the base-2
// domain (smooth_q's qm . (k - km)).  A score is (s * q_scale[row] *
// k_scale[tile]) * col_scale[col] + col_bias[col] (preq_score), the TPU
// kernel's order.  The +-7 codes of qk_bits=4 run the same int8 product:
// sm_90 has no int4 MMA, and the TPU kernel's int4 operand type changes
// its speed, not its numbers.
//
// The masked instantiation (MASKED) adds kernel 1's masking slices (c)-(g)
// (attention_pallas.py:575-582 the bool mask, 689-705 the bias, 748-777
// dead rows, 1616-1628 and 1676-1680 the window's band, 1865-1923 the msum
// liveness summary): element (row, col) is live when col < sk, the bool
// mask is set, the segment ids match or kv_lo[row] <= col < kv_hi[row]
// (varlen's range form), kv_pos[col] <= q_pos[row], col <= row when causal
// and col > row - window with a window.  A live score is the dequantized
// one + bias * log2(e); a dead one is -inf.  A row with no live key (l ==
// 0) writes o = 0 (no v_mean) and lse2 = -inf, as the TPU kernel does.
// The mask and the bias are read through four element strides (b, h, row,
// col), so a head-, batch-, row- or column-broadcast operand is never
// copied out per head.  The pieces below, shared by both kernels:
//   - mask_range: the KV tiles a CTA may visit, [first, end): a window
//     starts at tile (q0 - window + 1) / KT, the range form keeps [min
//     kv_lo, max kv_hi) of the CTA's rows (a reduction in shared memory
//     before the warpgroups part), causal ends at the CTA's last row;
//   - TileWalk: the liveness table's rows of the CTA (one a 64-row table
//     row: two for a 128-row CTA, one for a 64-row one) and the walk over
//     the listed tiles, which the producer and every consumer take alike,
//     so that each listed tile's stage is loaded once and released by
//     every consumer: a tile is listed unless every table row of the CTA
//     marks it dead (0);
//   - mask_scores: on a consumer's dequantized S of one tile, the bias,
//     the element rule and the causal, ragged-edge and window checks, then
//     the row maxima.  It acts on registers after the product, so every
//     wgmma stays on a path that the whole warpgroup takes.  The rule runs
//     only where a tile needs it: a tile that the warpgroup's table row
//     marks wholly live (2) and that every range of the thread's rows holds
//     takes the checks alone; one the row marks dead (0) is -inf whole.
//     Where it runs, a loop that is not unrolled (one copy of the rule's
//     code) sets one bit per element of a 64-bit dead mask, which the
//     unrolled pass tests with constant shifts.  Each thread adds its own
//     fragment's bias: at 64-256, where its column pairs are contiguous
//     and aligned (bias_stageable), staged by cp.async into its own
//     shared-memory slots a tile ahead (bias_stage; the SBIAS instances,
//     3 ring stages at 128 and 256); else loaded after the tile's S, a
//     column pair in one load where it can, with the next tile's columns
//     prefetched into L2.  A TMA-staged tile, as kernels 7-8 have, finds
//     no room: an fp32 [64 x 128] tile is 32 KB a warpgroup a stage.
//
// Bound: operations over the live (row, col) pairs, whatever V's type.  At
// the CogVideoX-2B layer shape (b=1, h=30, s=17,776, d=64) Q.K^T is
// 1.21e12 int8 ops and P.V 1.21e12 bf16 FLOP, about 1.84 ms on an H100
// SXM's data-sheet peaks, while the bytes (Q, K, V, O once each) take
// about 0.03 ms.  With masks the live pairs set the work; a per-head bias
// adds 4 bytes (fp32) a live pair.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

// V storage: bf16, or codes of one byte (widened to bf16 before the launch)
enum VKind { kVBf16 = 0, kVInt8 = 1, kVE4M3 = 2, kVE5M2 = 3 };

constexpr int BN = 128;   // the K-scale group: one k_scale a 128-column group
constexpr int kQTile = 64;  // Q rows of one row of the liveness table
constexpr int kWarpgroup = 128;  // threads a warpgroup
constexpr float NEG_INIT = -1e30f;
constexpr float kInvQmax = (float)(1.0 / 127.0);
constexpr float kLog2e = 1.4426950408889634f;

// KV columns a tile of attention_fwd_sm90.cuh's kernel: the K-scale group,
// or half of it from D = 256 on, where a consumer's fp32 O accumulator alone
// takes 128 registers a thread and a 128-column S tile (64 more) would leave
// nothing for the rest; half of it for the masked pre-quantized instances at
// 128 too, whose row vectors beside the masks' pass spilled (16-56 bytes of
// stack) with 128 columns
template <int D, bool PREQ = false, bool MASKED = false>
constexpr int kKvTile = D >= 256 || (D == 128 && PREQ && MASKED) ? BN / 2 : BN;

// the masked instantiation's operands; each pointer may be null
struct MaskArgs {
  const int* q_seg;    // int32 [b, sq] segment ids, with kv_seg [b, sk]
  const int* kv_seg;
  const int* kv_lo;    // int32 [b, sq]: row attends [kv_lo, kv_hi) (varlen)
  const int* kv_hi;
  const int* q_pos;    // int32 [b, sq] positions, with kv_pos [b, sk]
  const int* kv_pos;
  const uint8_t* mask; // bool, [b, h, sq, sk] by the strides mask_st
  const void* bias;    // fp32 or bf16 (bias_bf16), by the strides bias_st
  const uint8_t* live; // [b, *, n_qtiles, n_groups]: 0 dead, 1 some, 2 all live
  long long mask_st[4], bias_st[4];  // element strides of (b, h, row, col)
  long long live_bst, live_hst;      // batch and head strides of live
  int window;          // 0: none
  int bias_bf16;
};
// the unmasked instances' (empty) operand
struct NoMask {};
template <bool MASKED>
using MaskOf = std::conditional_t<MASKED, MaskArgs, NoMask>;

__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_f32(float x) { return x; }

__device__ inline void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ inline void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// PREQ: the score of element e of an n-tile, (s * rf) * k_scale + col_bias,
// rf the row factor, from its column pair's staged (scale, scale, bias, bias)
__device__ inline float preq_score(int s, float rf, float4 col, int e) {
  return (float)s * rf * ((e & 1) ? col.y : col.x) + ((e & 1) ? col.w : col.z);
}

// ---------------------------------------------------------------------------
// the masks' pieces
// ---------------------------------------------------------------------------

// one row's operands of the element rule (rows >= sq read as 0s)
struct RowMask {
  int seg, lo, hi, pos;
};

__device__ inline RowMask row_mask(const MaskArgs& mk, size_t r, bool in) {
  RowMask m{0, 0, 0, 0};
  if (!in) return m;
  if (mk.q_seg != nullptr) m.seg = mk.q_seg[r];
  if (mk.kv_lo != nullptr) {
    m.lo = mk.kv_lo[r];
    m.hi = mk.kv_hi[r];
  }
  if (mk.q_pos != nullptr) m.pos = mk.q_pos[r];
  return m;
}

// the element rule's id, range, position and bool-mask parts (causal, the
// window and the bias are applied by the caller): whether (row, col) is live
__device__ inline bool element_live(const MaskArgs& mk, RowMask rm, int bi, int h, int row,
                                    int col, int sq, int sk) {
  if (row >= sq || col >= sk) return false;
  const size_t kc = (size_t)bi * sk + col;
  if (mk.q_seg != nullptr && rm.seg != mk.kv_seg[kc]) return false;
  if (mk.kv_lo != nullptr && (col < rm.lo || col >= rm.hi)) return false;
  if (mk.q_pos != nullptr && mk.kv_pos[kc] > rm.pos) return false;
  if (mk.mask != nullptr &&
      mk.mask[bi * mk.mask_st[0] + h * mk.mask_st[1] + row * mk.mask_st[2] +
              col * mk.mask_st[3]] == 0)
    return false;
  return true;
}

// The KV tiles [*first, *end) of a CTA of `rows` Q rows from q0, before the
// liveness table: causal ends at the tile of its last row, a window starts
// at the tile of its first row's first key, the range form keeps [min
// kv_lo, max kv_hi) over its rows (none where no row has a key).  Every
// thread of the CTA calls it (it holds two __syncthreads); s_range is two
// ints of shared memory.
template <int KT, bool CAUSAL>
__device__ inline void mask_range(const MaskArgs& mk, int bi, int q0, int rows, int sq, int sk,
                                  int* s_range, int* first, int* end) {
  *first = 0;
  *end = (sk + KT - 1) / KT;
  if (CAUSAL) *end = min(*end, (q0 + rows - 1) / KT + 1);
  if (mk.window > 0) *first = max(0, q0 - mk.window + 1) / KT;
  if (mk.kv_lo == nullptr) return;
  if (threadIdx.x == 0) {
    s_range[0] = INT_MAX;
    s_range[1] = INT_MIN;
  }
  __syncthreads();
  const int r = q0 + (int)threadIdx.x;
  if ((int)threadIdx.x < rows && r < sq) {
    atomicMin(&s_range[0], mk.kv_lo[(size_t)bi * sq + r]);
    atomicMax(&s_range[1], mk.kv_hi[(size_t)bi * sq + r]);
  }
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];
  if (hi > lo) {
    *first = max(*first, lo / KT);
    *end = min(*end, (hi + KT - 1) / KT);
  } else {
    *end = *first;  // no row of the CTA has a live key
  }
}

// The walk over a CTA's listed KV tiles of KT columns: the liveness
// table's row of each 64 rows of the CTA (t1 null where the CTA has one,
// or its second 64 rows lie past sq); a tile is listed unless every row
// marks its 128-column group dead.  Without a table (and in the unmasked
// instances, default-constructed) every tile is listed.
template <int KT>
struct TileWalk {
  const uint8_t* t0 = nullptr;
  const uint8_t* t1 = nullptr;
  int end = 0;

  TileWalk() = default;
  __device__ TileWalk(const MaskArgs& mk, int bi, int h, int q0, int rows, int sq, int sk,
                      int end_) : end(end_) {
    if (mk.live != nullptr) {
      const int n_groups = (sk + BN - 1) / BN;
      t0 = mk.live + bi * mk.live_bst + h * mk.live_hst + (size_t)(q0 / kQTile) * n_groups;
      if (rows > kQTile && q0 + kQTile < sq) t1 = t0 + n_groups;
    }
  }
  __device__ bool listed(int j) const {
    if (t0 == nullptr) return true;
    const int g = j / (BN / KT);
    return t0[g] != 0 || (t1 != nullptr && t1[g] != 0);
  }
  // the first listed tile at or after j, or end
  __device__ int next(int j) const {
    while (j < end && !listed(j)) ++j;
    return j;
  }
  // the table's entry of tile j for the 64 rows of table row `which`
  // (0 or 1): 1 (not known) where there is no table; 0 where that row lies
  // past sq
  __device__ int state(int j, int which) const {
    if (t0 == nullptr) return 1;
    const uint8_t* t = which ? t1 : t0;
    return t == nullptr ? 0 : t[j / (BN / KT)];
  }
};

// The staged bias (STAGED): a consumer thread's column pairs of one tile in
// its warpgroup's shared-memory buffer, pair p (= 2n + the row) of thread x
// at (p * kWarpgroup + x) * 2 * esz bytes (esz 4 for fp32, 2 for bf16), so
// that a warp's reads of one pair are contiguous; sb is the shared-memory
// address of the thread's first
template <int KT>
constexpr int kBiasStageBytes = KT / 4 * kWarpgroup * 8;  // a warpgroup's buffer, fp32

// cp.async of tile kv0's bias pairs of the thread's two rows into its
// slots, columns past sk zero-filled (they are masked), one group a tile.
// Only for a bias whose column pairs are contiguous and aligned (the
// launch's choice: unit column stride, even other strides, aligned base)
template <int KT>
__device__ inline void bias_stage(const MaskArgs& mk, uint32_t sb, int bi, int h, int row0,
                                  int row1, int t, int kv0, int sq, int sk) {
  const int esz = mk.bias_bf16 ? 2 : 4;
  const long long bh = bi * mk.bias_st[0] + h * mk.bias_st[1];
  const char* r0 = static_cast<const char*>(mk.bias) +
                   (bh + (long long)min(row0, sq - 1) * mk.bias_st[2]) * esz;
  const char* r1 = static_cast<const char*>(mk.bias) +
                   (bh + (long long)min(row1, sq - 1) * mk.bias_st[2]) * esz;
  // one pair at a time, not unrolled: the copies hold no registers while
  // the tile's S, P and O do
#pragma unroll 1
  for (int p = 0; p < KT / 4; ++p) {
    const int c = kv0 + (p >> 1) * 8 + t * 2;
    const int keep = (c + 1 < sk ? 2 : c < sk ? 1 : 0) * esz;  // source bytes, the rest 0
    const char* src = ((p & 1) ? r1 : r0) + (long long)min(c, sk - 1) * esz;
    const uint32_t d = sb + p * kWarpgroup * 2 * esz;
    if (esz == 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(keep)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(keep)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A consumer thread's masked pass over its dequantized S of one KV tile at
// kv0: sf[4n + e] is row (e < 2 ? row0 : row1), column kv0 + 8n + 2t + (e &
// 1), as in a wgmma C fragment.  Adds the bias (times log2 e),
// sets dead elements to -inf (past sk, right of the causal diagonal, out of
// the window, the element rule), and returns the two rows' maxima over the
// thread's elements.  lv: the warpgroup's table entry of the tile (1
// where there is no table, so ids or a mask take the rule); edge:
// the tile reaches past sk or right of a row's diagonal (the unmasked
// kernel's own test).  STAGED: the bias is the tile's pairs that
// bias_stage copied to sb (waited on here), else each thread loads its own.
template <int KT, bool CAUSAL, bool STAGED = false>
__device__ inline void mask_scores(float* sf, const MaskArgs& mk, int bi, int h, int row0,
                                   int row1, int t, int kv0, int sq, int sk, int lv, bool edge,
                                   float& mx0, float& mx1, uint32_t sb = 0) {
  constexpr int NE = KT / 2;  // a thread's elements of the tile
  static_assert(NE <= 64, "mask_scores: one bit an element of a 64-bit mask");
  if constexpr (STAGED) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    const bool bf = mk.bias_bf16;
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const uint32_t a = sb + (2 * n + e2) * kWarpgroup * (bf ? 4 : 8);
        float x, y;
        if (bf) {
          uint32_t w;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(w) : "r"(a));
          const float2 v = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
          x = v.x, y = v.y;
        } else {
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x), "=f"(y) : "r"(a));
        }
        sf[4 * n + 2 * e2] += x * kLog2e;
        sf[4 * n + 2 * e2 + 1] += y * kLog2e;
      }
  } else if (mk.bias != nullptr) {
    const long long bh = bi * mk.bias_st[0] + h * mk.bias_st[1];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {  // the thread's two rows; rows >= sq read row sq - 1
      const long long rb = bh + (long long)min(e2 ? row1 : row0, sq - 1) * mk.bias_st[2];
      // a column pair in one load: contiguous columns and an aligned first
      const bool pair = mk.bias_st[3] == 1 && (rb & 1) == 0 &&
                        (reinterpret_cast<uintptr_t>(mk.bias) & (mk.bias_bf16 ? 3 : 7)) == 0;
#pragma unroll
      for (int n = 0; n < KT / 8; ++n) {
        const int c = kv0 + n * 8 + t * 2;  // even; columns >= sk are masked below
        float b0, b1;
        if (pair && c + 1 < sk) {
          if (mk.bias_bf16) {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const __nv_bfloat16*>(mk.bias) + rb + c));
            b0 = v.x, b1 = v.y;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(
                static_cast<const float*>(mk.bias) + rb + c);
            b0 = v.x, b1 = v.y;
          }
        } else {
          const long long e0 = rb + (long long)min(c, sk - 1) * mk.bias_st[3];
          const long long e1 = rb + (long long)min(c + 1, sk - 1) * mk.bias_st[3];
          if (mk.bias_bf16) {
            const __nv_bfloat16* bp = static_cast<const __nv_bfloat16*>(mk.bias);
            b0 = __bfloat162float(bp[e0]), b1 = __bfloat162float(bp[e1]);
          } else {
            const float* bp = static_cast<const float*>(mk.bias);
            b0 = bp[e0], b1 = bp[e1];
          }
        }
        sf[4 * n + 2 * e2] += b0 * kLog2e;
        sf[4 * n + 2 * e2 + 1] += b1 * kLog2e;
      }
      // the next tile's columns of this row into L2, a 128-byte line a
      // thread of the quad, so that its loads wait on L2, not on memory
      const int esz = mk.bias_bf16 ? 2 : 4, c = kv0 + KT + t * (128 / esz);
      if (mk.bias_st[3] == 1 && t * 128 < KT * esz && c < sk)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            static_cast<const char*>(mk.bias) + (rb + c) * esz));
    }
  }
  // the element rule, where the tile needs it: one bit a dead element
  uint64_t dead = 0;
  const bool ids = mk.q_seg != nullptr || mk.mask != nullptr;
  bool rule = (lv != 2 && ids) || mk.q_pos != nullptr;
  if (mk.kv_lo != nullptr && !rule) {
    const size_t rb = (size_t)bi * sq;
    const RowMask r0 = row_mask(mk, rb + row0, row0 < sq), r1 = row_mask(mk, rb + row1, row1 < sq);
    rule = !(r0.lo <= kv0 && kv0 + KT <= r0.hi && r1.lo <= kv0 && kv0 + KT <= r1.hi);
  }
  if (lv == 0) {
    dead = ~0ull;  // the table marks the tile dead for these rows
  } else if (rule) {
    const size_t rb = (size_t)bi * sq;
    const RowMask r0 = row_mask(mk, rb + row0, row0 < sq), r1 = row_mask(mk, rb + row1, row1 < sq);
#pragma unroll 1
    for (int idx = 0; idx < NE; ++idx) {
      const bool top = (idx & 3) < 2;
      const int col = kv0 + (idx >> 2) * 8 + t * 2 + (idx & 1);
      if (!element_live(mk, top ? r0 : r1, bi, h, top ? row0 : row1, col, sq, sk))
        dead |= 1ull << idx;
    }
  }
  const bool win = mk.window > 0 && kv0 <= row1 - mk.window;
  if (edge || win || dead != 0) {
#pragma unroll
    for (int idx = 0; idx < NE; ++idx) {
      const int col = kv0 + (idx >> 2) * 8 + t * 2 + (idx & 1);
      const int row = (idx & 3) < 2 ? row0 : row1;
      if (col >= sk || (CAUSAL && col > row) || (mk.window > 0 && col <= row - mk.window) ||
          ((dead >> idx) & 1))
        sf[idx] = -INFINITY;
    }
  }
#pragma unroll
  for (int n = 0; n < KT / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(sf[4 * n], sf[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(sf[4 * n + 2], sf[4 * n + 3]));
  }
}

// the masked entry points' mask operands into *out, from their arguments in
// sage_attn_fwd_masked's order (attention_fwd_masked.cu); false where these
// break its rules: a window >= 0, and > 0 only with causal; ids, ranges and
// positions in pairs
inline bool mask_args(MaskArgs* out, int causal, const void* q_seg, const void* kv_seg,
                      const void* kv_lo, const void* kv_hi, const void* q_pos,
                      const void* kv_pos, const void* mask, const void* bias,
                      const void* live, long long mask_sb, long long mask_sh,
                      long long mask_sr, long long mask_sc, long long bias_sb,
                      long long bias_sh, long long bias_sr, long long bias_sc,
                      long long live_sb, long long live_sh, int window, int bias_bf16) {
  if (window < 0 || (window > 0 && !causal) || (q_seg == nullptr) != (kv_seg == nullptr) ||
      (kv_lo == nullptr) != (kv_hi == nullptr) || (q_pos == nullptr) != (kv_pos == nullptr))
    return false;
  *out = MaskArgs{(const int*)q_seg, (const int*)kv_seg, (const int*)kv_lo,
                  (const int*)kv_hi, (const int*)q_pos, (const int*)kv_pos,
                  (const uint8_t*)mask, bias, (const uint8_t*)live,
                  {mask_sb, mask_sh, mask_sr, mask_sc}, {bias_sb, bias_sh, bias_sr, bias_sc},
                  live_sb, live_sh, window, bias_bf16};
  return true;
}

}  // namespace
