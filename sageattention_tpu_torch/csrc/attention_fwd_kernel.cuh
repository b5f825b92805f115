// Fused SageAttention forward for Hopper (sm_90a): int8 Q.K^T, bf16 P.V.
//
// The kernels of attention_fwd_masked.cu (MASKED = true) and the masked
// instances of attention_fwd_preq.cu (PREQ = true) at head dims 64 and
// 128, of attention_fwd_masked_hd256.cu and attention_fwd_preq_hd256.cu
// (masked, PREQ) at 256, and of attention_fwd_masked_wide.cu and the
// masked ones of attention_fwd_preq_wide.cu at 384 and 512 (O split by
// columns over CTAs, kDv); their body is attention_fwd_body.cuh.  Every
// unmasked instance is a TMA-fed wgmma kernel that computes the same and
// uses this header's operand types and helpers: attention_fwd_sm90.cuh's
// at 64, 128 and 256, attention_fwd_sm90_wide.cuh's (O's columns split
// between two warpgroups of one CTA) at 384 and 512.  Each source
// instantiates only its own kernels, so the sources build in parallel:
// every masked statement sits under `if constexpr (MASKED)`, every
// pre-quantized one under `if constexpr (PREQ)`, and the operands of
// either are an empty struct where its flag is off.
//
// Replaces the TPU kernel attention_pallas.py:sage_attention_fused
// (_kernel / _kernel_single, bodies _compute_parts, _merge_parts,
// _merge_into_scratch): non-causal and causal (top-left, col <= row), GQA,
// the base-2 LSE, per-row Q quantization inside the kernel, ragged sq / sk,
// and V stored as bf16 or as int8 / fp8 e4m3 / fp8 e5m2 codes with a
// per-channel scale and the smooth-v mean in the epilogue (the TPU
// kernel's default pv_compute="bf16").  Codes are widened to bf16 as the
// V tile is stored to shared memory (every int8, e4m3 and e5m2 value is
// exact in bf16), so P.V runs on the same bf16 tensor cores for every V
// type.  Native fp8 P.V would round P to fp8, which the JAX kernel does
// not do, so it is not this kernel's arithmetic.
//
// One CTA of four warps per (b, hq, 64-row Q tile); each warp owns 16 Q
// rows.  The CTA
//   1. quantizes its Q rows into shared memory: amax per row, the spec's
//      scale = max(amax,1e-30)*(1/127), r = 1/scale, roundf(x*r), with
//      sm_scale*log2(e) folded into the row scale as
//      max(amax,1e-30) * qs_mul, qs_mul = f32(1/127) * f32(sm_scale*log2e)
//      (the form XLA compiles the spec's fold into);
//   2. loops over KV tiles of 128 columns, which is also the K-scale group
//      (one k_scale per tile); from D = 256 on over tiles of 64 (kKvTile),
//      two to a group, each reading its group's scale.  K rows >= sk are zero-filled in shared
//      memory and their columns masked;
//   3. per tile: S = Q.K^T on the int8 tensor cores
//      (mma.sync.m16n8k32.s32.s8.s8.s32, K's rows are the "col" operand),
//      dequantized by q_scale[row] * k_scale[tile]; base-2 online softmax
//      with the finite initial max NEG_INIT = -1e30 (masked scores are
//      -inf, so exp2 gives 0 and no inf - inf arises); P rounded to bf16
//      and P.V on the bf16 tensor cores (mma.sync.m16n8k16, fp32
//      accumulate, V fragments by ldmatrix.trans);
//   4. writes o = (acc / l) * v_scale + v_mean (each if given) in q's
//      dtype and, if asked, lse2 = log2(l) + m.  Rows >= sq are not
//      written.  When causal, KV tiles wholly above the diagonal of the Q
//      tile are skipped.
// Above D = 256 (the masked instances only) a CTA computes one column
// slice of O, kDv<D> = D / 2 columns, and the grid's x axis walks each Q
// tile's two slices; every slice runs steps 1-3a over the whole D by the
// same instructions (so m, l and lse2 agree bit for bit), steps 3c-4 over
// its own V and O columns, and slice 0 writes lse2.  A warp's fp32 O
// accumulator over the whole D would take D / 2 registers a thread, 192 at
// 384 and 256 at 512; the split keeps it at 96 or 128, and costs Q.K^T
// (with Q's quantization and the masks) done in both slices: of the int8
// Q.K^T and bf16 P.V work Q.K^T is half, so the products take 1.5x their
// single-pass count.
//
// The pre-quantized instantiation (PREQ) is kernel 1's slices (h), (i) and
// (k) (attention_pallas.py:661-680, 1455-1457, 1837-1845): Q arrives as
// int8 codes with per-row fp32 scales that hold sm_scale*log2(e) (from
// csrc/quant_q.cu at 8 or 4 bits, or the qk_quant_gran granularities
// quantized in PyTorch), so step 1 copies the codes and scales instead of
// quantizing; K comes with one scale per 128-row tile or one per row, and
// an optional per-(b, q head) column bias in the base-2 domain (smooth_q's
// qm . (k - km), indexed by the query head: each head of a GQA group has
// its own qm).  A score is s * (q_scale[row] * k_scale[tile]) +
// col_bias[col] with per-tile K scales and (s * q_scale[row]) *
// k_scale[col] + col_bias[col] with per-row ones, the TPU kernel's orders
// (attention_pallas.py:661-680), before the masked instantiation's bias and
// masks.  Per tile, each column pair's K scales (1 where the tile's scale
// rides in the row factor) and biases (0 without a bias) are staged in
// shared memory as one float4, which a thread reads once per 8-column
// n-tile: the dequantization costs one FFMA more per score than the default
// instantiation's multiply.  The ±7 codes of qk_bits=4
// run the same int8 MMA: sm_90 has no int4 MMA, and the TPU kernel's int4
// operand type changes its speed, not its numbers.  The output type (bf16
// or fp32) is an argument: the codes carry no input type to name it.
//
// The masked instantiation adds kernel 1's masking slices (c)-(g)
// (attention_pallas.py:575-650, 689-705, 750-777): element (row, col) is
// live when col < sk, the bool mask is set, the segment ids match or
// kv_lo[row] <= col < kv_hi[row] (varlen's range form), kv_pos[col] <=
// q_pos[row], col <= row when causal and col > row - window with a
// window.  A live score is s * q_scale * k_scale + bias * log2(e); a dead
// one is -inf.  A row with no live key (l == 0) writes o = 0 (no v_mean)
// and lse2 = -inf, as the TPU kernel does.  The mask and the bias are read
// through four element strides (b, h, row, col), so a head-, batch-, row-
// or column-broadcast operand is never copied out per head.  Tiles are
// skipped as the TPU kernel's band grid and msum liveness summary skip
// them: a window starts each CTA at KV tile (q0 - window + 1) / 128, the
// range form limits it to [min kv_lo, max kv_hi) of its 64 rows, and a
// per-(Q tile, KV tile) liveness table (built by the wrapper from segment
// ids and the bool mask) skips the tiles it marks dead.  The element rule
// runs only on tiles that need it: a tile inside every range of the
// thread's rows, or that the table marks wholly live, takes the unmasked
// path's causal and ragged-edge checks alone.  Where it runs, a loop that
// is not unrolled (one copy of the rule's code) sets one bit per element
// of a 64-bit dead mask, which an unrolled pass tests with constant
// shifts; the bias is added in a pass of its own, read through per-row
// bases.  The unmasked instantiations keep their single fused pass.
//
// Bound: operations, whatever V's type.  At the CogVideoX-2B layer shape
// (b=1, h=30, s=17,776, d=64) Q.K^T is 1.21e12 int8 ops and P.V 1.21e12
// bf16 FLOP, about 1.84 ms on an H100 SXM's data-sheet peaks, while the
// bytes (Q, K, V, O once each) take about 0.03 ms.  With masks the live
// (row, col) pairs set the work.  This body is written to be right:
// mma.sync (not wgmma), plain synchronous tile loads (no TMA, no cp.async
// pipeline) and no warp specialisation; attention_fwd_sm90.cuh has all
// three for the unmasked instances.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

// V storage: bf16, or codes of one byte
enum VKind { kVBf16 = 0, kVInt8 = 1, kVE4M3 = 2, kVE5M2 = 3 };

constexpr int BM = 64;    // Q rows per CTA
constexpr int BN = 128;   // the K-scale group: one k_scale a 128-column group
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INIT = -1e30f;
constexpr float kInvQmax = (float)(1.0 / 127.0);
constexpr float kLog2e = 1.4426950408889634f;

// KV columns a tile: the K-scale group, or half of it from D = 256 on,
// where a warp's fp32 O accumulator alone takes 128 registers a thread and a
// 128-column S tile (64 more) would leave nothing for the rest
template <int D>
constexpr int kKvTile = D >= 256 ? BN / 2 : BN;

// O columns a CTA of this body computes: all D up to 256; above (the masked
// instances), half of them (192 at D = 384, 256 at 512), a grid axis over
// the column slices, so that a warp's O accumulator stays at D = 256's 128
// registers a thread or under
template <int D>
constexpr int kDv = D > 256 ? D / 2 : D;

template <int D>
struct Layout {
  static constexpr int QS = D + 16;         // int8 row stride of Q and K (bytes)
  static constexpr int VS = kDv<D> + 8;     // bf16 row stride of V's column slice (elements)
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BM * QS;
  static constexpr int v_off = k_off + kKvTile<D> * QS;
  static constexpr int qs_off = v_off + kKvTile<D> * VS * 2;
  static constexpr int bytes = qs_off + BM * 4;
};

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
  const uint8_t* live; // [b, *, n_qtiles, n_ktiles]: 0 dead, 1 some, 2 all live
  long long mask_st[4], bias_st[4];  // element strides of (b, h, row, col)
  long long live_bst, live_hst;      // batch and head strides of live
  int window;          // 0: none
  int bias_bf16;
};
struct NoMask {};
template <bool MASKED>
using MaskOf = std::conditional_t<MASKED, MaskArgs, NoMask>;

// the pre-quantized instantiation's operands
struct PreqArgs {
  const int8_t* q;        // int8 codes [b, hq, sq, D]
  const float* q_scale;   // fp32 [b, hq, sq], sm_scale*log2(e) folded in
  const float* col_bias;  // fp32 [b, hq, sk] in the base-2 domain, or null
  int ks_per_row;         // k_scale is [b, hkv, sk] (1) or [b, hkv, n_tiles] (0)
  int o_f32;              // o is fp32 (1) or bf16 (0)
};
struct NoPreq {};
template <bool PREQ>
using PreqOf = std::conditional_t<PREQ, PreqArgs, NoPreq>;

// dynamic shared memory: the layout, and with PREQ a tile's K scales and
// column bias, a float4 (scale, scale, bias, bias) a column pair
template <int D, bool PREQ>
constexpr int smem_bytes() {
  return Layout<D>::bytes + (PREQ ? 2 * BN * 4 : 0);
}

__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_f32(float x) { return x; }

__device__ inline void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ inline void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// one V code as fp32 (exact)
template <int VK>
__device__ inline float code_to_f32(uint8_t c) {
  if constexpr (VK == kVInt8) {
    return (float)(int8_t)c;
  } else {
    __half_raw h = __nv_cvt_fp8_to_halfraw(c, VK == kVE4M3 ? __NV_E4M3 : __NV_E5M2);
    return __half2float(__half(h));
  }
}

// eight V codes -> eight bf16 values (16 bytes)
template <int VK>
__device__ inline uint4 codes_to_bf16x8(uint2 raw) {
  const uint8_t* c = reinterpret_cast<const uint8_t*>(&raw);
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = pack_bf16(code_to_f32<VK>(c[2 * j]), code_to_f32<VK>(c[2 * j + 1]));
  return out;
}

// one row's operands of the element rule, read once per row
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

// the bias at element offset e, in fp32
__device__ inline float bias_at(const MaskArgs& mk, long long e) {
  return mk.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(mk.bias)[e])
                      : static_cast<const float*>(mk.bias)[e];
}

// PREQ: the score of element e of an n-tile, (s * rf) * k_scale + col_bias,
// rf the row factor, from its column pair's staged (scale, scale, bias, bias)
__device__ inline float preq_score(int s, float rf, float4 col, int e) {
  return (float)s * rf * ((e & 1) ? col.y : col.x) + ((e & 1) ? col.w : col.z);
}

// whether K's scales are per row (PREQ with per-row scales) or per tile
template <bool PREQ>
__device__ inline bool ks_per_row(const PreqOf<PREQ>& pq) {
  if constexpr (PREQ) return pq.ks_per_row;
  return false;
}

// whether the row's key range [lo, hi) holds the whole tile [kv0, kv0 + KT)
template <int KT>
__device__ inline bool covers(RowMask rm, int kv0) {
  return rm.lo <= kv0 && kv0 + KT <= rm.hi;
}

template <int D, bool CAUSAL, typename T, int VK, bool MASKED, bool PREQ>
__global__ void __launch_bounds__(NTHREADS)
sage_attn_fwd_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                     const float* __restrict__ k_scale, const void* __restrict__ v,
                     const float* __restrict__ v_scale, const float* __restrict__ v_mean,
                     T* __restrict__ o, float* __restrict__ lse2, int hq, int hkv, int sq,
                     int sk, float qs_mul, const MaskOf<MASKED> mk, const PreqOf<PREQ> pq) {
#include "attention_fwd_body.cuh"
}

// the launch's operands, as sage_attn_fwd takes them
struct Args {
  const void *q, *k, *k_scale, *v, *v_scale, *v_mean;
  void *o, *lse2;
  int b, hq, hkv, sq, sk;
  float qs_mul;
};

template <int D, bool PREQ, typename T, bool MASKED, typename Kernel>
int launch_kernel(Kernel kern, const Args& a, const MaskOf<MASKED>& mk, const PreqOf<PREQ>& pq,
                  cudaStream_t st) {
  const int smem = smem_bytes<D, PREQ>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // above D = 256 the x axis also walks O's column slices, a Q tile's
  // slices side by side (they read the same Q and K tiles)
  dim3 grid((a.sq + BM - 1) / BM * (D / kDv<D>), a.hq, a.b);
  kern<<<grid, NTHREADS, smem, st>>>((const T*)a.q, (const int8_t*)a.k, (const float*)a.k_scale,
                                     a.v, (const float*)a.v_scale, (const float*)a.v_mean,
                                     (T*)a.o, (float*)a.lse2, a.hq, a.hkv, a.sq, a.sk, a.qs_mul,
                                     mk, pq);
  return (int)cudaGetLastError();
}

template <int D, bool CAUSAL, typename T, int VK, bool MASKED, bool PREQ>
int launch(const Args& a, const MaskOf<MASKED>& mk, const PreqOf<PREQ>& pq, cudaStream_t st) {
  return launch_kernel<D, PREQ, T, MASKED>(sage_attn_fwd_kernel<D, CAUSAL, T, VK, MASKED, PREQ>,
                                           a, mk, pq, st);
}

template <int D, bool CAUSAL, typename T, bool MASKED, bool PREQ>
int launch_v(int v_kind, const Args& a, const MaskOf<MASKED>& mk, const PreqOf<PREQ>& pq,
             cudaStream_t st) {
  switch (v_kind) {
    case kVBf16: return launch<D, CAUSAL, T, kVBf16, MASKED, PREQ>(a, mk, pq, st);
    case kVInt8: return launch<D, CAUSAL, T, kVInt8, MASKED, PREQ>(a, mk, pq, st);
    case kVE4M3: return launch<D, CAUSAL, T, kVE4M3, MASKED, PREQ>(a, mk, pq, st);
    default: return launch<D, CAUSAL, T, kVE5M2, MASKED, PREQ>(a, mk, pq, st);
  }
}

template <int D, typename T, bool MASKED, bool PREQ>
int launch_c(bool causal, int v_kind, const Args& a, const MaskOf<MASKED>& mk,
             const PreqOf<PREQ>& pq, cudaStream_t st) {
  return causal ? launch_v<D, true, T, MASKED, PREQ>(v_kind, a, mk, pq, st)
                : launch_v<D, false, T, MASKED, PREQ>(v_kind, a, mk, pq, st);
}

// the instances of the one head dim D, without PREQ: causal x V kind x q
// dtype (16 of them); checks the shape arguments first
template <int D, bool MASKED>
int launch_fwd_d(const Args& a, const MaskOf<MASKED>& mk, int d, int causal, int q_is_f32,
                 int v_kind, int group, void* stream) {
  if (group != BN || a.hkv <= 0 || a.hq % a.hkv != 0 || d != D || v_kind < 0 || v_kind > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return q_is_f32 ? launch_c<D, float, MASKED, false>(causal, v_kind, a, mk, NoPreq{}, st)
                  : launch_c<D, __nv_bfloat16, MASKED, false>(causal, v_kind, a, mk, NoPreq{}, st);
}

// the PREQ instances of the one head dim D: causal x V kind (8 of them; the
// output type is pq.o_f32); checks the shape arguments first
template <int D, bool MASKED>
int launch_fwd_preq_d(const Args& a, const MaskOf<MASKED>& mk, const PreqArgs& pq, int d,
                      int causal, int v_kind, int group, void* stream) {
  if (group != BN || a.hkv <= 0 || a.hq % a.hkv != 0 || d != D || v_kind < 0 || v_kind > 3)
    return (int)cudaErrorInvalidValue;
  return launch_c<D, __nv_bfloat16, MASKED, true>(causal, v_kind, a, mk, pq, (cudaStream_t)stream);
}

// checks the shape arguments and launches one of the instantiations of
// (MASKED, PREQ) at head dim 64 or 128: causal x V kind, and the q dtype
// without PREQ (32 a source); PREQ's output type is its argument o_f32.
// The D = 256 instances are sources of their own (attention_fwd_hd256.cu,
// attention_fwd_masked_hd256.cu through launch_fwd_d, and
// attention_fwd_preq_hd256.cu through launch_fwd_preq_d), which build beside
// these in parallel
template <bool MASKED, bool PREQ>
int launch_fwd(const Args& a, const MaskOf<MASKED>& mk, const PreqOf<PREQ>& pq, int d,
               int causal, int q_is_f32, int v_kind, int group, void* stream) {
  if constexpr (!PREQ) {
    return d == 64 ? launch_fwd_d<64, MASKED>(a, mk, d, causal, q_is_f32, v_kind, group, stream)
                   : launch_fwd_d<128, MASKED>(a, mk, d, causal, q_is_f32, v_kind, group, stream);
  } else {
    return d == 64 ? launch_fwd_preq_d<64, MASKED>(a, mk, pq, d, causal, v_kind, group, stream)
                   : launch_fwd_preq_d<128, MASKED>(a, mk, pq, d, causal, v_kind, group, stream);
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
