// Fused SageAttention forward for Hopper (sm_90a): int8 Q.K^T, bf16 P.V.
//
// The kernel body shared by attention_fwd.cu (no masks: MASKED = false) and
// attention_fwd_masked.cu (MASKED = true).  Each source instantiates only
// its own 32 kernels, so the two build in parallel, and the unmasked
// instantiations compile to the code they had before masks existed: every
// masked statement sits under `if constexpr (MASKED)` and the masked
// operands are an empty struct there.
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
//      (one k_scale per tile).  K rows >= sk are zero-filled in shared
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
// (row, col) pairs set the work.  This first kernel is written to be
// right: mma.sync (not wgmma), plain synchronous tile loads (no TMA, no
// cp.async pipeline) and no warp specialisation; those are later work.

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
constexpr int BN = 128;   // KV columns per tile == K-scale group
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NT = BN / 8;  // 8-column n-tiles of S per warp
constexpr float NEG_INIT = -1e30f;
constexpr float kInvQmax = (float)(1.0 / 127.0);
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int QS = D + 16;  // int8 row stride of Q and K (bytes)
  static constexpr int VS = D + 8;   // bf16 row stride of V (elements)
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + BM * QS;
  static constexpr int v_off = k_off + BN * QS;
  static constexpr int qs_off = v_off + BN * VS * 2;
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

// whether the row's key range [lo, hi) holds the whole tile [kv0, kv0 + BN)
__device__ inline bool covers(RowMask rm, int kv0) {
  return rm.lo <= kv0 && kv0 + BN <= rm.hi;
}

template <int D, bool CAUSAL, typename T, int VK, bool MASKED>
__global__ void __launch_bounds__(NTHREADS)
sage_attn_fwd_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                     const float* __restrict__ k_scale, const void* __restrict__ v,
                     const float* __restrict__ v_scale, const float* __restrict__ v_mean,
                     T* __restrict__ o, float* __restrict__ lse2, int hq, int hkv, int sq,
                     int sk, float qs_mul, const MaskOf<MASKED> mk) {
  using L = Layout<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem + L::q_off);
  int8_t* sK = reinterpret_cast<int8_t*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* sQs = reinterpret_cast<float*>(smem + L::qs_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma groupID, thread in group
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const size_t q_base = (((size_t)bi * hq + h) * sq) * D;
  const size_t kv_base = (((size_t)bi * hkv + hk) * sk) * D;
  const int n_tiles_all = (sk + BN - 1) / BN;
  const float* ks_row = k_scale + ((size_t)bi * hkv + hk) * n_tiles_all;

  // ---- 1. per-row int8 Q quantization (each warp its 16 rows) ----------
  for (int rr = 0; rr < 16; ++rr) {
    const int row = warp * 16 + rr;
    const int gr = q0 + row;
    float x[D / 32];
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      x[e] = gr < sq ? to_f32(q[q_base + (size_t)gr * D + lane + 32 * e]) : 0.f;
      amax = fmaxf(amax, fabsf(x[e]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = fmaxf(amax, 1e-30f) * kInvQmax;
    const float r = 1.0f / scale;
#pragma unroll
    for (int e = 0; e < D / 32; ++e)
      sQ[row * L::QS + lane + 32 * e] = (int8_t)fminf(fmaxf(roundf(x[e] * r), -127.f), 127.f);
    if (lane == 0) sQs[row] = fmaxf(amax, 1e-30f) * qs_mul;
  }
  __syncwarp();
  const float qs0 = sQs[warp * 16 + g], qs1 = sQs[warp * 16 + g + 8];
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this thread's rows

  float m0 = NEG_INIT, m1 = NEG_INIT;  // running max (base 2)
  float l0 = 0.f, l1 = 0.f;            // this thread's partial row sums
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int j_first = 0;
  int n_tiles = n_tiles_all;
  if (CAUSAL) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);
  // masked: the rows' operands, the bias's row offsets, and the tile range
  // the window and the varlen ranges leave
  RowMask rm0{}, rm1{};
  long long bias_r0 = 0, bias_r1 = 0;
  if constexpr (MASKED) {
    const size_t rb = (size_t)bi * sq;
    rm0 = row_mask(mk, rb + row0, row0 < sq);
    rm1 = row_mask(mk, rb + row1, row1 < sq);
    const long long bh = bi * mk.bias_st[0] + h * mk.bias_st[1];
    bias_r0 = bh + (long long)min(row0, sq - 1) * mk.bias_st[2];  // rows >= sq read row sq-1
    bias_r1 = bh + (long long)min(row1, sq - 1) * mk.bias_st[2];
    if (mk.window > 0) j_first = max(0, q0 - mk.window + 1) / BN;
    if (mk.kv_lo != nullptr) {
      __shared__ int s_lo, s_hi;
      if (tid == 0) {
        s_lo = INT_MAX;
        s_hi = INT_MIN;
      }
      __syncthreads();
      if (tid < BM && q0 + tid < sq) {
        atomicMin(&s_lo, mk.kv_lo[rb + q0 + tid]);
        atomicMax(&s_hi, mk.kv_hi[rb + q0 + tid]);
      }
      __syncthreads();
      if (s_hi > s_lo) {
        j_first = max(j_first, s_lo / BN);
        n_tiles = min(n_tiles, (s_hi + BN - 1) / BN);
      } else {
        n_tiles = 0;  // no row of the tile has a live key
      }
    }
  }

  for (int j = j_first; j < n_tiles; ++j) {
    int lv = 2;  // the tile's liveness: 0 dead, 1 some, 2 all (ids and mask)
    if constexpr (MASKED) {
      if (mk.live != nullptr) {
        lv = mk.live[bi * mk.live_bst + h * mk.live_hst + (size_t)blockIdx.x * n_tiles_all + j];
        if (lv == 0) continue;  // the same for every thread of the CTA
      }
    }
    const int kv0 = j * BN;
    __syncthreads();  // the previous tile's K/V are no longer read
    // ---- 2. K and V tiles into shared memory, zero past sk ---------------
    for (int i = tid; i < BN * (D / 16); i += NTHREADS) {
      const int r = i / (D / 16), c = i % (D / 16);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kv0 + r < sk) val = *reinterpret_cast<const uint4*>(k + kv_base + (size_t)(kv0 + r) * D + c * 16);
      *reinterpret_cast<uint4*>(sK + r * L::QS + c * 16) = val;
    }
    for (int i = tid; i < BN * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8), c = i % (D / 8);
      const size_t e = kv_base + (size_t)(kv0 + r) * D + c * 8;  // first element
      uint4 val = make_uint4(0, 0, 0, 0);
      if constexpr (VK == kVBf16) {
        if (kv0 + r < sk) val = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(v) + e);
      } else {
        uint2 raw = make_uint2(0, 0);  // code 0 is 0 in every type
        if (kv0 + r < sk) raw = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(v) + e);
        val = codes_to_bf16x8<VK>(raw);
      }
      *reinterpret_cast<uint4*>(sV + r * L::VS + c * 8) = val;
    }
    __syncthreads();

    // ---- 3a. S = Q.K^T, int8 in, int32 out --------------------------------
    int s_i[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s_i[n][0] = s_i[n][1] = s_i[n][2] = s_i[n][3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      const int8_t* qa = sQ + (warp * 16 + g) * L::QS + kk * 32 + t * 4;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qa);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * L::QS);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * L::QS + 16);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int8_t* kb = sK + (n * 8 + g) * L::QS + kk * 32 + t * 4;
        mma_s8(s_i[n], a, *reinterpret_cast<const uint32_t*>(kb),
               *reinterpret_cast<const uint32_t*>(kb + 16));
      }
    }

    // ---- 3b. dequantize, mask, online softmax (base 2) --------------------
    const float ks = ks_row[j];
    const float rs0 = qs0 * ks, rs1 = qs1 * ks;
    bool need_mask = (kv0 + BN > sk) || (CAUSAL && kv0 + BN - 1 > q0);
    uint64_t dead = 0;  // masked: bit n * 4 + e set for an element the rule kills
    if constexpr (MASKED) {
      // this thread's elements need the rule unless the table says the
      // tile is wholly live under the ids and the mask, and its rows'
      // ranges hold the tile
      const bool rule = (lv != 2 && (mk.q_seg != nullptr || mk.mask != nullptr)) ||
                        mk.q_pos != nullptr ||
                        (mk.kv_lo != nullptr && !(covers(rm0, kv0) && covers(rm1, kv0)));
      if (rule) {
#pragma unroll 1
        for (int idx = 0; idx < NT * 4; ++idx) {
          const bool top = (idx & 3) < 2;
          const int col = kv0 + (idx >> 2) * 8 + t * 2 + (idx & 1);
          if (!element_live(mk, top ? rm0 : rm1, bi, h, top ? row0 : row1, col, sq, sk))
            dead |= 1ull << idx;
        }
      }
      need_mask = need_mask || rule || (mk.window > 0 && kv0 <= q0 + BM - 1 - mk.window);
    }
    float s[NT][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if constexpr (MASKED) {
      // dequantize; add the bias; mask (causal, ragged edge, window, rule)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = (float)s_i[n][e] * (e < 2 ? rs0 : rs1);
      if (mk.bias != nullptr) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = min(kv0 + n * 8 + t * 2 + (e & 1), sk - 1);  // cols >= sk masked below
            s[n][e] += bias_at(mk, (e < 2 ? bias_r0 : bias_r1) + col * mk.bias_st[3]) * kLog2e;
          }
      }
      if (need_mask) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + n * 8 + t * 2 + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= sk || (CAUSAL && col > row) || (mk.window > 0 && col <= row - mk.window) ||
                ((dead >> (n * 4 + e)) & 1))
              s[n][e] = -INFINITY;
          }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = (float)s_i[n][e] * (e < 2 ? rs0 : rs1);
          if (need_mask) {
            const int col = kv0 + n * 8 + t * 2 + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= sk || (CAUSAL && col > row)) val = -INFINITY;
          }
          s[n][e] = val;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= al0;
      acc[i][1] *= al0;
      acc[i][2] *= al1;
      acc[i][3] *= al1;
    }

    // ---- 3c. O += P.V, P rounded to bf16, fp32 accumulate -----------------
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int vr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, sV + vr * L::VS + np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // ---- 4. epilogue: o = (acc / l) * v_scale + v_mean, lse2 = log2(l) + m ---
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const size_t vc = ((size_t)bi * hkv + hk) * D;  // this kv head's channels
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + t * 2;
    float o0[2] = {acc[i][0] / l0, acc[i][1] / l0};
    float o1[2] = {acc[i][2] / l1, acc[i][3] / l1};
    if constexpr (MASKED) {  // a row with no live key writes 0
      if (!(l0 > 0.f)) o0[0] = o0[1] = 0.f;
      if (!(l1 > 0.f)) o1[0] = o1[1] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (v_scale != nullptr) {
        o0[e] *= v_scale[vc + col + e];
        o1[e] *= v_scale[vc + col + e];
      }
      if (v_mean != nullptr) {  // a row with l == 0 keeps 0
        o0[e] += l0 > 0.f ? v_mean[vc + col + e] : 0.f;
        o1[e] += l1 > 0.f ? v_mean[vc + col + e] : 0.f;
      }
    }
    if (row0 < sq) store2(o + q_base + (size_t)row0 * D + col, o0[0], o0[1]);
    if (row1 < sq) store2(o + q_base + (size_t)row1 * D + col, o1[0], o1[1]);
  }
  if (lse2 != nullptr && t == 0) {
    const size_t lbase = ((size_t)bi * hq + h) * sq;
    float ls0 = log2f(l0) + m0, ls1 = log2f(l1) + m1;
    if constexpr (MASKED) {  // and its LSE is -inf
      if (!(l0 > 0.f)) ls0 = -INFINITY;
      if (!(l1 > 0.f)) ls1 = -INFINITY;
    }
    if (row0 < sq) lse2[lbase + row0] = ls0;
    if (row1 < sq) lse2[lbase + row1] = ls1;
  }
}

// the launch's operands, as sage_attn_fwd takes them
struct Args {
  const void *q, *k, *k_scale, *v, *v_scale, *v_mean;
  void *o, *lse2;
  int b, hq, hkv, sq, sk;
  float qs_mul;
};

template <int D, bool CAUSAL, typename T, int VK, bool MASKED>
int launch(const Args& a, const MaskOf<MASKED>& mk, cudaStream_t st) {
  auto kern = sage_attn_fwd_kernel<D, CAUSAL, T, VK, MASKED>;
  const int smem = Layout<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.sq + BM - 1) / BM, a.hq, a.b);
  kern<<<grid, NTHREADS, smem, st>>>((const T*)a.q, (const int8_t*)a.k, (const float*)a.k_scale,
                                     a.v, (const float*)a.v_scale, (const float*)a.v_mean,
                                     (T*)a.o, (float*)a.lse2, a.hq, a.hkv, a.sq, a.sk, a.qs_mul,
                                     mk);
  return (int)cudaGetLastError();
}

template <int D, bool CAUSAL, typename T, bool MASKED>
int launch_v(int v_kind, const Args& a, const MaskOf<MASKED>& mk, cudaStream_t st) {
  switch (v_kind) {
    case kVBf16: return launch<D, CAUSAL, T, kVBf16, MASKED>(a, mk, st);
    case kVInt8: return launch<D, CAUSAL, T, kVInt8, MASKED>(a, mk, st);
    case kVE4M3: return launch<D, CAUSAL, T, kVE4M3, MASKED>(a, mk, st);
    default: return launch<D, CAUSAL, T, kVE5M2, MASKED>(a, mk, st);
  }
}

template <int D, typename T, bool MASKED>
int launch_c(bool causal, int v_kind, const Args& a, const MaskOf<MASKED>& mk, cudaStream_t st) {
  return causal ? launch_v<D, true, T, MASKED>(v_kind, a, mk, st)
                : launch_v<D, false, T, MASKED>(v_kind, a, mk, st);
}

// checks the shape arguments and launches one of the 32 instantiations of
// MASKED (head dim x causal x q dtype x V kind)
template <bool MASKED>
int launch_fwd(const Args& a, const MaskOf<MASKED>& mk, int d, int causal, int q_is_f32,
               int v_kind, int group, void* stream) {
  if (group != BN || a.hkv <= 0 || a.hq % a.hkv != 0 || (d != 64 && d != 128) || v_kind < 0 ||
      v_kind > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64)
    return q_is_f32 ? launch_c<64, float, MASKED>(causal, v_kind, a, mk, st)
                    : launch_c<64, __nv_bfloat16, MASKED>(causal, v_kind, a, mk, st);
  return q_is_f32 ? launch_c<128, float, MASKED>(causal, v_kind, a, mk, st)
                  : launch_c<128, __nv_bfloat16, MASKED>(causal, v_kind, a, mk, st);
}

}  // namespace
