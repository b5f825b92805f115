// Fused SageAttention forward for Hopper (sm_90a): int8 Q.K^T, bf16 P.V.
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
// Bound: operations, whatever V's type.  At the CogVideoX-2B layer shape
// (b=1, h=30, s=17,776, d=64) Q.K^T is 1.21e12 int8 ops and P.V 1.21e12
// bf16 FLOP, about 1.84 ms on an H100 SXM's data-sheet peaks, while the
// bytes (Q, K, V, O once each) take about 0.03 ms.  This first kernel is written to be
// right: mma.sync (not wgmma), plain synchronous tile loads (no TMA, no
// cp.async pipeline) and no warp specialisation; those are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int D, bool CAUSAL, typename T, int VK>
__global__ void __launch_bounds__(NTHREADS)
sage_attn_fwd_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                     const float* __restrict__ k_scale, const void* __restrict__ v,
                     const float* __restrict__ v_scale, const float* __restrict__ v_mean,
                     T* __restrict__ o, float* __restrict__ lse2, int hq, int hkv, int sq,
                     int sk, float qs_mul) {
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

  int n_tiles = n_tiles_all;
  if (CAUSAL) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

  for (int j = 0; j < n_tiles; ++j) {
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
    const bool need_mask = (kv0 + BN > sk) || (CAUSAL && kv0 + BN - 1 > q0);
    float s[NT][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
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
    if (row0 < sq) lse2[lbase + row0] = log2f(l0) + m0;
    if (row1 < sq) lse2[lbase + row1] = log2f(l1) + m1;
  }
}

// the launch's operands, as sage_attn_fwd takes them
struct Args {
  const void *q, *k, *k_scale, *v, *v_scale, *v_mean;
  void *o, *lse2;
  int b, hq, hkv, sq, sk;
  float qs_mul;
};

template <int D, bool CAUSAL, typename T, int VK>
int launch(const Args& a, cudaStream_t st) {
  auto kern = sage_attn_fwd_kernel<D, CAUSAL, T, VK>;
  const int smem = Layout<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.sq + BM - 1) / BM, a.hq, a.b);
  kern<<<grid, NTHREADS, smem, st>>>((const T*)a.q, (const int8_t*)a.k, (const float*)a.k_scale,
                                     a.v, (const float*)a.v_scale, (const float*)a.v_mean,
                                     (T*)a.o, (float*)a.lse2, a.hq, a.hkv, a.sq, a.sk, a.qs_mul);
  return (int)cudaGetLastError();
}

template <int D, bool CAUSAL, typename T>
int launch_v(int v_kind, const Args& a, cudaStream_t st) {
  switch (v_kind) {
    case kVBf16: return launch<D, CAUSAL, T, kVBf16>(a, st);
    case kVInt8: return launch<D, CAUSAL, T, kVInt8>(a, st);
    case kVE4M3: return launch<D, CAUSAL, T, kVE4M3>(a, st);
    default: return launch<D, CAUSAL, T, kVE5M2>(a, st);
  }
}

template <int D, typename T>
int launch_c(bool causal, int v_kind, const Args& a, cudaStream_t st) {
  return causal ? launch_v<D, true, T>(v_kind, a, st) : launch_v<D, false, T>(v_kind, a, st);
}

}  // namespace

// q: [b,hq,sq,d] (fp32 if q_is_f32 else bf16), unquantized; k: int8
// [b,hkv,sk,d]; k_scale: fp32 [b,hkv,ceil(sk/group)]; v: [b,hkv,sk,d] of
// v_kind (0 bf16, 1 int8, 2 fp8 e4m3, 3 fp8 e5m2); v_scale, v_mean: fp32
// [b,hkv,d] or NULL; o: [b,hq,sq,d] in q's dtype; lse2: fp32 [b,hq,sq] or
// NULL.  All contiguous; d in {64, 128}; group must be 128 (the kernel's
// KV tile); qs_mul = f32(1/127) * f32(sm_scale * log2(e)).
extern "C" int sage_attn_fwd(const void* q, const void* k, const void* k_scale,
                             const void* v, const void* v_scale, const void* v_mean,
                             void* o, void* lse2, int b, int hq, int hkv, int sq, int sk,
                             int d, int causal, int q_is_f32, int v_kind, int want_lse,
                             int group, float qs_mul, void* stream) {
  if (group != BN || hkv <= 0 || hq % hkv != 0 || (d != 64 && d != 128) || v_kind < 0 ||
      v_kind > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{q, k, k_scale, v, v_scale, v_mean, o, want_lse ? lse2 : nullptr,
               b, hq, hkv, sq, sk, qs_mul};
  if (d == 64)
    return q_is_f32 ? launch_c<64, float>(causal, v_kind, a, st)
                    : launch_c<64, __nv_bfloat16>(causal, v_kind, a, st);
  return q_is_f32 ? launch_c<128, float>(causal, v_kind, a, st)
                  : launch_c<128, __nv_bfloat16>(causal, v_kind, a, st);
}
