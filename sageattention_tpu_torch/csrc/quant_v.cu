// Per-channel V quantizer for Hopper (sm_90a): int8, fp8 e4m3 or fp8 e5m2
// codes with one fp32 scale per (b, h, channel) and, for smooth-v, the
// channel mean over the sequence.
//
// Replaces the TPU kernels quant_pallas.py:quant_v_per_channel
// (_quant_v_kernel: one pass over a VMEM-resident [s, d] slab) and
// quant_pallas.py:_quant_v_blocked (_v_stats_kernel, an XLA combine and
// _v_apply_kernel: the two-pass form for slabs over 4 MB).  Three launches:
//
//   quant_v_per_channel  kernel 5.  One CTA per (b,h, group of 8 channels)
//                        over the whole sequence: pass 1 takes the group's
//                        max, min and sum, pass 2 writes the codes.  A
//                        2.3 MB slab does not fit 227 KB of shared memory,
//                        so the slab is read twice; the CTAs of one slab's
//                        channel groups run side by side and share its
//                        lines in L2.  b*h*(d/8) CTAs (240 at
//                        CogVideoX-2B), no reduction across CTAs.
//   quant_v_stats        kernel 6, pass 1.  One CTA per (b,h, block of
//                        rows): the block's per-channel max, min and sum
//                        into a [bh, n_blocks, d] scratch (above d 256,
//                        where a row has more 8-channel vectors than a
//                        warp has lanes, quant_v_stats_wide_kernel).  The TPU grid
//                        carried these across its sequence axis in VMEM;
//                        blocks here run in no order, so the wrapper
//                        combines them in PyTorch, as the JAX package
//                        combines in XLA.
//   quant_v_apply        kernel 6, pass 2.  One CTA per (b,h, block of
//                        rows): codes of (x - mean) * r from the combined
//                        per-channel mean and r = 1/scale.
//
// Numerics, as quant.py:per_channel_quant: x in fp32; with smooth-v the
// mean is sum/s in the port's own summation order; amax =
// max(gmax - mean, mean - gmin) (without smoothing max(gmax, -gmin)),
// which equals max|x - mean| exactly because a rounded subtraction is
// monotone; scale = max(amax, 1e-30) * f32(1/qmax), r = 1/scale (an IEEE
// divide: no --use_fast_math); int8 codes roundf(x * r) (half away from
// zero) clamped to +-127; fp8 codes __nv_cvt_float_to_fp8 with
// saturation, which rounds to nearest even.  No atomics: the result is
// deterministic.
//
// Bound: bytes.  A few flops per element; the least time is reading V
// once and writing the codes once.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // rows a thread has in flight
constexpr int kMaxD = 512;  // the widest head dim (the kernels' 512)

enum CodeKind { kInt8 = 0, kE4M3 = 1, kE5M2 = 2 };

// f32(1/qmax) for int8, e4m3 and e5m2, as the spec's inv_scale
__device__ inline float inv_qmax(int kind) {
  return kind == kInt8 ? (float)(1.0 / 127.0)
                       : kind == kE4M3 ? (float)(1.0 / 448.0) : (float)(1.0 / 57344.0);
}

// eight consecutive elements of a row as fp32
__device__ inline void load8(const __nv_bfloat16* p, float* x) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__device__ inline void load8(const float* p, float* x) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

template <int KIND>
__device__ inline uint8_t encode(float y) {
  if constexpr (KIND == kInt8) {
    return (uint8_t)(int8_t)fminf(fmaxf(roundf(y), -127.f), 127.f);
  } else {
    return (uint8_t)__nv_cvt_float_to_fp8(y, __NV_SATFINITE,
                                          KIND == kE4M3 ? __NV_E4M3 : __NV_E5M2);
  }
}

// codes of eight channels of one row: (x - m) * r, stored as 8 bytes
template <int KIND>
__device__ inline void encode8(const float* x, const float* m, const float* r, uint8_t* dst) {
  union { uint8_t b[8]; uint2 u; } q;
#pragma unroll
  for (int j = 0; j < 8; ++j) q.b[j] = encode<KIND>((x[j] - m[j]) * r[j]);
  *reinterpret_cast<uint2*>(dst) = q.u;
}

__device__ inline void accumulate8(const float* x, float* mx, float* mn, float* sm) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[j] = fmaxf(mx[j], x[j]);
    mn[j] = fminf(mn[j], x[j]);
    sm[j] += x[j];
  }
}

// max, min and sum over the rows [r, end) of a thread, `step` rows apart,
// of the eight channels at `base` (row stride d)
template <typename T>
__device__ inline void column_stats(const T* base, int r, int end, int step, int d,
                                    float* mx, float* mn, float* sm) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[j] = -INFINITY;
    mn[j] = INFINITY;
    sm[j] = 0.f;
  }
  for (; r + (kUnroll - 1) * step < end; r += kUnroll * step) {
    float x[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load8(base + (size_t)(r + u * step) * d, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) accumulate8(x[u], mx, mn, sm);
  }
  for (; r < end; r += step) {
    float x[8];
    load8(base + (size_t)r * d, x);
    accumulate8(x, mx, mn, sm);
  }
}

// reduce mx/mn/sm across the lanes `from`, 2*from, ... apart (xor)
__device__ inline void warp_stats(float* mx, float* mn, float* sm, int from) {
  for (int o = from; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
      mn[j] = fminf(mn[j], __shfl_xor_sync(0xffffffffu, mn[j], o));
      sm[j] += __shfl_xor_sync(0xffffffffu, sm[j], o);
    }
  }
}

// (mean, r, scale) of a channel from its max, min and sum over s rows
__device__ inline void channel_scale(float gmax, float gmin, float gsum, int s, bool smooth,
                                     int kind, float* mean, float* r, float* scale) {
  const float m = smooth ? gsum / (float)s : 0.f;
  const float amax = smooth ? fmaxf(gmax - m, m - gmin) : fmaxf(gmax, -gmin);
  *scale = fmaxf(amax, 1e-30f) * inv_qmax(kind);
  *r = 1.0f / *scale;
  *mean = m;
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
quant_v_kernel(const T* __restrict__ v, uint8_t* __restrict__ out,
               float* __restrict__ scale, float* __restrict__ mean, int s, int d,
               int smooth) {
  __shared__ float red[3][kWarps][8];
  __shared__ float stat[2][8];  // mean, r of the group's channels
  const int c0 = blockIdx.x * 8, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t slab = (size_t)bh * s * d;
  const T* base = v + slab + c0;

  // ---- pass 1: max, min, sum of the 8 channels over the sequence ---------
  float mx[8], mn[8], sm[8];
  column_stats(base, threadIdx.x, s, kThreads, d, mx, mn, sm);
  warp_stats(mx, mn, sm, 1);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[0][warp][j] = mx[j];
      red[1][warp][j] = mn[j];
      red[2][warp][j] = sm[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    const int j = threadIdx.x;
    float gmax = red[0][0][j], gmin = red[1][0][j], gsum = red[2][0][j];
    for (int w = 1; w < kWarps; ++w) {
      gmax = fmaxf(gmax, red[0][w][j]);
      gmin = fminf(gmin, red[1][w][j]);
      gsum += red[2][w][j];
    }
    float m, r, sc;
    channel_scale(gmax, gmin, gsum, s, smooth, KIND, &m, &r, &sc);
    scale[(size_t)bh * d + c0 + j] = sc;
    if (smooth) mean[(size_t)bh * d + c0 + j] = m;
    stat[0][j] = m;
    stat[1][j] = r;
  }
  __syncthreads();

  // ---- pass 2: the codes --------------------------------------------------
  float m8[8], r8[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m8[j] = stat[0][j];
    r8[j] = stat[1][j];
  }
  uint8_t* obase = out + slab + c0;
  int r = threadIdx.x;
  for (; r + (kUnroll - 1) * kThreads < s; r += kUnroll * kThreads) {
    float x[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load8(base + (size_t)(r + u * kThreads) * d, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      encode8<KIND>(x[u], m8, r8, obase + (size_t)(r + u * kThreads) * d);
  }
  for (; r < s; r += kThreads) {
    float x[8];
    load8(base + (size_t)r * d, x);
    encode8<KIND>(x, m8, r8, obase + (size_t)r * d);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_v_stats_kernel(const T* __restrict__ v, float* __restrict__ pmax,
                     float* __restrict__ pmin, float* __restrict__ psum, int s, int d,
                     int block_s) {
  __shared__ float red[3][kWarps][256];
  const int blk = blockIdx.x, bh = blockIdx.y, n_blocks = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = d / 8;  // 8-channel vectors a row; divides 32
  const int vi = threadIdx.x % nv;
  const int row0 = blk * block_s, end = min(s, row0 + block_s);
  const T* base = v + (size_t)bh * s * d + vi * 8;

  float mx[8], mn[8], sm[8];
  column_stats(base, row0 + threadIdx.x / nv, end, kThreads / nv, d, mx, mn, sm);
  warp_stats(mx, mn, sm, nv);  // lanes vi, vi + nv, ... hold one vector
  if (lane < nv) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[0][warp][vi * 8 + j] = mx[j];
      red[1][warp][vi * 8 + j] = mn[j];
      red[2][warp][vi * 8 + j] = sm[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < d) {
    const int c = threadIdx.x;
    float gmax = red[0][0][c], gmin = red[1][0][c], gsum = red[2][0][c];
    for (int w = 1; w < kWarps; ++w) {
      gmax = fmaxf(gmax, red[0][w][c]);
      gmin = fminf(gmin, red[1][w][c]);
      gsum += red[2][w][c];
    }
    const size_t o = ((size_t)bh * n_blocks + blk) * d + c;
    pmax[o] = gmax;
    pmin[o] = gmin;
    psum[o] = gsum;
  }
}

// quant_v_stats_kernel for rows of more than 32 eight-channel vectors (d 384
// and 512), where a warp holds less than a row: thread i takes vector i %
// nv of every (kThreads / nv)-th row from row i / nv (the last kThreads %
// nv threads none), and the row groups' statistics are combined through
// shared memory ([3][groups][d] fp32, 24 KB at 512) in group order.  It
// computes every d, but at 64-256 the warp-shuffle kernel above stays: in
// its place there this one took 1.075x its time at the Wan2.1 layer (1,
// 12, 33272, 128) and 1.083x at (1, 8, 16384, 256), and the same at d 64
// and 128 (tools/ab_quant_v.py, H100 80GB HBM3 at 700 W).
template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_v_stats_wide_kernel(const T* __restrict__ v, float* __restrict__ pmax,
                          float* __restrict__ pmin, float* __restrict__ psum, int s, int d,
                          int block_s) {
  extern __shared__ float red[];  // [3][groups][d]
  const int blk = blockIdx.x, bh = blockIdx.y, n_blocks = gridDim.x;
  const int nv = d / 8, groups = kThreads / nv;
  const int vi = threadIdx.x % nv, grp = threadIdx.x / nv;
  const int row0 = blk * block_s, end = min(s, row0 + block_s);
  if (grp < groups) {
    float mx[8], mn[8], sm[8];
    column_stats(v + (size_t)bh * s * d + vi * 8, row0 + grp, end, groups, d, mx, mn, sm);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[(0 * groups + grp) * d + vi * 8 + j] = mx[j];
      red[(1 * groups + grp) * d + vi * 8 + j] = mn[j];
      red[(2 * groups + grp) * d + vi * 8 + j] = sm[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float gmax = red[c], gmin = red[groups * d + c], gsum = red[2 * groups * d + c];
    for (int g = 1; g < groups; ++g) {
      gmax = fmaxf(gmax, red[g * d + c]);
      gmin = fminf(gmin, red[(groups + g) * d + c]);
      gsum += red[(2 * groups + g) * d + c];
    }
    const size_t o = ((size_t)bh * n_blocks + blk) * d + c;
    pmax[o] = gmax;
    pmin[o] = gmin;
    psum[o] = gsum;
  }
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
quant_v_apply_kernel(const T* __restrict__ v, const float* __restrict__ r,
                     const float* __restrict__ mean, uint8_t* __restrict__ out, int s,
                     int d, int block_s) {
  __shared__ float sr[kMaxD], sm[kMaxD];
  const int blk = blockIdx.x, bh = blockIdx.y;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    sr[c] = r[(size_t)bh * d + c];
    sm[c] = mean ? mean[(size_t)bh * d + c] : 0.f;
  }
  __syncthreads();
  const int nv = d / 8;
  const int row0 = blk * block_s, rows = min(block_s, s - row0);
  const size_t off = ((size_t)bh * s + row0) * d;
  for (int i = threadIdx.x; i < rows * nv; i += kThreads) {
    const int rr = i / nv, c = (i % nv) * 8;
    float x[8];
    load8(v + off + (size_t)rr * d + c, x);
    encode8<KIND>(x, sm + c, sr + c, out + off + (size_t)rr * d + c);
  }
}

bool bad_shape(int bh, int s, int d) {
  return bh <= 0 || bh > 65535 || s <= 0 ||
         (d != 64 && d != 128 && d != 256 && d != 384 && d != 512);
}

template <typename T>
int launch_quant_v(const void* v, void* out, void* scale, void* mean, int bh, int s, int d,
                   int kind, int smooth, cudaStream_t st) {
  dim3 grid(d / 8, bh);
  const T* x = (const T*)v;
  uint8_t* o = (uint8_t*)out;
  float *sc = (float*)scale, *mn = (float*)mean;
  if (kind == kInt8)
    quant_v_kernel<T, kInt8><<<grid, kThreads, 0, st>>>(x, o, sc, mn, s, d, smooth);
  else if (kind == kE4M3)
    quant_v_kernel<T, kE4M3><<<grid, kThreads, 0, st>>>(x, o, sc, mn, s, d, smooth);
  else
    quant_v_kernel<T, kE5M2><<<grid, kThreads, 0, st>>>(x, o, sc, mn, s, d, smooth);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* v, const void* r, const void* mean, void* out, int bh, int s,
                 int d, int block_s, int kind, cudaStream_t st) {
  dim3 grid((s + block_s - 1) / block_s, bh);
  const T* x = (const T*)v;
  const float *rr = (const float*)r, *mn = (const float*)mean;
  uint8_t* o = (uint8_t*)out;
  if (kind == kInt8)
    quant_v_apply_kernel<T, kInt8><<<grid, kThreads, 0, st>>>(x, rr, mn, o, s, d, block_s);
  else if (kind == kE4M3)
    quant_v_apply_kernel<T, kE4M3><<<grid, kThreads, 0, st>>>(x, rr, mn, o, s, d, block_s);
  else
    quant_v_apply_kernel<T, kE5M2><<<grid, kThreads, 0, st>>>(x, rr, mn, o, s, d, block_s);
  return (int)cudaGetLastError();
}

}  // namespace

// v: [bh, s, d] (bf16 if v_is_bf16 else fp32), contiguous, d in {64, 128, 256,
// 384, 512};
// out: [bh, s, d] codes (kind 0 int8, 1 fp8 e4m3, 2 fp8 e5m2); scale:
// fp32 [bh, d]; mean: fp32 [bh, d], written when smooth (may be NULL
// otherwise).
extern "C" int quant_v_per_channel(const void* v, void* out, void* scale, void* mean, int bh,
                                   int s, int d, int v_is_bf16, int kind, int smooth,
                                   void* stream) {
  if (bad_shape(bh, s, d) || kind < 0 || kind > 2 || (smooth && mean == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return v_is_bf16
             ? launch_quant_v<__nv_bfloat16>(v, out, scale, mean, bh, s, d, kind, smooth, st)
             : launch_quant_v<float>(v, out, scale, mean, bh, s, d, kind, smooth, st);
}

// v: as above; pmax/pmin/psum: fp32 [bh, ceil(s/block_s), d], each block's
// per-channel max, min and sum.
extern "C" int quant_v_stats(const void* v, void* pmax, void* pmin, void* psum, int bh, int s,
                             int d, int block_s, int v_is_bf16, void* stream) {
  if (bad_shape(bh, s, d) || block_s <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((s + block_s - 1) / block_s, bh);
  cudaStream_t st = (cudaStream_t)stream;
  if (d > 256) {  // more than a warp's 32 vectors a row
    const int groups = kThreads / (d / 8);
    const size_t smem = sizeof(float) * 3 * groups * d;
    if (v_is_bf16)
      quant_v_stats_wide_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
          (const __nv_bfloat16*)v, (float*)pmax, (float*)pmin, (float*)psum, s, d, block_s);
    else
      quant_v_stats_wide_kernel<float><<<grid, kThreads, smem, st>>>(
          (const float*)v, (float*)pmax, (float*)pmin, (float*)psum, s, d, block_s);
    return (int)cudaGetLastError();
  }
  if (v_is_bf16)
    quant_v_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)v, (float*)pmax, (float*)pmin, (float*)psum, s, d, block_s);
  else
    quant_v_stats_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)v, (float*)pmax, (float*)pmin, (float*)psum, s, d, block_s);
  return (int)cudaGetLastError();
}

// v: as above; r: fp32 [bh, d] (1/scale); mean: fp32 [bh, d] or NULL (no
// smoothing); out: [bh, s, d] codes of `kind`.
extern "C" int quant_v_apply(const void* v, const void* r, const void* mean, void* out, int bh,
                             int s, int d, int block_s, int v_is_bf16, int kind, void* stream) {
  if (bad_shape(bh, s, d) || block_s <= 0 || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return v_is_bf16 ? launch_apply<__nv_bfloat16>(v, r, mean, out, bh, s, d, block_s, kind, st)
                   : launch_apply<float>(v, r, mean, out, bh, s, d, block_s, kind, st);
}
