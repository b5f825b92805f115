// Smoothed per-chunk int8 K quantizer for Hopper (sm_90a).
//
// Replaces the TPU kernels quant_pallas.py:quant_k_fused_mean
// (_quant_k_fused_kernel) and quant_pallas.py:quant_k_chunked
// (_quant_k_kernel).  Two launches:
//
//   k_channel_mean   km[d] = sum_s float(k[s,d]) / s in fp32: one CTA per
//                    (chunk of rows, b h), enough chunks to fill the card
//                    (the wrapper's plan, quant_cuda.mean_chunk_rows); each
//                    writes its chunk's sums, and the last CTA of a (b,h) to
//                    finish (a counter after a fence) adds the chunks' sums
//                    in chunk order, so the mean does not depend on the
//                    schedule (deterministic).
//   quant_k_chunked  one CTA per (b,h, group of G rows): x = k - km,
//                    amax over the LIVE rows of the group (the last group
//                    may be ragged), scale = max(amax,1e-30) * (1/qmax),
//                    r = 1/scale, code = roundf(x * r) (half away from
//                    zero, as the spec's round_half_away) clipped to
//                    +-qmax; qmax 127, or 7 for bits=4.
//
// Bound: bytes.  The work is a few flops per element; the least time is
// reading K (bf16) and writing the int8 codes.  The TPU fused both steps
// into one read of a VMEM-resident (b,h) slab; a 17,776 x 64 bf16 slab is
// 2.2 MB and does not fit in 227 KB of shared memory, so K is read twice
// here.  The second read follows the first within the same stream and is
// served mostly from the 50 MB L2; fusing the two reads (e.g. a cluster
// reduction of the mean) is later work.  Inside quant_k_chunked a CTA
// reads its group twice (amax, then codes); the second read hits L1/L2.
//
// Built without --use_fast_math so that 1/scale is an IEEE divide and the
// codes match the spec bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMeanThreads = 512;
constexpr int kQuantThreads = 256;
constexpr int kMaxD = 512;  // the widest head dim (the kernels' 512)

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

// CTA (c, bh) sums rows [c chunk, (c + 1) chunk) of (b,h) bh: thread i sums
// vector i % nv of the rows i / nv, i / nv + rows_per_iter, ... of the
// chunk; where nv does not divide the block (d 384: 48 vectors) the last
// kMeanThreads % nv threads sum nothing.  The partial sums are added in row
// order into part[bh, c, :].  The CTA that finds itself the last of its
// (b,h) (count[bh], zero at the launch, reaches n_chunks) adds the chunks'
// sums in chunk order, writes km[bh, :] = sum / s and sets count[bh] back
// to zero, so the counters serve the stream's next launch as they are.
template <typename T>
__global__ void channel_mean_kernel(const T* __restrict__ k, float* __restrict__ part,
                                    int* __restrict__ count, float* __restrict__ km, int s,
                                    int d, int chunk) {
  extern __shared__ float rows_sum[];  // [rows_per_iter][d]
  __shared__ bool last;
  const int nv = d / 8;                // 8-element vectors per row
  const int rows_per_iter = kMeanThreads / nv;
  const int v = threadIdx.x % nv;
  const int r0 = threadIdx.x / nv;
  const int c = blockIdx.x, n_chunks = gridDim.x, bh = blockIdx.y;
  const int row_end = min(s, (c + 1) * chunk);
  const T* base = k + (size_t)bh * s * d;
  float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  // two rows' loads in flight at a time, added in row order
  int r = c * chunk + r0;
  for (; r + rows_per_iter < row_end && r0 < rows_per_iter; r += 2 * rows_per_iter) {
    float x[8], y[8];
    load8(base + (size_t)r * d + v * 8, x);
    load8(base + (size_t)(r + rows_per_iter) * d + v * 8, y);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = (acc[j] + x[j]) + y[j];
  }
  if (r < row_end && r0 < rows_per_iter) {
    float x[8];
    load8(base + (size_t)r * d + v * 8, x);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += x[j];
  }
  if (r0 < rows_per_iter) {
#pragma unroll
    for (int j = 0; j < 8; ++j) rows_sum[r0 * d + v * 8 + j] = acc[j];
  }
  __syncthreads();
  float* mine = part + ((size_t)bh * n_chunks + c) * d;
  if (threadIdx.x < d) {
    float sum = 0.f;
    for (int r = 0; r < rows_per_iter; ++r) sum += rows_sum[r * d + threadIdx.x];
    mine[threadIdx.x] = sum;
  }
  __threadfence();  // this chunk's sums reach device memory before the count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&count[bh], 1) == n_chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) count[bh] = 0;  // zero again for the next launch
  if (threadIdx.x < d) {
    const float* sums = part + (size_t)bh * n_chunks * d + threadIdx.x;
    float sum = 0.f;
    for (int i = 0; i < n_chunks; ++i) sum += __ldcg(sums + (size_t)i * d);  // from L2
    km[(size_t)bh * d + threadIdx.x] = sum / (float)s;
  }
}

__device__ inline float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x / 32) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <typename T>
__global__ void quant_k_kernel(const T* __restrict__ k,
                               const float* __restrict__ km,
                               int8_t* __restrict__ out,
                               float* __restrict__ scales, int s, int d,
                               int group, float qmax, float inv_qmax) {
  __shared__ float red[32];
  __shared__ float mean[kMaxD];
  const int c = blockIdx.x, bh = blockIdx.y;
  const int n_groups = gridDim.x;
  const int row0 = c * group;
  const int rows = min(group, s - row0);  // live rows of this group
  const int nv = d / 8;
  const size_t off = ((size_t)bh * s + row0) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) mean[c] = km ? km[(size_t)bh * d + c] : 0.f;
  __syncthreads();

  float amax = 0.f;
  for (int i = threadIdx.x; i < rows * nv; i += blockDim.x) {
    const int r = i / nv, v = i % nv;
    float x[8];
    load8(k + off + (size_t)r * d + v * 8, x);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(x[j] - mean[v * 8 + j]));
  }
  amax = block_max(amax, red);
  const float scale = fmaxf(amax, 1e-30f) * inv_qmax;
  const float r_scale = 1.0f / scale;
  if (threadIdx.x == 0) scales[(size_t)bh * n_groups + c] = scale;

  for (int i = threadIdx.x; i < rows * nv; i += blockDim.x) {
    const int r = i / nv, v = i % nv;
    float x[8];
    load8(k + off + (size_t)r * d + v * 8, x);
    union { int8_t b[8]; uint2 u; } q;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float y = roundf((x[j] - mean[v * 8 + j]) * r_scale);
      q.b[j] = (int8_t)fminf(fmaxf(y, -qmax), qmax);
    }
    *reinterpret_cast<uint2*>(out + off + (size_t)r * d + v * 8) = q.u;
  }
}

}  // namespace

// k: [bh, s, d] (bf16 if k_is_bf16 else fp32), contiguous, d a multiple of 8
// up to 512 (64, 128, 256, 384 and 512 from the wrappers).  part: fp32
// [bh, ceil(s / chunk), d], the chunks' sums; count: int32 [bh], zero, and
// zero again when the launch ends; chunk: rows a CTA, a multiple of 64.
// km: [bh, d] fp32 out.
extern "C" int k_channel_mean(const void* k, void* part, void* count, void* km, int bh, int s,
                              int d, int chunk, int k_is_bf16, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxD || s <= 0 || chunk <= 0 || chunk % 64 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kMeanThreads / (d / 8)) * d;
  const dim3 grid((s + chunk - 1) / chunk, bh);
  cudaStream_t st = (cudaStream_t)stream;
  if (k_is_bf16)
    channel_mean_kernel<__nv_bfloat16><<<grid, kMeanThreads, smem, st>>>(
        (const __nv_bfloat16*)k, (float*)part, (int*)count, (float*)km, s, d, chunk);
  else
    channel_mean_kernel<float><<<grid, kMeanThreads, smem, st>>>(
        (const float*)k, (float*)part, (int*)count, (float*)km, s, d, chunk);
  return (int)cudaGetLastError();
}

// k: [bh, s, d]; km: [bh, d] fp32 or NULL (no smoothing); out: int8
// [bh, s, d]; scales: fp32 [bh, ceil(s/group)]; qmax 127 or 7 and
// inv_qmax = f32(1/qmax).
extern "C" int quant_k_chunked(const void* k, const void* km, void* out,
                               void* scales, int bh, int s, int d, int group,
                               int k_is_bf16, float qmax, float inv_qmax, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxD || group <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((s + group - 1) / group, bh);
  cudaStream_t st = (cudaStream_t)stream;
  if (k_is_bf16)
    quant_k_kernel<__nv_bfloat16><<<grid, kQuantThreads, 0, st>>>(
        (const __nv_bfloat16*)k, (const float*)km, (int8_t*)out, (float*)scales, s, d, group,
        qmax, inv_qmax);
  else
    quant_k_kernel<float><<<grid, kQuantThreads, 0, st>>>(
        (const float*)k, (const float*)km, (int8_t*)out, (float*)scales, s, d, group, qmax,
        inv_qmax);
  return (int)cudaGetLastError();
}
