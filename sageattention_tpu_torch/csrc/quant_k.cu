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
//   quant_k_chunked  kernel 3, per (b,h, group of G rows), a "tile": x = k -
//                    km, amax over the LIVE rows of the tile (the last may
//                    be ragged), scale = max(amax,1e-30) * (1/qmax), r =
//                    1/scale, code = roundf(x * r) (half away from zero, as
//                    the spec's round_half_away) clipped to +-qmax; qmax
//                    127, or 7 for bits=4.
//
// Bound: bytes.  A few flops per element; the least time is reading K once
// and writing the int8 codes once.  The TPU fused both launches into one
// read of a VMEM-resident (b,h) slab; a 17,776 x 64 bf16 slab is 2.2 MB and
// does not fit in 227 KB of shared memory, so the mean reads K once more
// here (served mostly from the 50 MB L2).
//
// quant_k_chunked's design (the wrapper's plan, quant_cuda.quant_k_plan):
// at head dims up to 128 a tile fits in the registers of one CTA, so each
// tile is one CTA's, loaded once into its threads' registers, every load
// in flight before the first is used, and kept there for the codes.  Above
// 128, a persistent grid of 256-thread CTAs, as many as the SMs hold (up to
// four an SM), each walking a contiguous run of the (b h, group) tiles.
// Each tile is staged once in shared memory, in units of `unit_rows` rows,
// into a ring of `stages` units that keeps the next tile's units in flight
// while this tile is worked on.  Each thread stages by cp.async the very
// chunks it reads (a fixed 8 columns of a unit's rows g, g + n, ...), so it
// waits for its own copies alone.  The amax is taken over the staged tile (warp
// shuffles, then one exchange), and the codes come from the same staged
// tile: K is read from device memory once.  km is loaded into each
// thread's registers once a slab.  Where a tile does not fit the ring with
// a unit to spare (fp32 K at head dim 512), its first `staged_rows` rows
// are staged and the rest read from device memory for the amax and again,
// from L2, for the codes.  Staging each unit by one bulk copy
// (cp.async.bulk on an mbarrier) issued by one thread moved 1.8 TB/s at the
// CogVideoX-2B layer, less than two plain reads of each tile (PERF.md).
//
// Built without --use_fast_math so that 1/scale is an IEEE divide and the
// codes match the spec bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_sm90.cuh"

namespace {

using qsm90::load8;

constexpr int kMeanThreads = 512;
constexpr int kQuantThreads = 256;
constexpr int kMaxStages = 16;  // quant_cuda.K_MAX_STAGES
constexpr int kRingBytes = 216 * 1024;  // quant_cuda.K_RING_BYTES
constexpr int kRegRows = 8;             // quant_cuda.K_REG_ROWS
constexpr int kMaxD = 512;  // the widest head dim (the kernels' 512)

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

// Kernel 3.  CTA c takes tiles [c n / grid, (c + 1) n / grid) of the n =
// bh ceil(s / group) tiles in (b h, group) order.  A tile stages
// min(staged_rows, live rows) rows in units of unit_rows (staged_rows /
// unit_rows units); the CTA's u-th unit goes to slot u % stages of the
// ring.  Thread i takes the 8 columns 8 (i % nv) of the rows i / nv, i / nv
// + n_rows, ... of each unit as its slot holds them (nv = d / 8, n_rows =
// 256 / nv; at d 384 the last 16 threads none), so a slot's chunk is always
// the same thread's, and copies exactly those chunks into the ring itself
// by cp.async, a commit group a unit: `stages` units at the start, and the
// unit `stages` on as soon as it has written a unit's codes.  (Were the
// rows taken by their place in the tile, a slot that holds another unit of
// the tile next time round, as with 16-row units in 9 stages, would pass a
// chunk from one thread to another without a barrier.)
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quant_k_kernel(const T* __restrict__ k, const float* __restrict__ km, int8_t* __restrict__ out,
               float* __restrict__ scales, int bh, int s, int d, int group, float qmax,
               float inv_qmax, int unit_rows, int stages, int staged_rows) {
  extern __shared__ __align__(128) unsigned char ring_raw[];
  T* ring = reinterpret_cast<T*>(ring_raw);
  __shared__ float red[2][kQuantThreads / 32];  // a tile's warp maxima, by tile parity
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ng = (s + group - 1) / group;
  const long long n_tiles = (long long)bh * ng;
  const int t0 = (int)(blockIdx.x * n_tiles / gridDim.x);
  const int t1 = (int)((blockIdx.x + 1) * n_tiles / gridDim.x);
  const int upt = staged_rows / unit_rows;  // units a tile stages
  const long long n_units = (long long)(t1 - t0) * upt;
  const size_t unit_elems = (size_t)unit_rows * d;
  const int nv = d / 8, n_rows = kQuantThreads / nv;
  const int v = tid % nv, g = tid / nv;
  const bool active = g < n_rows;

  // this thread's chunks of the CTA's u-th unit: rows [j unit_rows, (j + 1)
  // unit_rows) of the staged rows of tile t0 + u / upt
  long long issued = 0;
  auto issue = [&]() {
    if (issued >= n_units) return;
    const long long u = issued++;
    if (active) {
      const int t = t0 + (int)(u / upt), j = (int)(u % upt);
      const int row0 = (t % ng) * group;
      const int a = j * unit_rows, e = min(a + unit_rows, min(staged_rows, s - row0));
      const T* src = k + ((size_t)(t / ng) * s + row0 + a) * d + v * 8;
      T* dst = ring + (u % stages) * unit_elems + v * 8;
      for (int r = g; r < e - a; r += n_rows)
        qsm90::cp_async8(dst + (size_t)r * d, src + (size_t)r * d);
    }
    qsm90::cp_async_commit();
  };
  for (int i = 0; i < stages; ++i) issue();

  float mean[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int slab = -1;
  for (int i = 0; i < t1 - t0; ++i) {
    const int t = t0 + i, b = t / ng, gi = t % ng, row0 = gi * group;
    const int rows = min(group, s - row0);  // live rows of this tile
    const int st = min(staged_rows, rows);
    if (b != slab) {  // the slab's km, once a slab
      slab = b;
      if (km != nullptr && active) load8(km + (size_t)b * d + v * 8, mean);
    }
    const T* src = k + ((size_t)b * s + row0) * d + v * 8;
    const long long u0 = (long long)i * upt;

    // amax over the live rows: the staged ones as this thread's copies
    // land, the rest from device memory
    float amax = 0.f;
    auto take = [&](const float* x, int) {
#pragma unroll
      for (int c = 0; c < 8; ++c) amax = fmaxf(amax, fabsf(x[c] - mean[c]));
    };
    for (int j = 0; j < upt; ++j) {
      const long long u = u0 + j;
      qsm90::cp_async_wait((int)min(issued - u - 1, 16ll));
      if (!active) continue;
      const int a = j * unit_rows;  // the unit's first row in the tile
      qsm90::for_rows(ring + (u % stages) * unit_elems + v * 8, 0, min(unit_rows, st - a), g,
                      n_rows, d, take);
    }
    if (active) qsm90::for_rows(src, st, rows, g, n_rows, d, take);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) red[i & 1][warp] = amax;
    __syncthreads();
    amax = red[i & 1][0];
#pragma unroll
    for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[i & 1][w]);
    const float scale = fmaxf(amax, 1e-30f) * inv_qmax;
    const float r_scale = 1.0f / scale;
    if (tid == 0) scales[(size_t)b * ng + gi] = scale;

    // the codes, from the same staged rows; each unit's slot then takes
    // the unit `stages` on
    int8_t* dst = out + ((size_t)b * s + row0) * d + v * 8;
    auto code = [&](const float* x, int r) {
      union { int8_t b[8]; uint2 u; } q;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float y = roundf((x[c] - mean[c]) * r_scale);
        q.b[c] = (int8_t)fminf(fmaxf(y, -qmax), qmax);
      }
      *reinterpret_cast<uint2*>(dst + (size_t)r * d) = q.u;
    };
    for (int j = 0; j < upt; ++j) {
      if (active) {
        const int a = j * unit_rows;
        qsm90::for_rows(ring + ((u0 + j) % stages) * unit_elems + v * 8, 0,
                        min(unit_rows, st - a), g, n_rows, d,
                        [&](const float* x, int r) { code(x, a + r); });
      }
      issue();
    }
    if (active) qsm90::for_rows(src, st, rows, g, n_rows, d, code);
  }
}

// Kernel 3 where a tile fits in the registers of one CTA (d <= 128 and at
// most kRegRows rows a thread): one CTA a tile, as many as the SMs hold,
// each thread loading its 8 columns 8 (i % nv) of rows i / nv, i / nv +
// n_rows, ... (ROWS rows at most) before using any, so a thread has them
// all in flight, and keeping them for the codes.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kQuantThreads)
quant_k_regs_kernel(const T* __restrict__ k, const float* __restrict__ km,
                    int8_t* __restrict__ out, float* __restrict__ scales, int s, int d, int group,
                    float qmax, float inv_qmax) {
  __shared__ float red[kQuantThreads / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ng = (s + group - 1) / group, b = blockIdx.x / ng, gi = blockIdx.x % ng;
  const int row0 = gi * group, rows = min(group, s - row0);
  const int nv = d / 8, n_rows = kQuantThreads / nv, v = tid % nv, g = tid / nv;
  float mean[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (km != nullptr) load8(km + (size_t)b * d + v * 8, mean);
  const size_t off = ((size_t)b * s + row0) * d + v * 8;
  qsm90::Raw8<T> raw[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    if (g + i * n_rows < rows) qsm90::load_raw(k + off + (size_t)(g + i * n_rows) * d, raw[i]);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (g + i * n_rows < rows) {
      float x[8];
      qsm90::unpack(raw[i], x);
#pragma unroll
      for (int c = 0; c < 8; ++c) amax = fmaxf(amax, fabsf(x[c] - mean[c]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale = fmaxf(amax, 1e-30f) * inv_qmax;
  const float r_scale = 1.0f / scale;
  if (tid == 0) scales[(size_t)b * ng + gi] = scale;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (g + i * n_rows < rows) {
      float x[8];
      qsm90::unpack(raw[i], x);
      union { int8_t b[8]; uint2 u; } q;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float y = roundf((x[c] - mean[c]) * r_scale);
        q.b[c] = (int8_t)fminf(fmaxf(y, -qmax), qmax);
      }
      *reinterpret_cast<uint2*>(out + off + (size_t)(g + i * n_rows) * d) = q.u;
    }
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

// k: [bh, s, d] (bf16 if k_is_bf16 else fp32), contiguous and 16-byte
// aligned, d a multiple of 8 up to 512; km: [bh, d] fp32 or NULL (no
// smoothing); out: int8 [bh, s, d]; scales: fp32 [bh, ceil(s/group)]; qmax
// 127 or 7 and inv_qmax = f32(1/qmax).  The plan (quant_cuda.quant_k_plan):
// stages 0 holds each tile in registers, one CTA a tile (grid the tiles,
// unit_rows = staged_rows = group; d <= 128 and at most kRegRows rows a
// thread); else units of unit_rows rows, a ring of `stages` units, the
// first staged_rows (a multiple of unit_rows, at most group, at most stages
// units) rows of each tile staged, `grid` CTAs.
extern "C" int quant_k_chunked(const void* k, const void* km, void* out, void* scales, int bh,
                               int s, int d, int group, int k_is_bf16, float qmax,
                               float inv_qmax, int unit_rows, int stages, int staged_rows,
                               int grid, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxD || group <= 0 || bh <= 0 || s <= 0 || grid <= 0 ||
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(out)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (stages == 0) {  // each tile in registers
    const long long n_tiles = (long long)bh * ((s + group - 1) / group);
    const int n_rows = kQuantThreads / (d / 8);
    if (d > 128 || unit_rows != group || staged_rows != group || grid != n_tiles ||
        (group + n_rows - 1) / n_rows > kRegRows)
      return (int)cudaErrorInvalidValue;
    const bool four = (group + n_rows - 1) / n_rows <= 4;
    if (k_is_bf16) {
      auto kern =
          four ? quant_k_regs_kernel<__nv_bfloat16, 4> : quant_k_regs_kernel<__nv_bfloat16, 8>;
      kern<<<grid, kQuantThreads, 0, st>>>((const __nv_bfloat16*)k, (const float*)km,
                                           (int8_t*)out, (float*)scales, s, d, group, qmax,
                                           inv_qmax);
    } else {
      auto kern = four ? quant_k_regs_kernel<float, 4> : quant_k_regs_kernel<float, 8>;
      kern<<<grid, kQuantThreads, 0, st>>>((const float*)k, (const float*)km, (int8_t*)out,
                                           (float*)scales, s, d, group, qmax, inv_qmax);
    }
    return (int)cudaGetLastError();
  }
  if (unit_rows <= 0 || stages < 0 || stages > kMaxStages || staged_rows < 0 ||
      staged_rows > group || staged_rows % unit_rows != 0 || staged_rows / unit_rows > stages)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)stages * unit_rows * d * (k_is_bf16 ? 2 : 4);
  if (smem > (size_t)kRingBytes) return (int)cudaErrorInvalidValue;
  static bool ready[2][qsm90::kMaxDevices];  // the ring's limit set, by type and device
  if (k_is_bf16) {
    auto kern = quant_k_kernel<__nv_bfloat16>;
    const cudaError_t e = qsm90::set_once((const void*)kern, kRingBytes, false, ready[1]);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kQuantThreads, smem, st>>>((const __nv_bfloat16*)k, (const float*)km,
                                            (int8_t*)out, (float*)scales, bh, s, d, group, qmax,
                                            inv_qmax, unit_rows, stages, staged_rows);
  } else {
    auto kern = quant_k_kernel<float>;
    const cudaError_t e = qsm90::set_once((const void*)kern, kRingBytes, false, ready[0]);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kQuantThreads, smem, st>>>((const float*)k, (const float*)km, (int8_t*)out,
                                            (float*)scales, bh, s, d, group, qmax, inv_qmax,
                                            unit_rows, stages, staged_rows);
  }
  return (int)cudaGetLastError();
}
