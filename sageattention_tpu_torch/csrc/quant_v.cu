// Per-channel V quantizer for Hopper (sm_90a): int8, fp8 e4m3 or fp8 e5m2
// codes with one fp32 scale per (b, h, channel) and, for smooth-v, the
// channel mean over the sequence.
//
// Replaces the TPU kernels quant_pallas.py:quant_v_per_channel
// (_quant_v_kernel: one pass over a VMEM-resident [s, d] slab) and
// quant_pallas.py:_quant_v_blocked (_v_stats_kernel, an XLA combine and
// _v_apply_kernel: the two-pass form for slabs over 4 MB).  Three launches:
//
//   quant_v_per_channel  kernel 5, on slabs of at most 4 MB (the JAX rule,
//                        quant_cuda.V_SINGLE_PASS_BYTES).  A thread-block
//                        cluster of cl CTAs (1-16; 16 is a non-portable
//                        size) takes a (b,h) slab, the CTAs splitting its
//                        rows; as many clusters as the card holds walk
//                        the slabs (quant_cuda.quant_v_plan).  Each CTA
//                        stages its rows in shared memory (each thread
//                        copies by cp.async the chunks it reads itself, in
//                        eight pieces) and takes their per-channel max,
//                        min and sum as the pieces land; the CTAs exchange
//                        these over distributed shared memory and each
//                        combines them in rank order, so every CTA holds
//                        the same mean, scale and r; rank 0 writes scale
//                        and mean; the codes come from the staged rows,
//                        and each piece, as its codes leave, takes the
//                        cluster's next slab.  V is read from device
//                        memory once.  Rows beyond a CTA's room (a 4 MB
//                        slab over 16 CTAs) are read for the statistics
//                        and again, from the L2 the cluster just filled,
//                        for the codes.  The plan's other candidate, the
//                        column split, launches a CTA per (b,h, 8
//                        channels) that reads its columns twice, without
//                        a cluster's launch cost; the plan takes whichever
//                        of these its time model, fitted to an H100's
//                        times of each, predicts the faster.
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
// mean is sum/s in the port's own summation order (kernel 5's:
// quant_cuda.v_partition_sum); amax =
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

#include <cooperative_groups.h>

#include "quant_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using qsm90::load8;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // rows a thread has in flight
constexpr int kMaxD = 512;  // the widest head dim (the kernels' 512)
constexpr int kStageBytes = 192 * 1024;  // kernel 5's staged rows a CTA (quant_cuda.V_STAGE_BYTES)
constexpr int kPieces = 8;               // kernel 5's pieces a CTA
constexpr int kMaxCluster = 16;

enum CodeKind { kInt8 = 0, kE4M3 = 1, kE5M2 = 2 };

// f32(1/qmax) for int8, e4m3 and e5m2, as the spec's inv_scale
__device__ inline float inv_qmax(int kind) {
  return kind == kInt8 ? (float)(1.0 / 127.0)
                       : kind == kE4M3 ? (float)(1.0 / 448.0) : (float)(1.0 / 57344.0);
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

// Kernel 5's shared memory: the staged rows (stage_rows x d elements), the
// row groups' statistics [3][kThreads * 8] fp32, the CTA's partials [3][d],
// mean and r [2][d]
inline size_t v_smem_bytes(int stage_rows, int d, int elem) {
  return ((size_t)stage_rows * d * elem + 15) / 16 * 16 + sizeof(float) * (3 * kThreads * 8) +
         sizeof(float) * 5 * d;
}

// Kernel 5.  gridDim.x / cl clusters walk the bh slabs, cluster c taking
// slabs c, c + n_clusters, ...  CTA `rank` takes the rows [rank rpc, (rank +
// 1) rpc) of each slab (rpc = rows_per_cta), stages the first stage_rows of
// them in up to kPieces pieces, and reads the rest from device memory.
// Thread i takes the 8 channels 8 (i % nv) of the rows i / nv, i / nv + n,
// ... of its CTA's rows (nv = d / 8, n = kThreads / nv; at d 384 the last 16
// threads none), and stages exactly those chunks itself by cp.async, a
// commit group a piece, so it waits for its own copies alone; as it writes
// a piece's codes it copies its chunks of the next slab into the piece.  It
// sums its rows in row order from 0; the row groups' sums are added in
// group order, the CTAs' in rank order (quant_cuda.v_partition_sum
// computes the same sum in PyTorch).  The cluster barrier is split: a CTA
// arrives when it has read the others' partials and waits before it
// writes its next partials.
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
quant_v_kernel(const T* __restrict__ v, uint8_t* __restrict__ out, float* __restrict__ scale,
               float* __restrict__ mean, int bh_total, int s, int d, int smooth,
               int rows_per_cta, int stage_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n_clusters = gridDim.x / cl, tid = threadIdx.x;
  const int r0 = min(s, rank * rows_per_cta), rows = min(s, r0 + rows_per_cta) - r0;
  const int staged = min(rows, stage_rows);
  T* stage = reinterpret_cast<T*>(smem);
  float* grp = reinterpret_cast<float*>(smem + ((size_t)stage_rows * d * sizeof(T) + 15) / 16 * 16);
  float* part = grp + 3 * kThreads * 8;  // [3][d]: max, min, sum
  float* mr = part + 3 * d;              // [2][d]: mean, r
  const int pr = (staged + kPieces - 1) / kPieces;  // rows a piece
  const int np = staged > 0 ? (staged + pr - 1) / pr : 0;
  const int nv = d / 8, n = kThreads / nv, vi = tid % nv, g = tid / nv;
  const bool active = g < n;
  T* mine = stage + vi * 8;  // this thread's chunks: row r at mine + r d
  // this thread's chunks of piece p of slab bh, one commit group
  auto load_piece = [&](int bh, int p) {
    if (active) {
      const T* src = v + ((size_t)bh * s + r0) * d + vi * 8;
      for (int r = qsm90::first_row(p * pr, g, n); r < min(staged, (p + 1) * pr); r += n)
        qsm90::cp_async8(mine + (size_t)r * d, src + (size_t)r * d);
    }
    qsm90::cp_async_commit();
  };
  const int first = blockIdx.x / cl;
  for (int p = 0; p < np; ++p) load_piece(first, p);

  int k = 0;  // this CTA's slab count
  for (int bh = first; bh < bh_total; bh += n_clusters, ++k) {
    const size_t row0 = (size_t)bh * s + r0;
    const T* src = v + row0 * d + vi * 8;
    const int next = bh + n_clusters < bh_total ? bh + n_clusters : -1;

    // ---- the CTA's max, min and sum of each channel ----------------------
    float mx[8], mn[8], sm[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[j] = -INFINITY;
      mn[j] = INFINITY;
      sm[j] = 0.f;
    }
    auto take = [&](const float* x, int) { accumulate8(x, mx, mn, sm); };
    for (int p = 0; p < np; ++p) {
      qsm90::cp_async_wait(np - p - 1);
      if (active) qsm90::for_rows(mine, p * pr, min(staged, (p + 1) * pr), g, n, d, take);
    }
    if (active) {
      qsm90::for_rows(src, staged, rows, g, n, d, take);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        grp[g * d + vi * 8 + j] = mx[j];
        grp[kThreads * 8 + g * d + vi * 8 + j] = mn[j];
        grp[2 * kThreads * 8 + g * d + vi * 8 + j] = sm[j];
      }
    }
    __syncthreads();
    // every CTA has read this CTA's partials of the last slab
    if (k > 0) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    for (int c = tid; c < d; c += kThreads) {
      float gmax = grp[c], gmin = grp[kThreads * 8 + c], gsum = grp[2 * kThreads * 8 + c];
#pragma unroll 8
      for (int q = 1; q < n; ++q) {
        gmax = fmaxf(gmax, grp[q * d + c]);
        gmin = fminf(gmin, grp[kThreads * 8 + q * d + c]);
        gsum += grp[2 * kThreads * 8 + q * d + c];
      }
      part[c] = gmax;
      part[d + c] = gmin;
      part[2 * d + c] = gsum;
    }
    cluster.sync();  // every CTA's partials, visible to the cluster

    // ---- the cluster's statistics, in rank order; mean, scale, r ---------
    for (int c = tid; c < d; c += kThreads) {
      float qx[kMaxCluster], qn[kMaxCluster], qs[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {  // every rank's loads first
        if (q < cl) {
          const float* pq = cluster.map_shared_rank(part, q);
          qx[q] = pq[c];
          qn[q] = pq[d + c];
          qs[q] = pq[2 * d + c];
        }
      }
      float gmax = qx[0], gmin = qn[0], gsum = qs[0];
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q) {
        if (q < cl) {
          gmax = fmaxf(gmax, qx[q]);
          gmin = fminf(gmin, qn[q]);
          gsum += qs[q];
        }
      }
      float m, r, sc;
      channel_scale(gmax, gmin, gsum, s, smooth, KIND, &m, &r, &sc);
      mr[c] = m;
      mr[d + c] = r;
      if (rank == 0) {
        scale[(size_t)bh * d + c] = sc;
        if (smooth) mean[(size_t)bh * d + c] = m;
      }
    }
    // this CTA has read the others' partials
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    __syncthreads();

    // ---- the codes, from the staged rows; each piece then takes this
    // thread's chunks of the next slab -------------------------------------
    float m8[8], r8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m8[j] = active ? mr[vi * 8 + j] : 0.f;
      r8[j] = active ? mr[d + vi * 8 + j] : 0.f;
    }
    uint8_t* dst = out + row0 * d + vi * 8;
    auto code = [&](const float* x, int r) { encode8<KIND>(x, m8, r8, dst + (size_t)r * d); };
    for (int p = 0; p < np; ++p) {
      if (active) qsm90::for_rows(mine, p * pr, min(staged, (p + 1) * pr), g, n, d, code);
      if (next >= 0) load_piece(next, p);
    }
    if (active) qsm90::for_rows(src, staged, rows, g, n, d, code);
  }
  // no CTA leaves while another reads its partials
  if (k > 0) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Kernel 5's column split (the plan's cl 0, where quant_cuda.quant_v_plan
// predicts it faster than any cluster, as where all of V is small and its
// second read comes from L2): one CTA per (b,h, group of 8 channels) over
// the whole sequence, no cluster; pass 1 takes the group's max, min and sum
// (thread i its rows i, i + 256, ... in row order from 0, the lanes' sums by
// a butterfly over xor 1, 2, ..., 16, the warps' in warp order), pass 2
// reads the rows again and writes the codes.  At (1, 16, 4096, 64) the
// clusters took 1.27x its time, about 8 us of theirs outside their CTAs
// (the cluster launch, PERF.md).
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
quant_v_columns_kernel(const T* __restrict__ v, uint8_t* __restrict__ out,
                       float* __restrict__ scale, float* __restrict__ mean, int s, int d,
                       int smooth) {
  __shared__ float red[3][kWarps][8];
  __shared__ float stat[2][8];  // mean, r of the group's channels
  const int c0 = blockIdx.x * 8, bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t slab = (size_t)bh * s * d;
  const T* base = v + slab + c0;

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

// kernel 5's instance for V's type and the code kind, with its record of
// the devices its attributes are set on
template <typename T>
void* quant_v_instance(int kind, bool** ready) {
  static bool done[3][qsm90::kMaxDevices];
  *ready = done[kind];
  return kind == kInt8   ? (void*)quant_v_kernel<T, kInt8>
         : kind == kE4M3 ? (void*)quant_v_kernel<T, kE4M3>
                         : (void*)quant_v_kernel<T, kE5M2>;
}

// the largest shared memory a CTA of kernel 5 takes (v_smem_bytes at
// kStageBytes of rows, head dim 512)
constexpr int kMaxSmem = kStageBytes + sizeof(float) * (3 * kThreads * 8 + 5 * kMaxD);

static_assert(kMaxSmem <= 232448, "kernel 5's shared memory exceeds a CTA's 227 KB");

// the launch configuration of kernel 5 (n clusters of cl CTAs), with its
// instance's attributes set once a device (its shared memory, clusters
// above 8 CTAs)
cudaError_t quant_v_config(const void* kern, bool* ready, int n, int cl, size_t smem,
                           cudaStream_t st, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const cudaError_t e = qsm90::set_once(kern, kMaxSmem, true, ready);
  *cfg = {};
  cfg->gridDim = dim3(n * cl);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

template <typename T>
int launch_columns(const T* v, uint8_t* out, float* scale, float* mean, int bh, int s, int d,
                   int kind, int smooth, cudaStream_t st) {
  const dim3 grid(d / 8, bh);
  if (kind == kInt8)
    quant_v_columns_kernel<T, kInt8>
        <<<grid, kThreads, 0, st>>>(v, out, scale, mean, s, d, smooth);
  else if (kind == kE4M3)
    quant_v_columns_kernel<T, kE4M3>
        <<<grid, kThreads, 0, st>>>(v, out, scale, mean, s, d, smooth);
  else
    quant_v_columns_kernel<T, kE5M2>
        <<<grid, kThreads, 0, st>>>(v, out, scale, mean, s, d, smooth);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_quant_v(const void* v, void* out, void* scale, void* mean, int bh, int s, int d,
                   int kind, int smooth, int cl, int rows_per_cta, int stage_rows, int clusters,
                   cudaStream_t st) {
  if (cl == 0)
    return launch_columns((const T*)v, (uint8_t*)out, (float*)scale, (float*)mean, bh, s, d, kind,
                          smooth, st);
  bool* ready;
  const void* kern = quant_v_instance<T>(kind, &ready);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = quant_v_config(kern, ready, clusters, cl,
                                 v_smem_bytes(stage_rows, d, sizeof(T)), st, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&v, &out,  &scale,        &mean,      &bh, &s,
                  &d,        &smooth, &rows_per_cta, &stage_rows};
  e = cudaLaunchKernelExC(&cfg, kern, args);
  if (e != cudaSuccess) return (int)e;
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

// v: [bh, s, d] (bf16 if v_is_bf16 else fp32), contiguous and 16-byte
// aligned, d in {64, 128, 256, 384, 512}; out: [bh, s, d] codes (kind 0
// int8, 1 fp8 e4m3, 2 fp8 e5m2); scale: fp32 [bh, d]; mean: fp32 [bh, d],
// written when smooth (may be NULL otherwise).  The plan
// (quant_cuda.quant_v_plan): clusters of cl CTAs (1, 2, 4, 8 or 16), each
// CTA rows_per_cta rows (cl rows_per_cta >= s), at most stage_rows of them
// staged; `clusters` clusters (1 to bh) walk the slabs.  cl 0: the column
// split (quant_v_columns_kernel; the other plan fields unused).
extern "C" int quant_v_per_channel(const void* v, void* out, void* scale, void* mean, int bh,
                                   int s, int d, int v_is_bf16, int kind, int smooth, int cl,
                                   int rows_per_cta, int stage_rows, int clusters,
                                   void* stream) {
  const int elem = v_is_bf16 ? 2 : 4;
  if (bad_shape(bh, s, d) || kind < 0 || kind > 2 || (smooth && mean == nullptr) ||
      ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (cl != 0 && ((cl != 1 && cl != 2 && cl != 4 && cl != 8 && cl != 16) || rows_per_cta <= 0 ||
                  (long long)rows_per_cta * cl < s || stage_rows < 0 ||
                  (long long)stage_rows * d * elem > kStageBytes || clusters < 1 ||
                  clusters > bh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return v_is_bf16 ? launch_quant_v<__nv_bfloat16>(v, out, scale, mean, bh, s, d, kind, smooth,
                                                   cl, rows_per_cta, stage_rows, clusters, st)
                   : launch_quant_v<float>(v, out, scale, mean, bh, s, d, kind, smooth, cl,
                                           rows_per_cta, stage_rows, clusters, st);
}

// How many clusters of cl CTAs of kernel 5 (bf16 or fp32 V), each CTA with
// `smem` bytes of shared memory (quant_cuda.v_smem_bytes), the card holds
// at once, into *active (cudaOccupancyMaxActiveClusters); 0 where it cannot
// place one.
extern "C" int quant_v_cluster_room(int cl, int smem, int v_is_bf16, int* active) {
  if (cl < 1 || cl > kMaxCluster || smem < 0 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  bool* ready;
  const void* kern = v_is_bf16 ? quant_v_instance<__nv_bfloat16>(kInt8, &ready)
                               : quant_v_instance<float>(kInt8, &ready);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = quant_v_config(kern, ready, 1, cl, smem, nullptr, &cfg, &attr);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(active, kern, &cfg);
  return (int)e;
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
