// Kernel 4: the row-group int8 quantizer of Q and K for Hopper (sm_90a).
//
// Replaces the TPU kernel quant_pallas.py:quant_q_per_token
// (_quant_rows_kernel) and, on the card, the XLA chains of the JAX
// package's Q/K options that compute the same function over a group of
// rows with a mean taken off first: quant.py:quant_int8 at every
// granularity (quant.py:85-116), quantize_qk's smoothed K (quant.py:264-296)
// and smooth_q's centred Q (core.py:274-275).  It computes
// quant.quant_int8(x', granularity, block_size, scale_fold, bits) of the
// port's quant.py, with x' one of
//
//   x                        (no mean),
//   f32(x) - mean            (the K side of an option, after sub_mean),
//   cast(f32(x) - mean)      (smooth_q's Q, cast back to the caller's
//                             16-bit type, round to nearest even, as
//                             .to(dtype) and XLA's convert do),
//
// mean the fp32 per-(b,h) channel mean [bh, d], over groups of `group` rows
// of each (b,h) slab (1: per_token; 32: per_subtile; 128: per_block): the
// group's amax over its LIVE rows (a ragged last group takes its own),
// scale = max(amax,1e-30) * (1/qmax), r = 1/scale, code = roundf(x' * r)
// (half away from zero; computed by code_of) clipped to +-qmax (127, or 7
// for bits=4: the +-7
// codes that sageattn's qk_bits=4 feeds the pre-quantized forward), and one
// scale a row with the fold multiplied in, max(amax,1e-30) * qs_mul with
// qs_mul = f32(1/qmax) * f32(fold) (the reassociated form XLA compiles the
// spec into), the layout attention_fwd_preq.cu reads.
//
// The backward re-quantizes Q with it (group 1, no mean), and the forward
// kernel (attention_fwd.cu) quantized the same rows inside the kernel; the
// saved base-2 LSE was built from those scales, so P = exp2(l2 - lse2) only
// normalises if both agree bit for bit.  This kernel therefore keeps the
// forward's fp32 chain exactly: x - 0 is x, so subtracting a zero mean where
// there is none changes no bit.  The JAX forward quantizes Q inside its
// kernel with the same chain (attention_pallas.py:475-503), so at qmax 7
// these are its codes too.  Built without --use_fast_math so that 1/scale
// is an IEEE divide.
//
// Bound: bytes.  A few flops per element; the least time is reading x once
// and writing the int8 codes and one fp32 scale a row.  Design (the plan,
// quant_cuda.quant_q_plan): a row takes L lanes (8 at d 64, 16 at d 128 and
// 384, 32 at 256 and 512), each lane 8 columns of it by 16-byte loads (three
// 8-column chunks a lane at d 384, two at 512), so a warp holds W = 32 / L
// rows side by side (4 at d 64) and each thread R of them in flight
// ("slots", 1-16), every load issued before the first is used and the
// tile kept in registers for the codes (x' in place of x where x's type
// holds it): x is read once.  A 256-thread CTA holds 8 W R rows.  One row's amax is a shuffle
// among its L lanes; a group's, a shuffle over the warp, then over the
// group's warps in shared memory.  A group larger than a CTA's registers
// hold (128 rows at d 256 in fp32, at d 384 and 512) is split over a
// thread-block cluster of `cl` CTAs that exchange their amax over
// distributed shared memory.  The mean is loaded once a CTA.  Only the
// slot counts the plan picks are built (slots_of).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeldBytes = 256;  // quant_cuda.Q_HELD_BYTES: x a thread holds
constexpr int kMaxCluster = 8;
constexpr int kTokenElems = 16;  // quant_cuda.Q_TOKEN_ELEMS
constexpr int kGroupSlots = 4;   // quant_cuda.Q_GROUP_SLOTS

// the lanes that share a row: as many of a warp's as divide its d / 8
// chunks (32 at d 256 and 512, 16 at d 128 and 384, 8 at d 64)
__host__ __device__ constexpr int lanes_of(int d) {
  return ((d / 8) & -(d / 8)) < 32 ? ((d / 8) & -(d / 8)) : 32;
}

// the most slots (rows in flight) a thread holds: 16, 8, 4, 2 or 1, at most
// kHeldBytes of x (64 registers)
template <int D, typename T>
constexpr int held_max() {
  int r = 16;
  while (r > 1 && r * (D / 8 / lanes_of(D)) * 8 * (int)sizeof(T) > kHeldBytes) r /= 2;
  return r;
}

// the slots quant_cuda.quant_q_plan gives groups of `group` rows (1, 32 or
// 128): at one row a group kTokenElems of a row's elements a thread, twice
// as many with a mean; else the fewest from kGroupSlots up with which a CTA
// holds the group, or where none does kGroupSlots (the group split over a
// cluster), or fewer where a thread holds fewer
template <int D, typename T>
constexpr int slots_of(int group, bool mean) {
  constexpr int chunks = D / 8 / lanes_of(D);
  if (group == 1) {
    const int r = kTokenElems * (mean ? 2 : 1) / (chunks * 8);
    return r < 1 ? 1 : r;
  }
  const int rows = kWarps * (32 / lanes_of(D));  // a CTA's rows a slot
  for (int r = kGroupSlots; r <= held_max<D, T>(); r *= 2)
    if (rows * r >= group) return r;
  return held_max<D, T>() < kGroupSlots ? held_max<D, T>() : kGroupSlots;
}

// the rounding of smooth_q's centred Q back to the caller's 16-bit type:
// bf16 for bf16 x, fp16 for fp32 x (fp16 q, widened exactly)
template <typename T>
__device__ inline float cast_back(float y);
template <>
__device__ inline float cast_back<__nv_bfloat16>(float y) {
  return __bfloat162float(__float2bfloat16_rn(y));
}
template <>
__device__ inline float cast_back<float>(float y) {
  return __half2float(__float2half_rn(y));
}

// roundf(v) clipped to +-qmax, as an integer, in fewer operations than
// roundf: clipping first changes nothing (qmax is an integer and rounding
// is monotone; NaN clips to -qmax either way, as fmaxf takes the number),
// and on the clipped value half away from zero is trunc(v + copysign(0.5,
// v)) with the sum rounded toward zero, which never carries it past the
// next integer (round to nearest would take 0.49999997 + 0.5 to 1)
__device__ inline int code_of(float v, float qmax) {
  const float c = fminf(fmaxf(v, -qmax), qmax);
  return __float2int_rz(__fadd_rz(c, copysignf(0.5f, c)));
}

// MODE: 0 x' = x (no mean), 1 x' = f32(x) - mean, 2 x' = cast(f32(x) -
// mean).  CTA c of tile c / cl, rank c % cl in its cluster, takes RC = 8 W R
// rows of slab bh from ((c / cl) % tiles) cl + rank) RC on; thread (warp,
// lane) holds its rows warp W R + i W + lane / L (slot i < R), of each the
// 8 columns 8 (lane % L + c L) (chunk c < C).  A group is one row (group
// 1), or group / (W R) warps of one CTA (group <= RC), or the whole cluster
// (group = RC cl).
template <int D, typename T, int R, int MODE>
__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                  int8_t* __restrict__ out, float* __restrict__ scales, int s, int group,
                  float qmax, float inv_qmax, float qs_mul, int tiles, int cl) {
  constexpr int NV = D / 8;  // 8-column chunks a row
  constexpr int L = lanes_of(D);  // lanes a row
  constexpr int W = 32 / L;  // rows a warp holds side by side
  constexpr int C = NV / L;  // chunks a lane
  constexpr int RW = W * R;             // rows a warp holds
  constexpr int RC = kWarps * RW;       // rows a CTA holds
  __shared__ float red[kWarps];
  __shared__ float xchg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tl = lane % L;
  const int rank = blockIdx.x % cl, tile = blockIdx.x / cl;
  const int bh = tile / tiles;
  const int row0 = ((tile % tiles) * cl + rank) * RC + warp * RW + lane / L;
  const size_t slab = (size_t)bh * s;

  constexpr bool CAST = MODE == 2;
  float mu[MODE ? C : 1][8];  // the mean's columns of this lane's chunks
  if (MODE) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int v = tl + c * L;
      if (v < NV) qsm90::load8(mean + (size_t)bh * D + v * 8, mu[c]);
    }
  }
  // x' of chunk c as fp32
  auto prep = [&](const qsm90::Raw8<T>& raw, int c, float* y) {
    qsm90::unpack(raw, y);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (MODE) y[j] -= mu[MODE ? c : 0][j];
      if (CAST) y[j] = cast_back<T>(y[j]);
    }
  };
  // x' kept in place of x where its type holds it (fp32 x; x' rounded to
  // bf16 for bf16 x; x itself), so the codes do not compute it again
  constexpr bool KEEP = MODE != 1 || sizeof(T) == 4;
  qsm90::Raw8<T> raw[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + i * W;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int v = tl + c * L;
      if (r < s && v < NV) qsm90::load_raw(x + (slab + r) * D + v * 8, raw[i][c]);
    }
  }

  // ---- amax: each slot's over its row's lanes, or the group's --------------
  float a[R];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    a[i] = 0.f;
    if (row0 + i * W < s) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (tl + c * L < NV) {
          float y[8];
          prep(raw[i][c], c, y);
#pragma unroll
          for (int j = 0; j < 8; ++j) a[i] = fmaxf(a[i], fabsf(y[j]));
          if (KEEP && MODE) qsm90::pack(y, raw[i][c]);
        }
      }
    }
    m = fmaxf(m, a[i]);
  }
  if (group == 1) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        a[i] = fmaxf(a[i], __shfl_xor_sync(0xffffffffu, a[i], o));
  } else {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const int wg = group / RW < kWarps ? group / RW : kWarps;  // warps a group
    if (wg > 1) {
      if (lane == 0) red[warp] = m;
      __syncthreads();
      const int w0 = warp / wg * wg;
      m = red[w0];
      for (int w = 1; w < wg; ++w) m = fmaxf(m, red[w0 + w]);
    }
    if (cl > 1) {  // the cluster's CTAs share one group: exchange their amax
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x == 0) xchg = m;
      cluster.sync();
      for (int q = 0; q < cl; ++q) m = fmaxf(m, *cluster.map_shared_rank(&xchg, q));
      cluster.sync();  // no CTA leaves while another reads its amax
    }
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = m;
  }

  // ---- codes and the folded scales -----------------------------------------
  // the codes read x (or x') again from raw: the fp32 values of the amax
  // sweep would hold twice the registers for bf16 x
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) qsm90::pin(raw[i][c]);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + i * W;
    if (r >= s) continue;
    const float scale = fmaxf(a[i], 1e-30f) * inv_qmax;
    const float r_scale = 1.0f / scale;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int v = tl + c * L;
      if (v < NV) {
        float y[8];
        if (KEEP)
          qsm90::unpack(raw[i][c], y);
        else
          prep(raw[i][c], c, y);
        union { int8_t b[8]; uint2 u; } q;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          q.b[j] = (int8_t)code_of(y[j] * r_scale, qmax);
        *reinterpret_cast<uint2*>(out + (slab + r) * D + v * 8) = q.u;
      }
    }
    if (tl == 0) scales[slab + r] = fmaxf(a[i], 1e-30f) * qs_mul;
  }
}

struct Args {
  const void* x;
  const float* mean;
  int8_t* out;
  float* scales;
  int bh, s, group, cast;
  float qmax, inv_qmax, qs_mul;
  int slots, cl, tiles;
};

template <int D, typename T, int R, int MODE>
int launch_one(const Args& a, cudaStream_t st) {
  auto kern = quant_rows_kernel<D, T, R, MODE>;
  const unsigned grid = (unsigned)((long long)a.bh * a.tiles * a.cl);
  if (a.cl == 1) {
    kern<<<grid, kThreads, 0, st>>>((const T*)a.x, a.mean, a.out, a.scales, a.s, a.group,
                                    a.qmax, a.inv_qmax, a.qs_mul, a.tiles, a.cl);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, (const T*)a.x, a.mean, a.out, a.scales,
                                           a.s, a.group, a.qmax, a.inv_qmax, a.qs_mul, a.tiles,
                                           a.cl);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the one instance the plan gives (D, T, GROUP, MODE): slots_of's R
template <int D, typename T, int GROUP, int MODE>
int launch_group(const Args& a, cudaStream_t st) {
  constexpr int R = slots_of<D, T>(GROUP, MODE != 0);
  static_assert(R <= held_max<D, T>(), "more rows than a thread holds");
  if (a.slots != R) return (int)cudaErrorInvalidValue;
  return launch_one<D, T, R, MODE>(a, st);
}

template <int D, typename T, int MODE>
int launch_mode(const Args& a, cudaStream_t st) {
  switch (a.group) {
    case 1: return launch_group<D, T, 1, MODE>(a, st);
    case 32: return launch_group<D, T, 32, MODE>(a, st);
    default: return launch_group<D, T, 128, MODE>(a, st);
  }
}

template <int D, typename T>
int launch_t(const Args& a, cudaStream_t st) {
  if (a.mean == nullptr) return launch_mode<D, T, 0>(a, st);
  return a.cast ? launch_mode<D, T, 2>(a, st) : launch_mode<D, T, 1>(a, st);
}

template <int D>
int launch_d(const Args& a, int x_is_f32, cudaStream_t st) {
  return x_is_f32 ? launch_t<D, float>(a, st) : launch_t<D, __nv_bfloat16>(a, st);
}

}  // namespace

// x: [bh, s, d] contiguous, 16-byte aligned (bf16 if x_is_f32 == 0, else
// fp32), d in {64, 128, 256, 384, 512}; mean: fp32 [bh, d], 16-byte
// aligned, or NULL; out: int8 [bh, s, d]; scales: fp32 [bh, s].  group: 1,
// 32 or 128; cast: 0, or 1 (with a mean) to round x - mean to the caller's
// 16-bit type (bf16 for bf16 x, fp16 for fp32 x) before the amax and the
// codes; qmax 127 or 7, inv_qmax = f32(1/qmax), qs_mul = f32(1/qmax) *
// f32(fold).  The plan (quant_cuda.quant_q_plan): `slots` rows a thread
// holds (slots_of's), clusters of `cl` CTAs, `tiles` clusters a slab; cl > 1
// only where a group is exactly a cluster's rows.
extern "C" int quant_rows(const void* x, const void* mean, void* out, void* scales, int bh,
                          int s, int d, int x_is_f32, int group, int cast, float qs_mul,
                          float qmax, float inv_qmax, int slots, int cl, int tiles,
                          void* stream) {
  if (bh <= 0 || s <= 0 || (d != 64 && d != 128 && d != 256 && d != 384 && d != 512) ||
      (cast != 0 && cast != 1) || (cast && mean == nullptr) || slots <= 0 || cl <= 0 ||
      cl > kMaxCluster || tiles <= 0 || (group != 1 && group != 32 && group != 128) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(mean) |
        reinterpret_cast<uintptr_t>(out)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int rw = 32 / lanes_of(d) * slots, rc = kWarps * rw, span = rc * cl;
  if ((long long)tiles * span < s || (long long)(tiles - 1) * span >= s)
    return (int)cudaErrorInvalidValue;
  if (group == 1 ? cl != 1
                 : (group % rw != 0 ||
                    (group <= rc ? (cl != 1 || rc % group != 0) : group != span)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, (const float*)mean, (int8_t*)out, (float*)scales, bh, s, group, cast,
               qmax, inv_qmax, qs_mul, slots, cl, tiles};
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 64: return launch_d<64>(a, x_is_f32, st);
    case 128: return launch_d<128>(a, x_is_f32, st);
    case 256: return launch_d<256>(a, x_is_f32, st);
    case 384: return launch_d<384>(a, x_is_f32, st);
    default: return launch_d<512>(a, x_is_f32, st);
  }
}
