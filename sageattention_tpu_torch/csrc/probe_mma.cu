// Tensor-core, special-function and memory rate probe for Hopper (sm_90a):
// the port of the TPU kernel tools/probe_mxu.py:_time_variant ->
// _probe_kernel, which timed the MXU and VPU primitives the fused attention
// kernel issues, to answer kernel-design questions with rates measured on
// the chip instead of data-sheet ones.  These kernels ask the same
// questions of this card, for the instructions the port's kernels issue
// (mma.sync, csrc/mma_sm90.cuh) and for the ones a later kernel would
// (wgmma):
//
//   probe_sync_kernel<OP, NT, KS>   mma.sync m16n8k32 (s8, e4m3) or m16n8k16
//                                   (bf16): a warp's 16 x (8 NT) tile of
//                                   acc += x . y^T, KS 32-byte K steps a rep;
//   probe_wgmma_kernel<OP, N, KS>   wgmma.mma_async m64nNk32 (s8, e4m3) or
//                                   m64nNk16 (bf16), A from registers, B from
//                                   shared memory by a descriptor (no swizzle;
//                                   the wrappers in wgmma_sm90.cuh): a
//                                   warpgroup's 64 x N tile, KS K steps a rep;
//   probe_elem_kernel<BODY>         a softmax-chain pass a rep over a warp's
//                                   16 x 128 fp32 fragment: ex2.approx.f32,
//                                   exp2f as the kernels compile it, a row max
//                                   or a row sum by warp shuffles, f32 -> bf16
//                                   -> f32, f32 -> int8 quantize of a P tile;
//   probe_hbm_read / probe_hbm_copy a streaming reduction and a copy, reps
//                                   passes over the buffer.
//
// Each product and pass is the JAX probe's dependent chain (probe_mxu.py:
// 43-56), with its accumulator zeroed (the JAX kernel never zeroes its
// scratch): rep r reads acc[row, 0] of rep r - 1 and perturbs the row's
// operand by it, x + (acc & 1) on int8 codes (wrapping) and x +
// bf16(acc) * bf16(1e-30) on bf16 values, fp32 x + acc * 1e-30 for the
// passes (e4m3 takes no perturbation: 1e-30 cast to e4m3 is 0), then
// acc += body(x', y).  So no rep can start before the last one's column 0
// is known, every accumulator register is written to global memory at the
// end, and every product is an asm volatile statement: the compiler can
// neither fold the chain nor drop a product (the JAX probe's "known
// limitation", probe_mxu.py:137-142, where Mosaic folded it and reported
// 33k TOPS).  The other accumulators of a warp (NT of them for mma.sync; N / 8
// column groups in a wgmma) and the other warps of an SM hide the
// dependency's latency.  The same rule in PyTorch is the plain chain of
// sageattention_tpu_torch/utils/probe_mma.py, which the card's results are
// held to (int32 bit-exact, fp32 within 1e-3 relative).
//
// Bound: each probe is bound by the unit it measures (the tensor cores, the
// special-function units, the FP32 lanes, device memory), by construction:
// its operands sit in registers and shared memory, loaded once.  The rate
// is the slope between two rep counts (the JAX probe's method), which
// cancels the launch and the load of the operands.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

enum Op { kS8 = 0, kBf16 = 1, kE4m3 = 2 };
enum Body { kEx2 = 0, kExp2f = 1, kRowMax = 2, kRowSum = 3, kCastBf16 = 4, kQuantInt8 = 5 };
constexpr int WARPS = 4, THREADS = WARPS * 32;  // a CTA: 4 warps, one warpgroup
constexpr int KB = 32;     // bytes of K a step: k32 for 8-bit codes, k16 for bf16
constexpr int EW = 128;    // columns of a pass's fragment: a KV tile
constexpr int HBM_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int OP>
struct AccOf {
  using T = float;
};
template <>
struct AccOf<kS8> {
  using T = int;
};

__device__ inline void mma_e4m3(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int OP>
__device__ inline void mma_op(typename AccOf<OP>::T* c, const uint32_t* a, uint32_t b0,
                              uint32_t b1) {
  if constexpr (OP == kS8)
    mma_s8(c, a, b0, b1);
  else if constexpr (OP == kBf16)
    mma_bf16(c, a, b0, b1);
  else
    mma_e4m3(c, a, b0, b1);
}

__device__ inline uint32_t add_bf16x2(uint32_t v, __nv_bfloat162 p) {
  __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&v), p);
  return *reinterpret_cast<uint32_t*>(&r);
}

// The step rule on a thread's A fragment (rows g and g + 8: a[0], a[2] row
// g, a[1], a[3] row g + 8), from s_lo = acc[g, 0] and s_hi = acc[g + 8, 0]
template <int OP, typename T>
__device__ inline void perturb(uint32_t* xa, const uint32_t* a, T s_lo, T s_hi) {
  if constexpr (OP == kS8) {  // + (acc & 1) on each code, wrapping
    const uint32_t lo = (uint32_t)(s_lo & 1) * 0x01010101u;
    const uint32_t hi = (uint32_t)(s_hi & 1) * 0x01010101u;
    xa[0] = __vadd4(a[0], lo);
    xa[1] = __vadd4(a[1], hi);
    xa[2] = __vadd4(a[2], lo);
    xa[3] = __vadd4(a[3], hi);
  } else if constexpr (OP == kBf16) {  // + bf16(acc) * bf16(1e-30), in bf16
    const __nv_bfloat16 tiny = __float2bfloat16_rn(1e-30f);
    const __nv_bfloat162 lo = __bfloat162bfloat162(__hmul(__float2bfloat16_rn(s_lo), tiny));
    const __nv_bfloat162 hi = __bfloat162bfloat162(__hmul(__float2bfloat16_rn(s_hi), tiny));
    xa[0] = add_bf16x2(a[0], lo);
    xa[1] = add_bf16x2(a[1], hi);
    xa[2] = add_bf16x2(a[2], lo);
    xa[3] = add_bf16x2(a[3], hi);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) xa[i] = a[i];
  }
}

// the A fragment of rows g, g + 8 of a row-major tile whose thread row g
// (column 4t bytes) is at p; `stride` bytes a row
__device__ inline void load_frag(uint32_t* a, const uint8_t* p, int stride) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * stride + 16);
}

// The C fragment (rows g, g + 8; columns 8n + 2t, + 1) into a row-major
// [*, ncol] tile whose row 0 is `row0`
template <int NT, typename T>
__device__ inline void store_frag(T* out, T (*acc)[4], size_t row0, int ncol, int g,
                                  int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    out[(row0 + g) * ncol + col] = acc[n][0];
    out[(row0 + g) * ncol + col + 1] = acc[n][1];
    out[(row0 + g + 8) * ncol + col] = acc[n][2];
    out[(row0 + g + 8) * ncol + col + 1] = acc[n][3];
  }
}

// ---------------------------------------------------------------------------
// mma.sync: x [rows, KS * 32 bytes], y [8 NT, KS * 32 bytes], out [rows, 8 NT]
// ---------------------------------------------------------------------------

template <int OP, int NT, int KS>
__global__ void __launch_bounds__(THREADS)
probe_sync_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
                  void* __restrict__ out, int reps) {
  using T = typename AccOf<OP>::T;
  constexpr int K = KS * KB;  // bytes a row
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t row0 = ((size_t)blockIdx.x * WARPS + threadIdx.x / 32) * 16;
  uint32_t a[KS][4], b[NT][KS][2];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_frag(a[kk], x + (row0 + g) * K + kk * KB + t * 4, K);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint8_t* q = y + (size_t)(n * 8 + g) * K + kk * KB + t * 4;
      b[n][kk][0] = ld32(q);
      b[n][kk][1] = ld32(q + 16);
    }
  T acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    const T s_lo = __shfl_sync(FULL, acc[0][0], lane & ~3);
    const T s_hi = __shfl_sync(FULL, acc[0][2], lane & ~3);
    uint32_t xa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) perturb<OP>(xa[kk], a[kk], s_lo, s_hi);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) mma_op<OP>(acc[n], xa[kk], b[n][kk][0], b[n][kk][1]);
  }
  store_frag<NT>(static_cast<T*>(out), acc, row0, NT * 8, g, t);
}

// ---------------------------------------------------------------------------
// wgmma: the accumulator of m64nN is, in each warp, the C fragments of its
// 16 rows and N / 8 column groups in order (d[4j .. 4j + 3] of group j), and
// the register A fragment of a K step is mma.sync's (PTX ISA, wgmma register
// fragments); so the step rule and the store are the mma.sync kernel's
// ---------------------------------------------------------------------------

template <int OP, int N>
__device__ inline void wgmma_op(typename AccOf<OP>::T* d, const uint32_t* a, uint64_t desc) {
  if constexpr (OP == kS8)
    wgmma_s8<N>(d, a, desc);
  else if constexpr (OP == kBf16)
    wgmma_bf16<N>(d, a, desc);
  else
    wgmma_e4m3<N>(d, a, desc);
}

// x [rows, KS * 32 bytes] (64 rows a CTA), y [N, KS * 32 bytes], out [rows, N]
template <int OP, int N, int KS>
__global__ void __launch_bounds__(THREADS)
probe_wgmma_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
                   void* __restrict__ out, int reps) {
  using T = typename AccOf<OP>::T;
  constexpr int K = KS * KB;
  constexpr int STEP = N * KB;  // bytes of B a K step: N / 8 groups of two core matrices
  extern __shared__ __align__(128) uint8_t smem[];
  // y into core matrices: K step kk, 8-row group ng, half h of the step at
  // kk * STEP + ng * 256 + h * 128, its 8 rows 16 bytes apart
  for (int i = threadIdx.x; i < N * (K / 16); i += THREADS) {
    const int row = i / (K / 16), c = i % (K / 16);
    const int kk = c / 2, h = c % 2;
    *reinterpret_cast<uint4*>(smem + kk * STEP + (row / 8) * 256 + h * 128 + (row % 8) * 16) =
        *reinterpret_cast<const uint4*>(y + (size_t)row * K + c * 16);
  }
  // the generic proxy's stores made visible to wgmma's (async proxy) reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t row0 = (size_t)blockIdx.x * 64 + (threadIdx.x / 32) * 16;
  uint32_t a[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_frag(a[kk], x + (row0 + g) * K + kk * KB + t * 4, K);
  const uint64_t desc = smem_desc(smem, 128, 256);
  T acc[N / 8][4];
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    const T s_lo = __shfl_sync(FULL, acc[0][0], lane & ~3);
    const T s_hi = __shfl_sync(FULL, acc[0][2], lane & ~3);
    uint32_t xa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) perturb<OP>(xa[kk], a[kk], s_lo, s_hi);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_op<OP, N>(&acc[0][0], xa[kk], desc + (uint64_t)(kk * STEP / 16));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  store_frag<N / 8>(static_cast<T*>(out), acc, row0, N, g, t);
}

// ---------------------------------------------------------------------------
// the softmax chain's passes: x, out [rows, EW] fp32, 16 rows a warp
// ---------------------------------------------------------------------------

template <int BODY>
__global__ void __launch_bounds__(THREADS)
probe_elem_kernel(const float* __restrict__ x, float* __restrict__ out, int reps) {
  constexpr int NT = EW / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t row0 = ((size_t)blockIdx.x * WARPS + threadIdx.x / 32) * 16;
  float xv[NT][4], acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xv[n][e] = x[(row0 + g + (e < 2 ? 0 : 8)) * EW + col + (e & 1)];
      acc[n][e] = 0.f;
    }
  }
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    const float p_lo = __fmul_rn(__shfl_sync(FULL, acc[0][0], lane & ~3), 1e-30f);
    const float p_hi = __fmul_rn(__shfl_sync(FULL, acc[0][2], lane & ~3), 1e-30f);
    float xr[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xr[n][e] = __fadd_rn(xv[n][e], e < 2 ? p_lo : p_hi);
    float red_lo = 0.f, red_hi = 0.f;  // the row max or sum, broadcast to the row
    if constexpr (BODY == kRowMax || BODY == kRowSum) {
      red_lo = xr[0][0];
      red_hi = xr[0][2];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n == 0 && (e == 0 || e == 2)) continue;
          float& red = e < 2 ? red_lo : red_hi;
          red = BODY == kRowMax ? fmaxf(red, xr[n][e]) : __fadd_rn(red, xr[n][e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float o_lo = __shfl_xor_sync(FULL, red_lo, off);
        const float o_hi = __shfl_xor_sync(FULL, red_hi, off);
        red_lo = BODY == kRowMax ? fmaxf(red_lo, o_lo) : __fadd_rn(red_lo, o_lo);
        red_hi = BODY == kRowMax ? fmaxf(red_hi, o_hi) : __fadd_rn(red_hi, o_hi);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = xr[n][e];
        float y;
        if constexpr (BODY == kEx2) {
          asm volatile("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(v));
        } else if constexpr (BODY == kExp2f) {
          y = exp2f(v);
        } else if constexpr (BODY == kRowMax || BODY == kRowSum) {
          y = __fadd_rn(e < 2 ? red_lo : red_hi, __fmul_rn(v, 1e-30f));
        } else if constexpr (BODY == kCastBf16) {
          y = __bfloat162float(__float2bfloat16_rn(v));
        } else {  // (x * 127 + 0.5) to int8, toward zero, and back
          y = (float)(int8_t)(int)__fadd_rn(__fmul_rn(v, 127.f), 0.5f);
        }
        acc[n][e] = __fadd_rn(acc[n][e], y);
      }
  }
  store_frag<NT>(out, acc, row0, EW, g, t);
}

// ---------------------------------------------------------------------------
// device memory: `reps` passes over n16 16-byte vectors, four loads in
// flight a thread, cache-global (L2, not L1) and volatile so that no pass
// is folded into another
// ---------------------------------------------------------------------------

__device__ inline int4 ld_cg(const int4* p) {
  int4 v;
  asm volatile("ld.global.cg.v4.s32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ inline void st_cg(int4* p, int4 v) {
  asm volatile("st.global.cg.v4.s32 [%0], {%1,%2,%3,%4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// the sum of the int32 values (int64), a partial a CTA
__global__ void __launch_bounds__(HBM_THREADS)
probe_hbm_read_kernel(const int4* __restrict__ src, long long n16,
                      long long* __restrict__ partial, int reps) {
  const long long stride = (long long)gridDim.x * HBM_THREADS;
  long long sum = 0;
  for (int r = 0; r < reps; ++r) {
    long long i = (long long)blockIdx.x * HBM_THREADS + threadIdx.x;
    for (; i + 3 * stride < n16; i += 4 * stride) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = ld_cg(src + i + u * stride);
#pragma unroll
      for (int u = 0; u < 4; ++u) sum += (long long)v[u].x + v[u].y + (long long)v[u].z + v[u].w;
    }
    for (; i < n16; i += stride) {
      const int4 v = ld_cg(src + i);
      sum += (long long)v.x + v.y + (long long)v.z + v.w;
    }
  }
  __shared__ long long s_sum[HBM_THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
  if (threadIdx.x % 32 == 0) s_sum[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < HBM_THREADS / 32; ++w) total += s_sum[w];
    partial[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(HBM_THREADS)
probe_hbm_copy_kernel(const int4* __restrict__ src, int4* __restrict__ dst, long long n16,
                      int reps) {
  const long long stride = (long long)gridDim.x * HBM_THREADS;
  for (int r = 0; r < reps; ++r) {
    long long i = (long long)blockIdx.x * HBM_THREADS + threadIdx.x;
    for (; i + 3 * stride < n16; i += 4 * stride) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = ld_cg(src + i + u * stride);
#pragma unroll
      for (int u = 0; u < 4; ++u) st_cg(dst + i + u * stride, v[u]);
    }
    for (; i < n16; i += stride) st_cg(dst + i, ld_cg(src + i));
  }
}

template <typename Kern>
int prepare(Kern kern, int smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return 0;
}

// launch (blocks_per_sm == nullptr) or report the CTAs an SM holds
template <typename Kern>
int act(Kern kern, int smem, int threads, int grid, cudaStream_t st, int* blocks_per_sm,
        const uint8_t* x, const uint8_t* y, void* out, int reps) {
  const int e = prepare(kern, smem);
  if (e != 0) return e;
  if (blocks_per_sm != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, threads, smem);
  kern<<<grid, threads, smem, st>>>(x, y, out, reps);
  return (int)cudaGetLastError();
}

// the probe's instances; false for a combination it does not build
template <typename F>
bool dispatch_mma(int wg, int op, int n, int ks, F f) {
#define SYNC(OP, NT, KS) \
  if (!wg && op == OP && n == NT * 8 && ks == KS) return f(probe_sync_kernel<OP, NT, KS>, 0), true;
#define WG(OP, N, KS) \
  if (wg && op == OP && n == N && ks == KS) return f(probe_wgmma_kernel<OP, N, KS>, N * KS * KB), true;
  // Q.K^T, int8, contraction 64, 128, 256 bytes
  SYNC(kS8, 8, 2) SYNC(kS8, 8, 4) SYNC(kS8, 4, 8)
  WG(kS8, 256, 2) WG(kS8, 256, 4) WG(kS8, 256, 8)
  // P.V at output widths 64, 128, 256: bf16, e4m3, int8
  SYNC(kBf16, 8, 1) SYNC(kBf16, 16, 1) SYNC(kBf16, 32, 1)
  SYNC(kE4m3, 8, 1) SYNC(kE4m3, 16, 1) SYNC(kE4m3, 32, 1)
  SYNC(kS8, 16, 1) SYNC(kS8, 32, 1) SYNC(kS8, 8, 1)
  WG(kBf16, 64, 4) WG(kBf16, 128, 4) WG(kBf16, 256, 4)
  WG(kE4m3, 64, 2) WG(kE4m3, 128, 2) WG(kE4m3, 256, 2)
  WG(kS8, 64, 2) WG(kS8, 128, 2)
#undef SYNC
#undef WG
  return false;
}

}  // namespace

// A product probe: wg 0 (mma.sync, n = 8 NT output columns a warp, 16 rows
// a warp, 64 a CTA) or 1 (wgmma, n the instruction's N, 64 rows a CTA); op
// 0 s8 (out int32), 1 bf16, 2 e4m3 (out fp32); ks 32-byte K steps a rep.
// x [grid * 64, 32 ks] bytes, y [n, 32 ks] bytes, out [grid * 64, n].
// With blocks_per_sm not null, nothing is launched: *blocks_per_sm is set
// to the CTAs an SM holds.
extern "C" int probe_mma(int wg, int op, int n, int ks, const void* x, const void* y, void* out,
                         int reps, int grid, int* blocks_per_sm, void* stream) {
  int err = (int)cudaErrorInvalidValue;
  const bool ok = dispatch_mma(wg, op, n, ks, [&](auto kern, int smem) {
    err = act(kern, smem, THREADS, grid, (cudaStream_t)stream, blocks_per_sm,
              (const uint8_t*)x, (const uint8_t*)y, out, reps);
  });
  return ok ? err : (int)cudaErrorInvalidValue;
}

// A pass probe: body 0 ex2.approx.f32, 1 exp2f, 2 row max, 3 row sum, 4
// f32 -> bf16 -> f32, 5 int8 quantize; x, out fp32 [grid * 64, 128]
extern "C" int probe_elem(int body, const void* x, void* out, int reps, int grid,
                          int* blocks_per_sm, void* stream) {
  auto run = [&](auto kern) {
    const int e = prepare(kern, 0);
    if (e != 0) return e;
    if (blocks_per_sm != nullptr)
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, THREADS, 0);
    kern<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, reps);
    return (int)cudaGetLastError();
  };
  switch (body) {
    case kEx2: return run(probe_elem_kernel<kEx2>);
    case kExp2f: return run(probe_elem_kernel<kExp2f>);
    case kRowMax: return run(probe_elem_kernel<kRowMax>);
    case kRowSum: return run(probe_elem_kernel<kRowSum>);
    case kCastBf16: return run(probe_elem_kernel<kCastBf16>);
    case kQuantInt8: return run(probe_elem_kernel<kQuantInt8>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Device memory: copy 0 sums src's int32 values into partial (int64
// [grid], a CTA's sum over `reps` passes), copy 1 copies src into dst,
// `reps` times; n16 16-byte vectors, HBM_THREADS (256) threads a CTA
extern "C" int probe_hbm(int copy, const void* src, void* dst, long long n16, int reps,
                         int grid, void* stream) {
  if (copy)
    probe_hbm_copy_kernel<<<grid, HBM_THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)src, (int4*)dst, n16, reps);
  else
    probe_hbm_read_kernel<<<grid, HBM_THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)src, n16, (long long*)dst, reps);
  return (int)cudaGetLastError();
}
