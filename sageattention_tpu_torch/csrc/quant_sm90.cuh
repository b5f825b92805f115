// Pieces the quantizers of quant_k.cu and quant_v.cu share on Hopper
// (sm_90a): eight consecutive elements of a row as fp32; the same eight
// elements copied into shared memory by cp.async (16-byte copies that skip
// L1, one commit group a unit of rows, waited for by the copying thread
// alone: each thread stages the chunks it reads itself, so no barrier
// orders a chunk's copy and its reads); and a loop over a thread's rows
// that keeps four rows' loads in flight.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qsm90 {

// eight consecutive elements of a row as loaded (one 16-byte load of
// bf16, two of fp32), and as fp32
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 v;
};
template <>
struct Raw8<float> {
  float4 a, b;
};

__device__ inline void load_raw(const __nv_bfloat16* p, Raw8<__nv_bfloat16>& r) {
  r.v = *reinterpret_cast<const uint4*>(p);
}
__device__ inline void load_raw(const float* p, Raw8<float>& r) {
  r.a = *reinterpret_cast<const float4*>(p);
  r.b = *reinterpret_cast<const float4*>(p + 4);
}

__device__ inline void unpack(const Raw8<__nv_bfloat16>& r, float* x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}
__device__ inline void unpack(const Raw8<float>& r, float* x) {
  x[0] = r.a.x; x[1] = r.a.y; x[2] = r.a.z; x[3] = r.a.w;
  x[4] = r.b.x; x[5] = r.b.y; x[6] = r.b.z; x[7] = r.b.w;
}

// the inverse of unpack: eight fp32 values, each exact in T, back into a Raw8
__device__ inline void pack(const float* x, Raw8<__nv_bfloat16>& r) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r.v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
}
__device__ inline void pack(const float* x, Raw8<float>& r) {
  r.a = make_float4(x[0], x[1], x[2], x[3]);
  r.b = make_float4(x[4], x[5], x[6], x[7]);
}

// an empty asm the compiler must take to rewrite r: values computed from r
// before it are computed again from r after it, so r's registers stay live
// across, not the (for bf16, twice as many) fp32 values derived from them
__device__ inline void pin(Raw8<__nv_bfloat16>& r) {
  asm volatile("" : "+r"(r.v.x), "+r"(r.v.y), "+r"(r.v.z), "+r"(r.v.w));
}
__device__ inline void pin(Raw8<float>& r) {
  asm volatile("" : "+f"(r.a.x), "+f"(r.a.y), "+f"(r.a.z), "+f"(r.a.w), "+f"(r.b.x),
               "+f"(r.b.y), "+f"(r.b.z), "+f"(r.b.w));
}

template <typename T>
__device__ inline void load8(const T* p, float* x) {
  Raw8<T> r;
  load_raw(p, r);
  unpack(r, x);
}

// 16 bytes from device memory at src into shared memory at dst, both
// 16-byte aligned, in the thread's current cp.async group
__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

// eight elements of a row: one 16-byte copy (bf16) or two (fp32)
__device__ inline void cp_async8(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  cp_async16(dst, src);
}
__device__ inline void cp_async8(float* dst, const float* src) {
  cp_async16(dst, src);
  cp_async16(dst + 4, src + 4);
}

// closes the thread's current cp.async group (an empty one too)
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// waits until at most n of the thread's cp.async groups are pending (n
// above 15 waits for all but the 15 newest, which is more than asked)
__device__ inline void cp_async_wait(int n) {
  switch (n < 0 ? 0 : n) {
#define QSM90_WAIT(N) \
  case N:             \
    asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); \
    break;
    QSM90_WAIT(0) QSM90_WAIT(1) QSM90_WAIT(2) QSM90_WAIT(3) QSM90_WAIT(4) QSM90_WAIT(5)
    QSM90_WAIT(6) QSM90_WAIT(7) QSM90_WAIT(8) QSM90_WAIT(9) QSM90_WAIT(10) QSM90_WAIT(11)
    QSM90_WAIT(12) QSM90_WAIT(13) QSM90_WAIT(14)
#undef QSM90_WAIT
    default:
      asm volatile("cp.async.wait_group 15;\n" ::: "memory");
  }
}

// the first row r >= a with r = g (mod n): a thread's rows are g, g + n,
// g + 2n, ... of its CTA's rows, whatever range it walks
__device__ inline int first_row(int a, int g, int n) { return a + (g - a % n + n) % n; }

// f(x, r) for the rows r = first_row(a, g, n), + n, ... below e of the
// rows at `base` (d elements apart; device or shared memory), x the 8
// elements there as fp32, in row order, four rows' loads at a time (eight
// were slower in kernel 5, PERF.md)
template <typename T, typename F>
__device__ inline void for_rows(const T* base, int a, int e, int g, int n, int d, F&& f) {
  int r = first_row(a, g, n);
  for (; r + 3 * n < e; r += 4 * n) {
    Raw8<T> x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) load_raw(base + (size_t)(r + u * n) * d, x[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float y[8];
      unpack(x[u], y);
      f(y, r + u * n);
    }
  }
  for (; r < e; r += n) {
    float x[8];
    load8(base + (size_t)r * d, x);
    f(x, r);
  }
}

// Host: sets a kernel's attributes on the current device once, recording
// it in `done` (one flag a device, zero at first): the largest dynamic
// shared memory its launches take and, with `wide`, clusters above the
// portable 8 CTAs.  The attribute calls cost the host microseconds, more
// than a quantizer's launch should.
constexpr int kMaxDevices = 64;

inline cudaError_t set_once(const void* kern, int smem, bool wide, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && wide)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) done[dev] = true;
  return e;
}

}  // namespace qsm90
