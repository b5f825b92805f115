// V codes widened to bf16 for Hopper (sm_90a), exactly: the V-code half of
// kernel 1's P.V at its default pv_compute="bf16"
// (attention_pallas.py:sage_attention_fused widens a V tile's int8, e4m3 or
// e5m2 codes to bf16 in VMEM; _compute_parts :393).  The wgmma forward
// (attention_fwd_sm90.cuh) reads bf16 V by TMA, which cannot widen, so the
// wrapper widens V once a call with this kernel, before the launch; the
// per-channel scale and the smooth-v mean stay in the forward's epilogue.
// Widening inside the forward, a stage at a time in its producer's spare
// warps, repeats the work for every 128-row Q tile and held the code
// instances well behind the bf16 one (PERF.md, PR 13).
//
// Bound: bytes, one code read and one bf16 written an element (3 bytes):
// ~0.046 ms for the Wan2.1 layer's 51 M codes at 3.35 TB/s.  A thread
// reads 16 codes (16 bytes) and writes 32 bytes; the conversion is integer
// and bf16x2 arithmetic, no conversion unit:
//   e4m3 (s eeee mmm): the bits moved to bf16's sign (bit 15) and its low
//     exponent and mantissa bits (4-10), which read as the value x 2^-120
//     (a code with exponent 0 as a bf16 subnormal), then x 2^120;
//   e5m2 (s eeeee mm): the same at bits 5-11, x 2^112;
//   int8: (128 + (x & 127)) - (128 + 128 sign), each term a bf16 in
//     [128, 256) whose mantissa holds the integer.
// Each product and difference is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum VKind { kVInt8 = 1, kVE4M3 = 2, kVE5M2 = 3 };  // as attention_fwd_kernel.cuh numbers them

constexpr int kThreads = 256;

__device__ inline uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ inline uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Two codes, the low bytes of the halves of x ([c0, 0, c1, 0]), as two bf16
// values; the sign moves up as t + k u, u the sign bit of t = x << shift
template <int VK>
__device__ inline uint32_t codes2_bf16(uint32_t x) {
  if constexpr (VK == kVInt8) {
    return bf16x2_sub(0x43004300u | (x & 0x007F007Fu), 0x43004300u | (x & 0x00800080u));
  } else if constexpr (VK == kVE4M3) {
    const uint32_t t = x << 4, u = t & 0x08000800u;
    return bf16x2_mul(t + 15u * u, 0x7B807B80u);  // 2^120
  } else {
    const uint32_t t = x << 5, u = t & 0x10001000u;
    return bf16x2_mul(t + 7u * u, 0x77807780u);  // 2^112
  }
}

// four codes (a word) -> four bf16 values
template <int VK>
__device__ inline uint2 widen4(uint32_t w) {
  return make_uint2(codes2_bf16<VK>(__byte_perm(w, 0, 0x4140)),
                    codes2_bf16<VK>(__byte_perm(w, 0, 0x4342)));
}

template <int VK>
__global__ void __launch_bounds__(kThreads)
widen_v_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n16) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n16;
       i += (long long)gridDim.x * kThreads) {
    const uint4 c = src[i];
    const uint2 a = widen4<VK>(c.x), b = widen4<VK>(c.y), e = widen4<VK>(c.z), f = widen4<VK>(c.w);
    dst[2 * i] = make_uint4(a.x, a.y, b.x, b.y);
    dst[2 * i + 1] = make_uint4(e.x, e.y, f.x, f.y);
  }
}

}  // namespace

// src: n codes of v_kind (1 int8, 2 fp8 e4m3, 3 fp8 e5m2), 16-byte aligned,
// n a multiple of 16; dst: n bf16, 16-byte aligned.
extern "C" int widen_v_codes(const void* src, void* dst, long long n, int v_kind, void* stream) {
  if (n <= 0 || n % 16 != 0 || v_kind < kVInt8 || v_kind > kVE5M2 ||
      (reinterpret_cast<uintptr_t>(src) & 15) != 0 || (reinterpret_cast<uintptr_t>(dst) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long n16 = n / 16;
  const int grid = (int)(n16 / kThreads + 1 < 8LL * sms ? n16 / kThreads + 1 : 8LL * sms);
  cudaStream_t st = (cudaStream_t)stream;
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  if (v_kind == kVInt8)
    widen_v_kernel<kVInt8><<<grid, kThreads, 0, st>>>(s, d, n16);
  else if (v_kind == kVE4M3)
    widen_v_kernel<kVE4M3><<<grid, kThreads, 0, st>>>(s, d, n16);
  else
    widen_v_kernel<kVE5M2><<<grid, kThreads, 0, st>>>(s, d, n16);
  return (int)cudaGetLastError();
}
