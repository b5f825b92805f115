// Per-token int8 Q quantizer for Hopper (sm_90a).
//
// Replaces the TPU kernel quant_pallas.py:quant_q_per_token
// (_quant_rows_kernel): per-row amax, scale = max(amax,1e-30)*(1/qmax),
// r = 1/scale, code = roundf(x * r) (half away from zero) clipped to
// [-qmax, qmax], and the row's scale with sm_scale*log2(e) folded in.
// qmax is 127, or 7 for bits=4 (the +-7 codes that sageattn's qk_bits=4
// feeds the pre-quantized forward, attention_fwd_preq.cu).
//
// The backward re-quantizes Q with it, and the forward kernel
// (attention_fwd.cu) quantized the same rows inside the kernel; the saved
// base-2 LSE was built from those scales, so P = exp2(l2 - lse2) only
// normalises if both agree bit for bit.  This kernel therefore repeats the
// forward's arithmetic exactly: the same fp32 chain for the codes, and the
// folded scale as max(amax,1e-30) * qs_mul with qs_mul = f32(1/qmax) *
// f32(sm_scale*log2e), the reassociated form XLA compiles the spec into.
// The JAX forward quantizes Q inside its kernel with the same chain
// (attention_pallas.py:475-503), so at qmax 7 these are its codes too.
// Built without --use_fast_math so that 1/scale is an IEEE divide.
//
// Bound: bytes.  A few flops per element; the least time is reading Q and
// writing the int8 codes and one fp32 scale a row.  One warp per row, each
// lane one contiguous vector of D/32 elements (a 64-wide bf16 row is 128
// bytes, one coalesced load for the warp); eight rows a CTA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerCta = 8;

// the largest power of two that divides n bytes: a lane's vector of D / 32
// elements is aligned to it (at D = 384, 12 elements: 24 bytes of bf16 on
// 8, 48 of fp32 on 16, 12 codes on 4)
constexpr int align_of(int n) { return n & -n; }

template <typename T, int N>
struct alignas(align_of(sizeof(T) * N)) Vec {
  T v[N];
};

template <int N>
struct alignas(align_of(N)) Codes {
  int8_t v[N];
};

__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_f32(float x) { return x; }

template <int D, typename T>
__global__ void __launch_bounds__(kRowsPerCta * 32)
quant_q_kernel(const T* __restrict__ q, int8_t* __restrict__ out,
               float* __restrict__ scales, long long rows, float qs_mul, float qmax,
               float inv_qmax) {
  constexpr int E = D / 32;  // elements a lane
  const long long row = (long long)blockIdx.x * kRowsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const Vec<T, E> raw = *reinterpret_cast<const Vec<T, E>*>(q + row * D + lane * E);
  float x[E];
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    x[e] = to_f32(raw.v[e]);
    amax = fmaxf(amax, fabsf(x[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax, 1e-30f) * inv_qmax;
  const float r = 1.0f / scale;
  Codes<E> c;
#pragma unroll
  for (int e = 0; e < E; ++e)
    c.v[e] = (int8_t)fminf(fmaxf(roundf(x[e] * r), -qmax), qmax);
  *reinterpret_cast<Codes<E>*>(out + row * D + lane * E) = c;
  if (lane == 0) scales[row] = fmaxf(amax, 1e-30f) * qs_mul;
}

template <int D, typename T>
int launch(const void* q, void* out, void* scales, long long rows, float qs_mul, float qmax,
           float inv_qmax, cudaStream_t st) {
  const long long ctas = (rows + kRowsPerCta - 1) / kRowsPerCta;
  quant_q_kernel<D, T><<<(unsigned)ctas, kRowsPerCta * 32, 0, st>>>(
      (const T*)q, (int8_t*)out, (float*)scales, rows, qs_mul, qmax, inv_qmax);
  return (int)cudaGetLastError();
}

// the instances of the one head dim D
template <int D>
int launch_d(const void* q, void* out, void* scales, long long rows, int q_is_f32, float qs_mul,
             float qmax, float inv_qmax, cudaStream_t st) {
  return q_is_f32 ? launch<D, float>(q, out, scales, rows, qs_mul, qmax, inv_qmax, st)
                  : launch<D, __nv_bfloat16>(q, out, scales, rows, qs_mul, qmax, inv_qmax, st);
}

}  // namespace

// q: [rows, d] contiguous (bf16 if q_is_f32 == 0, else fp32), d in {64,
// 128, 256, 384, 512}; out: int8 [rows, d]; scales: fp32 [rows]; qmax 127
// or 7 and inv_qmax = f32(1/qmax); qs_mul = f32(1/qmax) * f32(sm_scale *
// log2(e)).
extern "C" int quant_q_per_token(const void* q, void* out, void* scales,
                                 long long rows, int d, int q_is_f32,
                                 float qs_mul, float qmax, float inv_qmax, void* stream) {
  if (rows <= 0 || (d != 64 && d != 128 && d != 256 && d != 384 && d != 512))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 64: return launch_d<64>(q, out, scales, rows, q_is_f32, qs_mul, qmax, inv_qmax, st);
    case 128: return launch_d<128>(q, out, scales, rows, q_is_f32, qs_mul, qmax, inv_qmax, st);
    case 256: return launch_d<256>(q, out, scales, rows, q_is_f32, qs_mul, qmax, inv_qmax, st);
    case 384: return launch_d<384>(q, out, scales, rows, q_is_f32, qs_mul, qmax, inv_qmax, st);
    default: return launch_d<512>(q, out, scales, rows, q_is_f32, qs_mul, qmax, inv_qmax, st);
  }
}
