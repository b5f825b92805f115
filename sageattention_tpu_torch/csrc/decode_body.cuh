// The numbers and helpers of the decode kernels (kernels 9-12: csrc/decode.cu,
// csrc/paged_decode.cu and their wide sources) for Hopper (sm_90a): decode
// attention of a few query tokens against a per-token-scaled int8 or
// token-pair-packed int4 KV cache.  The walk that runs them, split over a
// thread-block cluster and the grid, is decode_split_sm90.cuh; this header
// holds what it reuses: the chunk's operands (Chunk), the masks (Mask), the
// loads (cp_async16 / cp_async4, load16 and its ragged form), the int4
// unpacking (unpack16), the V^T store (store_vt4), floor_div and NEG_INIT.
//
// The counterpart of decode_pallas.py:decode_step_body, which the TPU's
// dense and paged kernels share: one copy of the numerics, two sources of
// chunks.  A row is one (query head of the GQA group, query token),
// head-major as the JAX package packs them.  Per chunk (a dense chunk from
// the host rules, or one page):
//   S = Q.K^T (int8 mma.sync m16n8k32, int32), sf = s * qsf * ks (qsf =
//   max(amax, 1e-30) * qs_mul, qs_mul = f32(1/qmax) * f32(sm_scale *
//   log2e), the form XLA compiles the spec into), masked; the row max m_c
//   over the whole chunk;
//   p = exp2(sf - m_c), l_c = sum p, pe = p * vs, and the row max of pe,
//   which gives the chunk's P scale psc;
//   P codes round(pe / psc); P.V on the int8 tensor cores against V^T,
//   int32 summed over the chunk (exact), then pv = f32(int32) * psc and the
//   base-2 online merge.
// Every multiply and add whose rounding the JAX spec fixes is written with
// __fmul_rn / __fadd_rn / __fsub_rn, so no FMA contraction changes it.  The
// packed cache is unpacked into int8 codes in shared memory (low nibble
// token 2t, high nibble 2t+1, sign-extended); Q and P then quantize to
// +-119, as the TPU kernel's two-int4-dot split does, and one int8 product
// gives the same int32 exactly (16a + b = x).
//
// Head dims: the instances compute at D = 64, 128, 256, 384 or 512; a cache
// of any head dim ds <= D (the cache keeps the caller's, as the JAX
// package's does) is read at its own row stride, its lanes ds..D
// zero-filled as Q and the slabs load, which adds 0 to every product, and
// only its ds lanes of o are written.  A ds that is not a multiple of 16
// leaves the rows off 16-byte alignment: the RAGGED instances read them
// byte by byte with ordinary loads (no cp.async), the last block of a row
// zero past ds.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode {

constexpr float NEG_INIT = -1e30f;

// one chunk's operands: K / V codes (int8, or token-pair-packed), and the
// per-token fp32 scales
struct Chunk {
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;
};

__device__ inline int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// 16 packed bytes -> the 16 low-nibble and 16 high-nibble codes, sign-extended
__device__ inline void unpack16(uint4 raw, uint4& lo, uint4& hi) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
  uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = __vsub4((w[i] & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
    h[i] = __vsub4(((w[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  }
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !valid
// (then nothing is read, and `src` need only be a valid address)
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ inline void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// bytes c0 .. c0 + 15 of a cache row of ds bytes, byte by byte (a row of a
// head dim that is not a multiple of 16 is not 16-byte aligned), zero past ds
__device__ inline uint4 load16_ragged(const int8_t* row, int c0, int ds) {
  uint4 out;
  int8_t* b = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int j = 0; j < 16; ++j) b[j] = c0 + j < ds ? row[c0 + j] : 0;
  return out;
}

// 16-byte block cb of data row r of the chunk's codes `x` (row stride ds),
// zero where the row is not live or the block lies past ds
template <bool RAGGED>
__device__ inline uint4 load16(const int8_t* x, int r, int cb, bool live, int ds) {
  if (!live) return make_uint4(0, 0, 0, 0);
  if constexpr (RAGGED) return load16_ragged(x + (size_t)r * ds, cb * 16, ds);
  return *reinterpret_cast<const uint4*>(x + (size_t)r * ds + cb * 16);
}

// tokens 4 qd .. 4 qd + 3 of V's codes at channels cb * 16 .. cb * 16 + 15
// (v[i] token 4 qd + i) into V^T (row stride TS bytes): a 4 x 4 byte
// transpose of each word, so one word store a channel holds the four tokens
template <int TS>
__device__ inline void store_vt4(int8_t* sVt, const uint4 (&v)[4], int qd, int cb) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // channels cb * 16 + 4 i .. + 3
    const uint32_t x0 = reinterpret_cast<const uint32_t*>(&v[0])[i];
    const uint32_t x1 = reinterpret_cast<const uint32_t*>(&v[1])[i];
    const uint32_t x2 = reinterpret_cast<const uint32_t*>(&v[2])[i];
    const uint32_t x3 = reinterpret_cast<const uint32_t*>(&v[3])[i];
    const uint32_t t0 = __byte_perm(x0, x1, 0x5140), t1 = __byte_perm(x0, x1, 0x7362);
    const uint32_t t2 = __byte_perm(x2, x3, 0x5140), t3 = __byte_perm(x2, x3, 0x7362);
    uint32_t* dst = reinterpret_cast<uint32_t*>(sVt + (cb * 16 + 4 * i) * TS + 4 * qd);
    dst[0] = __byte_perm(t0, t2, 0x5410);
    dst[TS / 4] = __byte_perm(t0, t2, 0x7632);
    dst[2 * TS / 4] = __byte_perm(t1, t3, 0x5410);
    dst[3 * TS / 4] = __byte_perm(t1, t3, 0x7632);
  }
}

// The masks of decode_step_body as the keys [lo, hi) each query token t
// of t_q sees: below the length and its causal end (keys < length - t_q +
// 1 + t, which is at most the length) and, with the sliding window, above
// length - t_q + t - window.  With t_q = 1 these are the TPU kernel's
// single-token masks.
struct Mask {
  int length, t_q, window;  // window <= 0: none
  __device__ inline int hi(int t) const { return length - t_q + 1 + t; }
  __device__ inline int lo(int t) const {
    return window > 0 ? max(0, length - t_q + t - window + 1) : 0;
  }
};

}  // namespace decode
