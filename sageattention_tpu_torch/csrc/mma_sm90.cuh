// Warp-level tensor-core helpers shared by the attention kernels (sm_90a):
// mma.sync for int8 (m16n8k32, int32 accumulate) and bf16 (m16n8k16, fp32
// accumulate), ldmatrix with transpose, and bf16 packing.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 / m16n8k32), for lane = 4*g + t:
//   A (16 x K, row-major):  a[0] row g, a[1] row g+8, a[2] row g (second
//                           half of K), a[3] row g+8 (second half of K);
//   B (K x 8, "col"):       b[0], b[1] column g, the two halves of K;
//   C (16 x 8):             c[0..1] row g, cols 2t, 2t+1; c[2..3] row g+8.
// So a C tile, rounded to bf16 and packed in pairs, is the A operand of
// the next product: that is how P and dS feed P.V, dS.K and dS^T.Q.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ inline void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline void ldsm_x4_trans(uint32_t* r, const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ inline uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of a 16-row tile at `p` (the thread's row g, its column 4t for
// int8 or 2t for bf16 already added): `stride` bytes between rows, `half`
// bytes to the second half of K (16 for int8 k32, 16 for bf16 k16).
__device__ inline void load_a(uint32_t* a, const unsigned char* p, int stride) {
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * stride + 16);
}

// C tile (16 rows x 16 columns, two n-tiles) -> A fragment of bf16 pairs.
__device__ inline void c_to_a(uint32_t* a, const float* c0, const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc[D/8][4] += A (16 x 16, bf16) . B, B the 16 rows of a row-major bf16
// tile starting at row `r0` of `tile` (`stride` elements a row), read
// transposed by ldmatrix: out column n of B is the tile's column n.
template <int D>
__device__ inline void mma_a_rows(float (*acc)[4], const uint32_t* a,
                                  const __nv_bfloat16* tile, int r0, int stride, int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_trans(b, tile + r * stride + np * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}
