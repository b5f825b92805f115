// Hopper (sm_90a) building blocks shared by the rate probe (probe_mma.cu),
// the backward (attention_bwd.cu) and the unmasked forward
// (attention_fwd_sm90.cuh), written as PTX, no CUTLASS:
//
//   wgmma.mma_async   m64nNk32 s8 and e4m3, m64nNk16 bf16: A from registers
//                     (the probe's; the backward's P, P^T and dS) or from
//                     shared memory, B from shared memory by a descriptor;
//   descriptors       without swizzle (the probe's hand-laid core matrices)
//                     and for tiles that TMA laid out with a 64- or 128-byte
//                     swizzle, read K-major or (bf16 only) MN-major;
//   mbarrier          init, arrive, expect_tx and a parity wait;
//   TMA               cp.async.bulk.tensor 1-D and 3-D loads into shared
//                     memory, completing on an mbarrier;
//   tensor maps       built on the host by cuTensorMapEncodeTiled, looked
//                     up with cudaGetDriverEntryPoint, so no library links
//                     against libcuda.
//
// Register fragments: the accumulator of m64nN is, in each warp of the
// warpgroup, the mma.sync C fragments of its 16 rows and N / 8 column
// groups in order (d[4j .. 4j + 3] of group j), and the register A
// fragment of a K step is mma.sync's A fragment of the warp's 16 rows
// (PTX ISA, "wgmma register fragments"; mma_sm90.cuh has their layout).
// So c_to_a turns a computed S-shaped tile into the A operand of the next
// product, as it does for mma.sync.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// wgmma: operand lists
// ---------------------------------------------------------------------------

#define WG_D16 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
  "}"
#define WG_D32 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}"
#define WG_D64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}"
#define WG_D96 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
  "}"
#define WG_D128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" \
  "}"

#define WG_OUT8(C, d, i) \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define WG_OUT16(C, d) WG_OUT8(C, d, 0), WG_OUT8(C, d, 8)
#define WG_OUT32(C, d) WG_OUT8(C, d, 0), WG_OUT8(C, d, 8), WG_OUT8(C, d, 16), WG_OUT8(C, d, 24)
#define WG_OUT64(C, d) \
  WG_OUT32(C, d), WG_OUT8(C, d, 32), WG_OUT8(C, d, 40), WG_OUT8(C, d, 48), WG_OUT8(C, d, 56)
#define WG_OUT96(C, d) \
  WG_OUT64(C, d), WG_OUT8(C, d, 64), WG_OUT8(C, d, 72), WG_OUT8(C, d, 80), WG_OUT8(C, d, 88)
#define WG_OUT128(C, d) \
  WG_OUT64(C, d), WG_OUT8(C, d, 64), WG_OUT8(C, d, 72), WG_OUT8(C, d, 80), WG_OUT8(C, d, 88), \
      WG_OUT8(C, d, 96), WG_OUT8(C, d, 104), WG_OUT8(C, d, 112), WG_OUT8(C, d, 120)

// One product of N columns whose accumulator takes N / 2 registers a
// thread (REGS, OUT); TAIL the operands after the accumulator, SETP the
// scale-d flag's operand.  A register A fragment is four 32-bit registers,
// a descriptor one 64-bit one.
#define WG_ASM(SHAPE, REGS, TAIL, SETP, OUTS, ...)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SETP ", 0;\n"                     \
               "wgmma.mma_async.sync.aligned." SHAPE " " REGS ", " TAIL ";\n}\n"     \
               : OUTS                                                                \
               : __VA_ARGS__)

// ---------------------------------------------------------------------------
// A from registers (the probe's products), scale-d 1: d += a . B
// ---------------------------------------------------------------------------

template <int N>
__device__ inline void wgmma_s8(int* d, const uint32_t* a, uint64_t desc);

template <>
__device__ inline void wgmma_s8<64>(int* d, const uint32_t* a, uint64_t desc) {
  WG_ASM("m64n64k32.s32.s8.s8", WG_D32, "{%32, %33, %34, %35}, %36, p", "%37", WG_OUT32("+r", d),
         "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ inline void wgmma_s8<128>(int* d, const uint32_t* a, uint64_t desc) {
  WG_ASM("m64n128k32.s32.s8.s8", WG_D64, "{%64, %65, %66, %67}, %68, p", "%69",
         WG_OUT64("+r", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ inline void wgmma_s8<256>(int* d, const uint32_t* a, uint64_t desc) {
  WG_ASM("m64n256k32.s32.s8.s8", WG_D128, "{%128, %129, %130, %131}, %132, p", "%133",
         WG_OUT128("+r", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// m64n128k32 with the scale-d flag (0: d = a . B), for the forward's S =
// Q.K^T with Q's codes in registers
__device__ inline void wgmma_s8_rs128(int* d, const uint32_t* a, uint64_t desc, int scale_d) {
  WG_ASM("m64n128k32.s32.s8.s8", WG_D64, "{%64, %65, %66, %67}, %68, p", "%69",
         WG_OUT64("+r", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
         "r"(scale_d));
}

template <int N>
__device__ inline void wgmma_bf16(float* d, const uint32_t* a, uint64_t desc);

template <>
__device__ inline void wgmma_bf16<64>(float* d, const uint32_t* a, uint64_t desc) {
  WG_ASM("m64n64k16.f32.bf16.bf16", WG_D32, "{%32, %33, %34, %35}, %36, p, 1, 1, 0", "%37",
         WG_OUT32("+f", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ inline void wgmma_bf16<128>(float* d, const uint32_t* a, uint64_t desc) {
  WG_ASM("m64n128k16.f32.bf16.bf16", WG_D64, "{%64, %65, %66, %67}, %68, p, 1, 1, 0", "%69",
         WG_OUT64("+f", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ inline void wgmma_bf16<256>(float* d, const uint32_t* a, uint64_t desc) {
  WG_ASM("m64n256k16.f32.bf16.bf16", WG_D128, "{%128, %129, %130, %131}, %132, p, 1, 1, 0",
         "%133", WG_OUT128("+f", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
         "r"(1));
}

template <int N>
__device__ inline void wgmma_e4m3(float* d, const uint32_t* a, uint64_t desc);

template <>
__device__ inline void wgmma_e4m3<64>(float* d, const uint32_t* a, uint64_t desc) {
  WG_ASM("m64n64k32.f32.e4m3.e4m3", WG_D32, "{%32, %33, %34, %35}, %36, p, 1, 1", "%37",
         WG_OUT32("+f", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ inline void wgmma_e4m3<128>(float* d, const uint32_t* a, uint64_t desc) {
  WG_ASM("m64n128k32.f32.e4m3.e4m3", WG_D64, "{%64, %65, %66, %67}, %68, p, 1, 1", "%69",
         WG_OUT64("+f", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ inline void wgmma_e4m3<256>(float* d, const uint32_t* a, uint64_t desc) {
  WG_ASM("m64n256k32.f32.e4m3.e4m3", WG_D128, "{%128, %129, %130, %131}, %132, p, 1, 1",
         "%133", WG_OUT128("+f", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
         "r"(1));
}

// ---------------------------------------------------------------------------
// The backward's products.  S-shaped tiles (N = 32 or 64 columns; 128 for
// the masked forward's S at head dim 128) from two shared descriptors, both
// K-major: d = A . B^T, or d += A . B^T with scale_d 1.
// The accumulating products (dQ, dK, dV; the forward's P.V) take A (P,
// P^T, dS) from registers and B = a row-major [k][n] bf16 tile read
// MN-major (tnspB 1): d += a . B.  N 192 is the wide forward's half of O at
// head dim 384.
// ---------------------------------------------------------------------------

template <int N>
__device__ inline void wgmma_s8_ss(int* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) {
    WG_ASM("m64n32k32.s32.s8.s8", WG_D16, "%16, %17, p", "%18", WG_OUT16("+r", d), "l"(da),
           "l"(db), "r"(scale_d));
  } else if constexpr (N == 64) {
    WG_ASM("m64n64k32.s32.s8.s8", WG_D32, "%32, %33, p", "%34", WG_OUT32("+r", d), "l"(da),
           "l"(db), "r"(scale_d));
  } else {
    static_assert(N == 128, "wgmma_s8_ss: N is 32, 64 or 128");
    WG_ASM("m64n128k32.s32.s8.s8", WG_D64, "%64, %65, p", "%66", WG_OUT64("+r", d), "l"(da),
           "l"(db), "r"(scale_d));
  }
}

template <int N>
__device__ inline void wgmma_bf16_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 32) {
    WG_ASM("m64n32k16.f32.bf16.bf16", WG_D16, "%16, %17, p, 1, 1, 0, 0", "%18",
           WG_OUT16("+f", d), "l"(da), "l"(db), "r"(scale_d));
  } else {
    static_assert(N == 64, "wgmma_bf16_ss: N is 32 or 64");
    WG_ASM("m64n64k16.f32.bf16.bf16", WG_D32, "%32, %33, p, 1, 1, 0, 0", "%34",
           WG_OUT32("+f", d), "l"(da), "l"(db), "r"(scale_d));
  }
}

template <int N>
__device__ inline void wgmma_bf16_rs_mn(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (N == 64) {
    WG_ASM("m64n64k16.f32.bf16.bf16", WG_D32, "{%32, %33, %34, %35}, %36, p, 1, 1, 1", "%37",
           WG_OUT32("+f", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 128) {
    WG_ASM("m64n128k16.f32.bf16.bf16", WG_D64, "{%64, %65, %66, %67}, %68, p, 1, 1, 1", "%69",
           WG_OUT64("+f", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 192) {
    WG_ASM("m64n192k16.f32.bf16.bf16", WG_D96, "{%96, %97, %98, %99}, %100, p, 1, 1, 1", "%101",
           WG_OUT96("+f", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 256, "wgmma_bf16_rs_mn: N is 64, 128, 192 or 256");
    WG_ASM("m64n256k16.f32.bf16.bf16", WG_D128, "{%128, %129, %130, %131}, %132, p, 1, 1, 1",
           "%133", WG_OUT128("+f", d), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
           "r"(1));
  }
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins n registers of an accumulator at this point of the program: after a
// wgmma_wait, no read of them moves above the wait
__device__ inline void reg_fence(float* r, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ inline void reg_fence(int* r, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ---------------------------------------------------------------------------
// shared-memory matrix descriptors (PTX ISA, "matrix descriptor"): the
// start address, the leading and the stride byte offsets, each in 16-byte
// units, and the layout (bits 62-63: 0 none, 1 128-byte swizzle, 2 64-byte)
// ---------------------------------------------------------------------------

// without swizzle: the leading byte offset is the step between the two 8 x
// 16-byte core matrices of a K step, along K, the stride byte offset the
// step between 8-row groups along N (the probe's layout)
__device__ inline uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ inline uint64_t smem_desc_sw(uint32_t addr, uint32_t lbo, uint32_t sbo, int layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// A tile of ROWS rows whose K runs along each row, as TMA lays out a
// [ROWS][K] row-major block in panels of ROWB bytes (64 or 128: the
// swizzle's span), panel p holding bytes [p ROWB, (p + 1) ROWB) of every
// row, ROWS x ROWB bytes a panel, 1024-byte aligned.  K step `ks` takes 32
// bytes of K (k32 of 8-bit codes, k16 of bf16): inside a panel the start
// address moves by 32 bytes and the swizzle, computed from the address,
// follows; 8-row groups are 8 ROWB bytes apart.
template <int ROWS, int ROWB>
__device__ inline uint64_t desc_kmajor(uint32_t tile, int ks) {
  static_assert(ROWB == 64 || ROWB == 128, "desc_kmajor: a panel row is 64 or 128 bytes");
  const int kb = ks * 32;
  return smem_desc_sw(tile + (kb / ROWB) * ROWS * ROWB + kb % ROWB, 16, 8 * ROWB,
                      ROWB == 128 ? 1 : 2);
}

// The same layout of a bf16 [K rows][N] tile (panels of 64 columns) read
// MN-major, as the B of d += a . B: K step `ks` is rows [16 ks, 16 ks + 16),
// 2048 bytes on; 8-row groups of K are 1024 bytes apart (the stride byte
// offset) and the 64-column panels ROWS x 128 bytes (the leading one).
template <int ROWS>
__device__ inline uint64_t desc_mnmajor(uint32_t tile, int ks) {
  return smem_desc_sw(tile + ks * 16 * 128, ROWS * 128, 1024, 1);
}

// ---------------------------------------------------------------------------
// mbarrier and TMA
// ---------------------------------------------------------------------------

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// the inits made visible to the other threads and to the async proxy
__device__ inline void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase `parity` has completed.  A lost arrival
// traps after about 10 s (2^34 SM cycles) instead of holding the card.
__device__ inline void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

// box {c0, c1, c2} of a 3-D tensor map into shared memory at dst
__device__ inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                   int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ inline void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// Shared-memory writes of this thread made visible to the async proxy
// (wgmma reads a tile that threads, not TMA, wrote)
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1-15; 0 is __syncthreads) over n threads
__device__ inline void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// a warpgroup's registers a thread, from here on (a multiple of 8 in [24, 256])
template <int N>
__device__ inline void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ inline void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*,
                                          const cuuint32_t*, const cuuint32_t*,
                                          CUtensorMapInterleave, CUtensorMapSwizzle,
                                          CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled as the CUDA runtime resolves it, or null
inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<TensorMapEncodeTiled>(p);
  }();
  return fn;
}

// A [planes, rows, cols] row-major tensor (cols x elem bytes a row, a
// multiple of 16, and a 16-byte aligned base) read in boxes of
// [1, box_rows, box_cols], box_cols x elem bytes being the swizzle's span
// (64 or 128).  Rows past `rows` read as zeros: the map's row dimension is
// one plane's, so a box at the end of a plane never reads the next one.
inline bool tensor_map_3d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
                          long long planes, long long rows, int cols, int box_rows,
                          int box_cols) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) != 0) return false;
  const int span = box_cols * elem;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)rows * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// n fp32 values read in boxes of `box`.  TMA wants a 16-byte aligned base,
// so the map starts at the address rounded down and *shift (0-3) is the
// offset of value 0 in it; elements past n read as zeros.
inline bool tensor_map_f32(CUtensorMap* map, const float* p, long long n, int box, int* shift) {
  const TensorMapEncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr || (reinterpret_cast<uintptr_t>(p) & 3) != 0) return false;
  *shift = (int)((reinterpret_cast<uintptr_t>(p) & 15) / 4);
  const cuuint64_t dims[1] = {(cuuint64_t)(n + *shift)};
  const cuuint32_t boxd[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  const cuuint64_t no_strides[1] = {0};  // a rank-1 map has none
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(p - *shift), dims,
             no_strides, boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
