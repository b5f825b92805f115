// Fused SageAttention forward for Hopper (sm_90a) at head dim 256, without
// masks: the D = 256 instances of attention_fwd_kernel.cuh (MASKED =
// false), which kernel 1 (attention_pallas.py:sage_attention_fused) runs
// for every head dim in (128, 256], padded to 256 (core.py:70-75 of the JAX
// package).  A source of its own, so that these 16 instances (causal x V
// kind x q dtype) build beside attention_fwd.cu's in parallel and those
// keep their code.
//
// At D = 256 a warp's fp32 O accumulator is 16 x 256 / 32 = 128 registers
// a thread, so the KV tile is 64 columns (kKvTile: the S tile takes 32
// registers, not 64); a tile is half of a 128-row K-scale group and reads
// that group's scale.  Q's int8 fragments are read from shared memory
// for each KV tile, as at every head dim, not held.  Shared memory: Q 17
// KB, K 17 KB, V 34 KB (69 KB a CTA).
//
// Bound: operations, as at 64 and 128.  At the Gemma-7B attention layer
// (b 4, 16 heads of 256, 4096 tokens, causal: 537 M live pairs) Q.K^T is
// 2.75e11 int8 ops and P.V 2.75e11 bf16 FLOP, about 0.42 ms on the H100
// SXM's data-sheet peaks; the bytes about 0.04 ms.

#include "attention_fwd_kernel.cuh"

// The operands of sage_attn_fwd (attention_fwd.cu), with d 256.
extern "C" int sage_attn_fwd_hd256(const void* q, const void* k, const void* k_scale,
                                   const void* v, const void* v_scale, const void* v_mean,
                                   void* o, void* lse2, int b, int hq, int hkv, int sq, int sk,
                                   int d, int causal, int q_is_f32, int v_kind, int want_lse,
                                   int group, float qs_mul, void* stream) {
  const Args a{q, k, k_scale, v, v_scale, v_mean, o, want_lse ? lse2 : nullptr,
               b, hq, hkv, sq, sk, qs_mul};
  return launch_fwd_d<256, false>(a, NoMask{}, d, causal, q_is_f32, v_kind, group, stream);
}
