// Fused SageAttention forward for Hopper (sm_90a) at head dim 256, without
// masks: the D = 256 instances of attention_fwd_sm90.cuh's kernel, which
// kernel 1 (attention_pallas.py:sage_attention_fused) runs
// for every head dim in (128, 256], padded to 256 (core.py:70-75 of the JAX
// package).  A source of its own, so that these 4 instances (causal x q
// dtype; V codes widened to bf16 before the launch) build beside
// attention_fwd.cu's in parallel.
//
// The kernel is attention_fwd_sm90.cuh's (TMA-fed wgmma).  At D = 256 a
// consumer's fp32 O accumulator is 64 x 256 / 128 = 128 registers a
// thread, so the KV tile is 64 columns (kKvTile: the S tile takes 32
// registers, not 64); a tile is half of a 128-row K-scale group and reads
// that group's scale.  Q.K^T reads Q's codes from shared memory
// (wgmma_s8_ss) instead of holding 32 registers of fragments.  Shared
// memory: Q 32 KB for the CTA's 128 rows, and 4 stages of K 16 KB and V
// 32 KB.
//
// Bound: operations, as at 64 and 128.  At the Gemma-7B attention layer
// (b 4, 16 heads of 256, 4096 tokens, causal: 537 M live pairs) Q.K^T is
// 2.75e11 int8 ops and P.V 2.75e11 bf16 FLOP, about 0.42 ms on the H100
// SXM's data-sheet peaks; the bytes about 0.04 ms.

#include "attention_fwd_sm90.cuh"

// The operands of sage_attn_fwd (attention_fwd.cu), with d 256.
extern "C" int sage_attn_fwd_hd256(const void* q, const void* k, const void* k_scale,
                                   const void* v, const void* v_scale, const void* v_mean,
                                   void* o, void* lse2, int b, int hq, int hkv, int sq, int sk,
                                   int d, int causal, int q_is_f32, int v_kind, int want_lse,
                                   int group, float qs_mul, void* stream) {
  const FwdSm90Args a{q, nullptr, (const float*)k_scale, nullptr, (const float*)v_scale,
                      (const float*)v_mean, o, want_lse ? (float*)lse2 : nullptr,
                      hq, hkv, sq, sk, qs_mul, 0, 0};
  return launch_fwd_sm90<256, false>(a, k, v, b, d, causal, q_is_f32, v_kind, group, stream);
}
