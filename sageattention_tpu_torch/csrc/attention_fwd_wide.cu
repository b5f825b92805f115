// Fused SageAttention forward for Hopper (sm_90a) at head dims 384 and 512,
// without masks: the instances of attention_fwd_sm90_wide.cuh (TMA-fed
// wgmma; causal x q dtype, V codes widened to bf16 before the launch),
// which kernel 1 (attention_pallas.py:sage_attention_fused) runs for every
// head dim in (256, 512], padded to the next multiple of 128 (core.py:70-75
// of the JAX package).  A source of its own, so that these instances build
// beside the other sources in parallel and every instance at 64, 128 and
// 256 keeps its code.
//
// Design: one CTA a 64-row Q tile, O's columns split between its two
// consumer warpgroups (D / 2 each: a thread's O accumulator is 96 registers
// at 384 and 128 at 512), each warpgroup computing the whole S = Q.K^T
// itself (the header says why that beat one S split over the head dim and
// exchanged, and what the KV tile is).  The masked wide instances
// (attention_fwd_masked_wide.cu and the masked ones of
// attention_fwd_preq_wide.cu) are the same kernel with MASKED.
//
// Bound: operations, as at 256.  At (4, 16/16, 4096, d) causal (537 M live
// pairs) Q.K^T is 2 x 537e6 x d int8 ops and P.V as many bf16 FLOP: 0.63 ms
// at 384 and 0.83 ms at 512 on the H100 SXM's data-sheet peaks; the bytes
// (bf16 Q, K codes, bf16 V, O) about 0.06 and 0.08 ms.

#include "attention_fwd_sm90_wide.cuh"

// The operands of sage_attn_fwd (attention_fwd.cu), with d 384 or 512.
extern "C" int sage_attn_fwd_wide(const void* q, const void* k, const void* k_scale,
                                  const void* v, const void* v_scale, const void* v_mean,
                                  void* o, void* lse2, int b, int hq, int hkv, int sq, int sk,
                                  int d, int causal, int q_is_f32, int v_kind, int want_lse,
                                  int group, float qs_mul, void* stream) {
  const FwdSm90Args a{q, nullptr, (const float*)k_scale, nullptr, (const float*)v_scale,
                      (const float*)v_mean, o, want_lse ? (float*)lse2 : nullptr,
                      hq, hkv, sq, sk, qs_mul, 0, 0};
  return d == 384 ? launch_fwd_wide<384, false>(a, k, v, b, d, causal, q_is_f32, v_kind, group,
                                                stream)
                  : launch_fwd_wide<512, false>(a, k, v, b, d, causal, q_is_f32, v_kind, group,
                                                stream);
}
