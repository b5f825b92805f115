// Fused SageAttention forward for Hopper (sm_90a), without masks: int8
// Q.K^T, bf16 P.V, at head dims 64 and 128 (the default sageattn path:
// non-causal or causal, every V type).  The kernel, TMA-fed wgmma, and its
// design notes are in attention_fwd_sm90.cuh; this source instantiates it
// without PREQ (8 instances: head dim x causal x q dtype).  V codes reach
// it widened to bf16 (widen_v.cu, the wrapper's pass before the launch).

#include "attention_fwd_sm90.cuh"

// q: [b,hq,sq,d] (fp32 if q_is_f32 else bf16), unquantized; k: int8
// [b,hkv,sk,d]; k_scale: fp32 [b,hkv,ceil(sk/group)]; v: bf16 [b,hkv,sk,d]
// (v_kind 0; codes widened first, the other kinds are refused); v_scale,
// v_mean: fp32 [b,hkv,d] or NULL (V codes' scale and mean); o:
// [b,hq,sq,d] in q's dtype; lse2: fp32 [b,hq,sq] or NULL.  All contiguous; d in {64, 128}; group must be 128 (the kernel's
// KV tile); qs_mul = f32(1/127) * f32(sm_scale * log2(e)).
extern "C" int sage_attn_fwd(const void* q, const void* k, const void* k_scale,
                             const void* v, const void* v_scale, const void* v_mean,
                             void* o, void* lse2, int b, int hq, int hkv, int sq, int sk,
                             int d, int causal, int q_is_f32, int v_kind, int want_lse,
                             int group, float qs_mul, void* stream) {
  const FwdSm90Args a{q, nullptr, (const float*)k_scale, nullptr, (const float*)v_scale,
                      (const float*)v_mean, o, want_lse ? (float*)lse2 : nullptr,
                      hq, hkv, sq, sk, qs_mul, 0, 0};
  return d == 64 ? launch_fwd_sm90<64, false>(a, k, v, b, d, causal, q_is_f32, v_kind, group,
                                              stream)
                 : launch_fwd_sm90<128, false>(a, k, v, b, d, causal, q_is_f32, v_kind, group,
                                               stream);
}
