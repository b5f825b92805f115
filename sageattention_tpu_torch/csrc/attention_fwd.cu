// Fused SageAttention forward for Hopper (sm_90a), without masks: int8
// Q.K^T, bf16 P.V.  The kernel and its design notes are in
// attention_fwd_kernel.cuh; this source instantiates it with MASKED =
// false (the default sageattn path: non-causal or causal, every V type).

#include "attention_fwd_kernel.cuh"

// q: [b,hq,sq,d] (fp32 if q_is_f32 else bf16), unquantized; k: int8
// [b,hkv,sk,d]; k_scale: fp32 [b,hkv,ceil(sk/group)]; v: [b,hkv,sk,d] of
// v_kind (0 bf16, 1 int8, 2 fp8 e4m3, 3 fp8 e5m2); v_scale, v_mean: fp32
// [b,hkv,d] or NULL; o: [b,hq,sq,d] in q's dtype; lse2: fp32 [b,hq,sq] or
// NULL.  All contiguous; d in {64, 128}; group must be 128 (the kernel's
// KV tile); qs_mul = f32(1/127) * f32(sm_scale * log2(e)).
extern "C" int sage_attn_fwd(const void* q, const void* k, const void* k_scale,
                             const void* v, const void* v_scale, const void* v_mean,
                             void* o, void* lse2, int b, int hq, int hkv, int sq, int sk,
                             int d, int causal, int q_is_f32, int v_kind, int want_lse,
                             int group, float qs_mul, void* stream) {
  const Args a{q, k, k_scale, v, v_scale, v_mean, o, want_lse ? lse2 : nullptr,
               b, hq, hkv, sq, sk, qs_mul};
  return launch_fwd<false, false>(a, NoMask{}, NoPreq{}, d, causal, q_is_f32, v_kind, group, stream);
}
