// Fused SageAttention forward for Hopper (sm_90a) at head dims 384 and 512,
// with masks: the instances of attention_fwd_sm90_wide.cuh's TMA-fed wgmma
// kernel with MASKED (8: head dim x causal x q dtype), kernel 1's slices
// (c)-(g) for head dims in (256, 512].  A source of its own beside
// attention_fwd_masked.cu and attention_fwd_masked_hd256.cu, for the
// reasons attention_fwd_wide.cu gives.  One CTA a 64-row Q tile, O's
// columns split between its two consumer warpgroups; each warpgroup
// computes the whole S and applies the masks, the bias and the tile skips
// to it by the same rule on the same operands, so the two agree on every
// dead element, on m, l and lse2, and on the rows with no live key (o = 0,
// lse2 = -inf).
//
// Bound: operations over the live (row, col) pairs, as attention_fwd_masked.cu.

#include "attention_fwd_sm90_wide.cuh"

// The operands of sage_attn_fwd_masked (attention_fwd_masked.cu), with d 384
// or 512.
extern "C" int sage_attn_fwd_masked_wide(
    const void* q, const void* k, const void* k_scale, const void* v, const void* v_scale,
    const void* v_mean, void* o, void* lse2, int b, int hq, int hkv, int sq, int sk, int d,
    int causal, int q_is_f32, int v_kind, int want_lse, int group, float qs_mul, void* stream,
    const void* q_seg, const void* kv_seg, const void* kv_lo, const void* kv_hi,
    const void* q_pos, const void* kv_pos, const void* mask, const void* bias,
    const void* live, long long mask_sb, long long mask_sh, long long mask_sr,
    long long mask_sc, long long bias_sb, long long bias_sh, long long bias_sr,
    long long bias_sc, long long live_sb, long long live_sh, int window, int bias_bf16) {
  MaskArgs mk;
  if (!mask_args(&mk, causal, q_seg, kv_seg, kv_lo, kv_hi, q_pos, kv_pos, mask, bias, live,
                 mask_sb, mask_sh, mask_sr, mask_sc, bias_sb, bias_sh, bias_sr, bias_sc, live_sb,
                 live_sh, window, bias_bf16))
    return (int)cudaErrorInvalidValue;
  const FwdSm90Args a{q, nullptr, (const float*)k_scale, nullptr, (const float*)v_scale,
                      (const float*)v_mean, o, want_lse ? (float*)lse2 : nullptr,
                      hq, hkv, sq, sk, qs_mul, 0, 0};
  return d == 384 ? launch_fwd_wide<384, false, true>(a, k, v, b, d, causal, q_is_f32, v_kind,
                                                     group, stream, mk)
                  : launch_fwd_wide<512, false, true>(a, k, v, b, d, causal, q_is_f32, v_kind,
                                                      group, stream, mk);
}
