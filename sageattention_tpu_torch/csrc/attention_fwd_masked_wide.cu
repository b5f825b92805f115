// Fused SageAttention forward for Hopper (sm_90a) at head dims 384 and 512,
// with masks: the D = 384 and D = 512 instances of attention_fwd_kernel.cuh
// (MASKED = true), kernel 1's slices (c)-(g) for head dims in (256, 512].
// A source of its own beside attention_fwd_masked.cu and
// attention_fwd_masked_hd256.cu, for the reasons attention_fwd_wide.cu
// gives.  O is split by columns over a grid axis, a CTA a column slice
// with S recomputed in each (attention_fwd_kernel.cuh says why and what it
// costs; the unmasked instances split O inside one CTA instead).  Each
// slice applies the masks, the bias and the tile skipping to its own S,
// by the same rule, so the slices agree on every dead element and on the
// rows with no live key (o = 0, lse2 = -inf).
//
// Bound: operations over the live (row, col) pairs, as attention_fwd_masked.cu.

#include "attention_fwd_kernel.cuh"

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
  const Args a{q, k, k_scale, v, v_scale, v_mean, o, want_lse ? lse2 : nullptr,
               b, hq, hkv, sq, sk, qs_mul};
  return d == 384 ? launch_fwd_d<384, true>(a, mk, d, causal, q_is_f32, v_kind, group, stream)
                  : launch_fwd_d<512, true>(a, mk, d, causal, q_is_f32, v_kind, group, stream);
}
