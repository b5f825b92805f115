// Fused SageAttention forward for Hopper (sm_90a) on pre-quantized Q at head
// dims 384 and 512, kernel 1's slices (h) score_col_bias, (i) qk_int4 and
// (k) pre-quantized operands of attention_pallas.py:sage_attention_fused
// for every head dim in (256, 512]: the PREQ instances of
// attention_fwd_sm90_wide.cuh (TMA-fed wgmma, O's columns split between
// two consumer warpgroups that both compute the whole S; 4 a head dim,
// causal x masked, V codes widened to bf16 before the launch).  The output
// type is an argument.
// sageattn's smooth_q, qk_bits=4 and qk_quant_gran run here at those head
// dims.  A source of its own, for the reasons attention_fwd_wide.cu gives.
//
// The +-7 codes of qk_bits=4 run the same int8 MMA: a sum of 512 products
// of +-7 stays under 2^15.  Per-tile K scales are read as group kv0 / 128
// of a KV tile (64 columns; 32 at 512), per-row ones as the
// row's own, staged by TMA with the column bias.
//
// Bound: operations, as the default wide forward.

#include "attention_fwd_sm90_wide.cuh"

// The operands of sage_attn_fwd_preq (attention_fwd_preq.cu), with d 384 or
// 512.
extern "C" int sage_attn_fwd_preq_wide(
    const void* q, const void* k, const void* k_scale, const void* v, const void* v_scale,
    const void* v_mean, void* o, void* lse2, int b, int hq, int hkv, int sq, int sk, int d,
    int causal, int v_kind, int want_lse, int group, int ks_per_row, int o_f32,
    const void* q_scale, const void* col_bias, void* stream, int masked, const void* q_seg,
    const void* kv_seg, const void* kv_lo, const void* kv_hi, const void* q_pos,
    const void* kv_pos, const void* mask, const void* bias, const void* live,
    long long mask_sb, long long mask_sh, long long mask_sr, long long mask_sc,
    long long bias_sb, long long bias_sh, long long bias_sr, long long bias_sc,
    long long live_sb, long long live_sh, int window, int bias_bf16) {
  if (q_scale == nullptr) return (int)cudaErrorInvalidValue;
  MaskArgs mk;
  if (!mask_args(&mk, causal, q_seg, kv_seg, kv_lo, kv_hi, q_pos, kv_pos, mask, bias, live,
                 mask_sb, mask_sh, mask_sr, mask_sc, bias_sb, bias_sh, bias_sr, bias_sc, live_sb,
                 live_sh, window, bias_bf16))
    return (int)cudaErrorInvalidValue;
  const FwdSm90Args u{q, (const float*)q_scale, (const float*)k_scale, (const float*)col_bias,
                      (const float*)v_scale, (const float*)v_mean, o,
                      want_lse ? (float*)lse2 : nullptr, hq, hkv, sq, sk, 0.f, ks_per_row, o_f32};
  if (!masked) {
    return d == 384
               ? launch_fwd_wide<384, true>(u, k, v, b, d, causal, 0, v_kind, group, stream)
               : launch_fwd_wide<512, true>(u, k, v, b, d, causal, 0, v_kind, group, stream);
  }
  return d == 384 ? launch_fwd_wide<384, true, true>(u, k, v, b, d, causal, 0, v_kind, group,
                                                    stream, mk)
                  : launch_fwd_wide<512, true, true>(u, k, v, b, d, causal, 0, v_kind, group,
                                                     stream, mk);
}
