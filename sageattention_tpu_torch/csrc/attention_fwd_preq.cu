// Fused SageAttention forward for Hopper (sm_90a) on pre-quantized Q:
// kernel 1's slices (h) score_col_bias, (i) qk_int4 and (k) pre-quantized
// operands of attention_pallas.py:sage_attention_fused.  sageattn's
// smooth_q, qk_bits=4 and qk_quant_gran = per_token / per_subtile /
// per_block run here: int8 Q codes (+-127, or +-7 at 4 bits) with per-row
// scales, K scales per 128-row tile or per row, and smooth_q's column bias.
// The instances are attention_fwd_sm90.cuh's kernel (TMA-fed wgmma; the
// producer stages the K scales and column bias of a tile by TMA) with PREQ,
// without masks and with them (MASKED, attention_fwd_kernel.cuh's pieces):
// 12 instances, head dim x causal x (unmasked, masked, masked with a staged
// bias), V codes widened to bf16 before
// the launch, the output type an argument; the source builds beside
// attention_fwd.cu and attention_fwd_masked.cu.
//
// Bound: operations, as the default forward's (the same int8 Q.K^T and
// bf16 P.V); it reads int8 Q and one fp32 scale a row where the default
// forward reads bf16 Q, plus the K scales and the column bias once a Q
// tile (a few bytes a column).

#include "attention_fwd_sm90.cuh"

// The operands of sage_attn_fwd (attention_fwd.cu), with q the int8 codes
// [b,hq,sq,d] and k_scale fp32 [b,hkv,ceil(sk/group)] (ks_per_row = 0) or
// [b,hkv,sk] (ks_per_row = 1); then q_scale fp32 [b,hq,sq] with
// sm_scale*log2(e) folded in, col_bias fp32 [b,hq,sk] (base 2) or NULL,
// o_f32 (o fp32, else bf16), and with `masked` the masks of
// sage_attn_fwd_masked (attention_fwd_masked.cu), in its order.  qs_mul
// is not read.
extern "C" int sage_attn_fwd_preq(
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
    return d == 64 ? launch_fwd_sm90<64, true>(u, k, v, b, d, causal, 0, v_kind, group, stream)
                   : launch_fwd_sm90<128, true>(u, k, v, b, d, causal, 0, v_kind, group, stream);
  }
  return d == 64 ? launch_fwd_sm90<64, true, true>(u, k, v, b, d, causal, 0, v_kind, group,
                                                   stream, mk)
                 : launch_fwd_sm90<128, true, true>(u, k, v, b, d, causal, 0, v_kind, group,
                                                    stream, mk);
}
