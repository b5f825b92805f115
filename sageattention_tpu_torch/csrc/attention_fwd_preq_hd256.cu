// Fused SageAttention forward for Hopper (sm_90a) on pre-quantized Q at
// head dim 256: the PREQ instances at D = 256 of attention_fwd_sm90.cuh's
// kernel (TMA-fed wgmma; 6, causal x (unmasked, masked, masked with a
// staged bias), V codes widened to bf16 before
// the launch, the output type an argument), kernel 1's slices (h)
// score_col_bias, (i) qk_int4 and (k)
// pre-quantized operands of attention_pallas.py:sage_attention_fused for
// every head dim in (128, 256], padded to 256 (core.py:70-75 of the JAX
// package).  sageattn's smooth_q, qk_bits=4 and qk_quant_gran run here at
// those head dims.  A source of its own, so that these instances build
// beside attention_fwd_preq.cu's in parallel and every other instance
// keeps its code.
//
// The tiling is attention_fwd_hd256.cu's: 64-column KV tiles, two to a
// 128-row K-scale group, so a per-tile K scale is the group's, read as
// group j / 2 for tile j, and a per-row one (per_token / per_subtile /
// per_block K) is the row's own.  Q's int8 codes sit in shared memory and
// are read for each KV tile, as the default D = 256 instances read the Q
// they quantize.  The column pairs' K scales and smooth_q's column bias
// take 32 float4 a tile (a slot a stage in the unmasked kernel; in the
// masked one the slot smem_bytes<D, PREQ> adds), so the dequantization
// holds no more registers than a float4 a thread per 8-column n-tile.  The +-7 codes of qk_bits=4 run the
// same int8 MMA: a sum of 256 products of +-7 stays under 2^15.
//
// Bound: operations, as the default D = 256 forward (the same int8 Q.K^T
// and bf16 P.V); it reads int8 Q and a fp32 scale a row where that one
// reads bf16 Q, plus the K scales and the column bias once a Q tile.

#include "attention_fwd_sm90.cuh"

// The operands of sage_attn_fwd_preq (attention_fwd_preq.cu), with d 256.
extern "C" int sage_attn_fwd_preq_hd256(
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
    return launch_fwd_sm90<256, true>(u, k, v, b, d, causal, 0, v_kind, group, stream);
  }
  return launch_fwd_sm90<256, true, true>(u, k, v, b, d, causal, 0, v_kind, group, stream,
                                         mk);
}
