// Fused SageAttention forward for Hopper (sm_90a) with masks: kernel 1's
// slices (c)-(g) of attention_pallas.py:sage_attention_fused (segment ids
// and varlen's range form, bool masks, the additive bias, the sliding
// window, positions) at head dims 64 and 128.  The kernel is
// attention_fwd_sm90.cuh's TMA-fed wgmma kernel with MASKED (16 instances:
// head dim x causal x q dtype x a staged bias or not); the masks' pieces
// and what they compute are in attention_fwd_kernel.cuh.  V codes reach it
// widened to bf16 (widen_v.cu).  A source of its own beside
// attention_fwd.cu, so the two compile in parallel.
//
// Bound: operations over the live (row, col) pairs, whose count the
// masks set; the mask and bias bytes, where given, are read once per
// query head that does not broadcast them.

#include "attention_fwd_sm90.cuh"

// The operands of sage_attn_fwd (attention_fwd.cu), then the masks, each
// NULL when absent: q_seg, kv_seg int32 [b,sq], [b,sk]; kv_lo, kv_hi
// int32 [b,sq] (row attends [kv_lo, kv_hi)); q_pos, kv_pos int32 [b,sq],
// [b,sk]; mask bool and bias fp32 (or bf16 with bias_bf16) of logical
// shape [b,hq,sq,sk] read through element strides (b, h, row, col), 0 for
// a broadcast dimension; live uint8 [b, *, ceil(sq/64), ceil(sk/128)]
// with batch and head strides (a tile marked 0 is skipped); window > 0
// keeps col > row - window (causal only).
extern "C" int sage_attn_fwd_masked(
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
  return d == 64 ? launch_fwd_sm90<64, false, true>(a, k, v, b, d, causal, q_is_f32, v_kind,
                                                    group, stream, mk)
                 : launch_fwd_sm90<128, false, true>(a, k, v, b, d, causal, q_is_f32, v_kind,
                                                     group, stream, mk);
}
