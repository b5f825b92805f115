// Fused SageAttention forward for Hopper (sm_90a) at head dim 256, with
// masks: the D = 256 instances of attention_fwd_sm90.cuh's TMA-fed wgmma
// kernel with MASKED (8: causal x q dtype x a staged bias or not), kernel
// 1's slices (c)-(g) for head dims in (128, 256].  A source of its own
// beside attention_fwd_masked.cu, for the reasons attention_fwd_hd256.cu gives;
// the tiling at D = 256 (64-column KV tiles) is described there.  The
// liveness table keeps its 128-column groups: a 64-column tile reads the
// entry of the group that holds it.
//
// Bound: operations over the live (row, col) pairs, as attention_fwd_masked.cu.

#include "attention_fwd_sm90.cuh"

// The operands of sage_attn_fwd_masked (attention_fwd_masked.cu), with d 256.
extern "C" int sage_attn_fwd_masked_hd256(
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
  return launch_fwd_sm90<256, false, true>(a, k, v, b, d, causal, q_is_f32, v_kind, group,
                                          stream, mk);
}
