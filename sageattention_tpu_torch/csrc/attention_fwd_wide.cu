// Fused SageAttention forward for Hopper (sm_90a) at head dims 384 and 512,
// without masks: the D = 384 and D = 512 instances of attention_fwd_kernel.cuh
// (MASKED = false), which kernel 1 (attention_pallas.py:sage_attention_fused)
// runs for every head dim in (256, 512], padded to the next multiple of 128
// (core.py:70-75 of the JAX package).  A source of its own, so that these 32
// instances (D x causal x V kind x q dtype) build beside the other sources
// in parallel and every instance at 64, 128 and 256 keeps its code.
//
// Design: O split by columns over a grid axis.  A warp that owns 16 Q rows
// would hold its fp32 O accumulator in D / 2 registers a thread, 192 at 384
// and 256 at 512, where the D = 256 instances already use 242-244 with a
// 64-column KV tile.  So each CTA computes one column slice of O, DV = D / 2
// columns (kDv: 192 at 384, 256 at 512), and the grid's x axis walks the Q
// tiles' two slices side by side.  Each slice's CTA quantizes its Q rows
// and computes S = Q.K^T over the whole D by the same instruction sequence,
// so its m, l and lse2 are those of the other slice bit for bit; slice 0
// writes lse2.  The cost is Q.K^T (and Q's quantization and the masks)
// done twice, written down, not hidden: of the int8 Q.K^T and bf16 P.V
// work, Q.K^T is half, so the products take 1.5x their single-pass count.
// The accumulator is then D = 256's (128 registers at 512, 96 at 384), the
// KV tile D = 256's 64 columns.  Shared memory a CTA: Q codes 64 x (D + 16)
// bytes, a K tile 64 x (D + 16), a V slice 64 x (DV + 8) bf16: 99 KB at
// 512, 75 KB at 384.  Registers (cuobjdump, chip_smoke.py, PR 11): 182-184
// a thread at 384 and 241-243 at 512, no stack; the masked instances
// 254-255 (8 bytes of stack in one at 512), the pre-quantized 179-255 (8-16
// bytes in two at 512).
//
// Bound: operations, as at 256.  At (4, 16/16, 4096, d) causal (537 M live
// pairs) Q.K^T is 2 x 537e6 x d int8 ops and P.V as many bf16 FLOP: 0.63 ms
// at 384 and 0.83 ms at 512 on the H100 SXM's data-sheet peaks; the bytes
// (bf16 Q, K codes, bf16 V, O) about 0.06 and 0.08 ms.

#include "attention_fwd_kernel.cuh"

// The operands of sage_attn_fwd (attention_fwd.cu), with d 384 or 512.
extern "C" int sage_attn_fwd_wide(const void* q, const void* k, const void* k_scale,
                                  const void* v, const void* v_scale, const void* v_mean,
                                  void* o, void* lse2, int b, int hq, int hkv, int sq, int sk,
                                  int d, int causal, int q_is_f32, int v_kind, int want_lse,
                                  int group, float qs_mul, void* stream) {
  const Args a{q, k, k_scale, v, v_scale, v_mean, o, want_lse ? lse2 : nullptr,
               b, hq, hkv, sq, sk, qs_mul};
  return d == 384 ? launch_fwd_d<384, false>(a, NoMask{}, d, causal, q_is_f32, v_kind, group, stream)
                  : launch_fwd_d<512, false>(a, NoMask{}, d, causal, q_is_f32, v_kind, group, stream);
}
