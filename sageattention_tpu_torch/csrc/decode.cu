// Decode attention over the dense quantized KV cache for Hopper (sm_90a):
// kernels 9 and 10 of the port.
//
// Replaces the TPU kernels decode_pallas.py:_decode_kernel (every chunk
// below each batch's length) and decode_pallas.py:_decode_kernel_window
// (only the n_live chunks the sliding window reaches, from a first chunk
// each block computes from the lengths on the device, with no host sync).
// The numerics are decode_body.cuh's, shared with csrc/paged_decode.cu as
// the TPU kernels share decode_step_body; the chunk width comes from the
// host rules of ops/decode_cuda.py, copied from the JAX package.
//
// Grid: (row tiles, kv heads, batch); a block reads its own length.
// Chunks past the length are neither read nor computed, so a short
// sequence in a long cache reads O(length) bytes.
//
// Bound: bytes, the live K and V codes (d bytes a token each, d/2 packed)
// and their two fp32 scales once per step.  At the llm-8b-gqa decode step
// (b 4, 8 kv heads, ~4,100 live tokens, d 128) that is about 35 MB a
// layer, about 10 us at 3.35 TB/s; this first kernel, 32 blocks with the
// chunk loop inside and K read three times a chunk (see decode_body.cuh),
// sits well above it.

#include "decode_dense.cuh"

// q: fp32 [b, hkv, rows, d], the (GQA group x t_q) rows of each kv head,
// head-major; k, v: int8 [b, hkv, S, d], or token-pair-packed [b, hkv,
// S/2, d] when packed; ks, vs: fp32 [b, hkv, S]; lengths: int32 [b]; o:
// fp32 [b, hkv, rows, d]; m, l: fp32 [b, hkv, rows] or both NULL.  All
// contiguous; d <= 256 (the kernels compute at 64, 128 or 256, the lanes
// past d zero; csrc/decode_wide.cu takes d in (256, 512]); chunk divides S; qs_mul = f32(1/qmax) *
// f32(sm_scale * log2(e)), qmax 127, or 119 for the packed cache.
extern "C" int sage_decode(const void* q, const void* k, const void* ks, const void* v,
                           const void* vs, const void* lengths, void* o, void* m, void* l, int b,
                           int hkv, int rows, int t_q, int S, int d, int packed, int chunk,
                           int window, int n_live, float qs_mul, void* stream) {
  return checked<false>(q, k, ks, v, vs, lengths, o, m, l, b, hkv, rows, t_q, S, d, packed,
                        chunk, 0, 0, qs_mul, stream, false);
}

// as sage_decode, with the sliding window: each query row keeps its last
// `window` keys, and a block visits only the n_live chunks from the first
// one the window reaches
extern "C" int sage_decode_window(const void* q, const void* k, const void* ks, const void* v,
                                  const void* vs, const void* lengths, void* o, void* m, void* l,
                                  int b, int hkv, int rows, int t_q, int S, int d, int packed,
                                  int chunk, int window, int n_live, float qs_mul, void* stream) {
  return checked<false>(q, k, ks, v, vs, lengths, o, m, l, b, hkv, rows, t_q, S, d, packed,
                        chunk, window, n_live, qs_mul, stream, true);
}
