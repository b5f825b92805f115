// Decode attention over the dense quantized KV cache for Hopper (sm_90a) at
// head dims in (256, 512]: kernels 9 and 10 of the port at D = 384 and 512,
// every head dim above 256 computed at the next multiple of 128 (as the JAX
// package pads it), the cache read at its own head dim.  A source of its
// own beside csrc/decode.cu, on the same kernel and host code
// (decode_dense.cuh), so that these instances build in parallel with the
// others and those keep their code.
//
// Both kernels are the split walk of decode_split_sm90.cuh at 64-token
// slabs, its S kept in shared memory, one CTA an SM.  The ragged
// instances (a head dim that is not a multiple of 16) read the rows byte by
// byte.
//
// Bound: bytes, as csrc/decode.cu: the live K and V codes (d bytes a token
// each, d/2 packed) and their two fp32 scales once per step.

#include "decode_dense.cuh"

// The operands of sage_decode (csrc/decode.cu), with d in (256, 512].
extern "C" int sage_decode_wide(const void* q, const void* k, const void* ks, const void* v,
                                const void* vs, const void* lengths, void* o, void* m, void* l,
                                int b, int hkv, int rows, int t_q, int S, int d, int packed,
                                int chunk, int window, int n_live, float qs_mul, void* stream,
                                int cl, int splits, void* work, void* tickets) {
  return checked<true>(q, k, ks, v, vs, lengths, o, m, l, b, hkv, rows, t_q, S, d, packed, chunk,
                       0, 0, qs_mul, stream, false, cl, splits, work, tickets);
}

// The operands of sage_decode_window, with d in (256, 512].
extern "C" int sage_decode_window_wide(const void* q, const void* k, const void* ks,
                                       const void* v, const void* vs, const void* lengths,
                                       void* o, void* m, void* l, int b, int hkv, int rows,
                                       int t_q, int S, int d, int packed, int chunk, int window,
                                       int n_live, float qs_mul, void* stream, int cl,
                                       int splits, void* work, void* tickets) {
  return checked<true>(q, k, ks, v, vs, lengths, o, m, l, b, hkv, rows, t_q, S, d, packed, chunk,
                       window, n_live, qs_mul, stream, true, cl, splits, work, tickets);
}
