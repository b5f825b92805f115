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
// Both entry points run one kernel, the split walk of decode_split_sm90.cuh:
// a thread-block cluster of cl CTAs shares each chunk, each CTA reading its
// share of the chunk's K once and keeping its S on chip; the grid's z axis
// splits the walked chunks (every chunk, or the window's n_live) into
// `splits` consecutive ranges, and the last range of a (batch, kv head, row
// tile) to finish merges the partials in the launch.  A row tile of 16 rows
// reads only the slabs that hold a key its rows see.  The host plans (cl,
// splits) from the shapes alone (ops/decode_cuda.py:split_plan) and passes
// the partials' workspace and tickets.  Grid: (row tiles x cl, kv heads,
// batch x splits).  Each block reads its own length on the device;
// chunks past it are neither read nor computed, so a short sequence in a
// long cache reads O(length) bytes.
//
// Bound: bytes at the decode step, the live K and V codes (d bytes a token
// each, d/2 packed) and their two fp32 scales once per step.  At the
// llm-8b-gqa decode step (b 4, 8 kv heads, ~4,100 live tokens, d 128) that
// is about 35 MB a layer, about 10 us at 3.35 TB/s.  An extend block
// (t_q 512) is bound by its int8 operations, 4 * rows * d a visible key.
// What keeps the walk above the bound is each CTA's chain of load
// latencies and three cluster barriers a chunk (PERF.md).

#include "decode_dense.cuh"

// q: fp32 [b, hkv, rows, d], the (GQA group x t_q) rows of each kv head,
// head-major; k, v: int8 [b, hkv, S, d], or token-pair-packed [b, hkv,
// S/2, d] when packed; ks, vs: fp32 [b, hkv, S]; lengths: int32 [b]; o:
// fp32 [b, hkv, rows, d]; m, l: fp32 [b, hkv, rows] or both NULL.  All
// contiguous; d <= 256 (the kernels compute at 64, 128 or 256, the lanes
// past d zero; csrc/decode_wide.cu takes d in (256, 512]); chunk divides S;
// qs_mul = f32(1/qmax) * f32(sm_scale * log2(e)), qmax 127, or 119 for the
// packed cache.  The split walk's plan: cl 1, 2, 4 or 8, 1 <= splits <=
// S / chunk (at most 256); with splits > 1, work (fp32,
// decode_cuda.split_workspace_size's floats) and tickets (int32, zero
// before the first call; the kernel leaves them zero), else both may be
// NULL.  window and n_live are not read.
extern "C" int sage_decode(const void* q, const void* k, const void* ks, const void* v,
                           const void* vs, const void* lengths, void* o, void* m, void* l, int b,
                           int hkv, int rows, int t_q, int S, int d, int packed, int chunk,
                           int window, int n_live, float qs_mul, void* stream, int cl,
                           int splits, void* work, void* tickets) {
  return checked<false>(q, k, ks, v, vs, lengths, o, m, l, b, hkv, rows, t_q, S, d, packed,
                        chunk, 0, 0, qs_mul, stream, false, cl, splits, work, tickets);
}

// as sage_decode, with the sliding window: each query row keeps its last
// `window` keys, and a block walks only the n_live chunks from the first
// one the window reaches (1 <= splits <= n_live, at most 256)
extern "C" int sage_decode_window(const void* q, const void* k, const void* ks, const void* v,
                                  const void* vs, const void* lengths, void* o, void* m, void* l,
                                  int b, int hkv, int rows, int t_q, int S, int d, int packed,
                                  int chunk, int window, int n_live, float qs_mul, void* stream,
                                  int cl, int splits, void* work, void* tickets) {
  return checked<false>(q, k, ks, v, vs, lengths, o, m, l, b, hkv, rows, t_q, S, d, packed,
                        chunk, window, n_live, qs_mul, stream, true, cl, splits, work,
                        tickets);
}
