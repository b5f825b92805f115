// Decode attention through a page table for Hopper (sm_90a): kernels 11
// and 12 of the port.
//
// Replaces the TPU kernels paged_decode_pallas.py:_paged_kernel (every page
// below each batch's length) and paged_decode_pallas.py:_paged_kernel_window
// (only the n_live pages the sliding window reaches).  One page is one
// chunk of decode_body.cuh's numbers, so the P quantization unit is the
// page, as on the TPU.  Where the TPU prefetches the page table and the
// lengths as scalars ahead of the grid, each block here reads its own
// length and its pages' ids from device memory.  The TPU's pairing of two
// pages per grid step (`pair`) tunes its step overhead and changes no
// number; it has no counterpart here.
//
// The sharded pool (`owned`, paged_decode_pallas.py:99-100, :151-152): a
// shard of a pool split over ranks passes an int32 [b, max_pages] mask of
// the logical pages it holds and asks for the (m, l) merge state.  A page
// whose mask is 0 is skipped before its table entry is read, so it costs
// neither bytes nor compute; a row with no owned live page ends with o = 0,
// m = NEG_INIT and l = 0, and weighs nothing in the merge.  The TPU's
// forward-filled local table exists to let its pipeline elide the DMAs of
// unowned grid steps; here the skip alone does that.  The lengths stay
// global: owned pages are global logical pages.
//
// Both entry points run the split walk of decode_split_sm90.cuh, as
// kernels 9 and 10 do (csrc/decode.cu): a cluster shares each page, the
// grid splits the walked pages (every page, or the window's n_live) into
// consecutive ranges, the last range to finish merges the partials in the
// launch; a range with no owned page reads nothing but its table's owned
// mask.  A page of C tokens takes the plan of a dense chunk of C, so the
// two give bit-identical numbers.  Pages past the length are neither read
// nor computed; entries of the table past it may hold any valid id.
//
// Bound: bytes at the decode step, as csrc/decode.cu: the live pages' K
// and V codes and their scales once per step, plus the table.  Pages of 16
// tokens (vLLM's size) fill an eighth of a 128-token slab (a quarter of a
// 64-token one at 256 and above) and cost a chunk's three barriers each;
// pages of 1024 (the JAX default, the main path's) fill eight slabs.

#include "decode_paged.cuh"

// q: fp32 [b, hkv, rows, d] (rows = GQA group x t_q, head-major); pk, pv:
// the page pool, int8 [P, hkv, page, d] or token-pair-packed [P, hkv,
// page/2, d]; pks, pvs: fp32 [P, hkv, page]; table: int32 [b, max_pages]
// physical page ids; owned: int32 [b, max_pages] (0: a page this shard does
// not hold) or NULL (every page); lengths: int32 [b]; o: fp32 [b, hkv, rows,
// d]; m, l: fp32 [b, hkv, rows] or both NULL (not with owned).  All
// contiguous; d as sage_decode's (csrc/paged_decode_wide.cu takes d in
// (256, 512]); qs_mul, cl, splits, work and tickets as sage_decode's,
// with max_pages in place of S / chunk.  window and n_live are not read.
extern "C" int sage_paged_decode(const void* q, const void* pk, const void* pks, const void* pv,
                                 const void* pvs, const void* table, const void* owned,
                                 const void* lengths, void* o, void* m, void* l, int b, int hkv,
                                 int rows, int t_q, int page, int max_pages, int d, int packed,
                                 int window, int n_live, float qs_mul, void* stream, int cl,
                                 int splits, void* work, void* tickets) {
  return checked<false>(q, pk, pks, pv, pvs, table, owned, lengths, o, m, l, b, hkv, rows, t_q,
                        page, max_pages, d, packed, 0, 0, qs_mul, stream, false, cl, splits, work,
                        tickets);
}

// as sage_paged_decode, over only the n_live pages the window reaches
// (1 <= splits <= n_live)
extern "C" int sage_paged_decode_window(const void* q, const void* pk, const void* pks,
                                        const void* pv, const void* pvs, const void* table,
                                        const void* owned, const void* lengths, void* o, void* m,
                                        void* l, int b, int hkv, int rows, int t_q, int page,
                                        int max_pages, int d, int packed, int window, int n_live,
                                        float qs_mul, void* stream, int cl, int splits,
                                        void* work, void* tickets) {
  return checked<false>(q, pk, pks, pv, pvs, table, owned, lengths, o, m, l, b, hkv, rows, t_q,
                        page, max_pages, d, packed, window, n_live, qs_mul, stream, true, cl,
                        splits, work, tickets);
}
