// Decode attention through a page table for Hopper (sm_90a) at head dims in
// (256, 512]: kernels 11 and 12 of the port at D = 384 and 512, with the
// sharded pool's `owned` page mask.  A source of its own beside
// csrc/paged_decode.cu, on the same kernel and host code (decode_paged.cuh),
// for the reasons csrc/decode_wide.cu gives; both kernels are the split
// walk of decode_split_sm90.cuh.
//
// Bound: bytes, as csrc/paged_decode.cu.

#include "decode_paged.cuh"

// The operands of sage_paged_decode (csrc/paged_decode.cu), with d in
// (256, 512].
extern "C" int sage_paged_decode_wide(const void* q, const void* pk, const void* pks,
                                      const void* pv, const void* pvs, const void* table,
                                      const void* owned, const void* lengths, void* o, void* m,
                                      void* l, int b, int hkv, int rows, int t_q, int page,
                                      int max_pages, int d, int packed, int window, int n_live,
                                      float qs_mul, void* stream, int cl, int splits,
                                      void* work, void* tickets) {
  return checked<true>(q, pk, pks, pv, pvs, table, owned, lengths, o, m, l, b, hkv, rows, t_q,
                       page, max_pages, d, packed, 0, 0, qs_mul, stream, false, cl, splits, work,
                       tickets);
}

// The operands of sage_paged_decode_window, with d in (256, 512].
extern "C" int sage_paged_decode_window_wide(const void* q, const void* pk, const void* pks,
                                             const void* pv, const void* pvs, const void* table,
                                             const void* owned, const void* lengths, void* o,
                                             void* m, void* l, int b, int hkv, int rows, int t_q,
                                             int page, int max_pages, int d, int packed,
                                             int window, int n_live, float qs_mul, void* stream,
                                             int cl, int splits, void* work, void* tickets) {
  return checked<true>(q, pk, pks, pv, pvs, table, owned, lengths, o, m, l, b, hkv, rows, t_q,
                       page, max_pages, d, packed, window, n_live, qs_mul, stream, true, cl,
                       splits, work, tickets);
}
