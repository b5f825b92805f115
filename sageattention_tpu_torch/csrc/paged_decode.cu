// Decode attention through a page table for Hopper (sm_90a): kernels 11
// and 12 of the port.
//
// Replaces the TPU kernels paged_decode_pallas.py:_paged_kernel (every page
// below each batch's length) and paged_decode_pallas.py:_paged_kernel_window
// (only the n_live pages the sliding window reaches).  One page is one
// chunk of decode_body.cuh's body, so the P quantization unit is the page,
// as on the TPU.  Where the TPU prefetches the page table and the lengths
// as scalars ahead of the grid, each block here reads its own length and
// its pages' ids from device memory.  The TPU's pairing of two pages per
// grid step (`pair`) tunes its step overhead and changes no number; it has
// no counterpart here.
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
// Grid: (row tiles, kv heads, batch).  Pages past the length are neither
// read nor computed; entries of the table past it may hold any valid id.
//
// Bound: bytes, as csrc/decode.cu: the live pages' K and V codes and their
// scales once per step, plus the table.  Pages of 16 tokens (vLLM's size)
// leave most of a 256-token shared-memory slab empty and run far from it;
// pages of 1024 (the JAX default, the main path's) fill four slabs.

#include "decode_body.cuh"

namespace {

using decode::Chunk;

template <int D, int MW, bool PACKED, bool WINDOW>
__global__ void __launch_bounds__(decode::NTHREADS)
sage_paged_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ pk,
                         const float* __restrict__ pks, const int8_t* __restrict__ pv,
                         const float* __restrict__ pvs, const int* __restrict__ table,
                         const int* __restrict__ owned, const int* __restrict__ lengths,
                         float* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out, int hkv, int rows,
                         int t_q, int page, int max_pages, int window, int n_live,
                         float qs_mul, int ds) {
  const int hk = blockIdx.y, bi = blockIdx.z;
  const size_t bh = (size_t)bi * hkv + hk;
  const int page_rows = PACKED ? page / 2 : page;  // data rows of one page
  const int* pt = table + (size_t)bi * max_pages;
  const int* own = owned == nullptr ? nullptr : owned + (size_t)bi * max_pages;
  auto chunk_at = [=](int p) {
    const size_t ph = (size_t)pt[p] * hkv + hk;  // the page's (page, kv head) slab
    return Chunk{pk + ph * page_rows * ds, pks + ph * page, pv + ph * page_rows * ds,
                 pvs + ph * page};
  };
  decode::decode_cta<D, MW, PACKED, WINDOW>(
      q + bh * rows * ds, o + bh * rows * ds, m_out ? m_out + bh * rows : nullptr,
      l_out ? l_out + bh * rows : nullptr, rows, t_q, lengths[bi], page, max_pages, window,
      n_live, qs_mul, ds, chunk_at, [=](int p) { return own == nullptr || own[p] != 0; });
}

struct Args {
  const float* q;
  const int8_t *k, *v;
  const float *ks, *vs;
  const int *table, *owned, *lengths;
  float *o, *m, *l;
  int b, hkv, rows, t_q, page, max_pages, window, n_live;
  float qs_mul;
  int ds;  // the cache's head dim
};

template <int D, int MW, bool PACKED, bool WINDOW>
int launch(const Args& a, cudaStream_t st) {
  auto kern = sage_paged_decode_kernel<D, MW, PACKED, WINDOW>;
  int smem = 0;
  const int e = decode::prepare<D, MW, PACKED>(kern, smem);
  if (e != 0) return e;
  constexpr int RT = decode::Shape<D, MW, PACKED>::RT;
  dim3 grid((a.rows + RT - 1) / RT, a.hkv, a.b);
  kern<<<grid, decode::NTHREADS, smem, st>>>(a.q, a.k, a.ks, a.v, a.vs, a.table, a.owned,
                                             a.lengths, a.o, a.m, a.l, a.hkv, a.rows, a.t_q,
                                             a.page, a.max_pages, a.window, a.n_live, a.qs_mul,
                                             a.ds);
  return (int)cudaGetLastError();
}

template <int D, bool PACKED, bool WINDOW>
int launch_rows(const Args& a, cudaStream_t st) {
  if constexpr (D == 256)  // two row warps at least (decode_body.cuh, "Warps")
    return a.rows <= 32 ? launch<D, 2, PACKED, WINDOW>(a, st) : launch<D, 4, PACKED, WINDOW>(a, st);
  else
    return a.rows <= 16 ? launch<D, 1, PACKED, WINDOW>(a, st) : launch<D, 4, PACKED, WINDOW>(a, st);
}

template <bool WINDOW>
int dispatch(int d, int packed, const Args& a, cudaStream_t st) {
  if (d <= 64)
    return packed ? launch_rows<64, true, WINDOW>(a, st) : launch_rows<64, false, WINDOW>(a, st);
  if (d <= 128)
    return packed ? launch_rows<128, true, WINDOW>(a, st) : launch_rows<128, false, WINDOW>(a, st);
  return packed ? launch_rows<256, true, WINDOW>(a, st) : launch_rows<256, false, WINDOW>(a, st);
}

int checked(const void* q, const void* pk, const void* pks, const void* pv, const void* pvs,
            const void* table, const void* owned, const void* lengths, void* o, void* m, void* l,
            int b, int hkv, int rows, int t_q, int page, int max_pages, int d, int packed,
            int window, int n_live, float qs_mul, void* stream, bool windowed) {
  // a shard's partial (owned) is only meaningful with its merge state
  if (d <= 0 || d > 256 || d % 16 != 0 || page <= 0 || (packed && page % 2 != 0) || max_pages <= 0 ||
      t_q <= 0 || rows <= 0 || (windowed && (window <= 0 || n_live <= 0 || n_live > max_pages)) ||
      ((m == nullptr) != (l == nullptr)) || (owned != nullptr && m == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)q, (const int8_t*)pk, (const int8_t*)pv, (const float*)pks,
               (const float*)pvs, (const int*)table, (const int*)owned, (const int*)lengths,
               (float*)o, (float*)m, (float*)l, b, hkv, rows, t_q, page, max_pages, window,
               n_live, qs_mul, d};
  cudaStream_t st = (cudaStream_t)stream;
  return windowed ? dispatch<true>(d, packed, a, st) : dispatch<false>(d, packed, a, st);
}

}  // namespace

// q: fp32 [b, hkv, rows, d] (rows = GQA group x t_q, head-major); pk, pv:
// the page pool, int8 [P, hkv, page, d] or token-pair-packed [P, hkv,
// page/2, d]; pks, pvs: fp32 [P, hkv, page]; table: int32 [b, max_pages]
// physical page ids; owned: int32 [b, max_pages] (0: a page this shard does
// not hold) or NULL (every page); lengths: int32 [b]; o: fp32 [b, hkv, rows,
// d]; m, l: fp32 [b, hkv, rows] or both NULL (not with owned).  All
// contiguous; d as sage_decode's; qs_mul as sage_decode's.
extern "C" int sage_paged_decode(const void* q, const void* pk, const void* pks, const void* pv,
                                 const void* pvs, const void* table, const void* owned,
                                 const void* lengths, void* o, void* m, void* l, int b, int hkv,
                                 int rows, int t_q, int page, int max_pages, int d, int packed,
                                 int window, int n_live, float qs_mul, void* stream) {
  return checked(q, pk, pks, pv, pvs, table, owned, lengths, o, m, l, b, hkv, rows, t_q, page,
                 max_pages, d, packed, 0, 0, qs_mul, stream, false);
}

// as sage_paged_decode, over only the n_live pages the window reaches
extern "C" int sage_paged_decode_window(const void* q, const void* pk, const void* pks,
                                        const void* pv, const void* pvs, const void* table,
                                        const void* owned, const void* lengths, void* o, void* m,
                                        void* l, int b, int hkv, int rows, int t_q, int page,
                                        int max_pages, int d, int packed, int window, int n_live,
                                        float qs_mul, void* stream) {
  return checked(q, pk, pks, pv, pvs, table, owned, lengths, o, m, l, b, hkv, rows, t_q, page,
                 max_pages, d, packed, window, n_live, qs_mul, stream, true);
}
