// The paged decode kernels and their host side, shared by
// csrc/paged_decode.cu (head dims up to 256) and csrc/paged_decode_wide.cu
// (head dims in (256, 512]), which build apart and in parallel: each source
// instantiates only its own instances (checked<WIDE>).  Kernels 11 (no
// window) and 12 (the window) are one kernel body, the split walk of
// decode_split_sm90.cuh: the window sets the walked pages, the mask and
// each row tile's slabs.  The design notes are in csrc/paged_decode.cu and
// that header.

#pragma once

#include "decode_split_sm90.cuh"

namespace {

using decode::Chunk;

template <int D, bool PACKED, bool RAGGED>
__global__ void __launch_bounds__(dsplit::NTHREADS, dsplit::Shape<D, PACKED>::MIN_BLOCKS)
sage_paged_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ pk,
                         const float* __restrict__ pks, const int8_t* __restrict__ pv,
                         const float* __restrict__ pvs, const int* __restrict__ table,
                         const int* __restrict__ owned, const int* __restrict__ lengths,
                         float* __restrict__ o, float* __restrict__ m_out,
                         float* __restrict__ l_out, int hkv, int rows, int t_q, int page,
                         int max_pages, int window, int n_live, float qs_mul, int ds, int cl,
                         int splits, float* work, int* tickets) {
  const int tiles = gridDim.x / cl, tile = blockIdx.x / cl, rank = blockIdx.x % cl;
  const int hk = blockIdx.y, bi = blockIdx.z / splits, split = blockIdx.z % splits;
  const size_t bh = (size_t)bi * hkv + hk;
  const int page_rows = PACKED ? page / 2 : page;  // data rows of one page
  const int* pt = table + (size_t)bi * max_pages;
  const int* own = owned == nullptr ? nullptr : owned + (size_t)bi * max_pages;
  auto chunk_at = [=](int p) {
    const size_t ph = (size_t)pt[p] * hkv + hk;  // the page's (page, kv head) slab
    return Chunk{pk + ph * page_rows * ds, pks + ph * page, pv + ph * page_rows * ds,
                 pvs + ph * page};
  };
  const int length = lengths[bi];
  int c0, c1;
  dsplit::chunk_range(length, t_q, page, max_pages, window, n_live, splits, split, c0, c1);
  const int slot = (int)((bh * tiles + tile) * cl + rank);
  const dsplit::Where w{rows, t_q, length, page, c0, c1, window, ds, qs_mul, splits, split,
                        work, tickets == nullptr ? nullptr : tickets + slot, slot};
  dsplit::split_cta<D, PACKED, RAGGED>(
      q + bh * rows * ds, o + bh * rows * ds, m_out ? m_out + bh * rows : nullptr,
      l_out ? l_out + bh * rows : nullptr, tile * dsplit::RT, w, chunk_at,
      [=](int p) { return own == nullptr || own[p] != 0; });
}

struct Args {
  const float* q;
  const int8_t *k, *v;
  const float *ks, *vs;
  const int *table, *owned, *lengths;
  float *o, *m, *l;
  int b, hkv, rows, t_q, page, max_pages, window, n_live;  // window 0: none
  float qs_mul;
  int ds;  // the cache's head dim
  // the split walk's plan (ops/decode_cuda.py:split_plan) and workspace
  int cl, splits;
  float* work;
  int* tickets;
};

template <int D, bool PACKED, bool RAGGED>
int launch(const Args& a, cudaStream_t st) {
  return dsplit::launch<D, PACKED>(sage_paged_decode_kernel<D, PACKED, RAGGED>,
                                   (a.rows + dsplit::RT - 1) / dsplit::RT, a.hkv, a.b, a.cl,
                                   a.splits, st, a.q, a.k, a.ks, a.v, a.vs, a.table, a.owned,
                                   a.lengths, a.o, a.m, a.l, a.hkv, a.rows, a.t_q, a.page,
                                   a.max_pages, a.window, a.n_live, a.qs_mul, a.ds, a.cl,
                                   a.splits, a.work, a.tickets);
}

// the instances of one head dim D: packed or not, ragged (rows off 16-byte
// alignment, read byte by byte) or not
template <int D>
int launch_d(int d, int packed, const Args& a, cudaStream_t st) {
  if (d % 16 != 0)
    return packed ? launch<D, true, true>(a, st) : launch<D, false, true>(a, st);
  return packed ? launch<D, true, false>(a, st) : launch<D, false, false>(a, st);
}

// the instances of one source: head dims up to 256 (computed at 64, 128 or
// 256), or with WIDE those in (256, 512] (384 or 512), which build apart
template <bool WIDE>
int dispatch(int d, int packed, const Args& a, cudaStream_t st) {
  if constexpr (WIDE) {
    return d <= 384 ? launch_d<384>(d, packed, a, st) : launch_d<512>(d, packed, a, st);
  } else {
    if (d <= 64) return launch_d<64>(d, packed, a, st);
    if (d <= 128) return launch_d<128>(d, packed, a, st);
    return launch_d<256>(d, packed, a, st);
  }
}

template <bool WIDE>
int checked(const void* q, const void* pk, const void* pks, const void* pv, const void* pvs,
            const void* table, const void* owned, const void* lengths, void* o, void* m, void* l,
            int b, int hkv, int rows, int t_q, int page, int max_pages, int d, int packed,
            int window, int n_live, float qs_mul, void* stream, bool windowed, int cl,
            int splits, void* work, void* tickets) {
  // a shard's partial (owned) is only meaningful with its merge state
  if (d <= (WIDE ? 256 : 0) || d > (WIDE ? 512 : 256) || page <= 0 ||
      (packed && page % 2 != 0) || max_pages <= 0 || t_q <= 0 || rows <= 0 ||
      (windowed && (window <= 0 || n_live <= 0 || n_live > max_pages)) ||
      !dsplit::plan_ok(cl, splits, windowed ? n_live : max_pages, work, tickets) ||
      ((m == nullptr) != (l == nullptr)) || (owned != nullptr && m == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)q, (const int8_t*)pk, (const int8_t*)pv, (const float*)pks,
               (const float*)pvs, (const int*)table, (const int*)owned, (const int*)lengths,
               (float*)o, (float*)m, (float*)l, b, hkv, rows, t_q, page, max_pages,
               windowed ? window : 0, windowed ? n_live : 0, qs_mul, d, cl, splits, (float*)work,
               (int*)tickets};
  return dispatch<WIDE>(d, packed, a, (cudaStream_t)stream);
}

}  // namespace
