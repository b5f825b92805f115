// The paged decode kernels and their host side, shared by
// csrc/paged_decode.cu (head dims up to 256) and csrc/paged_decode_wide.cu
// (head dims in (256, 512]), which build apart and in parallel: each source
// instantiates only its own instances (checked<WIDE>).  Kernel 11 (no
// window) runs the split walk of decode_split_sm90.cuh, kernel 12 (the
// window) decode_body.cuh's one-CTA walk.  The design notes are in
// csrc/paged_decode.cu and those headers.

#pragma once

#include "decode_body.cuh"
#include "decode_split_sm90.cuh"

namespace {

using decode::Chunk;

template <int D, bool PACKED, bool RAGGED>
__global__ void __launch_bounds__(dsplit::NTHREADS, dsplit::Shape<D, PACKED>::MIN_BLOCKS)
sage_paged_decode_split_kernel(const float* __restrict__ q, const int8_t* __restrict__ pk,
                               const float* __restrict__ pks, const int8_t* __restrict__ pv,
                               const float* __restrict__ pvs, const int* __restrict__ table,
                               const int* __restrict__ owned, const int* __restrict__ lengths,
                               float* __restrict__ o, float* __restrict__ m_out,
                               float* __restrict__ l_out, int hkv, int rows, int t_q, int page,
                               int max_pages, float qs_mul, int ds, int cl, int splits,
                               float* work, int* tickets) {
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
  const int per = (max_pages + splits - 1) / splits;
  const int slot = (int)((bh * tiles + tile) * cl + rank);
  const dsplit::Where w{rows, t_q, lengths[bi], page, split * per,
                        min(max_pages, (split + 1) * per), ds, qs_mul, splits, split, work,
                        tickets == nullptr ? nullptr : tickets + slot, slot};
  dsplit::split_cta<D, PACKED, RAGGED>(q + bh * rows * ds, o + bh * rows * ds,
                                       m_out ? m_out + bh * rows : nullptr,
                                       l_out ? l_out + bh * rows : nullptr, tile * dsplit::RT, w,
                                       chunk_at,
                                       [=](int p) { return own == nullptr || own[p] != 0; });
}

template <int D, int MW, bool PACKED, bool WINDOW, bool RAGGED>
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
  decode::decode_cta<D, MW, PACKED, WINDOW, RAGGED>(
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
  // the split walk's plan (ops/decode_cuda.py:split_plan) and workspace
  int cl, splits;
  float* work;
  int* tickets;
};

template <int D, bool PACKED, bool RAGGED>
int launch_split(const Args& a, cudaStream_t st) {
  const int tiles = (a.rows + dsplit::RT - 1) / dsplit::RT;
  return dsplit::launch<D, PACKED>(sage_paged_decode_split_kernel<D, PACKED, RAGGED>, tiles,
                                   a.hkv, a.b, a.cl, a.splits, st, a.q, a.k, a.ks, a.v, a.vs,
                                   a.table, a.owned, a.lengths, a.o, a.m, a.l, a.hkv, a.rows,
                                   a.t_q, a.page, a.max_pages, a.qs_mul, a.ds, a.cl, a.splits,
                                   a.work, a.tickets);
}

template <int D, int MW, bool PACKED, bool WINDOW, bool RAGGED>
int launch(const Args& a, cudaStream_t st) {
  auto kern = sage_paged_decode_kernel<D, MW, PACKED, WINDOW, RAGGED>;
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

template <int D, bool PACKED, bool WINDOW, bool RAGGED>
int launch_rows(const Args& a, cudaStream_t st) {
  if constexpr (D > 256)  // two row warps and four token warps (decode_body.cuh, "Wide")
    return launch<D, 2, PACKED, WINDOW, RAGGED>(a, st);
  else if constexpr (RAGGED)  // one row tiling at every row count: four row warps
    return launch<D, 4, PACKED, WINDOW, RAGGED>(a, st);
  else if constexpr (D == 256)  // two row warps at least (decode_body.cuh, "Warps")
    return a.rows <= 32 ? launch<D, 2, PACKED, WINDOW, RAGGED>(a, st)
                        : launch<D, 4, PACKED, WINDOW, RAGGED>(a, st);
  else
    return a.rows <= 16 ? launch<D, 1, PACKED, WINDOW, RAGGED>(a, st)
                        : launch<D, 4, PACKED, WINDOW, RAGGED>(a, st);
}

// the instances of the one head dim D (packed or not, ragged or not): the
// window's on decode_body.cuh, the others' the split walk
template <int D, bool WINDOW>
int launch_d(int d, int packed, const Args& a, cudaStream_t st) {
  if constexpr (WINDOW) {
    if (d % 16 != 0)  // rows off 16-byte alignment: read byte by byte
      return packed ? launch_rows<D, true, WINDOW, true>(a, st)
                    : launch_rows<D, false, WINDOW, true>(a, st);
    return packed ? launch_rows<D, true, WINDOW, false>(a, st)
                  : launch_rows<D, false, WINDOW, false>(a, st);
  } else {
    if (d % 16 != 0)
      return packed ? launch_split<D, true, true>(a, st) : launch_split<D, false, true>(a, st);
    return packed ? launch_split<D, true, false>(a, st) : launch_split<D, false, false>(a, st);
  }
}

// the instances of one source: head dims up to 256 (computed at 64, 128 or
// 256), or with WIDE those in (256, 512] (384 or 512), which build apart
template <bool WINDOW, bool WIDE>
int dispatch(int d, int packed, const Args& a, cudaStream_t st) {
  if constexpr (WIDE) {
    return d <= 384 ? launch_d<384, WINDOW>(d, packed, a, st)
                    : launch_d<512, WINDOW>(d, packed, a, st);
  } else {
    if (d <= 64) return launch_d<64, WINDOW>(d, packed, a, st);
    if (d <= 128) return launch_d<128, WINDOW>(d, packed, a, st);
    return launch_d<256, WINDOW>(d, packed, a, st);
  }
}

template <bool WIDE>
int checked(const void* q, const void* pk, const void* pks, const void* pv, const void* pvs,
            const void* table, const void* owned, const void* lengths, void* o, void* m, void* l,
            int b, int hkv, int rows, int t_q, int page, int max_pages, int d, int packed,
            int window, int n_live, float qs_mul, void* stream, bool windowed, int cl = 1,
            int splits = 1, void* work = nullptr, void* tickets = nullptr) {
  // a shard's partial (owned) is only meaningful with its merge state
  if (d <= (WIDE ? 256 : 0) || d > (WIDE ? 512 : 256) || page <= 0 ||
      (packed && page % 2 != 0) || max_pages <= 0 || t_q <= 0 || rows <= 0 || (windowed && (window <= 0 || n_live <= 0 || n_live > max_pages)) ||
      (!windowed && !dsplit::plan_ok(cl, splits, max_pages, work, tickets)) ||
      ((m == nullptr) != (l == nullptr)) || (owned != nullptr && m == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)q, (const int8_t*)pk, (const int8_t*)pv, (const float*)pks,
               (const float*)pvs, (const int*)table, (const int*)owned, (const int*)lengths,
               (float*)o, (float*)m, (float*)l, b, hkv, rows, t_q, page, max_pages, window,
               n_live, qs_mul, d, cl, splits, (float*)work, (int*)tickets};
  cudaStream_t st = (cudaStream_t)stream;
  return windowed ? dispatch<true, WIDE>(d, packed, a, st)
                  : dispatch<false, WIDE>(d, packed, a, st);
}

}  // namespace
