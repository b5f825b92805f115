// Host-side varlen batch preparation (the native data-loader tier): the
// port's copy of the JAX package's host library.
//
// The reference's varlen path prepares FlashAttention-style ragged batches
// host-side: cumulative sequence offsets and the derived per-scale offsets
// (reference: sageattention/triton/quant_per_block_varlen.py:72-79 computes
// cu_seqlens_scale on the host; sageattention/core.py:362-477 consumes
// cu_seqlens).  The host work is packing N ragged sequences into one
// contiguous buffer, splitting it back, and expanding cu_seqlens into
// segment-id / position vectors.  Those are memory-bound loops over
// potentially hundreds of MB of activations per batch; this C++
// implementation runs them multithreaded at memcpy speed, the copies cut
// into equal byte ranges rather than one thread a sequence.  Rows are moved
// as bytes, so any element type packs (bf16 included).
//
// Build (sageattention_tpu_torch/ops/_build.py lib, into build/):
//   g++ -O3 -std=c++17 -shared -fPIC -o libvarlen_pack-<hash>.so varlen_pack.cpp -lpthread
// Binding: sageattention_tpu_torch/native.py (ctypes).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) over up to `threads` workers.
template <typename F>
void parallel_for(int64_t n, F fn, int threads) {
  if (n <= 0) return;
  int nt = static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(threads, n)));
  if (nt == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

// Move n pieces between one packed buffer, whose bytes [offs[i], offs[i + 1])
// are piece i, and n buffers of their own.  The packed bytes are cut into
// equal ranges, one a worker (at least 1 MiB each), so that one long piece
// does not leave the other workers idle.  copy(i, at, len) moves bytes
// [at, at + len) of piece i.
template <typename F>
void copy_pieces(const std::vector<int64_t>& offs, F copy, int threads) {
  int64_t n = static_cast<int64_t>(offs.size()) - 1, total = offs[n];
  if (total <= 0) return;
  int64_t nt = std::max<int64_t>(1, std::min<int64_t>(threads, total >> 20));
  int64_t per = (total + nt - 1) / nt;
  parallel_for(
      nt,
      [&](int64_t t) {
        int64_t lo = t * per, hi = std::min(total, lo + per);
        if (lo >= hi) return;
        // the last piece that starts at or before lo (it ends after lo)
        int64_t i = std::upper_bound(offs.begin(), offs.end(), lo) - offs.begin() - 1;
        for (; i < n && offs[i] < hi; ++i) {
          int64_t a = std::max(lo, offs[i]), b = std::min(hi, offs[i + 1]);
          if (a < b) copy(i, a - offs[i], b - a);
        }
      },
      static_cast<int>(nt));
}

}  // namespace

extern "C" {

// Pack n_seq ragged sequences (row-major [len_i, row_bytes] each) into one
// contiguous [sum(len), row_bytes] buffer and fill cu_seqlens[n_seq + 1].
void sage_pack_ragged(const void** srcs, const int64_t* lens, int64_t n_seq,
                      int64_t row_bytes, void* dst, int32_t* cu_seqlens,
                      int32_t threads) {
  std::vector<int64_t> offs(n_seq + 1, 0);
  for (int64_t i = 0; i < n_seq; ++i) offs[i + 1] = offs[i] + lens[i];
  for (int64_t i = 0; i <= n_seq; ++i) {
    cu_seqlens[i] = static_cast<int32_t>(offs[i]);
    offs[i] *= row_bytes;
  }
  copy_pieces(
      offs,
      [&](int64_t i, int64_t at, int64_t len) {
        std::memcpy(static_cast<char*>(dst) + offs[i] + at,
                    static_cast<const char*>(srcs[i]) + at, static_cast<size_t>(len));
      },
      threads);
}

// Inverse of sage_pack_ragged: split a packed buffer back into per-sequence
// destination buffers.
void sage_unpack_ragged(const void* src, const int32_t* cu_seqlens,
                        int64_t n_seq, int64_t row_bytes, void** dsts,
                        int32_t threads) {
  std::vector<int64_t> offs(n_seq + 1);
  for (int64_t i = 0; i <= n_seq; ++i) offs[i] = cu_seqlens[i] * row_bytes;
  copy_pieces(
      offs,
      [&](int64_t i, int64_t at, int64_t len) {
        std::memcpy(static_cast<char*>(dsts[i]) + at,
                    static_cast<const char*>(src) + offs[i] + at, static_cast<size_t>(len));
      },
      threads);
}

// Expand cu_seqlens into per-token segment ids (1-based, matching
// jnp.searchsorted(cu, arange, side="right")) and intra-segment positions.
void sage_expand_cu_seqlens(const int32_t* cu_seqlens, int64_t n_seq,
                            int64_t total, int32_t* segment_ids,
                            int32_t* positions, int32_t threads) {
  parallel_for(
      n_seq,
      [&](int64_t i) {
        int64_t lo = cu_seqlens[i];
        int64_t hi = std::min<int64_t>(cu_seqlens[i + 1], total);
        for (int64_t t = lo; t < hi; ++t) {
          if (segment_ids) segment_ids[t] = static_cast<int32_t>(i + 1);
          if (positions) positions[t] = static_cast<int32_t>(t - lo);
        }
      },
      threads);
  // tail tokens beyond the last boundary (padding) get segment n_seq + 1
  int64_t last = std::min<int64_t>(cu_seqlens[n_seq], total);
  for (int64_t t = last; t < total; ++t) {
    if (segment_ids) segment_ids[t] = static_cast<int32_t>(n_seq + 1);
    if (positions) positions[t] = static_cast<int32_t>(t - last);
  }
}

}  // extern "C"
