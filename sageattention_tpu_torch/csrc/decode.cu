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

#include "decode_body.cuh"

namespace {

using decode::Chunk;

template <int D, int MW, bool PACKED, bool WINDOW>
__global__ void __launch_bounds__(decode::NTHREADS)
sage_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                   const float* __restrict__ ks, const int8_t* __restrict__ v,
                   const float* __restrict__ vs, const int* __restrict__ lengths,
                   float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                   int hkv, int rows, int t_q, int S, int C, int window, int n_live,
                   float qs_mul, int ds) {
  const int hk = blockIdx.y, bi = blockIdx.z;
  const size_t bh = (size_t)bi * hkv + hk;
  const int rows_per_chunk = PACKED ? C / 2 : C;  // data rows of one chunk
  const int8_t* kb = k + bh * (size_t)(PACKED ? S / 2 : S) * ds;
  const int8_t* vb = v + bh * (size_t)(PACKED ? S / 2 : S) * ds;
  const float* ksb = ks + bh * (size_t)S;
  const float* vsb = vs + bh * (size_t)S;
  auto chunk_at = [=](int ci) {
    const size_t off = (size_t)ci * rows_per_chunk * ds;
    return Chunk{kb + off, ksb + (size_t)ci * C, vb + off, vsb + (size_t)ci * C};
  };
  decode::decode_cta<D, MW, PACKED, WINDOW>(
      q + bh * rows * ds, o + bh * rows * ds, m_out ? m_out + bh * rows : nullptr,
      l_out ? l_out + bh * rows : nullptr, rows, t_q, lengths[bi], C, S / C, window, n_live,
      qs_mul, ds, chunk_at, [](int) { return true; });
}

struct Args {
  const float* q;
  const int8_t *k, *v;
  const float *ks, *vs;
  const int* lengths;
  float *o, *m, *l;
  int b, hkv, rows, t_q, S, C, window, n_live;
  float qs_mul;
  int ds;  // the cache's head dim
};

template <int D, int MW, bool PACKED, bool WINDOW>
int launch(const Args& a, cudaStream_t st) {
  auto kern = sage_decode_kernel<D, MW, PACKED, WINDOW>;
  int smem = 0;
  const int e = decode::prepare<D, MW, PACKED>(kern, smem);
  if (e != 0) return e;
  constexpr int RT = decode::Shape<D, MW, PACKED>::RT;
  dim3 grid((a.rows + RT - 1) / RT, a.hkv, a.b);
  kern<<<grid, decode::NTHREADS, smem, st>>>(a.q, a.k, a.ks, a.v, a.vs, a.lengths, a.o, a.m, a.l,
                                             a.hkv, a.rows, a.t_q, a.S, a.C, a.window, a.n_live,
                                             a.qs_mul, a.ds);
  return (int)cudaGetLastError();
}

// the row tiling: 16 rows a block for decode, 64 (four row warps) for
// extend blocks
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

int checked(const void* q, const void* k, const void* ks, const void* v, const void* vs,
            const void* lengths, void* o, void* m, void* l, int b, int hkv, int rows, int t_q,
            int S, int d, int packed, int chunk, int window, int n_live, float qs_mul,
            void* stream, bool windowed) {
  if (d <= 0 || d > 256 || d % 16 != 0 || chunk <= 0 || S % chunk != 0 || (packed && chunk % 2 != 0) ||
      t_q <= 0 || rows <= 0 || (windowed && (window <= 0 || n_live <= 0 || n_live > S / chunk)) ||
      ((m == nullptr) != (l == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)q, (const int8_t*)k, (const int8_t*)v, (const float*)ks,
               (const float*)vs, (const int*)lengths, (float*)o, (float*)m, (float*)l,
               b, hkv, rows, t_q, S, chunk, window, n_live, qs_mul, d};
  cudaStream_t st = (cudaStream_t)stream;
  return windowed ? dispatch<true>(d, packed, a, st) : dispatch<false>(d, packed, a, st);
}

}  // namespace

// q: fp32 [b, hkv, rows, d], the (GQA group x t_q) rows of each kv head,
// head-major; k, v: int8 [b, hkv, S, d], or token-pair-packed [b, hkv,
// S/2, d] when packed; ks, vs: fp32 [b, hkv, S]; lengths: int32 [b]; o:
// fp32 [b, hkv, rows, d]; m, l: fp32 [b, hkv, rows] or both NULL.  All
// contiguous; d <= 256 a multiple of 16 (the kernels compute at 64, 128 or 256,
// the lanes past d zero); chunk divides S; qs_mul = f32(1/qmax) *
// f32(sm_scale * log2(e)), qmax 127, or 119 for the packed cache.
extern "C" int sage_decode(const void* q, const void* k, const void* ks, const void* v,
                           const void* vs, const void* lengths, void* o, void* m, void* l, int b,
                           int hkv, int rows, int t_q, int S, int d, int packed, int chunk,
                           int window, int n_live, float qs_mul, void* stream) {
  return checked(q, k, ks, v, vs, lengths, o, m, l, b, hkv, rows, t_q, S, d, packed, chunk, 0, 0,
                 qs_mul, stream, false);
}

// as sage_decode, with the sliding window: each query row keeps its last
// `window` keys, and a block visits only the n_live chunks from the first
// one the window reaches
extern "C" int sage_decode_window(const void* q, const void* k, const void* ks, const void* v,
                                  const void* vs, const void* lengths, void* o, void* m, void* l,
                                  int b, int hkv, int rows, int t_q, int S, int d, int packed,
                                  int chunk, int window, int n_live, float qs_mul, void* stream) {
  return checked(q, k, ks, v, vs, lengths, o, m, l, b, hkv, rows, t_q, S, d, packed, chunk, window,
                 n_live, qs_mul, stream, true);
}
