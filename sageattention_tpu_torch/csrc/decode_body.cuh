// The body of the windowed decode kernels (kernel 10, sage_decode_window in
// csrc/decode.cu and csrc/decode_wide.cu; kernel 12,
// sage_paged_decode_window in csrc/paged_decode.cu and
// csrc/paged_decode_wide.cu) for Hopper (sm_90a): decode attention of a few
// query tokens against a per-token-scaled int8 or token-pair-packed int4 KV
// cache.  Kernels 9 and 11 (no window) run the split walk of
// decode_split_sm90.cuh, which reuses this file's numbers and helpers
// (Chunk, Mask, the loads and the int4 unpacking).
//
// The counterpart of decode_pallas.py:decode_step_body, which the TPU's
// dense and paged kernels share: one copy of the numerics, two sources of
// chunks.  A CTA owns one (batch, kv head, tile of RT packed rows), where a
// row is one (query head of the GQA group, query token), head-major as the
// JAX package packs them, and walks the chunks its length reaches in order,
// as the TPU's sequential grid axis does.  Per chunk (a dense chunk from the
// host rules, or one page):
//   pass 1  S = Q.K^T (int8 mma.sync m16n8k32, int32), sf = s * qsf * ks
//           (qsf = max(amax, 1e-30) * qs_mul, qs_mul = f32(1/qmax) *
//           f32(sm_scale * log2e), the form XLA compiles the spec into),
//           masked to NEG_INIT; the row max m_c over the whole chunk;
//   pass 2  S again; p = exp2(sf - m_c), l_c = sum p, pe = p * vs, and the
//           row max of pe, which gives the chunk's P scale psc;
//   pass 3  S again; P codes round(pe / psc) into shared memory; P.V on the
//           int8 tensor cores against V^T, int32 summed over the chunk
//           (exact), then pv = f32(int32) * psc and the base-2 online merge.
// S is recomputed rather than kept because a [rows, chunk] fp32 tile of a
// 4096-token chunk does not fit in shared memory; the recompute is the
// same instruction sequence, so the three passes see the same sf bit for
// bit.  Every multiply and add whose rounding the JAX spec fixes is
// written with __fmul_rn / __fadd_rn / __fsub_rn, so no FMA contraction
// changes it.  The packed cache is unpacked into int8 codes in shared
// memory (low nibble token 2t, high nibble 2t+1, sign-extended); Q and P
// then quantize to +-119, as the TPU kernel's two-int4-dot split does, and
// one int8 product gives the same int32 exactly (16a + b = x).
//
// Warps: MW along the rows (16 rows each), CW = 8 / MW along the tokens
// (32 tokens each), so a shared-memory slab holds 32 * CW tokens.  MW = 1
// for decode (4 rows at GQA 32/8, t_q 1), MW = 4 for extend blocks.  At
// D = 256, MW = 2 for decode: a 256-token slab's K, V and V^T rows of D + 16
// bytes with MW = 1 would take 248 KB of shared memory, over the 227 KB a
// block may have; a 128-token one takes 184 KB.  The second row warp has
// no live row below GQA 32 x t_q 1 and adds its MMAs, not bytes.
//
// Wide (D = 384 and 512): MW = 2 and CW = 4 at every row count, and P.V is
// split by columns, not tokens.  At D = 256 the int32 P.V partial pacc[D /
// 8][4] already takes 128 registers a thread (the instances use 250-255),
// and the [RT][D] int32 sums and fp32 accumulator in shared memory, 2 x 64
// KB at RT 32 and D 512, do not fit beside a slab.  So after each slab's P
// codes are in shared memory, warp (mw, cw) multiplies its 16 rows' P over
// all of the slab's 128 tokens by its DW = D / 4 columns of V^T (128 at
// 512, 96 at 384) and keeps the chunk's int32 sums in registers (DW / 2 a
// thread, exact); the online merge and the output accumulator are in
// registers too, the same fp32 operations on the same values, element by
// element, as the shared-memory merge.  V goes from global memory straight
// into V^T (no staged copy).  Shared memory at 512: 162 KB for the int8
// cache, 195 KB packed.  S and its three passes are unchanged.
//
// Head dims: the instances compute at D = 64, 128, 256, 384 or 512; a cache
// of any head dim ds <= D (the cache keeps the caller's, as the JAX
// package's does) is read at its own row stride, its lanes ds..D
// zero-filled as Q and the slabs load, which adds 0 to every product, and
// only its ds lanes of o are written.  A ds that is not a multiple of 16
// leaves the rows off 16-byte alignment: the RAGGED instances read them
// byte by byte with ordinary loads (no cp.async), the last block of a row
// zero past ds.
//
// Bound: bytes.  Each step reads the live cache once (K and V codes, two
// fp32 scales a token) and a few bytes of Q and O; the operations are a
// few hundred per cache byte at most, far under the int8 tensor-core rate.
// This walk is the first version, written to be right: one CTA per (b, kv
// head, row tile) with the chunk loop inside, K read three times per chunk
// (the second and third time from L2), a slab's loads issued together
// (cp.async) but not overlapped with the previous slab's compute.  Slabs
// wholly past the length or before the window are skipped (they are fully
// masked, so this changes no number).  The windowed kernels keep it: they
// visit only the n_live chunks the window reaches.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace decode {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INIT = -1e30f;

// one chunk's operands: K / V codes (int8, or token-pair-packed), and the
// per-token fp32 scales
struct Chunk {
  const int8_t* k;
  const float* ks;
  const int8_t* v;
  const float* vs;
};

template <int D, int MW, bool PACKED>
struct Shape {
  static constexpr bool WIDE = D > 256;    // P.V split by columns (see "Wide")
  static constexpr int CW = NWARPS / MW;   // warps along the tokens
  static constexpr int RT = 16 * MW;       // rows a CTA owns
  static constexpr int SLAB = 32 * CW;     // tokens a shared-memory slab holds
  static constexpr int DROWS = PACKED ? SLAB / 2 : SLAB;  // data rows of a slab
  static constexpr int DW = D / CW;        // wide: O columns a warp's P.V computes
  static constexpr int QS = D + 16;        // byte stride of the Q, K and staged rows
  static constexpr int TS = SLAB + 16;     // byte stride of the V^T and P rows
  static constexpr int NROW = 9;           // per-row fp32 arrays
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + RT * QS;
  static constexpr int kraw_off = k_off + SLAB * QS;              // packed K as read
  // V as read (wide: none, V goes from global memory straight into V^T)
  static constexpr int vraw_off = kraw_off + (PACKED ? DROWS * QS : 0);
  static constexpr int vt_off = vraw_off + (WIDE ? 0 : DROWS * QS);
  static constexpr int p_off = vt_off + D * TS;
  static constexpr int ks_off = p_off + RT * TS;
  static constexpr int vs_off = ks_off + SLAB * 4;
  static constexpr int red_off = vs_off + SLAB * 4;  // [2][CW][RT] fp32
  static constexpr int row_off = red_off + 2 * CW * RT * 4;
  // the P.V sums (int32 [RT][D]) and the output accumulator (fp32 [RT][D]);
  // wide: in registers instead
  static constexpr int pv_off = row_off + NROW * RT * 4;
  static constexpr int acc_off = pv_off + (WIDE ? 0 : RT * D * 4);
  static constexpr int bytes = acc_off + (WIDE ? 0 : RT * D * 4);
};

__device__ inline int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// 16 packed bytes -> the 16 low-nibble and 16 high-nibble codes, sign-extended
__device__ inline void unpack16(uint4 raw, uint4& lo, uint4& hi) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
  uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
  uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = __vsub4((w[i] & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
    h[i] = __vsub4(((w[i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
  }
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !valid
// (then nothing is read, and `src` need only be a valid address)
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ inline void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// bytes c0 .. c0 + 15 of a cache row of ds bytes, byte by byte (a row of a
// head dim that is not a multiple of 16 is not 16-byte aligned), zero past ds
__device__ inline uint4 load16_ragged(const int8_t* row, int c0, int ds) {
  uint4 out;
  int8_t* b = reinterpret_cast<int8_t*>(&out);
#pragma unroll
  for (int j = 0; j < 16; ++j) b[j] = c0 + j < ds ? row[c0 + j] : 0;
  return out;
}

// 16-byte block cb of data row r of the chunk's codes `x` (row stride ds),
// zero where the row is not live or the block lies past ds
template <bool RAGGED>
__device__ inline uint4 load16(const int8_t* x, int r, int cb, bool live, int ds) {
  if (!live) return make_uint4(0, 0, 0, 0);
  if constexpr (RAGGED) return load16_ragged(x + (size_t)r * ds, cb * 16, ds);
  return *reinterpret_cast<const uint4*>(x + (size_t)r * ds + cb * 16);
}

// one 16-byte block of V codes (data row r, channels cb * 16 ..) into V^T:
// unpacked from token pairs when packed
template <int TS, bool PACKED>
__device__ inline void store_vt(int8_t* sVt, uint4 raw, int r, int cb) {
  if constexpr (PACKED) {
    uint4 lo, hi;
    unpack16(raw, lo, hi);
    const int8_t* bl = reinterpret_cast<const int8_t*>(&lo);
    const int8_t* bh = reinterpret_cast<const int8_t*>(&hi);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sVt[(cb * 16 + j) * TS + 2 * r] = bl[j];
      sVt[(cb * 16 + j) * TS + 2 * r + 1] = bh[j];
    }
  } else {
    const int8_t* bv = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int j = 0; j < 16; ++j) sVt[(cb * 16 + j) * TS + r] = bv[j];
  }
}

// tokens [tok0, tok0 + SLAB) of the chunk's K (and with V, V^T) and scales
// into shared memory; tokens past the chunk's C are zero.  Every global
// load of the slab is in flight at once (cp.async); packed codes are then
// unpacked, and V transposed, from the staged copy.  RAGGED (a head dim
// ds that is not a multiple of 16): the rows are read byte by byte with
// ordinary loads, their last block zero-filled past ds.  Wide: V is read
// from global memory into registers and transposed from there.  The
// caller synchronises before reading.
template <int D, int MW, bool PACKED, bool WITH_V, bool RAGGED>
__device__ inline void load_slab(const Chunk& ch, int tok0, int C, int ds, int8_t* sK,
                                 int8_t* sKraw, int8_t* sVraw, int8_t* sVt, float* sKs,
                                 float* sVs) {
  using L = Shape<D, MW, PACKED>;
  const int tid = threadIdx.x;
  constexpr int CB = D / 16;  // 16-byte blocks of a row
  const int drow0 = PACKED ? tok0 / 2 : tok0;
  const int drows_live = PACKED ? (C - tok0) / 2 : C - tok0;  // C is even when packed
  int8_t* kdst = PACKED ? sKraw : sK;
  if constexpr (RAGGED) {
    for (int i = tid; i < L::DROWS * CB; i += NTHREADS) {
      const int r = i / CB, cb = i % CB;
      const bool live = r < drows_live && cb * 16 < ds;
      *reinterpret_cast<uint4*>(kdst + r * L::QS + cb * 16) =
          load16<true>(ch.k, drow0 + r, cb, live, ds);
      if constexpr (WITH_V && !L::WIDE)
        *reinterpret_cast<uint4*>(sVraw + r * L::QS + cb * 16) =
            load16<true>(ch.v, drow0 + r, cb, live, ds);
    }
  } else {
    for (int i = tid; i < L::DROWS * CB; i += NTHREADS) {
      const int r = i / CB, cb = i % CB;
      const bool live = r < drows_live && cb * 16 < ds;  // lanes past ds are zero
      const size_t src = live ? (size_t)(drow0 + r) * ds + cb * 16 : 0;
      cp_async16(kdst + r * L::QS + cb * 16, ch.k + src, live);
      if constexpr (WITH_V && !L::WIDE) cp_async16(sVraw + r * L::QS + cb * 16, ch.v + src, live);
    }
  }
  if constexpr (WITH_V && L::WIDE) {
    // straight from global memory, rows as the staged path below takes them
    for (int i = tid; i < L::DROWS * CB; i += NTHREADS) {
      const int r = i % L::DROWS, cb = i / L::DROWS;
      const bool live = r < drows_live && cb * 16 < ds;
      store_vt<L::TS, PACKED>(sVt, load16<RAGGED>(ch.v, drow0 + r, cb, live, ds), r, cb);
    }
  }
  for (int i = tid; i < L::SLAB; i += NTHREADS) {
    const bool live = tok0 + i < C;
    cp_async4(sKs + i, ch.ks + (live ? tok0 + i : 0), live);
    cp_async4(sVs + i, ch.vs + (live ? tok0 + i : 0), live);
  }
  cp_async_wait_all();
  if (!PACKED && !WITH_V) return;
  __syncthreads();
  if constexpr (PACKED) {
    for (int i = tid; i < L::DROWS * CB; i += NTHREADS) {
      const int r = i / CB, cb = i % CB;
      uint4 lo, hi;
      unpack16(*reinterpret_cast<const uint4*>(sKraw + r * L::QS + cb * 16), lo, hi);
      *reinterpret_cast<uint4*>(sK + (2 * r) * L::QS + cb * 16) = lo;
      *reinterpret_cast<uint4*>(sK + (2 * r + 1) * L::QS + cb * 16) = hi;
    }
  }
  if constexpr (WITH_V && !L::WIDE) {
    // consecutive threads take consecutive rows, so a warp's byte stores
    // into a V^T row are contiguous
    for (int i = tid; i < L::DROWS * CB; i += NTHREADS) {
      const int r = i % L::DROWS, cb = i / L::DROWS;
      store_vt<L::TS, PACKED>(sVt, *reinterpret_cast<const uint4*>(sVraw + r * L::QS + cb * 16),
                              r, cb);
    }
  }
}

// The masks of decode_step_body: the length, the causal tail of t_q > 1
// (row t sees keys < length - t_q + 1 + t) and the sliding window (keys >
// length - t_q + t - window).  With t_q = 1 these are the TPU kernel's
// single-token masks.
struct Mask {
  int length, t_q, window;  // window <= 0: none
  __device__ inline bool ok(int col, int trow) const {
    bool v = col < length && col < length - (t_q - 1) + trow;
    if (window > 0) v = v && col > length - t_q + trow - window;
    return v;
  }
};

// this warp's 16 rows x 32 tokens of sf (mma C layout: [n-tile][e], e < 2
// row g, e >= 2 row g + 8; token n*8 + 2t + (e & 1)); `ok` bit n*4+e set
// where the score is live
template <int D, int MW, bool PACKED>
__device__ inline uint32_t slab_scores(float (&sf)[4][4], const int8_t* sQ, const int8_t* sK,
                                       const float* sKs, int mw, int cw, int tok0, int base,
                                       int C, float qsf0, float qsf1, int trow0, int trow1,
                                       const Mask& mask) {
  using L = Shape<D, MW, PACKED>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  int acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    uint32_t a[4];
    load_a(a, reinterpret_cast<const unsigned char*>(sQ) + (mw * 16 + g) * L::QS + kk * 32 + t * 4,
           L::QS);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int8_t* kb = sK + (cw * 32 + n * 8 + g) * L::QS + kk * 32 + t * 4;
      mma_s8(acc[n], a, ld32(kb), ld32(kb + 16));
    }
  }
  uint32_t ok = 0;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ts = cw * 32 + n * 8 + 2 * t + (e & 1);  // token in the slab
      const int tc = tok0 + ts;                           // token in the chunk
      const bool live = tc < C && mask.ok(base + tc, e < 2 ? trow0 : trow1);
      const float v = __fmul_rn(__fmul_rn((float)acc[n][e], e < 2 ? qsf0 : qsf1), sKs[ts]);
      sf[n][e] = live ? v : NEG_INIT;
      ok |= (uint32_t)live << (n * 4 + e);
    }
  }
  return ok;
}

// the whole decode of one CTA's rows: q [rows, ds] fp32 and o [rows, ds] fp32
// of this (batch, kv head), ds <= D the cache's head dim; m_out / l_out
// [rows] or null; chunk_at(ci) gives chunk ci's operands.  n_total chunks of
// C tokens; with a window only the n_live chunks from the window's first one.
// live_at(ci) false skips chunk ci before anything of it is read (a page
// another shard of a sharded pool owns); the dense kernels pass a functor
// that is always true.
template <int D, int MW, bool PACKED, bool WINDOW, bool RAGGED, typename ChunkAt,
          typename LiveAt>
__device__ void decode_cta(const float* __restrict__ q, float* __restrict__ o,
                           float* __restrict__ m_out, float* __restrict__ l_out, int rows,
                           int t_q, int length, int C, int n_total, int window, int n_live,
                           float qs_mul, int ds, ChunkAt chunk_at, LiveAt live_at) {
  using L = Shape<D, MW, PACKED>;
  constexpr int RT = L::RT, CW = L::CW;
  constexpr float QMAX = PACKED ? 119.f : 127.f;
  constexpr float INV_QMAX = PACKED ? (float)(1.0 / 119.0) : (float)(1.0 / 127.0);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem + L::q_off);
  int8_t* sK = reinterpret_cast<int8_t*>(smem + L::k_off);
  int8_t* sKraw = reinterpret_cast<int8_t*>(smem + L::kraw_off);
  int8_t* sVraw = reinterpret_cast<int8_t*>(smem + L::vraw_off);
  int8_t* sVt = reinterpret_cast<int8_t*>(smem + L::vt_off);
  int8_t* sP = reinterpret_cast<int8_t*>(smem + L::p_off);
  float* sKs = reinterpret_cast<float*>(smem + L::ks_off);
  float* sVs = reinterpret_cast<float*>(smem + L::vs_off);
  float* sRed = reinterpret_cast<float*>(smem + L::red_off);
  float* sRow = reinterpret_cast<float*>(smem + L::row_off);
  int* sPV = reinterpret_cast<int*>(smem + L::pv_off);
  float* sAcc = reinterpret_cast<float*>(smem + L::acc_off);
  float* sQsf = sRow;         // qscale * sm_scale * log2(e)
  float* sM = sRow + RT;      // running max (base 2)
  float* sL = sRow + 2 * RT;  // running sum
  float* sMc = sRow + 3 * RT;
  float* sLc = sRow + 4 * RT;
  float* sPsc = sRow + 5 * RT;
  float* sPr = sRow + 6 * RT;
  float* sAlpha = sRow + 7 * RT;
  float* sW = sRow + 8 * RT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int mw = warp / CW, cw = warp % CW;
  const int row0 = blockIdx.x * RT;  // the tile's first row

  // ---- per-row Q quantization (the TPU kernel's in-register chain) --------
  for (int r = warp; r < RT; r += NWARPS) {
    const int gr = row0 + r;
    float x[D / 32];
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      x[e] = gr < rows && lane + 32 * e < ds ? q[(size_t)gr * ds + lane + 32 * e] : 0.f;
      amax = fmaxf(amax, fabsf(x[e]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = __fmul_rn(fmaxf(amax, 1e-30f), INV_QMAX);
    const float rs = __fdiv_rn(1.0f, scale);
#pragma unroll
    for (int e = 0; e < D / 32; ++e)
      sQ[r * L::QS + lane + 32 * e] = (int8_t)fminf(fmaxf(roundf(__fmul_rn(x[e], rs)), -QMAX), QMAX);
    if (lane == 0) {
      sQsf[r] = __fmul_rn(fmaxf(amax, 1e-30f), qs_mul);
      sM[r] = NEG_INIT;
      sL[r] = 0.f;
    }
  }
  if constexpr (!L::WIDE) {
    for (int i = tid; i < RT * D; i += NTHREADS) {
      sAcc[i] = 0.f;
      sPV[i] = 0;
    }
  }
  __syncthreads();
  // wide: this thread's share of the output accumulator, rows ra and rb
  // (below) by the columns [cw * DW, (cw + 1) * DW) of its warp's P.V
  constexpr int NP = L::WIDE ? L::DW / 8 : D / 8;  // 8-column n-tiles of a warp's P.V
  float acc_w[L::WIDE ? NP : 1][4];
  if constexpr (L::WIDE) {
#pragma unroll
    for (int i = 0; i < NP; ++i) acc_w[i][0] = acc_w[i][1] = acc_w[i][2] = acc_w[i][3] = 0.f;
  }

  const int ra = mw * 16 + g, rb = ra + 8;  // this thread's rows in the tile
  const int trow0 = (row0 + ra) % t_q, trow1 = (row0 + rb) % t_q;
  const float qsf0 = sQsf[ra], qsf1 = sQsf[rb];
  const Mask mask{length, t_q, WINDOW ? window : 0};

  int start = 0, count = n_total;
  if (WINDOW) {
    start = min(max(floor_div(length - (window + t_q - 1), C), 0), n_total - n_live);
    count = n_live;
  }
  for (int gi = 0; gi < count; ++gi) {
    const int ci = start + gi;
    if ((long long)ci * C >= length) break;  // chunks past the length are never read
    if (!live_at(ci)) continue;              // nor are chunks the caller masks out
    const int base = ci * C;
    const Chunk ch = chunk_at(ci);
    // the slabs that hold a visible key: below the length and, with a
    // window, from the oldest key the first query row sees.  The others are
    // wholly masked and leave m_c, l_c, pmax and P.V as they are.
    const int hi = min(C, length - base);
    int lo = 0;
    if (WINDOW) lo = max(0, length - t_q - window + 1 - base) / L::SLAB * L::SLAB;
    float sf[4][4];

    // ---- pass 1: the chunk's row max of sf -------------------------------
    float mx0 = NEG_INIT, mx1 = NEG_INIT;
    for (int tok0 = lo; tok0 < hi; tok0 += L::SLAB) {
      load_slab<D, MW, PACKED, false, RAGGED>(ch, tok0, C, ds, sK, sKraw, sVraw, sVt, sKs, sVs);
      __syncthreads();
      slab_scores<D, MW, PACKED>(sf, sQ, sK, sKs, mw, cw, tok0, base, C, qsf0, qsf1, trow0, trow1, mask);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sf[n][0], sf[n][1]));
        mx1 = fmaxf(mx1, fmaxf(sf[n][2], sf[n][3]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (t == 0) {
      sRed[cw * RT + ra] = mx0;
      sRed[cw * RT + rb] = mx1;
    }
    __syncthreads();
    for (int r = tid; r < RT; r += NTHREADS) {
      float m = sRed[r];
      for (int w = 1; w < CW; ++w) m = fmaxf(m, sRed[w * RT + r]);
      sMc[r] = m;
    }
    __syncthreads();
    const float mc0 = sMc[ra], mc1 = sMc[rb];

    // ---- pass 2: l_c and the row max of pe = p * vs ------------------------
    float ls0 = 0.f, ls1 = 0.f, pm0 = 0.f, pm1 = 0.f;
    for (int tok0 = lo; tok0 < hi; tok0 += L::SLAB) {
      load_slab<D, MW, PACKED, false, RAGGED>(ch, tok0, C, ds, sK, sKraw, sVraw, sVt, sKs, sVs);
      __syncthreads();
      const uint32_t ok =
          slab_scores<D, MW, PACKED>(sf, sQ, sK, sKs, mw, cw, tok0, base, C, qsf0, qsf1, trow0, trow1, mask);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (ok >> (n * 4 + e)) & 1u ? exp2f(__fsub_rn(sf[n][e], e < 2 ? mc0 : mc1)) : 0.f;
          const float pe = __fmul_rn(p, sVs[cw * 32 + n * 8 + 2 * t + (e & 1)]);
          if (e < 2) {
            ls0 = __fadd_rn(ls0, p);
            pm0 = fmaxf(pm0, pe);
          } else {
            ls1 = __fadd_rn(ls1, p);
            pm1 = fmaxf(pm1, pe);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ls0 = __fadd_rn(ls0, __shfl_xor_sync(0xffffffffu, ls0, off));
      ls1 = __fadd_rn(ls1, __shfl_xor_sync(0xffffffffu, ls1, off));
      pm0 = fmaxf(pm0, __shfl_xor_sync(0xffffffffu, pm0, off));
      pm1 = fmaxf(pm1, __shfl_xor_sync(0xffffffffu, pm1, off));
    }
    if (t == 0) {
      sRed[cw * RT + ra] = ls0;
      sRed[cw * RT + rb] = ls1;
      sRed[(CW + cw) * RT + ra] = pm0;
      sRed[(CW + cw) * RT + rb] = pm1;
    }
    __syncthreads();
    for (int r = tid; r < RT; r += NTHREADS) {
      float l = sRed[r], pm = sRed[CW * RT + r];
      for (int w = 1; w < CW; ++w) {
        l = __fadd_rn(l, sRed[w * RT + r]);
        pm = fmaxf(pm, sRed[(CW + w) * RT + r]);
      }
      const float psc = __fmul_rn(fmaxf(pm, 1e-30f), INV_QMAX);
      sLc[r] = l;
      sPsc[r] = psc;
      sPr[r] = __fdiv_rn(1.0f, psc);
    }
    __syncthreads();
    const float pr0 = sPr[ra], pr1 = sPr[rb];

    // ---- pass 3: P codes and the integer P.V -----------------------------
    int pacc[NP][4];
#pragma unroll
    for (int i = 0; i < NP; ++i) pacc[i][0] = pacc[i][1] = pacc[i][2] = pacc[i][3] = 0;
    for (int tok0 = lo; tok0 < hi; tok0 += L::SLAB) {
      load_slab<D, MW, PACKED, true, RAGGED>(ch, tok0, C, ds, sK, sKraw, sVraw, sVt, sKs, sVs);
      __syncthreads();
      const uint32_t ok =
          slab_scores<D, MW, PACKED>(sf, sQ, sK, sKs, mw, cw, tok0, base, C, qsf0, qsf1, trow0, trow1, mask);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ts = cw * 32 + n * 8 + 2 * t + (e & 1);
          const float p = (ok >> (n * 4 + e)) & 1u ? exp2f(__fsub_rn(sf[n][e], e < 2 ? mc0 : mc1)) : 0.f;
          const float pe = __fmul_rn(p, sVs[ts]);
          const float code = fminf(roundf(__fmul_rn(pe, e < 2 ? pr0 : pr1)), QMAX);
          sP[(e < 2 ? ra : rb) * L::TS + ts] = (int8_t)code;
        }
      }
      if constexpr (L::WIDE) {
        // the slab's every token against this warp's DW columns of V^T,
        // int32 summed over the chunk in registers (exact)
        __syncthreads();  // every token warp's P codes
#pragma unroll
        for (int kk = 0; kk < L::SLAB / 32; ++kk) {
          uint32_t a[4];
          load_a(a, reinterpret_cast<const unsigned char*>(sP) + ra * L::TS + kk * 32 + t * 4,
                 L::TS);
#pragma unroll
          for (int nt = 0; nt < NP; ++nt) {
            const int8_t* vb = sVt + (cw * L::DW + nt * 8 + g) * L::TS + kk * 32 + t * 4;
            mma_s8(pacc[nt], a, ld32(vb), ld32(vb + 16));
          }
        }
      } else {
        __syncwarp();
        uint32_t a[4];
        load_a(a, reinterpret_cast<const unsigned char*>(sP) + ra * L::TS + cw * 32 + t * 4, L::TS);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const int8_t* vb = sVt + (nt * 8 + g) * L::TS + cw * 32 + t * 4;
          mma_s8(pacc[nt], a, ld32(vb), ld32(vb + 16));
        }
      }
      __syncthreads();
    }
    if constexpr (!L::WIDE) {
      // the int32 partials of the CW token warps, summed exactly
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const int c0 = nt * 8 + 2 * t;
        atomicAdd(&sPV[ra * D + c0], pacc[nt][0]);
        atomicAdd(&sPV[ra * D + c0 + 1], pacc[nt][1]);
        atomicAdd(&sPV[rb * D + c0], pacc[nt][2]);
        atomicAdd(&sPV[rb * D + c0 + 1], pacc[nt][3]);
      }
    }
    __syncthreads();

    // ---- the base-2 online merge ------------------------------------------
    for (int r = tid; r < RT; r += NTHREADS) {
      const float m_prev = sM[r], mc = sMc[r];
      const float m_next = fmaxf(m_prev, mc);
      const float alpha = exp2f(__fsub_rn(m_prev, m_next));
      const float w = exp2f(__fsub_rn(mc, m_next));
      sM[r] = m_next;
      sL[r] = __fadd_rn(__fmul_rn(alpha, sL[r]), __fmul_rn(w, sLc[r]));
      sAlpha[r] = alpha;
      sW[r] = w;
    }
    __syncthreads();
    if constexpr (L::WIDE) {
#pragma unroll
      for (int nt = 0; nt < NP; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? ra : rb;
          const float pv = __fmul_rn((float)pacc[nt][e], sPsc[r]);
          acc_w[nt][e] = __fadd_rn(__fmul_rn(acc_w[nt][e], sAlpha[r]), __fmul_rn(pv, sW[r]));
        }
      }
    } else {
      for (int i = tid; i < RT * D; i += NTHREADS) {
        const int r = i / D;
        const float pv = __fmul_rn((float)sPV[i], sPsc[r]);
        sAcc[i] = __fadd_rn(__fmul_rn(sAcc[i], sAlpha[r]), __fmul_rn(pv, sW[r]));
        sPV[i] = 0;
      }
    }
    __syncthreads();
  }

  // ---- epilogue: o = acc * (1 / l), 0 where l == 0 ---------------------------
  if constexpr (L::WIDE) {
#pragma unroll
    for (int nt = 0; nt < NP; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? ra : rb, gr = row0 + r;
        const int col = cw * L::DW + nt * 8 + 2 * t + (e & 1);
        if (gr >= rows || col >= ds) continue;
        const float l = sL[r];
        const float l_inv = l == 0.f ? 0.f : __fdiv_rn(1.0f, l);
        o[(size_t)gr * ds + col] = __fmul_rn(acc_w[nt][e], l_inv);
      }
    }
  } else {
    for (int i = tid; i < RT * D; i += NTHREADS) {
      const int r = i / D, gr = row0 + r;
      if (gr >= rows || i % D >= ds) continue;
      const float l = sL[r];
      const float l_inv = l == 0.f ? 0.f : __fdiv_rn(1.0f, l);
      o[(size_t)gr * ds + i % D] = __fmul_rn(sAcc[i], l_inv);
    }
  }
  if (m_out != nullptr) {
    for (int r = tid; r < RT; r += NTHREADS) {
      if (row0 + r >= rows) continue;
      m_out[row0 + r] = sM[r];
      l_out[row0 + r] = sL[r];
    }
  }
}

// the host side of a launch: the shared-memory size (raising the limit
// above 48 KB) and the row tile
template <int D, int MW, bool PACKED, typename Kernel>
int prepare(Kernel kern, int& smem) {
  smem = Shape<D, MW, PACKED>::bytes;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace decode
