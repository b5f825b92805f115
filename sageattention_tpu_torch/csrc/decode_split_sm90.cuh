// The body of every decode kernel (kernels 9 and 10, csrc/decode.cu and
// csrc/decode_wide.cu; kernels 11 and 12, csrc/paged_decode.cu and
// csrc/paged_decode_wide.cu) for Hopper (sm_90a): the chunk walk of
// decode_pallas.py:decode_step_body split over a thread-block cluster and
// over the grid, each K byte read once, the partials merged in the launch.
// The windowed kernels (10, 12) walk the same body over the window's chunks.
//
// The numbers are decode_body.cuh's (its header gives the chain): per
// chunk the row max m_c of sf, l_c = sum p, the P scale psc from the row
// max of pe = p * vs, P codes round(pe / psc), an int32 P.V, and the
// base-2 online merge, each with the same fp32 operations.  The chunk is
// the P quantization unit, so a split may not change where chunks begin;
// it shares one chunk between CTAs instead:
//
// * A cluster of CL CTAs (CL 1, 2, 4 or 8) takes one chunk; each CTA takes
//   a contiguous share of its live slabs (SLAB tokens: 128 at head dims up
//   to 128, 64 above), reads their K codes and scales once, and keeps its
//   sf in shared memory (16 rows x KEEP = 512 tokens, 32 KB).  m_c and pmax
//   are maxima, so their reduction over the cluster through distributed
//   shared memory is exact; l_c is summed in cluster rank order, so it is
//   deterministic; the P codes then follow from the chunk's own m_c and
//   psc, and are the codes a single CTA would compute.  Each CTA's int32
//   P.V over its share is stored into the shared memory of the CTA that
//   owns each column (D / CL columns a CTA), which sums the cluster's
//   partials (exact) and keeps its columns' online merge in registers.
//   Every exchange pushes (st.shared::cluster, which does not wait on the
//   remote CTA) and is read locally after the barrier.  Three cluster
//   barriers a chunk (after m_c, after l_c and pmax, after P.V).
// * A share longer than KEEP tokens (a chunk above 8 x 512 tokens: only a
//   caller's chunk or page above 4096) is walked in groups of KEEP tokens
//   whose K is read again in the second and third steps.
// * The walked chunks: every chunk of the cache, or with a window the n_live
//   chunks from the first one it reaches, which each CTA computes from its
//   own length (decode_pallas.py's start[b]; no host sync, and lengths
//   outside [0, S] keep working).  The grid's z axis splits them: split s of
//   `splits` takes a contiguous range (chunk_range).  A range that holds no
//   key the tile sees, or (kernels 11-12 with `owned`) no owned page, reads
//   nothing and leaves an empty partial (m = NEG_INIT, l = 0, o = 0).  With
//   splits > 1 each CTA writes its normalized partial o, m and l to a
//   workspace, raises a ticket after a __threadfence(), and the last of the
//   splits to finish merges them in split order with
//   merge_decode_partials' formula (ops/decode_cuda.py): w_i = l_i * 2^(m_i
//   - max m), o = sum w_i o_i / sum w_i (1 where that is 0), m = max m, l =
//   sum w_i; it resets its ticket for the next call.  The workspace and
//   tickets belong to the wrapper (allocated once per device and stream);
//   the kernel allocates nothing.
// * The slabs of a row tile: only those that meet the keys its live rows
//   can see, [length - t_q + tmin - window + 1, length - t_q + tmax + 1) cut
//   to [0, length), tmin and tmax the least and largest query token among
//   them (no lower end without a window).  A slab or chunk outside holds no
//   live (row, key) pair of the tile: it would leave m_c, l_c, pmax and the
//   P.V sums as they are, and merge with weight 0 (or 1 with l = 0 and o =
//   0 before any live chunk), so skipping it changes no number.  At t_q 1
//   this is the whole window (or every key below the length); in an extend
//   block a 16-row tile sees window + 15 keys where the block spans window
//   + t_q - 1.
// * Loads overlap compute: a two-stage cp.async ring of slabs, K then V
//   of each share, one barrier an item; the next item's loads (across the
//   cluster barriers and into the next chunk) are in flight while the
//   current one is computed.  RAGGED rows (a head dim that is not a
//   multiple of 16) are read byte by byte and are not overlapped.
// * Occupancy: up to head dim 256 a CTA takes at most 115 KB of shared
//   memory and 128 registers a thread (__launch_bounds__ with two blocks),
//   so two CTAs share an SM and one's barriers hide behind the other's
//   loads; that beat deeper rings or S kept in registers at one CTA an SM,
//   and 255 registers without spills (PERF.md).  At 384 and 512 a CTA takes
//   an SM.  A 64-row tile (four 16-row groups over one staged slab, 128
//   tokens of S kept, one CTA an SM at 252-255 registers) read the window's
//   K and V from L2 a quarter as often in extend blocks, yet ran 1.4-2.4x
//   slower than the 16-row tile at every cluster size (PERF.md).
//
// Warps: 8, all on the tile's 16 rows (RT = 16; extend blocks take more
// row tiles).  S of a slab: warp w takes 8 * NT of its tokens (NT n-tiles
// of m16n8k32 int8 mma.sync); P.V of a slab: warp w takes D / 8 columns
// over all of its tokens, the int32 sums in registers over the share.  The
// mma fragments come by ldmatrix, V^T is stored a word (four tokens) at a
// time and sf, p and the P codes two tokens at a time: a CTA's time goes
// mostly to shared-memory and cp.async instructions and cluster barriers,
// not to the tensor cores (PERF.md, in-kernel clocks).
//
// Bound: bytes at the decode step: each live K and V byte and scale is read
// once from device memory; S, p and the codes stay on chip.  Operations in
// an extend block (4 * rows * d a visible key, on the int8 mma.sync).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_body.cuh"
#include "mma_sm90.cuh"

namespace dsplit {

namespace cg = cooperative_groups;
using decode::Chunk;
using decode::Mask;
using decode::NEG_INIT;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RT = 16;     // rows a CTA owns
constexpr int KEEP = 512;  // tokens of sf a CTA keeps in shared memory
constexpr int CL_MAX = 8;  // the portable cluster size
constexpr int SPLITS_MAX = KEEP / 2;  // the merge's (m_i, w_i) of each split fit sf's room

template <int D, bool PACKED>
struct Shape {
  static constexpr int NT = D <= 128 ? 2 : 1;  // n-tiles of a warp's S
  static constexpr int NSTAGE = 2;              // stages of the load ring (at most 4)
  // CTAs an SM: two up to 256 (about 110 KB of shared memory and 128
  // registers a thread each), one above
  static constexpr int MIN_BLOCKS = D <= 256 ? 2 : 1;
  static constexpr int SLAB = 8 * NT * NWARPS;                // tokens a slab holds
  static constexpr int NSL = KEEP / SLAB;                     // slabs of a KEEP group
  static constexpr int DROWS = PACKED ? SLAB / 2 : SLAB;      // data rows of a slab
  static constexpr int QS = D + 16;      // byte stride of the Q, K and staged rows
  static constexpr int TS = SLAB + 16;   // byte stride of the V^T and P rows
  static constexpr int SFS = KEEP + 8;   // fp32 stride of the kept sf rows
  static constexpr int DW = D / NWARPS;  // O columns of a warp's P.V
  static constexpr int NACC = RT * D / NTHREADS;  // O elements a thread merges (CL 1)
  static constexpr int STAGE = DROWS * QS + 2 * SLAB * 4;  // rows, then ks and vs
  static constexpr int q_off = 0;
  static constexpr int stage_off = q_off + RT * QS;
  static constexpr int k_off = stage_off + NSTAGE * STAGE;  // unpacked K (packed only)
  static constexpr int vt_off = k_off + (PACKED ? SLAB * QS : 0);
  static constexpr int p_off = vt_off + D * TS;
  static constexpr int sf_off = p_off + RT * TS;
  static constexpr int vs_off = sf_off + RT * SFS * 4;  // the KEEP group's V scales
  // the cluster's int32 P.V partials of this CTA's columns: [CL][RT][D / CL]
  static constexpr int pv_off = vs_off + KEEP * 4;
  // the warps' row partials, [2][NWARPS][RT] fp32, where the P codes are
  // (the two are never live at once)
  static constexpr int red_off = p_off;
  // the cluster's m_c, l_c and pmax partials: [3][CL_MAX][RT] fp32
  static constexpr int loc_off = pv_off + RT * D * 4;
  static constexpr int row_off = loc_off + 3 * CL_MAX * RT * 4;
  static constexpr int NROW = 8;
  static constexpr int bytes = row_off + NROW * RT * 4;
  static_assert(bytes <= 232448, "a CTA's shared memory");
  static_assert(MIN_BLOCKS == 1 || MIN_BLOCKS * (bytes + 1024) <= 233472, "two CTAs an SM");
  static_assert(KEEP % SLAB == 0 && D % (8 * CL_MAX) == 0, "shapes");
  static_assert(RT * TS >= 2 * NWARPS * RT * 4, "the row partials fit the P codes' room");
};

// distributed shared memory: the address of `p` in the shared memory of
// cluster CTA `rank`, and stores there.  The exchanges push: each CTA
// stores its values into every reader's shared memory (stores do not wait
// on the remote CTA) and each reader, after the cluster barrier, reads its
// own.
__device__ inline uint32_t cluster_addr(const void* p, int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ inline void st_cluster(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}
__device__ inline void st_cluster(uint32_t a, int x, int y) {
  asm volatile("st.shared::cluster.v2.s32 [%0], {%1, %2};\n" ::"r"(a), "r"(x), "r"(y) : "memory");
}

// The mma.sync fragments by ldmatrix: the int8 m16n8k32 A and B fragments
// are, byte for byte, the b16 m16n8k16 ones, four 8 x 16-byte matrices (A:
// rows 0-7 and 8-15 of each 16-byte half of k; B: each n-tile's two halves).
// `p` points at the first row's k block; rows are `stride` bytes apart.
__device__ inline void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
__device__ inline void ldsm(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
// the A fragment of 16 rows (load_a's registers)
__device__ inline void frag_a(uint32_t (&a)[4], const int8_t* p, int stride, int lane) {
  ldsm(a, p + (lane % 16) * stride + lane / 16 * 16);
}
// the B fragments (b0, b1) of N n-tiles of 8 rows each: pairs by four
// matrices, an odd last one by two
template <int N>
__device__ inline void frag_b(uint32_t (&b)[N][2], const int8_t* p, int stride, int lane) {
  const int half = lane / 8 % 2 * 16;
#pragma unroll
  for (int i = 0; i + 1 < N; i += 2) {
    uint32_t r[4];
    ldsm(r, p + ((i + lane / 16) * 8 + lane % 8) * stride + half);
    b[i][0] = r[0], b[i][1] = r[1], b[i + 1][0] = r[2], b[i + 1][1] = r[3];
  }
  if constexpr (N % 2 != 0) {
    uint32_t r[2];
    ldsm(r, p + ((N - 1) * 8 + lane % 8) * stride + half);
    b[N - 1][0] = r[0], b[N - 1][1] = r[1];
  }
}

// chunks [c0, c1) of split `split` of `splits`: consecutive ranges of the
// walked chunks, every chunk of the cache (n_total) or, with a window, the
// n_live from the first one the window reaches (decode_pallas.py's
// start[b], clamped to [0, n_total - n_live])
__device__ inline void chunk_range(int length, int t_q, int C, int n_total, int window,
                                   int n_live, int splits, int split, int& c0, int& c1) {
  int start = 0, n = n_total;
  if (window > 0) {
    start = min(max(decode::floor_div(length - (window + t_q - 1), C), 0), n_total - n_live);
    n = n_live;
  }
  const int per = (n + splits - 1) / splits;
  c0 = start + split * per;
  c1 = start + min(n, (split + 1) * per);
}

// where this CTA's chunks and partial go
struct Where {
  int rows, t_q, length, C, c0, c1;  // chunks [c0, c1) of C tokens
  int window;                         // 0: none
  int ds;                             // the cache's head dim
  float qs_mul;
  int splits, split;
  float* work;   // [slot][splits][RT * D / CL + 2 * RT] fp32, or null with splits 1
  int* ticket;   // this slot's ticket, or null with splits 1
  int slot;      // (bh * tiles + tile) * CL + rank
};

// tokens [tok0, tok0 + SLAB) of a chunk's K (with its scales) or V into a
// ring stage, zero past the chunk's `hi` live tokens and past ds
template <int D, bool PACKED, bool RAGGED>
__device__ inline void fetch(const Chunk& ch, bool isv, int tok0, int hi, int ds,
                             unsigned char* stage) {
  using L = Shape<D, PACKED>;
  constexpr int CB = D / 16;
  const int tid = threadIdx.x;
  const int drow0 = PACKED ? tok0 / 2 : tok0;
  const int live_rows = PACKED ? (hi - tok0 + 1) / 2 : hi - tok0;
  const int8_t* src = isv ? ch.v : ch.k;
  int8_t* dst = reinterpret_cast<int8_t*>(stage);
  for (int i = tid; i < L::DROWS * CB; i += NTHREADS) {
    const int r = i / CB, cb = i % CB;
    const bool live = r < live_rows && cb * 16 < ds;
    if constexpr (RAGGED) {
      *reinterpret_cast<uint4*>(dst + r * L::QS + cb * 16) =
          decode::load16<true>(src, drow0 + r, cb, live, ds);
    } else {
      const size_t off = live ? (size_t)(drow0 + r) * ds + cb * 16 : 0;
      decode::cp_async16(dst + r * L::QS + cb * 16, src + off, live);
    }
  }
  if (!isv) {
    float* ks = reinterpret_cast<float*>(stage + L::DROWS * L::QS);
    for (int i = tid; i < L::SLAB; i += NTHREADS) {
      const bool live = tok0 + i < hi;
      decode::cp_async4(ks + i, ch.ks + (live ? tok0 + i : 0), live);
      decode::cp_async4(ks + L::SLAB + i, ch.vs + (live ? tok0 + i : 0), live);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One CTA of the split walk: rows [row0, row0 + RT) of one (batch, kv head)
// over chunks [w.c0, w.c1) with its cluster; chunk_at(ci) gives chunk ci's
// operands and live_at(ci) false skips chunk ci unread.  q and o point at
// this (batch, kv head)'s rows; m_out / l_out too, or null.
template <int D, bool PACKED, bool RAGGED, typename ChunkAt, typename LiveAt>
__device__ void split_cta(const float* __restrict__ q, float* __restrict__ o,
                          float* __restrict__ m_out, float* __restrict__ l_out, int row0,
                          const Where& w, ChunkAt chunk_at, LiveAt live_at) {
  using L = Shape<D, PACKED>;
  constexpr float QMAX = PACKED ? 119.f : 127.f;
  constexpr float INV_QMAX = PACKED ? (float)(1.0 / 119.0) : (float)(1.0 / 127.0);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem + L::q_off);
  unsigned char* sStage = smem + L::stage_off;
  int8_t* sKu = reinterpret_cast<int8_t*>(smem + L::k_off);
  int8_t* sVt = reinterpret_cast<int8_t*>(smem + L::vt_off);
  int8_t* sP = reinterpret_cast<int8_t*>(smem + L::p_off);
  float* sSf = reinterpret_cast<float*>(smem + L::sf_off);
  float* sVs = reinterpret_cast<float*>(smem + L::vs_off);
  int* sPV = reinterpret_cast<int*>(smem + L::pv_off);
  float* sRed = reinterpret_cast<float*>(smem + L::red_off);
  float* sLoc = reinterpret_cast<float*>(smem + L::loc_off);
  float* sRow = reinterpret_cast<float*>(smem + L::row_off);
  float* sQsf = sRow;
  float* sM = sRow + RT;
  float* sL = sRow + 2 * RT;
  float* sMc = sRow + 3 * RT;
  float* sPsc = sRow + 4 * RT;
  float* sPr = sRow + 5 * RT;
  float* sAlpha = sRow + 6 * RT;
  float* sW = sRow + 7 * RT;

  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int DC = D / CL;  // the O columns this CTA merges
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  auto cluster_sync = [&]() {
    if (CL > 1)
      cluster.sync();
    else
      __syncthreads();
  };

  // ---- per-row Q quantization (decode_body.cuh's chain) ------------------
  for (int r = warp; r < RT; r += NWARPS) {
    const int gr = row0 + r;
    float x[D / 32];
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      x[e] = gr < w.rows && lane + 32 * e < w.ds ? q[(size_t)gr * w.ds + lane + 32 * e] : 0.f;
      amax = fmaxf(amax, fabsf(x[e]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = __fmul_rn(fmaxf(amax, 1e-30f), INV_QMAX);
    const float rs = __fdiv_rn(1.0f, scale);
#pragma unroll
    for (int e = 0; e < D / 32; ++e)
      sQ[r * L::QS + lane + 32 * e] =
          (int8_t)fminf(fmaxf(roundf(__fmul_rn(x[e], rs)), -QMAX), QMAX);
    if (lane == 0) {
      sQsf[r] = __fmul_rn(fmaxf(amax, 1e-30f), w.qs_mul);
      sM[r] = NEG_INIT;
      sL[r] = 0.f;
    }
  }
  __syncthreads();
  const float qsf0 = sQsf[g], qsf1 = sQsf[g + 8];
  const Mask mask{w.length, w.t_q, w.window};
  // the keys [lo, hi) this thread's rows g and g + 8 see
  const int trow0 = (row0 + g) % w.t_q, trow1 = (row0 + g + 8) % w.t_q;
  const int lo0 = mask.lo(trow0), hi0 = mask.hi(trow0);
  const int lo1 = mask.lo(trow1), hi1 = mask.hi(trow1);
  // the keys the tile's live rows see, [klo, khi), from their least and
  // largest query token, and the walked chunks that hold them
  int tmin = row0 % w.t_q, tmax = tmin + min(RT, w.rows - row0) - 1;
  if (tmax >= w.t_q) {  // every query token
    tmin = 0;
    tmax = w.t_q - 1;
  }
  const int klo = mask.lo(tmin), khi = mask.hi(tmax);
  const int c0 = max(w.c0, klo / w.C);
  const int c1 = khi <= 0 ? c0 : min(w.c1, (int)(((long long)khi + w.C - 1) / w.C));
  float acc[L::NACC];  // O elements e = tid + k * NTHREADS < RT * DC
#pragma unroll
  for (int k = 0; k < L::NACC; ++k) acc[k] = 0.f;

  // ---- the chunks: each visited chunk's share of slabs ---------------------
  struct Share {
    Chunk ch;
    int base, hi, s_lo, n;  // the chunk's first token, tokens below khi, my slabs
  };
  auto share_of = [&](int ci) {
    Share s;
    s.ch = chunk_at(ci);
    s.base = ci * w.C;
    s.hi = min(w.C, khi - s.base);
    const int first = max(0, klo - s.base) / L::SLAB;  // the slabs that meet [klo, khi)
    const int nsl = (s.hi + L::SLAB - 1) / L::SLAB - first;
    const int per = (nsl + CL - 1) / CL;
    s.s_lo = first + rank * per;
    s.n = max(0, min(per, nsl - rank * per));
    return s;
  };
  // the chunks are visited in order, less those live_at skips
  auto next_visited = [&](int ci) {
    for (++ci; ci < c1; ++ci)
      if (live_at(ci)) return ci;
    return c1;
  };
  // item i of a share: keep mode (n <= NSL) K(0..n), V(0..n); else (groups
  // of NSL) K(0..n) for m_c, K(0..n) for l_c, then each group's K and V
  auto item_at = [&](const Share& s, int i, bool& isv) {
    isv = false;
    if (s.n <= L::NSL) {
      isv = i >= s.n;
      return s.s_lo + (isv ? i - s.n : i);
    }
    if (i < 2 * s.n) return s.s_lo + i % s.n;
    i -= 2 * s.n;
    const int gi = i / (2 * L::NSL), j = i % (2 * L::NSL);
    const int cnt = min(L::NSL, s.n - gi * L::NSL);
    isv = j >= cnt;
    return s.s_lo + gi * L::NSL + (isv ? j - cnt : j);
  };
  auto items = [&](const Share& s) { return s.n <= L::NSL ? 2 * s.n : 4 * s.n; };

  // the ring: items are issued in order (the current share's, then the next
  // visited chunk's), stage = ordinal % NSTAGE, up to NSTAGE - 1 ahead of the
  // one being computed
  int issued = 0, consumed = 0;  // ordinals
  int cur_issued = 0, nxt_issued = 0;  // items of the current and next share issued
  int ci_next = -1;
  Share nxt;
  auto issue = [&](const Share& s, int i) {
    bool isv;
    const int sl = item_at(s, i, isv);
    fetch<D, PACKED, RAGGED>(s.ch, isv, sl * L::SLAB, s.hi, w.ds,
                             sStage + (issued % L::NSTAGE) * L::STAGE);
    ++issued;
  };
  // item i of share s: wait for its loads, then (one barrier: every thread
  // is done with item i - 1, whose stage is free) issue the items up to
  // i + NSTAGE - 1, into the next chunk's share past this one's end
  auto step = [&](const Share& s, int i) -> unsigned char* {
    if (cur_issued <= i) issue(s, cur_issued++);  // nothing was in flight
    switch (issued - consumed - 1) {  // groups issued after item i
      case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
      case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
      case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
      default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    }
    __syncthreads();
    const int upto = i + L::NSTAGE;  // items [0, upto) of this share, then the next's
    while (cur_issued < min(items(s), upto)) issue(s, cur_issued++);
    if (ci_next < c1)
      while (nxt_issued < min(items(nxt), upto - items(s))) issue(nxt, nxt_issued++);
    return sStage + ((consumed++) % L::NSTAGE) * L::STAGE;
  };

  // K item j of the current KEEP group: S of the slab into the kept sf (-inf
  // where masked) and the slab's V scales into sVs; returns the slab's row
  // maxima (NEG_INIT where masked) folded into mx
  auto scores = [&](const Share& s, int i, int j, float& mx0, float& mx1) {
    unsigned char* st = step(s, i);
    bool isv;
    const int tok0 = item_at(s, i, isv) * L::SLAB;
    const int8_t* kr = reinterpret_cast<const int8_t*>(st);
    const float* ks = reinterpret_cast<const float*>(st + L::DROWS * L::QS);
    if constexpr (PACKED) {
      constexpr int CB = D / 16;
      for (int x = tid; x < L::DROWS * CB; x += NTHREADS) {
        const int r = x / CB, cb = x % CB;
        uint4 lo, hi;
        decode::unpack16(*reinterpret_cast<const uint4*>(kr + r * L::QS + cb * 16), lo, hi);
        *reinterpret_cast<uint4*>(sKu + (2 * r) * L::QS + cb * 16) = lo;
        *reinterpret_cast<uint4*>(sKu + (2 * r + 1) * L::QS + cb * 16) = hi;
      }
      __syncthreads();
      kr = sKu;
    }
    for (int x = tid; x < L::SLAB; x += NTHREADS) sVs[j * L::SLAB + x] = ks[L::SLAB + x];
    int a32[L::NT][4];
#pragma unroll
    for (int n = 0; n < L::NT; ++n) a32[n][0] = a32[n][1] = a32[n][2] = a32[n][3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t a[4], b[L::NT][2];
      frag_a(a, sQ + kk * 32, L::QS, lane);
      frag_b<L::NT>(b, kr + warp * 8 * L::NT * L::QS + kk * 32, L::QS, lane);
#pragma unroll
      for (int n = 0; n < L::NT; ++n) mma_s8(a32[n], a, b[n][0], b[n][1]);
    }
    // the mma C layout: a32[n][2h + i] is row g + 8h, token ts + i of the slab
#pragma unroll
    for (int n = 0; n < L::NT; ++n) {
      const int ts = warp * 8 * L::NT + n * 8 + 2 * t;  // the pair's first token in the slab
      const int tc = tok0 + ts, col = s.base + tc;      // in the chunk, in the cache
      const float2 ksp = *reinterpret_cast<const float2*>(ks + ts);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lo = h ? lo1 : lo0, hi = h ? hi1 : hi0;
        const float qsf = h ? qsf1 : qsf0;
        const bool live0 = tc < w.C && col >= lo && col < hi;
        const bool live1 = tc + 1 < w.C && col + 1 >= lo && col + 1 < hi;
        const float v0 = __fmul_rn(__fmul_rn((float)a32[n][2 * h], qsf), ksp.x);
        const float v1 = __fmul_rn(__fmul_rn((float)a32[n][2 * h + 1], qsf), ksp.y);
        *reinterpret_cast<float2*>(sSf + (g + 8 * h) * L::SFS + j * L::SLAB + ts) =
            make_float2(live0 ? v0 : -INFINITY, live1 ? v1 : -INFINITY);
        float& mx = h ? mx1 : mx0;
        mx = fmaxf(fmaxf(mx, live0 ? v0 : NEG_INIT), live1 ? v1 : NEG_INIT);
      }
    }
  };
  // the CTA's row values of two warp-reduced per-thread values (rows g and
  // g + 8), combined over the warps: max, or an fp32 sum in warp order
  auto cta_rows = [&](float a0, float a1, float b0, float b1, bool sum_a) {
    if (t == 0) {
      sRed[warp * RT + g] = a0;
      sRed[warp * RT + g + 8] = a1;
      sRed[(NWARPS + warp) * RT + g] = b0;
      sRed[(NWARPS + warp) * RT + g + 8] = b1;
    }
    __syncthreads();
    if (tid < RT) {
      float x = sRed[tid], y = sRed[NWARPS * RT + tid];
      for (int v = 1; v < NWARPS; ++v) {
        x = sum_a ? __fadd_rn(x, sRed[v * RT + tid]) : fmaxf(x, sRed[v * RT + tid]);
        y = fmaxf(y, sRed[(NWARPS + v) * RT + tid]);
      }
      // into every cluster CTA's slot for this rank
      float* a = sLoc + ((sum_a ? CL_MAX : 0) + rank) * RT + tid;
      float* b = sLoc + (2 * CL_MAX + rank) * RT + tid;
      if (CL == 1) {
        *a = x;
        if (sum_a) *b = y;
      }
      for (int r = 0; CL > 1 && r < CL; ++r) {
        st_cluster(cluster_addr(a, r), x);
        if (sum_a) st_cluster(cluster_addr(b, r), y);
      }
    }
  };

  int ci = c0;
  if (ci < c1 && !live_at(ci)) ci = next_visited(ci);
  if (ci < c1) {
    Share cur = share_of(ci);
    ci_next = next_visited(ci);
    if (ci_next < c1) nxt = share_of(ci_next);
    for (;;) {
      const Share s = cur;
      const int groups = (s.n + L::NSL - 1) / L::NSL;
      const bool keep = groups <= 1;
      int it = 0;  // the share's next item

      // ---- m_c: the chunk's row max of sf, over the cluster (exact) ------
      float mx0 = NEG_INIT, mx1 = NEG_INIT;
      for (int gi = 0; gi < groups; ++gi)
        for (int j = 0; j < min(L::NSL, s.n - gi * L::NSL); ++j) scores(s, it++, j, mx0, mx1);
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      cta_rows(mx0, mx1, 0.f, 0.f, false);
      cluster_sync();
      if (tid < RT) {
        float m = NEG_INIT;
        for (int r = 0; r < CL; ++r) m = fmaxf(m, sLoc[r * RT + tid]);
        sMc[tid] = m;
      }
      __syncthreads();
      const float mc0 = sMc[g], mc1 = sMc[g + 8];

      // ---- l_c and pmax of pe = p * vs (l_c in rank order) ----------------
      float ls0 = 0.f, ls1 = 0.f, pm0 = 0.f, pm1 = 0.f;
      for (int gi = 0; gi < groups; ++gi) {
        const int cnt = min(L::NSL, s.n - gi * L::NSL);
        if (!keep) {
          float d0 = NEG_INIT, d1 = NEG_INIT;
          for (int j = 0; j < cnt; ++j) scores(s, it++, j, d0, d1);
          __syncthreads();  // sVs
        }
        for (int j = 0; j < cnt; ++j) {
#pragma unroll
          for (int n = 0; n < L::NT; ++n) {
            const int ts = j * L::SLAB + warp * 8 * L::NT + n * 8 + 2 * t;
            const float2 vsp = *reinterpret_cast<const float2*>(sVs + ts);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 sf = *reinterpret_cast<const float2*>(sSf + (g + 8 * h) * L::SFS + ts);
              const float mc = h ? mc1 : mc0;
              const float p0 = exp2f(__fsub_rn(sf.x, mc)), p1 = exp2f(__fsub_rn(sf.y, mc));
              float& ls = h ? ls1 : ls0;
              float& pm = h ? pm1 : pm0;
              ls = __fadd_rn(__fadd_rn(ls, p0), p1);  // 0 where -inf
              pm = fmaxf(fmaxf(pm, __fmul_rn(p0, vsp.x)), __fmul_rn(p1, vsp.y));
            }
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ls0 = __fadd_rn(ls0, __shfl_xor_sync(0xffffffffu, ls0, off));
        ls1 = __fadd_rn(ls1, __shfl_xor_sync(0xffffffffu, ls1, off));
        pm0 = fmaxf(pm0, __shfl_xor_sync(0xffffffffu, pm0, off));
        pm1 = fmaxf(pm1, __shfl_xor_sync(0xffffffffu, pm1, off));
      }
      cta_rows(ls0, ls1, pm0, pm1, true);
      cluster_sync();
      if (tid < RT) {
        float l = sLoc[CL_MAX * RT + tid], pm = sLoc[2 * CL_MAX * RT + tid];
        for (int r = 1; r < CL; ++r) {
          l = __fadd_rn(l, sLoc[(CL_MAX + r) * RT + tid]);
          pm = fmaxf(pm, sLoc[(2 * CL_MAX + r) * RT + tid]);
        }
        const float psc = __fmul_rn(fmaxf(pm, 1e-30f), INV_QMAX);
        sPsc[tid] = psc;
        sPr[tid] = __fdiv_rn(1.0f, psc);
        // the base-2 online merge of (m, l); O's follows the P.V
        const float m_prev = sM[tid], mc = sMc[tid];
        const float m_next = fmaxf(m_prev, mc);
        const float alpha = exp2f(__fsub_rn(m_prev, m_next));
        const float wt = exp2f(__fsub_rn(mc, m_next));
        sM[tid] = m_next;
        sL[tid] = __fadd_rn(__fmul_rn(alpha, sL[tid]), __fmul_rn(wt, l));
        sAlpha[tid] = alpha;
        sW[tid] = wt;
      }
      __syncthreads();
      const float pr0 = sPr[g], pr1 = sPr[g + 8];

      // ---- P codes and the integer P.V over the share ---------------------
      int pacc[L::DW / 8][4];
#pragma unroll
      for (int i = 0; i < L::DW / 8; ++i) pacc[i][0] = pacc[i][1] = pacc[i][2] = pacc[i][3] = 0;
      for (int gi = 0; gi < groups; ++gi) {
        const int cnt = min(L::NSL, s.n - gi * L::NSL);
        if (!keep) {
          float d0 = NEG_INIT, d1 = NEG_INIT;
          for (int j = 0; j < cnt; ++j) scores(s, it++, j, d0, d1);
        }
        for (int j = 0; j < cnt; ++j) {
          const unsigned char* st = step(s, it++);
#pragma unroll
          for (int n = 0; n < L::NT; ++n) {
            const int ts = warp * 8 * L::NT + n * 8 + 2 * t;
            const float2 vsp = *reinterpret_cast<const float2*>(sVs + j * L::SLAB + ts);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 sf =
                  *reinterpret_cast<const float2*>(sSf + (g + 8 * h) * L::SFS + j * L::SLAB + ts);
              const float mc = h ? mc1 : mc0, pr = h ? pr1 : pr0;
              const float pe0 = __fmul_rn(exp2f(__fsub_rn(sf.x, mc)), vsp.x);
              const float pe1 = __fmul_rn(exp2f(__fsub_rn(sf.y, mc)), vsp.y);
              const int code0 = (int)fminf(roundf(__fmul_rn(pe0, pr)), QMAX);
              const int code1 = (int)fminf(roundf(__fmul_rn(pe1, pr)), QMAX);
              *reinterpret_cast<uint16_t*>(sP + (g + 8 * h) * L::TS + ts) =
                  (uint16_t)((code0 & 0xFF) | (code1 & 0xFF) << 8);
            }
          }
          // V^T (unpacked from token pairs when packed), four tokens by 16
          // channels a thread; consecutive threads take consecutive tokens,
          // so a warp's word stores into a V^T row are contiguous
          constexpr int CB = D / 16, NQ = L::SLAB / 4;
          for (int x = tid; x < NQ * CB; x += NTHREADS) {
            const int qd = x % NQ, cb = x / NQ;
            uint4 v[4];
            if constexpr (PACKED) {  // data rows 2 qd and 2 qd + 1 hold tokens 4 qd .. 4 qd + 3
              decode::unpack16(*reinterpret_cast<const uint4*>(st + (2 * qd) * L::QS + cb * 16),
                               v[0], v[1]);
              decode::unpack16(*reinterpret_cast<const uint4*>(st + (2 * qd + 1) * L::QS + cb * 16),
                               v[2], v[3]);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                v[i] = *reinterpret_cast<const uint4*>(st + (4 * qd + i) * L::QS + cb * 16);
            }
            decode::store_vt4<L::TS>(sVt, v, qd, cb);
          }
          __syncthreads();
#pragma unroll
          for (int kk = 0; kk < L::SLAB / 32; ++kk) {
            uint32_t a[4], b[L::DW / 8][2];
            frag_a(a, sP + kk * 32, L::TS, lane);
            frag_b<L::DW / 8>(b, sVt + warp * L::DW * L::TS + kk * 32, L::TS, lane);
#pragma unroll
            for (int nt = 0; nt < L::DW / 8; ++nt) mma_s8(pacc[nt], a, b[nt][0], b[nt][1]);
          }
        }
      }
      // each column's partial into the shared memory of the CTA that merges it
#pragma unroll
      for (int nt = 0; nt < L::DW / 8; ++nt) {
        const int c = warp * L::DW + nt * 8 + 2 * t, x = c / DC;
        int* dst = sPV + (rank * RT + g) * DC + c - x * DC;
        if (CL == 1) {
          *reinterpret_cast<int2*>(dst) = make_int2(pacc[nt][0], pacc[nt][1]);
          *reinterpret_cast<int2*>(dst + 8 * DC) = make_int2(pacc[nt][2], pacc[nt][3]);
        } else {
          st_cluster(cluster_addr(dst, x), pacc[nt][0], pacc[nt][1]);
          st_cluster(cluster_addr(dst + 8 * DC, x), pacc[nt][2], pacc[nt][3]);
        }
      }
      cluster_sync();

      // ---- this CTA's D / CL columns: the cluster's P.V (exact) and O's merge
#pragma unroll
      for (int k = 0; k < L::NACC; ++k) {
        const int e = tid + k * NTHREADS, r = e / DC;
        if (e < RT * DC) {
          int sum = 0;
          for (int x = 0; x < CL; ++x) sum += sPV[x * RT * DC + e];
          const float pv = __fmul_rn((float)sum, sPsc[r]);
          acc[k] = __fadd_rn(__fmul_rn(acc[k], sAlpha[r]), __fmul_rn(pv, sW[r]));
        }
      }
      if (ci_next >= c1) break;
      ci = ci_next;
      cur = nxt;
      cur_issued = nxt_issued;
      nxt_issued = 0;
      ci_next = next_visited(ci);
      if (ci_next < c1) nxt = share_of(ci_next);
    }
  }
  cluster_sync();  // no CTA leaves while another reads its shared memory

  // ---- this CTA's columns of o (and m, l), or its partial and the merge ----
  if (w.splits == 1) {
#pragma unroll
    for (int k = 0; k < L::NACC; ++k) {
      const int e = tid + k * NTHREADS;
      const int r = e / DC, c = rank * DC + e % DC, gr = row0 + r;
      if (e >= RT * DC || gr >= w.rows || c >= w.ds) continue;
      const float l = sL[r];
      o[(size_t)gr * w.ds + c] = __fmul_rn(acc[k], l == 0.f ? 0.f : __fdiv_rn(1.0f, l));
    }
    if (m_out != nullptr && rank == 0 && tid < RT && row0 + tid < w.rows) {
      m_out[row0 + tid] = sM[tid];
      l_out[row0 + tid] = sL[tid];
    }
    return;
  }
  const int part = RT * DC + 2 * RT;  // floats of one split's partial
  float* mine = w.work + ((size_t)w.slot * w.splits + w.split) * part;
#pragma unroll
  for (int k = 0; k < L::NACC; ++k) {
    const int e = tid + k * NTHREADS;
    if (e >= RT * DC) continue;
    const float l = sL[e / DC];
    mine[e] = __fmul_rn(acc[k], l == 0.f ? 0.f : __fdiv_rn(1.0f, l));
  }
  if (tid < RT) {
    mine[RT * DC + tid] = sM[tid];
    mine[RT * DC + RT + tid] = sL[tid];
  }
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(sLoc);  // free after the last cluster barrier
  if (tid == 0) *last = atomicAdd(w.ticket, 1) == w.splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* all = w.work + (size_t)w.slot * w.splits * part;
  // the weights w_i = l_i * 2^(m_i - max m) of each split, in the kept sf's room
  float* wts = sSf;
  // (m_i, l_i) of every split into shared memory, read by all the threads
  float* sMs = wts + w.splits * RT;
  for (int x = tid; x < w.splits * RT; x += NTHREADS) {
    const float* pi = all + (size_t)(x / RT) * part + RT * DC;
    sMs[x] = __ldcg(pi + x % RT);
    wts[x] = __ldcg(pi + RT + x % RT);
  }
  __syncthreads();
  if (tid < RT) {
    float mg = NEG_INIT;
    for (int i = 0; i < w.splits; ++i) mg = fmaxf(mg, sMs[i * RT + tid]);
    float den = 0.f;
    for (int i = 0; i < w.splits; ++i) {
      const float wi = __fmul_rn(wts[i * RT + tid], exp2f(__fsub_rn(sMs[i * RT + tid], mg)));
      wts[i * RT + tid] = wi;
      den = i == 0 ? wi : __fadd_rn(den, wi);
    }
    sM[tid] = mg;
    sL[tid] = den;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < L::NACC; ++k) {
    const int e = tid + k * NTHREADS;
    const int r = e / DC, c = rank * DC + e % DC, gr = row0 + r;
    if (e >= RT * DC || gr >= w.rows || c >= w.ds) continue;
    float num = 0.f;
#pragma unroll 4
    for (int i = 0; i < w.splits; ++i) {
      const float x = __fmul_rn(wts[i * RT + r], __ldcg(all + (size_t)i * part + e));
      num = i == 0 ? x : __fadd_rn(num, x);
    }
    const float den = sL[r];
    o[(size_t)gr * w.ds + c] = __fdiv_rn(num, den == 0.f ? 1.f : den);
  }
  if (m_out != nullptr && rank == 0 && tid < RT && row0 + tid < w.rows) {
    m_out[row0 + tid] = sM[tid];
    l_out[row0 + tid] = sL[tid];
  }
  if (tid == 0) *w.ticket = 0;  // for the next call
}

// The launch of a split kernel: CL CTAs a cluster along x (row tiles x CL),
// kv heads along y, batch x splits along z.  A refused launch returns its
// error (a cluster the card cannot place, too much shared memory).
template <int D, bool PACKED, typename Kernel, typename... Args>
int launch(Kernel kern, int tiles, int hkv, int b, int cl, int splits, cudaStream_t st,
           Args... args) {
  constexpr int smem = Shape<D, PACKED>::bytes;
  int e = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != 0) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cl, hkv, b * splits);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// the plan's limits: CL 1, 2, 4 or 8; 1 to n_walked splits (the chunks the
// walk visits), at most SPLITS_MAX; a workspace and tickets with splits > 1
inline bool plan_ok(int cl, int splits, int n_walked, const void* work, const void* tickets) {
  return (cl == 1 || cl == 2 || cl == 4 || cl == 8) && splits >= 1 && splits <= n_walked &&
         splits <= SPLITS_MAX && (splits == 1 || (work != nullptr && tickets != nullptr));
}

}  // namespace dsplit
