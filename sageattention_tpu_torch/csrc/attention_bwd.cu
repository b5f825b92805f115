// SageAttention backward for Hopper (sm_90a): the straight-through gradient
// of the quantized forward (attention_fwd.cu), in two kernels.
//
// Replaces the TPU kernels attention_bwd_pallas.py:sage_attention_bwd ->
// _dq_kernel and _dkv_kernel.  Both recompute the base-2 logits from the
// same int8 codes as the forward, l2 = s_i32 * (q_scale * k_scale) in the
// forward's operand order, and P = exp2(l2 - lse2) from the forward's saved
// LSE; there is no online softmax, so every (Q tile, KV tile) pair is
// independent work.  With D = rowsum(dO * O) - dlse (computed outside):
//
//   dP = dO.V^T     dS = bf16(P * (dP - D))     dQ = dS.K_sm * sm_scale
//   dV = bf16(P)^T.dO                           dK = dS^T.Q * sm_scale
//
// rounded to bf16 where the TPU kernels round (P before P^T.dO, dS before
// both products; dO, V, K_sm = bf16(K - km) and Q in bf16), fp32 sums.
//
// sage_attn_bwd_dq: a CTA owns Q rows and loops over 64-column KV tiles;
//   this loop replaces the TPU's sequential n_kv grid axis and its VMEM
//   accumulator, and dQ accumulates in registers.  Causal: it stops at the
//   diagonal tile; with a sliding window (causal only) it starts at the
//   window's first tile, the counterpart of the TPU's band grid
//   (attention_bwd_pallas.py:117-143).
// sage_attn_bwd_dkv: a CTA owns KV rows and loops over every q head of its
//   GQA group and every 64-row Q tile (causal: from the diagonal; with a
//   window, up to the last Q row that sees the tile,
//   attention_bwd_pallas.py:274-287), so dK and dV sum over the group in
//   registers, with no atomics and no repeat of K/V: the port's form of
//   the TPU's rep*n_q fourth grid axis.  It works on the transposed scores
//   S^T = K.Q^T so that a KV row is a product's row.  A KV tile of 64 rows
//   lies inside one 128-row K-scale group, so it reads one k_scale.
//
// Every instance is a Hopper kernel: TMA loads through a ring of
// shared-memory stages, one producer warp, wgmma for all five products
// (their section below has the design).  A sliding window keeps col > row -
// window wherever causal keeps col <= row, in instances of its own
// (WINDOW).
//
// A bias (the BIAS instances, attention_bwd_pallas.py:146-204, 311-316) is
// a per-head [b, hq, sq, sk] fp32 or bf16 tensor, which the forward added
// to the base-2 logits as bias * log2(e).  Both kernels add it to the
// recomputed logits too and clamp them at -1e30, and a row whose lse2 is
// -inf (every key biased to -inf; the forward gave o = 0) takes 0 in its
// place, so its P is exactly 0 and no NaN arises.  dQ writes dBias = dS =
// P * (dP - D) in fp32, before the bf16 rounding, in the bias's type (when
// asked: a fixed bias costs no write), a fragment's column pair in one
// store (a quad's stores cover 32 consecutive bytes in fp32), and writes
// the zeros right of each warpgroup's causal diagonal itself, in 16-byte
// stores, so the wrapper allocates dBias uninitialised.  A window with a
// bias is not taken: the JAX package sends it to its exact backward
// (:423-426), and so does the port.
//
// How the bias reaches the registers, against a shared-memory budget that
// the bias-free rings already fill (dQ 119-214 KB, dK/dV 218-222 KB of the
// H100's 227 KB a block):
//   kBiasTma (where a TMA map of the bias exists: a row of sk elements a
//     multiple of 16 bytes, a 16-byte aligned base): the producer stages it
//     in a ring of its own, beside the K/V ring (dQ: each consumer
//     warpgroup's [64 Q rows][64 KV columns] tile) or the Q ring (dK/dV: a
//     Q tile's rows x the CTA's 128 or 192 KV columns), in 128-byte
//     swizzled panels, so that a fragment's reads meet no bank conflict.
//     dQ: 2 stages at d 64 and 128 (K/V 4 and 2), 1 at 256 (K/V 2). dK/dV:
//     2 stages at d 64 (Q 4) and 128 (Q 2); at 256 no fp32 tile fits;
//   kBiasLoads (any sk, and dK/dV at 256): each consumer thread loads its
//     fragment's bias from device memory.  dQ: at d 128 into registers right
//     after the tile's S and dP products are issued, at 64 and 256 after
//     them (no registers to spare: 160 a thread beside three warpgroups at
//     64, dQ's 128-register accumulator at 256), with the next tile's rows
//     prefetched into L2.  dK/dV: bias[q row, kv row] of its transposed
//     fragment after the pass's products (for one element a warp reads 8
//     consecutive KV columns of each of 4 Q rows, whole 32-byte sectors in
//     fp32; held across the products they spilled), so the bias needs no
//     transposed copy (the TPU launcher's one XLA transpose, :931-940).  At
//     D = 256 the one launch's dV and dK warpgroups both load it, the second
//     from L2.
// The caller picks the form (the bias_kind argument), as
// ops/attention_bwd_cuda.py's bias_reads rules.  tools/ab_attention_bwd.py
// times both forms against each other.
//
// Ragged edges: K/V rows past sk and Q rows past sq land as zeros, their P
// is set to 0 by a select (no inf - inf and no inf * 0: the exp2 of a
// masked entry is never used), and no row past sq (dQ) or sk (dK, dV) is
// stored.  No padding of the sequence in memory.
//
// Bound: operations.  Per score pair dQ does one int8 Q.K^T (2d ops) and
// two bf16 products' worth of 4d FLOP (dO.V^T, dS.K), dKV 2d int8 and 6d
// bf16 (dO.V^T, P^T.dO, dS^T.Q).  At the CogVideoX-2B layer shape (b=1,
// h=30, s=17,776, d=64; 9.48e9 pairs) that is about 3.1 ms for dQ and 4.3 ms
// for dKV on the H100 SXM's data-sheet peaks; the bytes take well under
// 0.1 ms, and the two exp2 passes (2 x 9.48e9 MUFU operations) are a second
// floor of a few ms.  With a bias, bytes: each live pair's bias is read once
// by each kernel and dQ writes its dBias (and the causal zeros), 8 to 12
// bytes a pair in fp32 against 6d-10d operations.  At the llm-8b-gqa layer
// (b=1, hq=32, s=4096, d=128, causal: 268.5 M live pairs) that is about
// 0.96 ms for dQ with its dBias and 0.32 ms for dKV at 3.35 TB/s, against
// 0.17 and 0.24 ms of operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"  // pack_bf16
#include "wgmma_sm90.cuh"

namespace {

constexpr int KGROUP = 128;  // K-scale group

// the operands of both kernels (shapes at the extern "C" entry points)
struct BwdArgs {
  const int8_t* q_i8;
  const float* q_scale;
  const __nv_bfloat16* q_bf;
  const int8_t* k_i8;
  const float* k_scale;
  const __nv_bfloat16* k_sm;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse2;
  const float* dvec;
  float* dq;
  float* dk;
  float* dv;
  int hq, hkv, sq, sk;
  float sm_scale;
  int window;  // 0: none (causal only)
};

// how an instance reads a bias (its BIAS template argument; see the header)
constexpr int kNoBias = 0;
constexpr int kBiasLoads = 1;  // each consumer thread from device memory
constexpr int kBiasTma = 2;    // dQ: staged by the producer's TMA

// the BIAS instances' operands, a parameter of their own (an empty one
// elsewhere): the same three fields appended to BwdArgs moved the registers
// of every instance without a bias
struct BiasArgs {
  CUtensorMap map;   // [b hq, sq, sk] in boxes of [64 rows][128 bytes] (kBiasTma)
  const void* bias;  // [b, hq, sq, sk], fp32 or bf16 (bf16)
  void* dbias;       // dS in the bias's type, or null (dQ only)
  int bf16;
  int shift;  // log2 of the element's bytes (2 fp32, 1 bf16): one address path for both
  int pairs;  // sk even and the bases aligned: a column pair is one load or store
};
struct NoBias {};
template <int BIAS>
using BiasOf = std::conditional_t<BIAS != kNoBias, BiasArgs, NoBias>;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLogitFloor = -1e30f;  // the TPU kernels' clamp of biased logits

// a row's lse2: with a bias, -inf (no live key) becomes 0, so its P is 0
template <int BIAS>
__device__ inline float live_lse(float x) {
  if constexpr (BIAS != kNoBias) return x == -INFINITY ? 0.f : x;
  return x;
}

// P of a biased logit: exp2(max(l2 + bias log2(e), floor) - lse2)
__device__ inline float biased_p(float l2, float bias, float lse) {
  return exp2f(fmaxf(l2 + bias * kLog2e, kLogitFloor) - lse);
}

// The bias at columns c and c + 1 (c even) of the row that starts at
// element `row`, columns past sk reading the row's last ones (never used):
// fp32 bits in x0 and x1, or a bf16 pair in x0; one load where ba.pairs
__device__ inline void bias_pair(const BiasArgs& ba, size_t row, int c, int sk, uint32_t& x0,
                                 uint32_t& x1) {
  const unsigned char* b = static_cast<const unsigned char*>(ba.bias);
  if (ba.pairs) {
    const unsigned char* p = b + ((row + min(c, sk - 2)) << ba.shift);
    if (ba.bf16) {
      x0 = __ldg(reinterpret_cast<const unsigned int*>(p));
      x1 = 0;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      x0 = v.x;
      x1 = v.y;
    }
  } else {
    const unsigned char* p0 = b + ((row + min(c, sk - 1)) << ba.shift);
    const unsigned char* p1 = b + ((row + min(c + 1, sk - 1)) << ba.shift);
    if (ba.bf16) {
      x0 = (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p0)) |
           ((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p1)) << 16);
      x1 = 0;
    } else {
      x0 = __ldg(reinterpret_cast<const unsigned int*>(p0));
      x1 = __ldg(reinterpret_cast<const unsigned int*>(p1));
    }
  }
}

// value `odd` (0, 1) of a pair that bias_pair loaded, in fp32
__device__ inline float pair_value(int bf16, uint32_t x0, uint32_t x1, int odd) {
  return __uint_as_float(bf16 ? (odd ? x0 & 0xffff0000u : x0 << 16) : odd ? x1 : x0);
}

// one bias element that a dK/dV thread loaded: fp32 bits, or bf16 bits
__device__ inline uint32_t bias_one(const BiasArgs& ba, size_t e) {
  const unsigned char* p = static_cast<const unsigned char*>(ba.bias) + (e << ba.shift);
  return ba.bf16 ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p))
                 : __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ inline float one_value(int bf16, uint32_t x) {
  return __uint_as_float(bf16 ? x << 16 : x);
}

// dS of columns c and c + 1 (c even) into the dBias row that starts at
// element `row`, in the bias's type, the columns below sk only; one
// streaming store where ba.pairs
__device__ inline void dbias_pair(const BiasArgs& ba, size_t row, int c, int sk, float x0,
                                  float x1) {
  if (c >= sk) return;
  unsigned char* p = static_cast<unsigned char*>(ba.dbias) + ((row + c) << ba.shift);
  if (ba.bf16) {
    unsigned short* h = reinterpret_cast<unsigned short*>(p);
    if (ba.pairs) {
      __stcs(reinterpret_cast<unsigned int*>(h), pack_bf16(x0, x1));
    } else {
      __stcs(h, __bfloat16_as_ushort(__float2bfloat16(x0)));
      if (c + 1 < sk) __stcs(h + 1, __bfloat16_as_ushort(__float2bfloat16(x1)));
    }
  } else {
    float* f = reinterpret_cast<float*>(p);
    if (ba.pairs) {
      __stcs(reinterpret_cast<float2*>(f), make_float2(x0, x1));
    } else {
      __stcs(f, x0);
      if (c + 1 < sk) __stcs(f + 1, x1);
    }
  }
}

// zeros into columns [c, sk) of the dBias row that starts at element `row`,
// by the 32 lanes of a warp: 16-byte stores between a head and a tail of
// single elements
__device__ inline void dbias_zeros(const BiasArgs& ba, size_t row, int c, int sk, int lane) {
  const int es = ba.bf16 ? 2 : 4, per = 16 / es;
  unsigned char* p = static_cast<unsigned char*>(ba.dbias) + row * es;
  auto zero1 = [&](int col) {
    if (ba.bf16)
      __stcs(reinterpret_cast<unsigned short*>(p + (size_t)col * 2), (unsigned short)0);
    else
      __stcs(reinterpret_cast<float*>(p + (size_t)col * 4), 0.f);
  };
  const int mis = (int)((reinterpret_cast<uintptr_t>(p + (size_t)c * es) & 15) / es);
  const int head = min(mis ? per - mis : 0, sk - c);
  if (lane < head) zero1(c + lane);
  c += head;
  const int nv = (sk - c) / per;
  uint4* v = reinterpret_cast<uint4*>(p + (size_t)c * es);
  for (int i = lane; i < nv; i += 32) __stcs(v + i, make_uint4(0, 0, 0, 0));
  c += nv * per;
  if (lane < sk - c) zero1(c + lane);
}

// bring the line at p into L2 (no registers, no completion to wait for)
__device__ inline void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ inline uint32_t lds16(uint32_t addr) {
  uint16_t x;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(x) : "r"(addr));
  return x;
}
__device__ inline uint32_t lds32(uint32_t addr) {
  uint32_t x;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(x) : "r"(addr));
  return x;
}
__device__ inline void lds64(uint32_t addr, uint32_t& x0, uint32_t& x1) {
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(x0), "=r"(x1) : "r"(addr));
}

// ---------------------------------------------------------------------------
// The kernels: TMA-fed wgmma, one producer warp
// ---------------------------------------------------------------------------
//
// A CTA is NWG consumer warpgroups and one producer warpgroup, of which one
// thread issues every load.  What a CTA keeps (dQ: its Q codes and dO;
// dK/dV: its K codes and V) lands once; what it walks over (dQ: the K
// codes, K_sm and V of each 64-column KV tile; dK/dV: the Q codes, bf16 Q
// and dO of each 64-row Q tile with their rows of q_scale, lse2 and dvec)
// streams through a ring of STAGES buffers: the producer waits for a
// buffer to be released (`empty`), posts its bytes on `full` and issues
// the TMA loads; a consumer waits on `full`, computes and arrives on
// `empty`.  Every tile is [64 rows][D] in panels of up to 128 bytes a row,
// swizzled as wgmma reads it; rows past the sequence land as zeros (a
// 3-D map [b h, s, d], so no box reads the next head's rows).  The bias
// tiles (kBiasTma) stream through a second ring of BST stages (`bfull`,
// `bempty`) in the same way.
//
// Products, each a warpgroup's 64 rows:
//   dQ:   S = Q.K^T (int8, both from shared memory, K-major), dP = dO.V^T
//         (bf16, the same), then dQ += bf16(dS) . K_sm with dS from
//         registers and K_sm read MN-major;
//   dKV:  S^T = K.Q^T, dP^T = V.dO^T, then dV += bf16(P^T) . dO and
//         dK += bf16(dS^T) . Q, dO and Q read MN-major from the tile that
//         dP^T read K-major.
// The consumers hold their rows' q_scale, lse2 and dvec (dQ) in registers
// or read a Q tile's from the stage, a fragment's two columns at a time
// (dK/dV).  Registers: the producer warpgroup gives its own up (setmaxnreg,
// to 24) so that a consumer thread holds 240 beside one other consumer
// warpgroup, 160 beside two.  dQ runs three consumer warpgroups at d 64
// (192 Q rows share each streamed KV tile), two at 128 and one at 256,
// where its 64 x 256 fp32 accumulator takes 128 registers a thread.  dK/dV
// runs three at d 64 and two at 128, a 64-row KV slice each, keeping dK and
// dV (D registers a thread), and two at 256 on one slice, one keeping dV
// and one dK (one launch; Q, dO and the row vectors read once, S^T
// computed by both).  Except at 256 with a causal mask and no bias, a Q
// tile goes through dK/dV in two passes of 32 Q rows, so that S^T and dP^T
// (and a bias's 16 values) take 16 registers each beside the accumulators.
//
// The grid's fastest axis is the tile, so that the CTAs of a wave share one
// head's K and V (dQ) or Q and dO (dK/dV) in L2; along it the longest work
// comes first: causal dQ from the last Q tile, causal dK/dV from the first
// KV tile.  A causal launch of at most two waves puts the tile on the
// slowest axis instead (heads_first), so that every head's longest tiles
// start in the first wave (llm-8b-gqa's causal dK/dV: 256 CTAs, each
// walking 4 heads).

constexpr int WG = 128;  // threads a warpgroup
constexpr int TILE = 64;  // rows of a staged tile; KV columns a dQ step, Q rows a dK/dV step
// A Q tile's rows of q_scale, lse2 or dvec, as dK/dV stages them: a TMA box
// starts 16-byte aligned in device memory (a box at another element faults),
// so each vector lands from its first row rounded down to a multiple of 4,
// VEC values, in a slot of VSLOT bytes (128-byte aligned, as TMA writes)
constexpr int VEC = TILE + 4;
constexpr int VSLOT = 384;

// a [TILE][D] tile of ELEM-byte elements as TMA lays it out
template <int D, int ELEM>
struct Tile {
  static constexpr int ROWB = D * ELEM < 128 ? D * ELEM : 128;  // bytes a panel row
  static constexpr int COLS = ROWB / ELEM;                       // columns a panel (a box)
  static constexpr int PANELS = D * ELEM / ROWB;
  static constexpr int BYTES = TILE * D * ELEM;
};
template <int D>
using TI8 = Tile<D, 1>;
template <int D>
using TBF = Tile<D, 2>;

// registers a thread of a consumer warpgroup beside a producer one at 24
template <int NWG>
constexpr int kConsumerRegs = NWG == 2 ? 240 : 160;  // (65536 - 24 x 128) / (128 NWG)

// rows [row0, row0 + TILE) of plane `plane` into dst, one box a panel
template <typename T>
__device__ inline void load_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                 int row0, int plane) {
#pragma unroll
  for (int p = 0; p < T::PANELS; ++p)
    tma_load_3d(dst + p * TILE * T::ROWB, map, bar, p * T::COLS, row0, plane);
}

__device__ inline unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// heads_first: the grid is (heads, b, tiles), not (tiles, heads, b) (see
// grid_of)
struct DqMaps {
  CUtensorMap q, dout, k, k_sm, v;
  int heads_first;
};

struct DkvMaps {
  CUtensorMap k, v, q, q_bf, dout, q_scale, lse2, dvec;
  int shift[3];  // offset of element 0 in the three 1-D maps (tensor_map_f32)
  int heads_first;
};

// this CTA's (tile, head, batch) and the tiles a head
struct GridPos {
  int tile, n_tiles, h, bi;
};
__device__ inline GridPos grid_pos(int heads_first) {
  return heads_first ? GridPos{(int)blockIdx.z, (int)gridDim.z, (int)blockIdx.x, (int)blockIdx.y}
                     : GridPos{(int)blockIdx.x, (int)gridDim.x, (int)blockIdx.y, (int)blockIdx.z};
}

template <int D>
constexpr int dq_nwg() { return D == 256 ? 1 : D == 64 ? 3 : 2; }
// the K/V ring's stages; kBiasTma gives d 128 two of its four to the bias
template <int D, int BIAS = kNoBias>
constexpr int dq_stages() { return D == 256 || (D == 128 && BIAS == kBiasTma) ? 2 : 4; }
// kBiasTma: the bias ring's stages (a variable: the kernel reads it too)
template <int D>
constexpr int kDqBiasStages = D == 256 ? 1 : 2;
// the Q ring's stages; kBiasTma gives d 128 two of its four to the bias
template <int D, int BIAS = kNoBias>
constexpr int dkv_stages() { return D == 256 || (D == 128 && BIAS == kBiasTma) ? 2 : 4; }
// kBiasTma (d 64 and 128): the bias ring's stages
template <int D>
constexpr int kDkvBiasStages = 2;

template <int D, int NWG, int STAGES, int BST = 0>
struct DqTma {
  static constexpr int q = 0;                          // NWG x int8 [64][D]
  static constexpr int dout = q + NWG * TI8<D>::BYTES;  // NWG x bf16 [64][D]
  static constexpr int ring = dout + NWG * TBF<D>::BYTES;
  static constexpr int k = 0, k_sm = TI8<D>::BYTES, v = k_sm + TBF<D>::BYTES;  // in a stage
  static constexpr int stage = v + TBF<D>::BYTES;       // also the bytes a stage posts
  // kBiasTma: BST stages of NWG bias tiles [64][64], the tile of warpgroup
  // w at w x 64 x 64 x the element's bytes, fp32 in two 32-column panels,
  // bf16 in one
  static constexpr int bias = ring + STAGES * stage;
  static constexpr int bstage = NWG * TILE * TILE * 4;
  static constexpr int bars = bias + BST * bstage;  // full, empty [STAGES], rows, bfull, bempty [BST]
  static constexpr int bytes = bars + (2 * STAGES + 1 + 2 * BST) * 8 + 1024;  // + the base's alignment
};

template <int D, int NWG, int STAGES, bool CAUSAL, bool WINDOW, int BIAS>
__global__ void __launch_bounds__(WG*(NWG + 1), 1)
sage_attn_bwd_dq_tma_kernel(const BwdArgs a, const __grid_constant__ DqMaps m,
                            const __grid_constant__ BiasOf<BIAS> ba) {
  constexpr int BST = BIAS == kBiasTma ? kDqBiasStages<D> : 0;
  using L = DqTma<D, NWG, STAGES, BST>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* rows_bar = empty + STAGES;
  uint64_t* bfull = rows_bar + 1;
  uint64_t* bempty = bfull + BST;

  const int hq = a.hq, sq = a.sq, sk = a.sk;
  const int window = WINDOW ? a.window : 0;
  const GridPos gp = grid_pos(m.heads_first);
  const int h = gp.h, bi = gp.bi;
  const int qt = CAUSAL ? gp.n_tiles - 1 - gp.tile : gp.tile;
  const int q0 = qt * TILE * NWG;
  const int plane_q = bi * hq + h, plane_kv = bi * a.hkv + h / (hq / a.hkv);
  int j_end = (sk + TILE - 1) / TILE;
  if (CAUSAL) j_end = min(j_end, (q0 + TILE * NWG - 1) / TILE + 1);
  const int j_first = window > 0 ? max(0, q0 - window + 1) / TILE : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * WG);
    }
    mbar_init(rows_bar, 1);
    for (int s = 0; s < BST; ++s) {
      mbar_init(&bfull[s], 1);
      mbar_init(&bempty[s], NWG * WG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == NWG) {  // the producer
    if constexpr (NWG > 1) regs_dec<24>();
    if (threadIdx.x % WG == 0) {
      int live = 0;  // warpgroups with a row below sq
      for (int w = 0; w < NWG; ++w) live += q0 + w * TILE < sq;
      mbar_expect_tx(rows_bar, live * (TI8<D>::BYTES + TBF<D>::BYTES));
      for (int w = 0; w < live; ++w) {
        load_tile<TI8<D>>(smem + L::q + w * TI8<D>::BYTES, &m.q, rows_bar, q0 + w * TILE, plane_q);
        load_tile<TBF<D>>(smem + L::dout + w * TBF<D>::BYTES, &m.dout, rows_bar, q0 + w * TILE,
                          plane_q);
      }
      int s = 0, ph = 0;
      [[maybe_unused]] int bs = 0, bph = 0;
      for (int j = j_first; j < j_end; ++j) {
        mbar_wait(&empty[s], ph ^ 1);
        unsigned char* st = smem + L::ring + s * L::stage;
        mbar_expect_tx(&full[s], L::stage);
        load_tile<TI8<D>>(st + L::k, &m.k, &full[s], j * TILE, plane_kv);
        load_tile<TBF<D>>(st + L::k_sm, &m.k_sm, &full[s], j * TILE, plane_kv);
        load_tile<TBF<D>>(st + L::v, &m.v, &full[s], j * TILE, plane_kv);
        if (++s == STAGES) s = 0, ph ^= 1;
        if constexpr (BST > 0) {
          // the bias tile of each warpgroup that computes tile j (live, and
          // not right of its causal diagonal), 128 bytes of each row a box
          const int es = ba.bf16 ? 2 : 4, tile_b = TILE * TILE * es;
          auto wants = [&](int w) {
            return q0 + w * TILE < sq && !(CAUSAL && j * TILE > q0 + w * TILE + TILE - 1);
          };
          int n = 0;
          for (int w = 0; w < NWG; ++w) n += wants(w);
          mbar_wait(&bempty[bs], bph ^ 1);
          mbar_expect_tx(&bfull[bs], n * tile_b);
          unsigned char* bt = smem + L::bias + bs * L::bstage;
          for (int w = 0; w < NWG; ++w) {
            if (!wants(w)) continue;
            for (int p = 0; p < es / 2; ++p)  // fp32: two 32-column panels
              tma_load_3d(bt + w * tile_b + p * TILE * 128, &ba.map, &bfull[bs],
                          j * TILE + p * (128 / es), q0 + w * TILE, plane_q);
          }
          if (++bs == BST) bs = 0, bph ^= 1;
        }
      }
    }
    return;
  }
  if constexpr (NWG > 1) regs_inc<kConsumerRegs<NWG>>();

  // a consumer: rows [q0w, q0w + 64), 16 a warp, two a thread
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0w = q0 + wg * TILE;
  const size_t row_base = (size_t)plane_q * sq;
  const int row0 = q0w + warp * 16 + g, row1 = row0 + 8;
  // rows past sq: P = 1 there, but dO = 0 makes their dS 0, and they are never stored
  const float qs0 = row0 < sq ? a.q_scale[row_base + row0] : 0.f;
  const float qs1 = row1 < sq ? a.q_scale[row_base + row1] : 0.f;
  const float ls0 = row0 < sq ? live_lse<BIAS>(a.lse2[row_base + row0]) : 0.f;
  const float ls1 = row1 < sq ? live_lse<BIAS>(a.lse2[row_base + row1]) : 0.f;
  const float dv0 = row0 < sq ? a.dvec[row_base + row0] : 0.f;
  const float dv1 = row1 < sq ? a.dvec[row_base + row1] : 0.f;
  const float* ks_row = a.k_scale + (size_t)plane_kv * ((sk + KGROUP - 1) / KGROUP);
  const uint32_t sQ = smem_u32(smem + L::q + wg * TI8<D>::BYTES);
  const uint32_t sDo = smem_u32(smem + L::dout + wg * TBF<D>::BYTES);

  float acc[D / 2];  // dQ: acc[4i + e] is column group i's C fragment
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const bool live = q0w < sq;
  if (live) mbar_wait(rows_bar, 0);
  // tile j sits in stage (j - j_first) % STAGES; a tile right of this
  // warpgroup's causal diagonal or left of its window is only waited for
  // and released
  auto skip = [&](int j) {
    const int kv0 = j * TILE;
    return !live || (CAUSAL && kv0 > q0w + TILE - 1) ||
           (window > 0 && kv0 + TILE - 1 <= q0w - window);
  };
  auto stage = [&](int j) {
    return smem_u32(smem + L::ring + ((j - j_first) % STAGES) * L::stage);
  };
  // S = Q.K^T (int8) and dP = dO.V^T (bf16) of tile j, issued
  auto issue = [&](int j, int (&s_i)[32], float (&dp)[32]) {
    const int i = j - j_first;
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    if (skip(j)) return;
    const uint32_t st = stage(j);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      wgmma_s8_ss<64>(s_i, desc_kmajor<TILE, TI8<D>::ROWB>(sQ, kk),
                      desc_kmajor<TILE, TI8<D>::ROWB>(st + L::k, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16_ss<64>(dp, desc_kmajor<TILE, 128>(sDo, kk), desc_kmajor<TILE, 128>(st + L::v, kk),
                        kk > 0);
    wgmma_commit();
  };
  // tile j's S and dP complete: P = exp2(l2 - lse2), masked, dS = P * (dP -
  // D) a column group at a time into bf16 A fragments, and dQ += bf16(dS) .
  // K_sm issued
  auto finish = [&](int j, int (&s_i)[32], float (&dp)[32]) {
    if (skip(j)) return;
    const int kv0 = j * TILE;
    const float ks = ks_row[kv0 / KGROUP];
    const float rs0 = qs0 * ks, rs1 = qs1 * ks;  // the forward's order
    const bool need_mask = (kv0 + TILE > sk) || (CAUSAL && kv0 + TILE - 1 > q0w) ||
                           (window > 0 && kv0 <= q0w + TILE - 1 - window);
    uint32_t af[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        float p = exp2f((float)s_i[4 * n + e] * (lo ? rs0 : rs1) - (lo ? ls0 : ls1));
        if (need_mask) {
          const int col = kv0 + n * 8 + t * 2 + (e & 1);
          const int row = lo ? row0 : row1;
          if (col >= sk || (CAUSAL && col > row) || (window > 0 && col <= row - window)) p = 0.f;
        }
        ds[e] = p * (dp[4 * n + e] - (lo ? dv0 : dv1));
      }
      // column group n is half (n & 1) of the A fragment of K step n / 2
      af[n / 2][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
      af[n / 2][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
    }
    const uint32_t st = stage(j);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_rs_mn<D>(acc, af[kk], desc_mnmajor<TILE>(st + L::k_sm, kk));
    wgmma_commit();
  };
  // (the same loop with the tile's work written in place ran the causal
  // instances at d 128 and 256 1.46-1.52x slower on an H100 80GB HBM3 at
  // 700 W, tools/ab_attention_bwd.py, with no cause the source shows)
  int s_i[32];
  float dp[32];
  if constexpr (BIAS == kNoBias) {
    for (int j = j_first; j < j_end; ++j) {
      issue(j, s_i, dp);
      wgmma_wait<0>();
      reg_fence(s_i, 32);
      reg_fence(dp, 32);
      finish(j, s_i, dp);
      wgmma_wait<0>();
      mbar_arrive(&empty[(j - j_first) % STAGES]);
    }
  } else {
    // The bias rows of the thread's two rows (rows past sq read the last
    // row, never stored), and at d 128 with kBiasLoads the tile's bias,
    // loaded while its S and dP run: column group n's pairs of row0 at bv[4n],
    // bv[4n + 1], of row1 at bv[4n + 2], bv[4n + 3] (bias_pair's x0, x1)
    constexpr bool HOLD = BIAS == kBiasLoads && D == 128;
    const size_t brow0 = (row_base + min(row0, sq - 1)) * (size_t)sk;
    // row1's: 8 rows on, or row0's where row1 is past sq (never stored)
    const size_t brow1 = brow0 + (row1 < sq ? 8 * sk : 0);
    auto load_bias = [&](int j, uint32_t (&bv)[HOLD ? 32 : 1]) {
      if constexpr (HOLD) {
        if (skip(j)) return;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = j * TILE + n * 8 + t * 2;
          bias_pair(ba, brow0, col, sk, bv[4 * n], bv[4 * n + 1]);
          bias_pair(ba, brow1, col, sk, bv[4 * n + 2], bv[4 * n + 3]);
        }
      }
    };
    // finish with the bias: l2 + bias log2(e), clamped, and dS in fp32 into
    // dBias when asked; the bias from the bias ring (kBiasTma), from bv
    // (HOLD) or loaded here
    auto finish_bias = [&](int j, int (&s_i)[32], float (&dp)[32], uint32_t (&bv)[HOLD ? 32 : 1]) {
      [[maybe_unused]] const int bslot = (j - j_first) % (BST > 0 ? BST : 1);
      if constexpr (BST > 0) mbar_wait(&bfull[bslot], ((j - j_first) / BST) & 1);
      if (skip(j)) {
        if constexpr (BST > 0) mbar_arrive(&bempty[bslot]);
        return;
      }
      const int kv0 = j * TILE;
      const float ks = ks_row[kv0 / KGROUP];
      const float rs0 = qs0 * ks, rs1 = qs1 * ks;  // the forward's order
      const bool need_mask = (kv0 + TILE > sk) || (CAUSAL && kv0 + TILE - 1 > q0w);
      // kBiasTma: this warpgroup's tile; rows r and r + 8 of the fragment
      // (r = 16 warp + g) in 128-byte swizzled rows (chunk c of row r at c ^ g)
      [[maybe_unused]] const uint32_t bt =
          smem_u32(smem + L::bias + bslot * L::bstage + wg * TILE * TILE * (ba.bf16 ? 2 : 4)) +
          (warp * 16 + g) * 128;
      uint32_t af[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = kv0 + n * 8 + t * 2;
        uint32_t b[4];  // row0's pair in b[0], b[1], row1's in b[2], b[3]
        if constexpr (BST > 0) {
          if (ba.bf16) {
            const uint32_t o = ((n ^ g) << 4) + t * 4;
            b[0] = lds32(bt + o);
            b[2] = lds32(bt + 8 * 128 + o);
            b[1] = b[3] = 0;
          } else {
            const uint32_t o =
                (n >> 2) * TILE * 128 + (((2 * (n & 3) + (t >> 1)) ^ g) << 4) + (t & 1) * 8;
            lds64(bt + o, b[0], b[1]);
            lds64(bt + 8 * 128 + o, b[2], b[3]);
          }
        } else if constexpr (HOLD) {
#pragma unroll
          for (int e = 0; e < 4; ++e) b[e] = bv[4 * n + e];
        } else {
          bias_pair(ba, brow0, col, sk, b[0], b[1]);
          bias_pair(ba, brow1, col, sk, b[2], b[3]);
        }
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const float bias = pair_value(ba.bf16, b[lo ? 0 : 2], b[lo ? 1 : 3], e & 1);
          float p = biased_p((float)s_i[4 * n + e] * (lo ? rs0 : rs1), bias, lo ? ls0 : ls1);
          if (need_mask) {
            const int c = col + (e & 1);
            if (c >= sk || (CAUSAL && c > (lo ? row0 : row1))) p = 0.f;
          }
          ds[e] = p * (dp[4 * n + e] - (lo ? dv0 : dv1));
        }
        if (ba.dbias != nullptr) {
          if (row0 < sq) dbias_pair(ba, brow0, col, sk, ds[0], ds[1]);
          if (row1 < sq) dbias_pair(ba, brow1, col, sk, ds[2], ds[3]);
        }
        af[n / 2][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
        af[n / 2][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
      }
      if constexpr (BST > 0) mbar_arrive(&bempty[bslot]);
      const uint32_t st = stage(j);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16_rs_mn<D>(acc, af[kk], desc_mnmajor<TILE>(st + L::k_sm, kk));
      wgmma_commit();
    };
    uint32_t bv[HOLD ? 32 : 1];
    for (int j = j_first; j < j_end; ++j) {
      if constexpr (BIAS == kBiasLoads) {
        // the next tile's bias of this warp's 16 rows into L2, a 32-column
        // half row a lane
        if (live && j + 1 < j_end && !skip(j + 1))
          prefetch_l2(static_cast<const unsigned char*>(ba.bias) +
                      (((row_base + min(q0w + warp * 16 + (lane >> 1), sq - 1)) * sk +
                        min((j + 1) * TILE + (lane & 1) * 32, sk - 1)) << ba.shift));
      }
      issue(j, s_i, dp);
      load_bias(j, bv);
      wgmma_wait<0>();
      reg_fence(s_i, 32);
      reg_fence(dp, 32);
      finish_bias(j, s_i, dp, bv);
      wgmma_wait<0>();
      mbar_arrive(&empty[(j - j_first) % STAGES]);
    }
    // causal: the columns right of this warpgroup's diagonal tile read 0 in
    // dBias, a warp a row
    if constexpr (CAUSAL) {
      if (ba.dbias != nullptr && live && q0w + TILE < sk) {
        for (int r = warp; r < TILE && q0w + r < sq; r += 4)
          dbias_zeros(ba, (row_base + q0w + r) * (size_t)sk, q0w + TILE, sk, lane);
      }
    }
  }
  reg_fence(acc, D / 2);

  // epilogue: dq = acc * sm_scale, rows < sq
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + t * 2;
    if (row0 < sq)
      *reinterpret_cast<float2*>(a.dq + (row_base + row0) * D + col) =
          make_float2(acc[4 * i] * a.sm_scale, acc[4 * i + 1] * a.sm_scale);
    if (row1 < sq)
      *reinterpret_cast<float2*>(a.dq + (row_base + row1) * D + col) =
          make_float2(acc[4 * i + 2] * a.sm_scale, acc[4 * i + 3] * a.sm_scale);
  }
}

// dK/dV: KV = the 64-row KV slices a CTA owns, one a consumer warpgroup, or
// at D = 256 one shared by the dV and the dK warpgroup
template <int D, int STAGES, int BST = 0>
struct DkvTma {
  static constexpr int KV = D == 256 ? 1 : D == 64 ? 3 : 2;
  static constexpr int NWG = D == 256 ? 2 : KV;  // consumer warpgroups
  static constexpr int k = 0;                           // KV x int8 [64][D]
  static constexpr int v = k + KV * TI8<D>::BYTES;       // KV x bf16 [64][D]
  static constexpr int ring = v + KV * TBF<D>::BYTES;
  // in a stage: int8 Q, bf16 Q, dO, then q_scale, lse2, dvec [VEC] fp32
  static constexpr int q = 0, q_bf = TI8<D>::BYTES, dout = q_bf + TBF<D>::BYTES;
  static constexpr int vec = dout + TBF<D>::BYTES;
  static constexpr int posted = vec + 3 * VEC * 4;       // the bytes a stage posts
  static constexpr int stage = vec + 3 * VSLOT + 896;    // 1024-byte aligned stages
  // kBiasTma: BST stages of the bias at a Q tile's rows and the CTA's KV
  // columns, slice x's [64][64] at x x 64 x 64 x the element's bytes, fp32
  // in two 32-column panels, bf16 in one
  static constexpr int bias = ring + STAGES * stage;
  static constexpr int bstage = KV * TILE * TILE * 4;
  static constexpr int bars = bias + BST * bstage;  // full, empty [STAGES], rows, bfull, bempty [BST]
  static constexpr int bytes = bars + (2 * STAGES + 1 + 2 * BST) * 8 + 1024;
};

// which of dK and dV a consumer warpgroup keeps: both (D <= 128), or at
// D = 256 one of them
enum DkvPart { kDV = 1, kDK = 2, kDKV = 3 };

// One consumer warpgroup's dK/dV work for KV rows [kvs, kvs + 64): PART
// kDV, kDK or both
template <int D, int STAGES, bool CAUSAL, bool WINDOW, int PART, int BIAS>
__device__ __forceinline__ void dkv_consumer(const BwdArgs& a, const BiasOf<BIAS>& ba,
                                    unsigned char* smem, uint64_t* full,
                                    uint64_t* empty, uint64_t* rows_bar, uint64_t* bfull,
                                    const int* shift, int hk, int bi, int slice, int kv0,
                                    int qt0, int n_qt) {
  constexpr int BST = BIAS == kBiasTma ? kDkvBiasStages<D> : 0;
  using L = DkvTma<D, STAGES, BST>;
  [[maybe_unused]] uint64_t* bempty = bfull + BST;
  constexpr bool WANT_V = PART & kDV, WANT_K = PART & kDK;
  // Q rows a pass over a Q tile: 64 where one pass holds no stack (causal
  // and windowed at 256 without a bias; a bias keeps two), else 32, so that
  // S^T and dP^T take 16 registers each (one pass spilled 8-40 bytes at 128
  // and at 256 without a mask; three warpgroups at d 64 hold 160 registers
  // a thread)
  constexpr int NQ = D == 256 && CAUSAL && BIAS == kNoBias ? TILE : TILE / 2;
  const int hq = a.hq, hkv = a.hkv, sq = a.sq, sk = a.sk;
  const int window = WINDOW ? a.window : 0;
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rep = hq / hkv;
  const int kvs = kv0 + slice * TILE;
  const int kr0 = kvs + warp * 16 + g, kr1 = kr0 + 8;  // this thread's KV rows
  const size_t kv_row_base = ((size_t)bi * hkv + hk) * sk;
  const float ks = a.k_scale[((size_t)bi * hkv + hk) * ((sk + KGROUP - 1) / KGROUP) + kvs / KGROUP];
  const uint32_t sK = smem_u32(smem + L::k + slice * TI8<D>::BYTES);
  const uint32_t sV = smem_u32(smem + L::v + slice * TBF<D>::BYTES);

  float acc_v[WANT_V ? D / 2 : 1], acc_k[WANT_K ? D / 2 : 1];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    if constexpr (WANT_V) acc_v[i] = 0.f;
    if constexpr (WANT_K) acc_k[i] = 0.f;
  }

  const bool live = kvs < sk;
  if (live) mbar_wait(rows_bar, 0);
  // this thread's KV rows past sk (masked), and its rows relative to
  // column 2t of a Q tile (the causal and window masks)
  const bool kr0_out = kr0 >= sk, kr1_out = kr1 >= sk;
  const int nq = n_qt - qt0;  // Q tiles a head
  int s = 0, ph = 0;
  for (int it = 0; it < rep * nq; ++it) {  // every q head of the group, every Q tile
    const int q0 = (qt0 + it % nq) * TILE;
    mbar_wait(&full[s], ph);
    // kBiasTma: the tile's bias lands in stage it % BST of the bias ring
    [[maybe_unused]] const int bslot = it % (BST > 0 ? BST : 1);
    if constexpr (BST > 0) mbar_wait(&bfull[bslot], (it / BST) & 1);
    const bool skip = !live || (CAUSAL && q0 + TILE - 1 < kvs) ||
                      (window > 0 && kvs + TILE - 1 <= q0 - window);
    if (!skip) {
      unsigned char* stp = smem + L::ring + s * L::stage;
      const uint32_t st = smem_u32(stp);
      // kBiasTma: this slice's tile, Q row q at byte 128 q of each panel,
      // swizzled (chunk c of row q at c ^ (q & 7))
      [[maybe_unused]] uint32_t bt = 0;
      if constexpr (BST > 0)
        bt = smem_u32(smem + L::bias + bslot * L::bstage) + slice * TILE * TILE * (ba.bf16 ? 2 : 4);
      // the tile's row vectors, q_scale, lse2 and dvec of Q row q0 + i at
      // [i] (each landed from the 16-byte aligned element at or before row q0)
      const int r = (bi * hq + hk * rep + it / nq) * sq + q0;
      const float* vqs = reinterpret_cast<const float*>(stp + L::vec) + ((r + shift[0]) & 3);
      const float* vls =
          reinterpret_cast<const float*>(stp + L::vec + VSLOT) + ((r + shift[1]) & 3);
      const float* vdv =
          reinterpret_cast<const float*>(stp + L::vec + 2 * VSLOT) + ((r + shift[2]) & 3);
      const bool need_mask = (q0 + TILE > sq) || (kvs + TILE > sk) ||
                             (CAUSAL && kvs + TILE - 1 > q0) ||
                             (window > 0 && kvs <= q0 + TILE - 1 - window);
      // for element (n, e) of a pass: Q row q0 + c0 + 2t + 8n + (e & 1), KV
      // row kr0 or kr1
      const int q_left = sq - q0 - 2 * t;  // Q rows past sq: c0 + 8n + (e & 1) >= q_left
      const int rel = kr0 - q0 - 2 * t;    // kr - qr = rel + 8 (e >= 2) - c0 - 8n - (e & 1)
#pragma unroll
      for (int c0 = 0; c0 < TILE; c0 += NQ) {  // the tile's Q rows, NQ a pass
        int s_i[NQ / 2];
        float dp[WANT_K ? NQ / 2 : 1];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk)  // S^T = K.Q^T
          wgmma_s8_ss<NQ>(s_i, desc_kmajor<TILE, TI8<D>::ROWB>(sK, kk),
                          desc_kmajor<TILE, TI8<D>::ROWB>(st + L::q + c0 * TI8<D>::ROWB, kk),
                          kk > 0);
        if constexpr (WANT_K) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V.dO^T
            wgmma_bf16_ss<NQ>(dp, desc_kmajor<TILE, 128>(sV, kk),
                              desc_kmajor<TILE, 128>(st + L::dout + c0 * 128, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(s_i, NQ / 2);
        if constexpr (WANT_K) reg_fence(dp, NQ / 2);
        // P^T = exp2(l2 - lse2), masked, and dS^T = P^T * (dP^T - D), a
        // column group at a time (so P^T never takes a whole tile of fp32
        // registers), into bf16 A fragments; the Q tile's row vectors as
        // float2 pairs of the fragment's two columns
        uint32_t pa[WANT_V ? NQ / 16 : 1][4], da[WANT_K ? NQ / 16 : 1][4];
#pragma unroll
        for (int n = 0; n < NQ / 8; ++n) {
          const int c = c0 + n * 8 + t * 2;  // Q row within the tile
          const float2 qs2 = make_float2(vqs[c], vqs[c + 1]);
          const float2 ls2 = make_float2(vls[c], vls[c + 1]);
          // BIAS: bias[q row, kv row] of the group's elements (rows past sq,
          // sk read the last ones), offsets from the tile's first bias row
          uint32_t bv[BIAS != kNoBias ? 4 : 1];
          if constexpr (BIAS == kBiasTma) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = c + (e & 1), kvl = warp * 16 + g + (e < 2 ? 0 : 8);
              bv[e] = ba.bf16 ? lds16(bt + q * 128 + ((((kvl >> 3) ^ (q & 7)) << 4) | ((kvl & 7) << 1)))
                              : lds32(bt + (kvl >> 5) * TILE * 128 + q * 128 +
                                      ((((kvl & 31) >> 2) ^ (q & 7)) << 4) + ((kvl & 3) << 2));
            }
          } else if constexpr (BIAS == kBiasLoads) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              bv[e] = bias_one(ba, (size_t)r * sk + min(c + (e & 1), sq - 1 - q0) * sk +
                                       min(e < 2 ? kr0 : kr1, sk - 1));
          }
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            float pv;
            if constexpr (BIAS != kNoBias) {
              pv = biased_p((float)s_i[4 * n + e] * ((odd ? qs2.y : qs2.x) * ks),
                            one_value(ba.bf16, bv[e]),
                            live_lse<BIAS>(odd ? ls2.y : ls2.x));
            } else {
              pv = exp2f((float)s_i[4 * n + e] * ((odd ? qs2.y : qs2.x) * ks) -
                         (odd ? ls2.y : ls2.x));
            }
            if (need_mask) {
              const int d_kq = rel + (e < 2 ? 0 : 8) - c0 - 8 * n - odd;  // kr - qr
              if (c0 + 8 * n + odd >= q_left || (e < 2 ? kr0_out : kr1_out) ||
                  (CAUSAL && d_kq > 0) || (window > 0 && d_kq <= -window))
                pv = 0.f;
            }
            p[e] = pv;
          }
          // column group n is half (n & 1) of the A fragment of K step n / 2
          if constexpr (WANT_V) {
            pa[n / 2][2 * (n & 1)] = pack_bf16(p[0], p[1]);
            pa[n / 2][2 * (n & 1) + 1] = pack_bf16(p[2], p[3]);
          }
          if constexpr (WANT_K) {
            const float2 dv2 = make_float2(vdv[c], vdv[c + 1]);
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ds[e] = p[e] * (dp[4 * n + e] - ((e & 1) ? dv2.y : dv2.x));
            da[n / 2][2 * (n & 1)] = pack_bf16(ds[0], ds[1]);
            da[n / 2][2 * (n & 1) + 1] = pack_bf16(ds[2], ds[3]);
          }
        }
        // dV += bf16(P^T) . dO, dK += bf16(dS^T) . Q over the pass's Q rows
        wgmma_fence();
        if constexpr (WANT_V) {
#pragma unroll
          for (int kk = 0; kk < NQ / 16; ++kk)
            wgmma_bf16_rs_mn<D>(acc_v, pa[kk], desc_mnmajor<TILE>(st + L::dout, c0 / 16 + kk));
        }
        if constexpr (WANT_K) {
#pragma unroll
          for (int kk = 0; kk < NQ / 16; ++kk)
            wgmma_bf16_rs_mn<D>(acc_k, da[kk], desc_mnmajor<TILE>(st + L::q_bf, c0 / 16 + kk));
        }
        wgmma_commit();
        wgmma_wait<0>();
      }
      if constexpr (WANT_V) reg_fence(acc_v, D / 2);
      if constexpr (WANT_K) reg_fence(acc_k, D / 2);
    }
    if constexpr (BST > 0) mbar_arrive(&bempty[bslot]);
    mbar_arrive(&empty[s]);
    if (++s == STAGES) s = 0, ph ^= 1;
  }

  // epilogue: dk = acc_k * sm_scale, dv = acc_v, rows < sk
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + t * 2;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int kr = hi ? kr1 : kr0;
      if (kr >= sk) continue;
      const size_t o = (kv_row_base + kr) * D + col;
      if constexpr (WANT_K)
        *reinterpret_cast<float2*>(a.dk + o) =
            make_float2(acc_k[4 * i + 2 * hi] * a.sm_scale, acc_k[4 * i + 2 * hi + 1] * a.sm_scale);
      if constexpr (WANT_V)
        *reinterpret_cast<float2*>(a.dv + o) = make_float2(acc_v[4 * i + 2 * hi], acc_v[4 * i + 2 * hi + 1]);
    }
  }
}

template <int D, int STAGES, bool CAUSAL, bool WINDOW, int BIAS>
__global__ void __launch_bounds__(WG*(DkvTma<D, STAGES>::NWG + 1), 1)
sage_attn_bwd_dkv_tma_kernel(const BwdArgs a, const __grid_constant__ DkvMaps m,
                             const __grid_constant__ BiasOf<BIAS> ba) {
  constexpr int BST = BIAS == kBiasTma ? kDkvBiasStages<D> : 0;
  using L = DkvTma<D, STAGES, BST>;
  constexpr int KV = L::KV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* rows_bar = empty + STAGES;
  uint64_t* bfull = rows_bar + 1;
  uint64_t* bempty = bfull + BST;

  const int hq = a.hq, hkv = a.hkv, sq = a.sq, sk = a.sk;
  const int window = WINDOW ? a.window : 0;
  const GridPos gp = grid_pos(m.heads_first);
  const int hk = gp.h, bi = gp.bi, rep = hq / hkv;
  const int kv0 = gp.tile * TILE * KV;  // causal: the longest columns first
  const int qt0 = CAUSAL ? kv0 / TILE : 0;
  int n_qt = (sq + TILE - 1) / TILE;
  if (window > 0)  // up to the last Q row whose window reaches this tile
    n_qt = min(n_qt, (kv0 + TILE * KV - 1 + window - 1) / TILE + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::NWG * WG);
    }
    mbar_init(rows_bar, 1);
    for (int s = 0; s < BST; ++s) {
      mbar_init(&bfull[s], 1);
      mbar_init(&bempty[s], L::NWG * WG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == L::NWG) {  // the producer
    regs_dec<24>();
    if (threadIdx.x % WG == 0) {
      const int plane_kv = bi * hkv + hk;
      int live = 0;  // KV slices with a row below sk
      for (int x = 0; x < KV; ++x) live += kv0 + x * TILE < sk;
      mbar_expect_tx(rows_bar, live * (TI8<D>::BYTES + TBF<D>::BYTES));
      for (int x = 0; x < live; ++x) {
        load_tile<TI8<D>>(smem + L::k + x * TI8<D>::BYTES, &m.k, rows_bar, kv0 + x * TILE, plane_kv);
        load_tile<TBF<D>>(smem + L::v + x * TBF<D>::BYTES, &m.v, rows_bar, kv0 + x * TILE, plane_kv);
      }
      int s = 0, ph = 0;
      [[maybe_unused]] int bs = 0, bph = 0;
      for (int hh = 0; hh < rep; ++hh) {
        const int plane = bi * hq + hk * rep + hh;
        for (int qt = qt0; qt < n_qt; ++qt) {
          mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = smem + L::ring + s * L::stage;
          mbar_expect_tx(&full[s], L::posted);
          load_tile<TI8<D>>(st + L::q, &m.q, &full[s], qt * TILE, plane);
          load_tile<TBF<D>>(st + L::q_bf, &m.q_bf, &full[s], qt * TILE, plane);
          load_tile<TBF<D>>(st + L::dout, &m.dout, &full[s], qt * TILE, plane);
          const int r = plane * sq + qt * TILE;
          tma_load_1d(st + L::vec, &m.q_scale, &full[s], (r + m.shift[0]) & ~3);
          tma_load_1d(st + L::vec + VSLOT, &m.lse2, &full[s], (r + m.shift[1]) & ~3);
          tma_load_1d(st + L::vec + 2 * VSLOT, &m.dvec, &full[s], (r + m.shift[2]) & ~3);
          if (++s == STAGES) s = 0, ph ^= 1;
          if constexpr (BST > 0) {
            // the bias at the tile's Q rows and each KV slice that computes
            // the tile (live, and not above its causal diagonal)
            const int es = ba.bf16 ? 2 : 4, tile_b = TILE * TILE * es;
            auto wants = [&](int x) {
              return kv0 + x * TILE < sk && !(CAUSAL && qt * TILE + TILE - 1 < kv0 + x * TILE);
            };
            int n = 0;
            for (int x = 0; x < KV; ++x) n += wants(x);
            mbar_wait(&bempty[bs], bph ^ 1);
            mbar_expect_tx(&bfull[bs], n * tile_b);
            unsigned char* bt = smem + L::bias + bs * L::bstage;
            for (int x = 0; x < KV; ++x) {
              if (!wants(x)) continue;
              for (int p = 0; p < es / 2; ++p)  // fp32: two 32-column panels
                tma_load_3d(bt + x * tile_b + p * TILE * 128, &ba.map, &bfull[bs],
                            kv0 + x * TILE + p * (128 / es), qt * TILE, plane);
            }
            if (++bs == BST) bs = 0, bph ^= 1;
          }
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs<L::NWG>>();
  if constexpr (KV == 1) {  // D = 256: warpgroup 0 keeps dV, warpgroup 1 dK
    if (wg == 0)
      dkv_consumer<D, STAGES, CAUSAL, WINDOW, kDV, BIAS>(a, ba, smem, full, empty, rows_bar,
                                                         bfull, m.shift, hk, bi, 0, kv0, qt0,
                                                         n_qt);
    else
      dkv_consumer<D, STAGES, CAUSAL, WINDOW, kDK, BIAS>(a, ba, smem, full, empty, rows_bar,
                                                         bfull, m.shift, hk, bi, 0, kv0, qt0,
                                                         n_qt);
  } else {
    dkv_consumer<D, STAGES, CAUSAL, WINDOW, kDKV, BIAS>(a, ba, smem, full, empty, rows_bar,
                                                        bfull, m.shift, hk, bi, wg, kv0, qt0,
                                                        n_qt);
  }
}

// the tensor maps of a [planes, rows, D] operand, in the boxes of its tile
template <int D, int ELEM>
bool tile_map(CUtensorMap* map, const void* p, long long planes, int rows) {
  return tensor_map_3d(map, p, ELEM == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       ELEM, planes, rows, D, TILE, Tile<D, ELEM>::COLS);
}

// The launch grid of n_tiles tiles x heads x b, with the tile on the
// fastest axis, or on the slowest (*heads_first) for a causal launch without
// a window that fills at most two waves of one CTA an SM
inline dim3 grid_of(int n_tiles, int heads, int b, bool causal_band, int* heads_first) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *heads_first = causal_band && (long long)n_tiles * heads * b <= 2LL * sms;
  return *heads_first ? dim3(heads, b, n_tiles) : dim3(n_tiles, heads, b);
}

template <typename Kern, typename M, typename B>
int launch_tma(Kern kern, int smem, dim3 grid, int threads, cudaStream_t st, const BwdArgs& a,
               const M& m, const B& ba) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, st>>>(a, m, ba);
  return (int)cudaGetLastError();
}

// (causal, window) picks the instance; a bias comes without a window
template <int D, int BIAS>
int launch_dq_tma(int b, int causal, cudaStream_t st, const BwdArgs& a, const BiasOf<BIAS>& ba) {
  constexpr int NWG = dq_nwg<D>(), STAGES = dq_stages<D, BIAS>();
  constexpr int smem = DqTma<D, NWG, STAGES, BIAS == kBiasTma ? kDqBiasStages<D> : 0>::bytes;
  const long long pq = (long long)b * a.hq, pk = (long long)b * a.hkv;
  DqMaps m;
  if (!tile_map<D, 1>(&m.q, a.q_i8, pq, a.sq) || !tile_map<D, 2>(&m.dout, a.dout, pq, a.sq) ||
      !tile_map<D, 1>(&m.k, a.k_i8, pk, a.sk) || !tile_map<D, 2>(&m.k_sm, a.k_sm, pk, a.sk) ||
      !tile_map<D, 2>(&m.v, a.v, pk, a.sk))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of((a.sq + TILE * NWG - 1) / (TILE * NWG), a.hq, b,
                            causal && a.window == 0, &m.heads_first);
  const int threads = WG * (NWG + 1);
  if constexpr (BIAS == kNoBias) {
    if (a.window > 0)
      return launch_tma(sage_attn_bwd_dq_tma_kernel<D, NWG, STAGES, true, true, BIAS>, smem, grid,
                        threads, st, a, m, ba);
  }
  return causal ? launch_tma(sage_attn_bwd_dq_tma_kernel<D, NWG, STAGES, true, false, BIAS>, smem,
                             grid, threads, st, a, m, ba)
                : launch_tma(sage_attn_bwd_dq_tma_kernel<D, NWG, STAGES, false, false, BIAS>, smem,
                             grid, threads, st, a, m, ba);
}

template <int D, int BIAS>
int launch_dkv_tma(int b, int causal, cudaStream_t st, const BwdArgs& a, const BiasOf<BIAS>& ba) {
  constexpr int STAGES = dkv_stages<D, BIAS>();
  using L = DkvTma<D, STAGES, BIAS == kBiasTma ? kDkvBiasStages<D> : 0>;
  const long long pq = (long long)b * a.hq, pk = (long long)b * a.hkv;
  DkvMaps m;
  if (!tile_map<D, 1>(&m.k, a.k_i8, pk, a.sk) || !tile_map<D, 2>(&m.v, a.v, pk, a.sk) ||
      !tile_map<D, 1>(&m.q, a.q_i8, pq, a.sq) || !tile_map<D, 2>(&m.q_bf, a.q_bf, pq, a.sq) ||
      !tile_map<D, 2>(&m.dout, a.dout, pq, a.sq) ||
      !tensor_map_f32(&m.q_scale, a.q_scale, pq * a.sq, VEC, &m.shift[0]) ||
      !tensor_map_f32(&m.lse2, a.lse2, pq * a.sq, VEC, &m.shift[1]) ||
      !tensor_map_f32(&m.dvec, a.dvec, pq * a.sq, VEC, &m.shift[2]))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of((a.sk + TILE * L::KV - 1) / (TILE * L::KV), a.hkv, b,
                            causal && a.window == 0, &m.heads_first);
  const int threads = WG * (L::NWG + 1);
  if constexpr (BIAS == kNoBias) {
    if (a.window > 0)
      return launch_tma(sage_attn_bwd_dkv_tma_kernel<D, STAGES, true, true, BIAS>, L::bytes, grid,
                        threads, st, a, m, ba);
  }
  return causal ? launch_tma(sage_attn_bwd_dkv_tma_kernel<D, STAGES, true, false, BIAS>, L::bytes,
                             grid, threads, st, a, m, ba)
                : launch_tma(sage_attn_bwd_dkv_tma_kernel<D, STAGES, false, false, BIAS>, L::bytes,
                             grid, threads, st, a, m, ba);
}

// head dims 64, 128 and 256, with a bias or without
bool bad_shape(int hq, int hkv, int d, int group, int causal, int window) {
  return group != KGROUP || hkv <= 0 || hq % hkv != 0 || (d != 64 && d != 128 && d != 256) ||
         window < 0 || (window > 0 && !causal);
}

// The entry points' common body: check, head dim, instance
template <int BIAS>
int run_dq(const BwdArgs& a, const BiasOf<BIAS>& ba, int b, int d, int causal, int group,
           void* stream) {
  if (bad_shape(a.hq, a.hkv, d, group, causal, a.window)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64) return launch_dq_tma<64, BIAS>(b, causal, st, a, ba);
  if (d == 256) return launch_dq_tma<256, BIAS>(b, causal, st, a, ba);
  return launch_dq_tma<128, BIAS>(b, causal, st, a, ba);
}

template <int BIAS>
int run_dkv(const BwdArgs& a, const BiasOf<BIAS>& ba, int b, int d, int causal, int group,
            void* stream) {
  if (bad_shape(a.hq, a.hkv, d, group, causal, a.window)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64) return launch_dkv_tma<64, BIAS>(b, causal, st, a, ba);
  if (d == 256) {
    // a bias tile beside the d 256 ring does not fit: the threads load it
    if constexpr (BIAS == kBiasTma) return (int)cudaErrorInvalidValue;
    else return launch_dkv_tma<256, BIAS>(b, causal, st, a, ba);
  }
  return launch_dkv_tma<128, BIAS>(b, causal, st, a, ba);
}

// The bias operands of an entry point; kBiasTma also encodes the bias's
// tensor map (false if the bias cannot be mapped: a row of sk elements is
// not a multiple of 16 bytes, or the base is not 16-byte aligned)
bool bias_args(BiasArgs* ba, const void* bias, void* dbias, int bf16, long long planes, int sq,
               int sk, bool tma) {
  const int es = bf16 ? 2 : 4;
  auto aligned = [&](const void* p) { return (reinterpret_cast<uintptr_t>(p) % (2 * es)) == 0; };
  ba->bias = bias;
  ba->dbias = dbias;
  ba->bf16 = bf16;
  ba->shift = bf16 ? 1 : 2;
  ba->pairs = sk % 2 == 0 && aligned(bias) && (dbias == nullptr || aligned(dbias));
  return !tma || tensor_map_3d(&ba->map, bias, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                               es, planes, sq, sk, TILE, 128 / es);
}

}  // namespace

// Shapes (all contiguous, d in {64, 128, 256}, hq a multiple of hkv):
//   q_i8 int8 [b,hq,sq,d]; q_scale fp32 [b,hq,sq] (sm_scale*log2e folded);
//   k_i8 int8 [b,hkv,sk,d]; k_scale fp32 [b,hkv,ceil(sk/group)], group 128;
//   k_sm, v bf16 [b,hkv,sk,d]; q_bf, dout bf16 [b,hq,sq,d];
//   lse2 (base 2), dvec fp32 [b,hq,sq]; dq fp32 [b,hq,sq,d]; dk, dv fp32
//   [b,hkv,sk,d]; window > 0 (with causal only) keeps col > row - window.
extern "C" int sage_attn_bwd_dq(const void* q_i8, const void* q_scale, const void* k_i8,
                                const void* k_scale, const void* k_sm, const void* v,
                                const void* dout, const void* lse2, const void* dvec,
                                void* dq, int b, int hq, int hkv, int sq, int sk, int d,
                                int causal, int window, int group, float sm_scale,
                                void* stream) {
  const BwdArgs a{(const int8_t*)q_i8, (const float*)q_scale, nullptr, (const int8_t*)k_i8,
                  (const float*)k_scale, (const __nv_bfloat16*)k_sm, (const __nv_bfloat16*)v,
                  (const __nv_bfloat16*)dout, (const float*)lse2, (const float*)dvec,
                  (float*)dq, nullptr, nullptr, hq, hkv, sq, sk, sm_scale, window};
  return run_dq<kNoBias>(a, NoBias{}, b, d, causal, group, stream);
}

extern "C" int sage_attn_bwd_dkv(const void* q_i8, const void* q_scale, const void* q_bf,
                                 const void* k_i8, const void* k_scale, const void* v,
                                 const void* dout, const void* lse2, const void* dvec,
                                 void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
                                 int d, int causal, int window, int group, float sm_scale,
                                 void* stream) {
  const BwdArgs a{(const int8_t*)q_i8, (const float*)q_scale, (const __nv_bfloat16*)q_bf,
                  (const int8_t*)k_i8, (const float*)k_scale, nullptr, (const __nv_bfloat16*)v,
                  (const __nv_bfloat16*)dout, (const float*)lse2, (const float*)dvec, nullptr,
                  (float*)dk, (float*)dv, hq, hkv, sq, sk, sm_scale, window};
  return run_dkv<kNoBias>(a, NoBias{}, b, d, causal, group, stream);
}

// The bias instances: the operands of sage_attn_bwd_dq / sage_attn_bwd_dkv
// without the window, d 64, 128 or 256, and the bias [b,hq,sq,sk],
// contiguous, indexed by the query head; dbias (dQ only) its shape and type,
// or null for no dBias.  Every element of dbias is written: dS where the
// kernel computes it, 0 right of the causal diagonal.  bias_kind: bit 0 the
// bias is bf16 (else fp32); bit 1 each thread loads its bias from device
// memory (kBiasLoads, any sk), else the producer stages it by TMA
// (kBiasTma: sk a multiple of 16 bytes and a 16-byte aligned bias, or
// cudaErrorInvalidValue); dK/dV at d 256 loads it either way.
extern "C" int sage_attn_bwd_dq_bias(const void* q_i8, const void* q_scale, const void* k_i8,
                                     const void* k_scale, const void* k_sm, const void* v,
                                     const void* dout, const void* lse2, const void* dvec,
                                     void* dq, const void* bias, void* dbias, int b, int hq,
                                     int hkv, int sq, int sk, int d, int causal, int bias_kind,
                                     int group, float sm_scale, void* stream) {
  const BwdArgs a{(const int8_t*)q_i8, (const float*)q_scale, nullptr, (const int8_t*)k_i8,
                  (const float*)k_scale, (const __nv_bfloat16*)k_sm, (const __nv_bfloat16*)v,
                  (const __nv_bfloat16*)dout, (const float*)lse2, (const float*)dvec,
                  (float*)dq, nullptr, nullptr, hq, hkv, sq, sk, sm_scale, 0};
  const bool tma = !(bias_kind & 2);
  BiasArgs ba;
  if (bias == nullptr || !bias_args(&ba, bias, dbias, bias_kind & 1, (long long)b * hq, sq, sk, tma))
    return (int)cudaErrorInvalidValue;
  return tma ? run_dq<kBiasTma>(a, ba, b, d, causal, group, stream)
             : run_dq<kBiasLoads>(a, ba, b, d, causal, group, stream);
}

extern "C" int sage_attn_bwd_dkv_bias(const void* q_i8, const void* q_scale, const void* q_bf,
                                      const void* k_i8, const void* k_scale, const void* v,
                                      const void* dout, const void* lse2, const void* dvec,
                                      void* dk, void* dv, const void* bias, int b, int hq,
                                      int hkv, int sq, int sk, int d, int causal, int bias_kind,
                                      int group, float sm_scale, void* stream) {
  const BwdArgs a{(const int8_t*)q_i8, (const float*)q_scale, (const __nv_bfloat16*)q_bf,
                  (const int8_t*)k_i8, (const float*)k_scale, nullptr, (const __nv_bfloat16*)v,
                  (const __nv_bfloat16*)dout, (const float*)lse2, (const float*)dvec, nullptr,
                  (float*)dk, (float*)dv, hq, hkv, sq, sk, sm_scale, 0};
  const bool tma = !(bias_kind & 2) && d != 256;
  BiasArgs ba;
  if (bias == nullptr || !bias_args(&ba, bias, nullptr, bias_kind & 1, (long long)b * hq, sq, sk,
                                    tma))
    return (int)cudaErrorInvalidValue;
  return tma ? run_dkv<kBiasTma>(a, ba, b, d, causal, group, stream)
             : run_dkv<kBiasLoads>(a, ba, b, d, causal, group, stream);
}
