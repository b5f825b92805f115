// The body of the forward kernel of attention_fwd_kernel.cuh,
// sage_attn_fwd_kernel, which includes it inside its braces.  It reads the
// kernel's parameters and template arguments; the design notes are in
// attention_fwd_kernel.cuh.  Not a header of its own.
  using L = Layout<D>;
  constexpr int KT = kKvTile<D>;  // KV columns a tile
  constexpr int NT = KT / 8;      // 8-column n-tiles of S per warp
  constexpr int DV = kDv<D>;      // O columns of this CTA
  constexpr int NS = D / DV;      // O's column slices, a CTA each
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem + L::q_off);
  int8_t* sK = reinterpret_cast<int8_t*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* sQs = reinterpret_cast<float*>(smem + L::qs_off);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma groupID, thread in group
  // the Q tile, and the first O (and V) column of this CTA's slice; every
  // slice computes S over the whole D by the same instructions, so m, l and
  // lse2 are the same bit for bit in each, and slice 0 writes lse2
  const unsigned qt = NS == 1 ? blockIdx.x : blockIdx.x / NS;
  const int c_v = NS == 1 ? 0 : (int)(blockIdx.x % NS) * DV;
  const int q0 = qt * BM;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const size_t q_base = (((size_t)bi * hq + h) * sq) * D;
  const size_t kv_base = (((size_t)bi * hkv + hk) * sk) * D;
  const int n_groups = (sk + BN - 1) / BN;  // K-scale groups, the liveness table's columns
  const int n_tiles_all = (sk + KT - 1) / KT;
  const float* ks_row = k_scale + ((size_t)bi * hkv + hk) * n_groups;

  // ---- 1. per-row int8 Q quantization (each warp its 16 rows) ----------
  if constexpr (PREQ) {
    // the caller's codes and folded scales; rows >= sq are zero
    const int8_t* qc = pq.q + q_base;
    for (int i = lane; i < 16 * (D / 16); i += 32) {
      const int row = warp * 16 + i / (D / 16), c = i % (D / 16);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (q0 + row < sq) val = *reinterpret_cast<const uint4*>(qc + (size_t)(q0 + row) * D + c * 16);
      *reinterpret_cast<uint4*>(sQ + row * L::QS + c * 16) = val;
    }
    if (lane < 16) {
      const int gr = q0 + warp * 16 + lane;
      sQs[warp * 16 + lane] = gr < sq ? pq.q_scale[((size_t)bi * hq + h) * sq + gr] : 0.f;
    }
  }
  for (int rr = 0; rr < (PREQ ? 0 : 16); ++rr) {
    const int row = warp * 16 + rr;
    const int gr = q0 + row;
    float x[D / 32];
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      x[e] = gr < sq ? to_f32(q[q_base + (size_t)gr * D + lane + 32 * e]) : 0.f;
      amax = fmaxf(amax, fabsf(x[e]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = fmaxf(amax, 1e-30f) * kInvQmax;
    const float r = 1.0f / scale;
#pragma unroll
    for (int e = 0; e < D / 32; ++e)
      sQ[row * L::QS + lane + 32 * e] = (int8_t)fminf(fmaxf(roundf(x[e] * r), -127.f), 127.f);
    if (lane == 0) sQs[row] = fmaxf(amax, 1e-30f) * qs_mul;
  }
  __syncwarp();
  const float qs0 = sQs[warp * 16 + g], qs1 = sQs[warp * 16 + g + 8];
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this thread's rows

  float m0 = NEG_INIT, m1 = NEG_INIT;  // running max (base 2)
  float l0 = 0.f, l1 = 0.f;            // this thread's partial row sums
  float acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int j_first = 0;
  int n_tiles = n_tiles_all;
  if (CAUSAL) n_tiles = min(n_tiles, (q0 + BM - 1) / KT + 1);
  // masked: the rows' operands, the bias's row offsets, and the tile range
  // the window and the varlen ranges leave
  RowMask rm0{}, rm1{};
  long long bias_r0 = 0, bias_r1 = 0;
  if constexpr (MASKED) {
    const size_t rb = (size_t)bi * sq;
    rm0 = row_mask(mk, rb + row0, row0 < sq);
    rm1 = row_mask(mk, rb + row1, row1 < sq);
    const long long bh = bi * mk.bias_st[0] + h * mk.bias_st[1];
    bias_r0 = bh + (long long)min(row0, sq - 1) * mk.bias_st[2];  // rows >= sq read row sq-1
    bias_r1 = bh + (long long)min(row1, sq - 1) * mk.bias_st[2];
    if (mk.window > 0) j_first = max(0, q0 - mk.window + 1) / KT;
    if (mk.kv_lo != nullptr) {
      __shared__ int s_lo, s_hi;
      if (tid == 0) {
        s_lo = INT_MAX;
        s_hi = INT_MIN;
      }
      __syncthreads();
      if (tid < BM && q0 + tid < sq) {
        atomicMin(&s_lo, mk.kv_lo[rb + q0 + tid]);
        atomicMax(&s_hi, mk.kv_hi[rb + q0 + tid]);
      }
      __syncthreads();
      if (s_hi > s_lo) {
        j_first = max(j_first, s_lo / KT);
        n_tiles = min(n_tiles, (s_hi + KT - 1) / KT);
      } else {
        n_tiles = 0;  // no row of the tile has a live key
      }
    }
  }

  for (int j = j_first; j < n_tiles; ++j) {
    int lv = 2;  // the tile's liveness: 0 dead, 1 some, 2 all (ids and mask)
    if constexpr (MASKED) {
      if (mk.live != nullptr) {
        lv = mk.live[bi * mk.live_bst + h * mk.live_hst + (size_t)qt * n_groups + j / (BN / KT)];
        if (lv == 0) continue;  // the same for every thread of the CTA
      }
    }
    const int kv0 = j * KT;
    __syncthreads();  // the previous tile's K/V are no longer read
    // ---- 2. K and V tiles into shared memory, zero past sk ---------------
    for (int i = tid; i < KT * (D / 16); i += NTHREADS) {
      const int r = i / (D / 16), c = i % (D / 16);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (kv0 + r < sk) val = *reinterpret_cast<const uint4*>(k + kv_base + (size_t)(kv0 + r) * D + c * 16);
      *reinterpret_cast<uint4*>(sK + r * L::QS + c * 16) = val;
    }
    for (int i = tid; i < KT * (DV / 8); i += NTHREADS) {
      const int r = i / (DV / 8), c = i % (DV / 8);
      const size_t e = kv_base + (size_t)(kv0 + r) * D + c_v + c * 8;  // first element
      uint4 val = make_uint4(0, 0, 0, 0);
      if constexpr (VK == kVBf16) {
        if (kv0 + r < sk) val = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(v) + e);
      } else {
        uint2 raw = make_uint2(0, 0);  // code 0 is 0 in every type
        if (kv0 + r < sk) raw = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(v) + e);
        val = codes_to_bf16x8<VK>(raw);
      }
      *reinterpret_cast<uint4*>(sV + r * L::VS + c * 8) = val;
    }
    if constexpr (PREQ) {
      // each column pair's (scale, scale, bias, bias): the rows' own K
      // scales, or 1 with the tile's in the row factor; the bias or 0; 0
      // past sk
      float4* sCol = reinterpret_cast<float4*>(smem + Layout<D>::bytes);
      for (int i = tid; i < KT / 2; i += NTHREADS) {
        float c4[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = kv0 + 2 * i + u;
          const bool in = col < sk;
          c4[u] = !in ? 0.f : pq.ks_per_row ? k_scale[((size_t)bi * hkv + hk) * sk + col] : 1.f;
          c4[2 + u] = in && pq.col_bias != nullptr ? pq.col_bias[((size_t)bi * hq + h) * sk + col]
                                                   : 0.f;
        }
        sCol[i] = make_float4(c4[0], c4[1], c4[2], c4[3]);
      }
    }
    __syncthreads();

    // ---- 3a. S = Q.K^T, int8 in, int32 out --------------------------------
    int s_i[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s_i[n][0] = s_i[n][1] = s_i[n][2] = s_i[n][3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      const int8_t* qa = sQ + (warp * 16 + g) * L::QS + kk * 32 + t * 4;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qa);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * L::QS);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * L::QS + 16);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int8_t* kb = sK + (n * 8 + g) * L::QS + kk * 32 + t * 4;
        mma_s8(s_i[n], a, *reinterpret_cast<const uint32_t*>(kb),
               *reinterpret_cast<const uint32_t*>(kb + 16));
      }
    }

    // ---- 3b. dequantize, mask, online softmax (base 2) --------------------
    const float ks = ks_per_row<PREQ>(pq) ? 1.f : ks_row[j / (BN / KT)];
    const float rs0 = qs0 * ks, rs1 = qs1 * ks;
    const float4* sCol = reinterpret_cast<const float4*>(smem + Layout<D>::bytes);  // PREQ
    bool need_mask = (kv0 + KT > sk) || (CAUSAL && kv0 + KT - 1 > q0);
    uint64_t dead = 0;  // masked: bit n * 4 + e set for an element the rule kills
    if constexpr (MASKED) {
      // this thread's elements need the rule unless the table says the
      // tile is wholly live under the ids and the mask, and its rows'
      // ranges hold the tile
      const bool rule = (lv != 2 && (mk.q_seg != nullptr || mk.mask != nullptr)) ||
                        mk.q_pos != nullptr ||
                        (mk.kv_lo != nullptr && !(covers<KT>(rm0, kv0) && covers<KT>(rm1, kv0)));
      if (rule) {
#pragma unroll 1
        for (int idx = 0; idx < NT * 4; ++idx) {
          const bool top = (idx & 3) < 2;
          const int col = kv0 + (idx >> 2) * 8 + t * 2 + (idx & 1);
          if (!element_live(mk, top ? rm0 : rm1, bi, h, top ? row0 : row1, col, sq, sk))
            dead |= 1ull << idx;
        }
      }
      need_mask = need_mask || rule || (mk.window > 0 && kv0 <= q0 + BM - 1 - mk.window);
    }
    float s[NT][4];
    float mx0 = -INFINITY, mx1 = -INFINITY;
    if constexpr (MASKED) {
      // dequantize; add the bias; mask (causal, ragged edge, window, rule)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 cv = PREQ ? sCol[n * 4 + t] : float4{};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = PREQ ? preq_score(s_i[n][e], e < 2 ? rs0 : rs1, cv, e)
                         : (float)s_i[n][e] * (e < 2 ? rs0 : rs1);
      }
      if (mk.bias != nullptr) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = min(kv0 + n * 8 + t * 2 + (e & 1), sk - 1);  // cols >= sk masked below
            s[n][e] += bias_at(mk, (e < 2 ? bias_r0 : bias_r1) + col * mk.bias_st[3]) * kLog2e;
          }
      }
      if (need_mask) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + n * 8 + t * 2 + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= sk || (CAUSAL && col > row) || (mk.window > 0 && col <= row - mk.window) ||
                ((dead >> (n * 4 + e)) & 1))
              s[n][e] = -INFINITY;
          }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 cv = PREQ ? sCol[n * 4 + t] : float4{};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = PREQ ? preq_score(s_i[n][e], e < 2 ? rs0 : rs1, cv, e)
                           : (float)s_i[n][e] * (e < 2 ? rs0 : rs1);
          if (need_mask) {
            const int col = kv0 + n * 8 + t * 2 + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= sk || (CAUSAL && col > row)) val = -INFINITY;
          }
          s[n][e] = val;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      acc[i][0] *= al0;
      acc[i][1] *= al0;
      acc[i][2] *= al1;
      acc[i][3] *= al1;
    }

    // ---- 3c. O += P.V, P rounded to bf16, fp32 accumulate -----------------
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int vr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < DV / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, sV + vr * L::VS + np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // ---- 4. epilogue: o = (acc / l) * v_scale + v_mean, lse2 = log2(l) + m ---
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const size_t vc = ((size_t)bi * hkv + hk) * D;  // this kv head's channels
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int col = c_v + i * 8 + t * 2;
    float o0[2] = {acc[i][0] / l0, acc[i][1] / l0};
    float o1[2] = {acc[i][2] / l1, acc[i][3] / l1};
    if constexpr (MASKED) {  // a row with no live key writes 0
      if (!(l0 > 0.f)) o0[0] = o0[1] = 0.f;
      if (!(l1 > 0.f)) o1[0] = o1[1] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (v_scale != nullptr) {
        o0[e] *= v_scale[vc + col + e];
        o1[e] *= v_scale[vc + col + e];
      }
      if (v_mean != nullptr) {  // a row with l == 0 keeps 0
        o0[e] += l0 > 0.f ? v_mean[vc + col + e] : 0.f;
        o1[e] += l1 > 0.f ? v_mean[vc + col + e] : 0.f;
      }
    }
    if constexpr (PREQ) {
      if (pq.o_f32) {  // the pre-quantized instantiation's fp32 output
        float* of = reinterpret_cast<float*>(o);
        if (row0 < sq) store2(of + q_base + (size_t)row0 * D + col, o0[0], o0[1]);
        if (row1 < sq) store2(of + q_base + (size_t)row1 * D + col, o1[0], o1[1]);
        continue;
      }
    }
    if (row0 < sq) store2(o + q_base + (size_t)row0 * D + col, o0[0], o0[1]);
    if (row1 < sq) store2(o + q_base + (size_t)row1 * D + col, o1[0], o1[1]);
  }
  if (lse2 != nullptr && t == 0 && (NS == 1 || c_v == 0)) {
    const size_t lbase = ((size_t)bi * hq + h) * sq;
    float ls0 = log2f(l0) + m0, ls1 = log2f(l1) + m1;
    if constexpr (MASKED) {  // and its LSE is -inf
      if (!(l0 > 0.f)) ls0 = -INFINITY;
      if (!(l1 > 0.f)) ls1 = -INFINITY;
    }
    if (row0 < sq) lse2[lbase + row0] = ls0;
    if (row1 < sq) lse2[lbase + row1] = ls1;
  }
