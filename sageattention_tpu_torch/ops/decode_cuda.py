"""Decode attention over the quantized KV cache: CUDA wrappers and plain versions.

Replaces the TPU kernels of ``sageattention_tpu/ops/decode_pallas.py``
(``_decode_kernel``, ``_decode_kernel_window``) and
``sageattention_tpu/ops/paged_decode_pallas.py`` (``_paged_kernel``,
``_paged_kernel_window``), which share one chunk body,
``decode_step_body``.  The kernels are ``csrc/decode.cu`` and
``csrc/paged_decode.cu`` (head dims up to 256) and ``csrc/decode_wide.cu``
and ``csrc/paged_decode_wide.cu`` (head dims in (256, 512]), one body for
all four (``csrc/decode_split_sm90.cuh``, its numbers and helpers in
``csrc/decode_body.cuh``); their headers say what bounds them and how they
are laid out.

What every version computes, chunk by chunk (a chunk of the dense cache
comes from the host rules below, a chunk of the paged cache is a page):

* per row of the packed (GQA group x query token) tile, Q quantized to
  +-127 (+-119 for the packed 4-bit cache) with its scale times
  ``sm_scale * log2(e)``;
* ``sf = s_i32 * (qscale * sm_fold) * ks``, masked to ``NEG_INIT`` past the
  length, the causal tail of t_q > 1 and the sliding window;
* ``p = exp2(sf - m_c)``, ``pe = p * vs``, requantized per row with the
  chunk's own ``pmax`` for an integer P.V, ``pv = int32(P_q . V) * psc``;
* the base-2 online merge into (m, l, acc), and ``o = acc / l`` (0 where
  ``l == 0``).

The chunking is part of the numbers (the P quantization unit is the chunk),
so the host rules are the JAX package's, copied exactly.  On a CPU tensor
the wrappers run the plain versions; on a CUDA tensor they launch the
kernels or raise.  ``decode_kernel``, ``decode_window_kernel``,
``paged_kernel`` and ``paged_window_kernel`` launch kernels 9-12 and count
their launches in ``.launches``, and those at head dims above 128 by the
instances' head dim, in ``.hd256_launches`` (d in (128, 256]),
``.hd384_launches`` and ``.hd512_launches``; kernels 11-12 also count
their launches over a shard of a sharded pool (``owned``) in
``.owned_launches``.  The kernels take every head dim up to
``_build.MAX_HEAD_DIM`` = 512, computed at 64, 128, 256, 384 or 512: a cache of
another head dim is read at its own row stride, byte by byte where that
is not a multiple of 16 bytes.

Every kernel splits the chunk walk (``csrc/decode_split_sm90.cuh``): a
cluster of ``cl`` CTAs shares each chunk, ``splits`` ranges of the walked
chunks (every chunk, or with a window the ``n_live`` from the first one it
reaches) run side by side, and the last range to finish merges the
partials in the launch; a row tile of 16 rows reads only the slabs that
hold a key its rows see.  :func:`split_plan` chooses ``cl`` and ``splits``
on the host from the shapes alone (never the lengths on the card); the
partials' workspace and tickets are the wrapper's, one per device and
stream (:func:`split_workspace`).
"""

from __future__ import annotations

import torch

from sageattention_tpu_torch import quant
from sageattention_tpu_torch.ops import _build

LOG2E = quant.LOG2E
NEG_INIT = -1e30
# f32(ln 2): XLA compiles exp2(x) as exp(f32(0.693147182) * x)
LN2_F32 = 0.693147182


def xla_exp2(x: torch.Tensor) -> torch.Tensor:
    """2^x as XLA compiles ``jnp.exp2`` for fp32: ``exp(x * f32(ln 2))``.
    ``torch.exp2`` differs from it by up to 17 ulp on [-40, 0], enough to
    move a P code at a rounding tie; this form stays within 1 ulp."""
    return torch.exp(x * LN2_F32)


# the score-tile budget of the extend-block rule (bytes of a fp32 [rows, chunk] tile)
_TILE_BUDGET = 8 * 2**20


# --------------------------------------------------------------------------
# host-side chunk rules (decode_pallas.py:50-67, :379-384, :415-424;
# paged_decode_pallas.py:228-240, :272-277)
# --------------------------------------------------------------------------


def _chunk_divisor(S: int, cap: int) -> int:
    """Chunk width for a cache of length ``S`` under the cap: ``S`` itself
    when it fits, else the largest divisor that is a multiple of 128."""
    if S <= cap:
        return S
    c = cap // 128 * 128
    while c > 128 and S % c:
        c -= 128
    if S % c:
        raise ValueError(
            f"cache length {S} larger than the chunk cap {cap} must have "
            "a 128-multiple divisor (size max_len up to a multiple of 128)"
        )
    return c


def _rows8(rows: int) -> int:
    return max(8, -(-rows // 8) * 8)


def dense_plan(S: int, rows: int, t_q: int, chunk: int, window: int | None):
    """(chunk, n_kv, n_live) of the dense decode; ``n_live`` is None
    without a window."""
    rows8 = _rows8(rows)
    if rows8 > 128:
        # extend blocks: shrink the chunk so the score tile fits the budget
        budget = (_TILE_BUDGET // 4) // rows8
        chunk = min(chunk, max(128, 1 << (budget.bit_length() - 1)))
    chunk = _chunk_divisor(S, chunk)
    n_kv = S // chunk
    if window is None:
        return chunk, n_kv, None
    span = window + t_q - 1
    target = max(1024, 1 << max((span - 1).bit_length() - 1, 0))
    if chunk > target:
        chunk = _chunk_divisor(S, target)
        n_kv = S // chunk
    return chunk, n_kv, min(n_kv, -(-span // chunk) + 1)


def paged_plan(page: int, max_pages: int, rows: int, group: int, t_q: int,
               window: int | None):
    """``n_live`` pages of the windowed paged decode (None without a
    window); raises where the JAX package refuses the score tile."""
    rows8 = _rows8(rows)
    if rows8 * page * 4 > _TILE_BUDGET:
        raise ValueError(
            f"paged chunked-prefill tile too large: rows {rows8} x page "
            f"{page} exceeds the ~8 MB score-tile budget; use smaller "
            f"extend blocks (t_q <= {_TILE_BUDGET // (4 * page * group)}) "
            f"or smaller pages, or the dense-cache path (its chunk "
            f"width adapts to t_q)"
        )
    if window is None:
        return None
    span = window + t_q - 1
    return min(max_pages, -(-span // page) + 1)


def window_start(length: int, span: int, chunk: int, n_total: int, n_live: int) -> int:
    """First chunk (or page) the window reaches, as each block computes it."""
    return min(max((length - span) // chunk, 0), n_total - n_live)


# --------------------------------------------------------------------------
# the split walk of kernels 9-12 (csrc/decode_split_sm90.cuh)
# --------------------------------------------------------------------------

SPLIT_RT = 16     # rows a CTA owns
SPLIT_KEEP = 512  # tokens of S a CTA keeps on chip
CL_MAX = 8        # the portable cluster size
SPLITS_MAX = 256
# the plan aims at about two waves of CTAs: two CTAs on each of the H100's
# 132 SMs (up to head dim 256; at 384 and 512 a CTA takes an SM, and the
# same plan, four waves there, measured no slower on pages of 16)
_WAVE = 2 * 132


def split_slab(d: int) -> int:
    """Tokens of one shared-memory slab at head dim ``d`` (padded as the
    kernels compute it): 128 up to 128, 64 above."""
    return 128 if _build.pad_head_dim(d) <= 128 else 64


def split_plan(n_chunks: int, chunk: int, d: int, rows: int, b: int, hkv: int):
    """(cl, splits) of a decode kernel over ``n_chunks`` walked chunks
    (pages) of ``chunk`` tokens: the cluster that shares one chunk, at least
    enough CTAs that each keeps its share's S on chip (512 tokens; 1 where a
    chunk holds one slab), and the ranges of chunks the grid runs side by
    side, enough for about two waves of CTAs (two an SM) over the (row
    tile, kv head, batch) clusters (1 where those already fill the card, as
    extend blocks do).  Where every range is one chunk and the CTAs would
    not fill one wave, the cluster widens, down to one slab a CTA.  No range
    is empty."""
    slabs = -(-chunk // split_slab(d))
    cl = 1
    while cl < CL_MAX and cl * SPLIT_KEEP < chunk:
        cl *= 2
    base = -(-rows // SPLIT_RT) * hkv * b
    target = 2 * _WAVE
    splits = min(n_chunks, SPLITS_MAX, -(-target // (base * cl)))
    while splits == n_chunks and 2 * base * cl * splits <= target and 2 * cl <= min(CL_MAX, slabs):
        cl *= 2
    per = -(-n_chunks // splits)
    return cl, -(-n_chunks // per)


def dense_split_plan(q_shape, hkv: int, S: int, chunk: int):
    """(cl, splits) of kernel 9 for q of ``q_shape`` over a cache of ``S``
    tokens in chunks of ``chunk`` (the kernel's, from :func:`dense_plan`)."""
    b, hq, t_q, d = q_shape
    return split_plan(S // chunk, chunk, d, hq // hkv * t_q, b, hkv)


def paged_split_plan(q_shape, hkv: int, page: int, max_pages: int):
    """(cl, splits) of kernel 11: a page is a chunk, so pages of C give the
    plan of a dense cache in chunks of C."""
    b, hq, t_q, d = q_shape
    return split_plan(max_pages, page, d, hq // hkv * t_q, b, hkv)


def window_split_plan(q_shape, hkv: int, chunk: int, n_live: int):
    """(cl, splits) of kernel 10 or 12: the plan over the ``n_live`` chunks
    (pages) of ``chunk`` tokens that the window walks."""
    b, hq, t_q, d = q_shape
    return split_plan(n_live, chunk, d, hq // hkv * t_q, b, hkv)


def split_ranges(n_chunks: int, splits: int):
    """The consecutive chunk ranges [c0, c1) of the ``splits`` splits."""
    per = -(-n_chunks // splits)
    return [(s * per, min(n_chunks, (s + 1) * per)) for s in range(splits)]


def tile_tokens(row0: int, rows: int, t_q: int):
    """(tmin, tmax): the least and largest query token among the live rows
    [row0, min(row0 + 16, rows)) of a row tile, as the kernel takes them
    (every token where the rows wrap past the last one)."""
    tmin = row0 % t_q
    tmax = tmin + min(SPLIT_RT, rows - row0) - 1
    return (0, t_q - 1) if tmax >= t_q else (tmin, tmax)


def tile_keys(length: int, t_q: int, window, tokens):
    """[klo, khi): the keys a row tile whose query tokens span ``tokens``
    (:func:`tile_tokens`) can see: below the causal end of its largest
    token and, with a window, from the oldest key of its least one."""
    tmin, tmax = tokens
    klo = 0 if window is None else max(0, length - t_q + tmin - window + 1)
    return klo, length - t_q + tmax + 1


def walked_chunks(length: int, t_q: int, chunk: int, n_chunks: int, window, n_live):
    """(start, count) of the chunks the kernel walks: every chunk, or with a
    window the ``n_live`` from the first one it reaches."""
    if window is None:
        return 0, n_chunks
    return window_start(length, window + t_q - 1, chunk, n_chunks, n_live), n_live


def split_shares(cl: int, splits: int, n_chunks: int, chunk: int, d: int, length: int, *,
                 t_q: int = 1, window=None, n_live=None, tokens=None):
    """{(split, rank): [(chunk, slab), ...]}: the slabs each CTA of a
    cluster reads for one row tile (its query tokens ``tokens``, default
    all of them), as the kernel deals them: each walked chunk of its
    split's range that holds a key the tile sees (:func:`tile_keys`), the
    chunk's slabs that meet those keys cut into ``cl`` contiguous shares."""
    slab = split_slab(d)
    start, count = walked_chunks(length, t_q, chunk, n_chunks, window, n_live)
    klo, khi = tile_keys(length, t_q, window, tokens or (0, t_q - 1))
    out = {}
    for s, (c0, c1) in enumerate(split_ranges(count, splits)):
        c0 = max(start + c0, klo // chunk)
        c1 = c0 if khi <= 0 else min(start + c1, -(-khi // chunk))
        for r in range(cl):
            got = out.setdefault((s, r), [])
            for ci in range(c0, c1):
                first = max(0, klo - ci * chunk) // slab
                nsl = -(-min(chunk, khi - ci * chunk) // slab) - first
                per = -(-nsl // cl)
                got += [(ci, j) for j in range(first + r * per, first + min(nsl, (r + 1) * per))]
    return out


def split_workspace_size(plan, b: int, hkv: int, rows: int, d: int):
    """(tickets, fp32 partial floats) of one launch under ``plan``."""
    cl, splits = plan
    slots = -(-rows // SPLIT_RT) * hkv * b * cl
    D = _build.pad_head_dim(d)
    return slots, slots * splits * (SPLIT_RT * D // cl + 2 * SPLIT_RT)


_WORKSPACES: dict = {}


def split_workspace(device, stream: int, plan, b: int, hkv: int, rows: int, d: int):
    """(partials, tickets) data pointers for a launch under ``plan`` on
    ``stream``, or (None, None) with one split.  One fp32 workspace and one
    int32 ticket array per (device, stream), grown as calls need; the
    kernel leaves every ticket at 0 for the next call."""
    if plan[1] == 1:
        return None, None
    n_tickets, floats = split_workspace_size(plan, b, hkv, rows, d)
    key = (str(device), stream)
    work, tickets = _WORKSPACES.get(key, (None, None))
    if work is None or work.numel() < floats or tickets.numel() < n_tickets:
        floats = max(floats, 0 if work is None else work.numel())
        n_tickets = max(n_tickets, 0 if tickets is None else tickets.numel())
        work = torch.empty(floats, dtype=torch.float32, device=device)
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
        _WORKSPACES[key] = (work, tickets)
    return work.data_ptr(), tickets.data_ptr()


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def unpack_token_pairs(p: torch.Tensor) -> torch.Tensor:
    """[..., t/2, d] token-pair-packed int8 -> [..., t, d] int8 in [-8, 7]:
    token 2t is the low nibble, 2t+1 the high one, sign-extended."""
    x = p.to(torch.int32)
    lo = (x << 28) >> 28
    hi = x >> 4
    out = torch.stack([lo, hi], dim=-2)
    return out.reshape(*p.shape[:-2], -1, p.shape[-1]).to(torch.int8)


def _q_qmax(packed: bool) -> float:
    return 119.0 if packed else 127.0


def _quant_q(q_pack: torch.Tensor, packed: bool, sm_fold: float):
    """Per-row Q codes and ``qscale * sm_fold``, as the kernels compute them:
    XLA compiles the spec's ``(max(amax, 1e-30) * (1/qmax)) * sm_fold`` as
    ``max(amax, 1e-30) * ((1/qmax) * sm_fold)``, which is what the JAX
    kernel's numbers are (:func:`quant.fold_multiplier`)."""
    qmax = _q_qmax(packed)
    qf = q_pack.float()
    amax = qf.abs().amax(dim=-1)
    _, r = quant.inv_scale(amax, qmax)
    q_int = quant.round_half_away(qf * r[..., None]).clamp(-qmax, qmax)
    mul = quant.f32_scalar(quant.fold_multiplier(sm_fold, qmax), q_pack.device)
    return q_int, torch.clamp_min(amax, 1e-30) * mul


def _chunk_body(state, q_int, qsf, k, ks, v, vs, *, base_col: int, length: int,
                t_q: int, window: int | None, packed: bool) -> None:
    """One chunk of ``decode_step_body`` for one batch entry, all kv heads:
    q_int [hkv, rows, d], k/v [hkv, C, d] int8 codes, ks/vs [hkv, C].
    Updates ``state`` = [m, l, acc] in place."""
    dev = q_int.device
    rows, C = q_int.shape[1], k.shape[1]
    s = torch.matmul(q_int.double(), k.double().transpose(-1, -2)).float()
    sf = s * qsf[..., None] * ks[:, None, :]
    col = torch.arange(C, device=dev)[None, :] + base_col
    trow = (torch.arange(rows, device=dev) % t_q)[:, None]
    valid = col < length
    if t_q > 1:
        valid = valid & (col < length - (t_q - 1) + trow)
        if window is not None:
            valid = valid & (col > length - t_q + trow - window)
    elif window is not None:
        valid = valid & (col > length - 1 - window)
    sf = torch.where(valid, sf, NEG_INIT)
    m_c = sf.amax(dim=-1, keepdim=True)
    p = torch.where(valid, xla_exp2(sf - m_c), 0.0)
    l_c = p.sum(dim=-1, keepdim=True)
    pe = p * vs[:, None, :]
    pmax = pe.amax(dim=-1, keepdim=True)
    p_qmax = 119.0 if packed else 127.0
    psc, pr = quant.inv_scale(pmax, p_qmax)
    p_int = quant.round_half_away(pe * pr).clamp(0.0, p_qmax)
    # the integer P.V is exact in fp64 (|sum| < 2^31), as int32 on the card
    pv = torch.matmul(p_int.double(), v.double()).float() * psc
    m_prev, l_prev, acc = state
    m_next = torch.maximum(m_prev, m_c)
    alpha = xla_exp2(m_prev - m_next)
    w = xla_exp2(m_c - m_next)
    state[0] = m_next
    state[1] = alpha * l_prev + w * l_c
    state[2] = acc * alpha + pv * w


def _decode_plain(q, chunks_of, lengths, *, packed: bool, sm_scale, window,
                  out_dtype, return_state, hkv: int):
    """The shared loop of the plain versions: ``chunks_of(bi, length)`` yields
    (base_col, k, ks, v, vs) for each chunk the kernel visits, in order."""
    b, hq, t_q, d = q.shape
    group = hq // hkv
    rows = group * t_q
    if sm_scale is None:
        sm_scale = d**-0.5
    out_dtype = out_dtype or q.dtype
    q_int, qsf = _quant_q(q.reshape(b, hkv, rows, d), packed, sm_scale * LOG2E)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.zeros(b, hkv, rows, d, **f32)
    m_out = torch.full((b, hkv, rows), NEG_INIT, **f32)
    l_out = torch.zeros(b, hkv, rows, **f32)
    for bi, length in enumerate(lengths.tolist()):
        state = [torch.full((hkv, rows, 1), NEG_INIT, **f32),
                 torch.zeros(hkv, rows, 1, **f32), torch.zeros(hkv, rows, d, **f32)]
        for base_col, k, ks, v, vs in chunks_of(bi, length):
            if packed:
                k, v = unpack_token_pairs(k), unpack_token_pairs(v)
            _chunk_body(state, q_int[bi], qsf[bi], k, ks.float(), v, vs.float(),
                        base_col=base_col, length=length, t_q=t_q, window=window,
                        packed=packed)
        m, l, acc = state
        l_inv = torch.where(l == 0.0, 0.0, 1.0 / l)
        o[bi] = acc * l_inv
        m_out[bi], l_out[bi] = m[..., 0], l[..., 0]

    def heads(x):
        return x.reshape(b, hq, t_q, *x.shape[3:])

    o = heads(o).to(out_dtype)
    return (o, heads(m_out), heads(l_out)) if return_state else o


def _check_cache(q, k, k_scale, v, v_scale):
    b, hq, t_q, d = q.shape
    hkv, S = k.shape[1], k_scale.shape[2]
    if k.shape[2] not in (S, S // 2) or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"K/V {tuple(k.shape)} / {tuple(v.shape)} do not fit scales "
                         f"{tuple(k_scale.shape)} and head dim {d}")
    if hq % hkv:
        raise ValueError(f"hq={hq} is not a multiple of hkv={hkv}")
    return hkv, S, k.shape[2] != S


def sage_decode_attention_plain(q, k_i8, k_scale, v_i8, v_scale, lengths, *,
                                sm_scale=None, chunk: int = 4096, window=None,
                                out_dtype=None, return_state: bool = False):
    """Kernels 9 and 10 in plain PyTorch (see :func:`sage_decode_attention`)."""
    b, hq, t_q, d = q.shape
    hkv, S, packed = _check_cache(q, k_i8, k_scale, v_i8, v_scale)
    C, n_kv, n_live = dense_plan(S, hq // hkv * t_q, t_q, chunk, window)
    cb = C // 2 if packed else C  # data rows of one chunk

    def chunks_of(bi, length):
        start, count = 0, n_kv
        if window is not None:
            start = window_start(length, window + t_q - 1, C, n_kv, n_live)
            count = n_live
        for ci in range(start, start + count):
            if ci * C >= length:
                break
            yield (ci * C, k_i8[bi, :, ci * cb:(ci + 1) * cb], k_scale[bi, :, ci * C:(ci + 1) * C],
                   v_i8[bi, :, ci * cb:(ci + 1) * cb], v_scale[bi, :, ci * C:(ci + 1) * C])

    return _decode_plain(q, chunks_of, lengths, packed=packed, sm_scale=sm_scale,
                         window=window, out_dtype=out_dtype, return_state=return_state,
                         hkv=hkv)


def sage_paged_decode_attention_plain(q, pages_k, pages_k_scale, pages_v, pages_v_scale,
                                      page_table, lengths, *, owned=None, sm_scale=None,
                                      window=None, out_dtype=None, return_state: bool = False):
    """Kernels 11 and 12 in plain PyTorch (see
    :func:`sage_paged_decode_attention`)."""
    _check_owned(owned, page_table, return_state)
    b, hq, t_q, d = q.shape
    hkv, page, packed = _check_cache(q, pages_k, pages_k_scale, pages_v, pages_v_scale)
    max_pages = page_table.shape[1]
    n_live = paged_plan(page, max_pages, hq // hkv * t_q, hq // hkv, t_q, window)
    table = page_table.tolist()
    own = None if owned is None else owned.tolist()

    def chunks_of(bi, length):
        start, count = 0, max_pages
        if window is not None:
            start = window_start(length, window + t_q - 1, page, max_pages, n_live)
            count = n_live
        for pi in range(start, start + count):
            if pi * page >= length:
                break
            if own is not None and not own[bi][pi]:
                continue  # another shard's page: its table entry is not read
            ph = table[bi][pi]
            yield (pi * page, pages_k[ph], pages_k_scale[ph], pages_v[ph], pages_v_scale[ph])

    return _decode_plain(q, chunks_of, lengths, packed=packed, sm_scale=sm_scale,
                         window=window, out_dtype=out_dtype, return_state=return_state,
                         hkv=hkv)


def _check_owned(owned, page_table, return_state: bool) -> None:
    if owned is None:
        return
    if not return_state:
        # a shard's normalized partial looks like a whole decode's output
        raise ValueError(
            "owned= runs a PARTIAL decode over a shard of the page pool; it requires "
            "return_state=True so that the caller can merge the partials "
            "(merge_decode_partials)"
        )
    if tuple(owned.shape) != tuple(page_table.shape):
        raise ValueError(f"owned {tuple(owned.shape)} must match the page table "
                         f"{tuple(page_table.shape)}")


def merge_decode_partials(o_parts, m_parts, l_parts, out_dtype=None):
    """Exactly combine normalized partial decodes over disjoint cache shards
    (``return_state=True`` outputs stacked on a leading axis):
    ``o = sum_i w_i o_i / sum_i w_i`` with ``w_i = l_i * 2^(m_i - max m)``.
    Empty shards (m = NEG_INIT, l = 0) weigh 0; a row empty everywhere is 0."""
    out_dtype = out_dtype or o_parts.dtype
    m_g = m_parts.amax(dim=0)
    w = l_parts * xla_exp2(m_parts - m_g)
    den = w.sum(dim=0)
    den = torch.where(den == 0.0, 1.0, den)
    num = (w[..., None] * o_parts.float()).sum(dim=0)
    return (num / den[..., None]).to(out_dtype)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def _device_args(q, lengths, *tensors):
    """q as fp32 [b, hkv, rows, d] and the int32 lengths, checked."""
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"tensor on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError("the decode kernels take contiguous tensors")
    d = q.shape[-1]
    if d > _build.MAX_HEAD_DIM:
        raise NotImplementedError(
            f"head dim {d} > {_build.MAX_HEAD_DIM}: the decode kernels compute at 64, 128, 256, 384 "
            f"or 512 (ROADMAP: limits, head dims above 512)")
    return q.float().contiguous(), lengths.to(device=q.device, dtype=torch.int32).contiguous()


def _wide(d: int) -> str:
    """The suffix of the library and entry point of the instances at head
    dim ``d``: those above 256 are sources of their own
    (``csrc/decode_wide.cu``, ``csrc/paged_decode_wide.cu``)."""
    return "_wide" if d > 256 else ""


def _outputs(q, rows_shape, return_state):
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.empty(*rows_shape, q.shape[-1], **f32)
    m = torch.empty(*rows_shape, **f32) if return_state else None
    l = torch.empty(*rows_shape, **f32) if return_state else None
    return o, m, l


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _split_args(q, stream: int, plan, hkv: int):
    """The split walk's trailing arguments: cl, splits, partials, tickets."""
    b, hq, t_q, d = q.shape
    return (*plan, *split_workspace(q.device, stream, plan, b, hkv, hq // hkv * t_q, d))


def _launch_dense(fn_name, q, k_i8, k_scale, v_i8, v_scale, lengths, *, chunk, window,
                  n_live, qs_mul, return_state):
    b, hq, t_q, d = q.shape
    hkv, S = k_i8.shape[1], k_scale.shape[2]
    rows = hq // hkv * t_q
    qf, lens = _device_args(q, lengths, k_i8, k_scale, v_i8, v_scale)
    o, m, l = _outputs(q, (b, hkv, rows), return_state)
    sfx = _wide(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        plan = (dense_split_plan(q.shape, hkv, S, chunk) if window is None
                else window_split_plan(q.shape, hkv, chunk, n_live))
        err = getattr(_build.lib("decode" + sfx), fn_name + sfx)(
            qf.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(), v_i8.data_ptr(),
            v_scale.data_ptr(), lens.data_ptr(), o.data_ptr(), _ptr(m), _ptr(l),
            b, hkv, rows, t_q, S, d, int(k_i8.shape[2] != S), chunk, window or 0,
            n_live or 0, qs_mul, stream, *_split_args(q, stream, plan, hkv),
        )
    _build.check(err, fn_name + sfx)
    return o, m, l


def decode_kernel(q, k_i8, k_scale, v_i8, v_scale, lengths, *, chunk, qs_mul,
                  return_state):
    """Launch kernel 9 (dense cache, every chunk below the length)."""
    out = _launch_dense("sage_decode", q, k_i8, k_scale, v_i8, v_scale, lengths,
                        chunk=chunk, window=None, n_live=None, qs_mul=qs_mul,
                        return_state=return_state)
    _build.count_launch(decode_kernel, _build.pad_head_dim(q.shape[-1]))
    return out


def decode_window_kernel(q, k_i8, k_scale, v_i8, v_scale, lengths, *, chunk, window,
                         n_live, qs_mul, return_state):
    """Launch kernel 10 (dense cache, the ``n_live`` chunks the window reaches)."""
    out = _launch_dense("sage_decode_window", q, k_i8, k_scale, v_i8, v_scale, lengths,
                        chunk=chunk, window=window, n_live=n_live, qs_mul=qs_mul,
                        return_state=return_state)
    _build.count_launch(decode_window_kernel, _build.pad_head_dim(q.shape[-1]))
    return out


def _launch_paged(fn_name, q, pages_k, pages_k_scale, pages_v, pages_v_scale, page_table,
                  owned, lengths, *, window, n_live, qs_mul, return_state):
    b, hq, t_q, d = q.shape
    hkv, page = pages_k.shape[1], pages_k_scale.shape[2]
    rows = hq // hkv * t_q
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    own = None if owned is None else owned.to(device=q.device, dtype=torch.int32).contiguous()
    qf, lens = _device_args(q, lengths, pages_k, pages_k_scale, pages_v, pages_v_scale)
    o, m, l = _outputs(q, (b, hkv, rows), return_state)
    sfx = _wide(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        plan = (paged_split_plan(q.shape, hkv, page, table.shape[1]) if window is None
                else window_split_plan(q.shape, hkv, page, n_live))
        err = getattr(_build.lib("paged_decode" + sfx), fn_name + sfx)(
            qf.data_ptr(), pages_k.data_ptr(), pages_k_scale.data_ptr(), pages_v.data_ptr(),
            pages_v_scale.data_ptr(), table.data_ptr(), _ptr(own), lens.data_ptr(), o.data_ptr(),
            _ptr(m), _ptr(l), b, hkv, rows, t_q, page, table.shape[1], d,
            int(pages_k.shape[2] != page), window or 0, n_live or 0, qs_mul, stream,
            *_split_args(q, stream, plan, hkv),
        )
    _build.check(err, fn_name + sfx)
    return o, m, l


def _count_paged(fn, q, owned) -> None:
    _build.count_launch(fn, _build.pad_head_dim(q.shape[-1]))
    if owned is not None:
        fn.owned_launches += 1  # of those, the launches over a pool shard


def paged_kernel(q, pages_k, pages_k_scale, pages_v, pages_v_scale, page_table, lengths, *,
                 qs_mul, return_state, owned=None):
    """Launch kernel 11 (paged cache, every page below the length; with
    ``owned`` only the pages it marks)."""
    out = _launch_paged("sage_paged_decode", q, pages_k, pages_k_scale, pages_v,
                        pages_v_scale, page_table, owned, lengths, window=None, n_live=None,
                        qs_mul=qs_mul, return_state=return_state)
    _count_paged(paged_kernel, q, owned)
    return out


def paged_window_kernel(q, pages_k, pages_k_scale, pages_v, pages_v_scale, page_table,
                        lengths, *, window, n_live, qs_mul, return_state, owned=None):
    """Launch kernel 12 (paged cache, the ``n_live`` pages the window reaches;
    with ``owned`` only the pages it marks)."""
    out = _launch_paged("sage_paged_decode_window", q, pages_k, pages_k_scale, pages_v,
                        pages_v_scale, page_table, owned, lengths, window=window,
                        n_live=n_live, qs_mul=qs_mul, return_state=return_state)
    _count_paged(paged_window_kernel, q, owned)
    return out


_build.zero_counters(decode_kernel, decode_window_kernel, paged_kernel, paged_window_kernel)
for _fn in (paged_kernel, paged_window_kernel):
    _fn.owned_launches = 0


def _finish(res, q, out_dtype, return_state):
    """The kernels' fp32 [b, hkv, rows, ...] outputs in [b, hq, t_q, ...]."""
    b, hq, t_q, _ = q.shape
    o, m, l = res
    o = o.reshape(b, hq, t_q, -1).to(out_dtype or q.dtype)
    if not return_state:
        return o
    return o, m.reshape(b, hq, t_q), l.reshape(b, hq, t_q)


def sage_decode_attention(q, k_i8, k_scale, v_i8, v_scale, lengths, *, sm_scale=None,
                          chunk: int = 4096, window: int | None = None, out_dtype=None,
                          return_state: bool = False):
    """Decode attention of a few query tokens against the dense int8 (or
    token-pair-packed int4) cache.

    q [b, hq, t_q, d]; k_i8 / v_i8 [b, hkv, S, d] int8, or [b, hkv, S/2, d]
    packed; k_scale / v_scale [b, hkv, S] fp32 per token; lengths [b] live
    lengths including the t_q new tokens.  Values outside [0, S] are part of
    the contract: a negative length gives 0 and (m, l) = (NEG_INIT, 0).
    Query row t also sees the causal tail (keys < length - t_q + 1 + t);
    ``window`` keeps each query's last ``window`` keys and reads only the
    chunks they lie in.  Returns o [b, hq, t_q, d] in ``out_dtype``
    (default q's) and, with ``return_state``, the base-2 (m, l) [b, hq,
    t_q] fp32 for :func:`merge_decode_partials`."""
    if q.device.type == "cpu":
        return sage_decode_attention_plain(q, k_i8, k_scale, v_i8, v_scale, lengths,
                                           sm_scale=sm_scale, chunk=chunk, window=window,
                                           out_dtype=out_dtype, return_state=return_state)
    if q.device.type != "cuda":
        raise ValueError(f"sage_decode_attention: tensor on {q.device}")
    b, hq, t_q, d = q.shape
    hkv, S, _ = _check_cache(q, k_i8, k_scale, v_i8, v_scale)
    C, _, n_live = dense_plan(S, hq // hkv * t_q, t_q, chunk, window)
    packed = k_i8.shape[2] != S
    qs_mul = quant.fold_multiplier((d**-0.5 if sm_scale is None else sm_scale) * LOG2E,
                                    _q_qmax(packed))
    args = (q, k_i8, k_scale, v_i8, v_scale, lengths)
    if window is None:
        res = decode_kernel(*args, chunk=C, qs_mul=qs_mul, return_state=return_state)
    else:
        res = decode_window_kernel(*args, chunk=C, window=window, n_live=n_live,
                                   qs_mul=qs_mul, return_state=return_state)
    return _finish(res, q, out_dtype, return_state)


def sage_paged_decode_attention(q, pages_k, pages_k_scale, pages_v, pages_v_scale,
                                page_table, lengths, *, owned=None, sm_scale=None,
                                window: int | None = None, out_dtype=None,
                                return_state: bool = False):
    """Decode attention through a page table: logical chunk j of sequence b
    is physical page ``page_table[b, j]`` of the pool (pages_k / pages_v
    [P, hkv, page, d] int8 or [P, hkv, page/2, d] packed; scales [P, hkv,
    page]).  Entries past the live length may hold any valid page id.  Same
    query semantics and outputs as :func:`sage_decode_attention`, one page
    per chunk.

    ``owned`` (int32 [b, max_pages], with ``return_state=True``) runs a
    partial decode over one shard of a pool split over ranks: only the
    logical pages it marks contribute, and the table entries of the others
    are never read.  ``lengths`` stay global.  A row with no owned live page
    gives o = 0, m = NEG_INIT and l = 0; the shards' partials merge exactly
    with :func:`merge_decode_partials`."""
    _check_owned(owned, page_table, return_state)
    if q.device.type == "cpu":
        return sage_paged_decode_attention_plain(
            q, pages_k, pages_k_scale, pages_v, pages_v_scale, page_table, lengths,
            owned=owned, sm_scale=sm_scale, window=window, out_dtype=out_dtype,
            return_state=return_state)
    if q.device.type != "cuda":
        raise ValueError(f"sage_paged_decode_attention: tensor on {q.device}")
    b, hq, t_q, d = q.shape
    hkv, page, _ = _check_cache(q, pages_k, pages_k_scale, pages_v, pages_v_scale)
    n_live = paged_plan(page, page_table.shape[1], hq // hkv * t_q, hq // hkv, t_q, window)
    packed = pages_k.shape[2] != page
    qs_mul = quant.fold_multiplier((d**-0.5 if sm_scale is None else sm_scale) * LOG2E,
                                    _q_qmax(packed))
    args = (q, pages_k, pages_k_scale, pages_v, pages_v_scale, page_table, lengths)
    if window is None:
        res = paged_kernel(*args, qs_mul=qs_mul, return_state=return_state, owned=owned)
    else:
        res = paged_window_kernel(*args, window=window, n_live=n_live, qs_mul=qs_mul,
                                  return_state=return_state, owned=owned)
    return _finish(res, q, out_dtype, return_state)
