"""Sequence- and tensor-parallel serving decode: the KV cache sharded over ranks.

The counterpart of the JAX package's ``parallel/decode.py``.  Long-context
serving runs out of one card's memory before it runs out of FLOPs, so the
cache is split: its sequence over the ``axis`` dim of a mesh (SP), its kv
heads over ``head_axis`` (TP, GQA groups kept whole).  Each rank holds its
own shard of the cache and runs the decode kernel over it with
``return_state=True``; the partials reduce with one exact LSE merge (one
``all_reduce(MAX)``, two ``all_reduce(SUM)``).  The head split needs no
collective: a rank's query heads see only its kv heads.

Each sharded function is a local body, which returns the shard's (o, m,
l) before any collective and takes the shard's index as a number (so one
process can run every shard's body in turn), and the reduce.  The partial
o stays fp32 (the kernels' own output) until the merge has summed it; only
the merged output is cast to q's dtype:

* :func:`local_shard_decode`: the dense shard of ``S_local`` tokens,
  decoded at ``local_len = lengths - shard * S_local``.  Every mask of the
  kernel compares local columns with that local length, so the length,
  the causal tail of t_q > 1 and the window stay exact; a local length
  above ``S_local`` means the whole shard is live, a negative one nothing.
  The chunk comes from ``S_local``: the merge equals an unsharded decode at
  the same chunk.
* :func:`local_paged_shard_decode`: pages ``[shard*pp, (shard+1)*pp)`` of
  the pool live on shard ``shard``; the table stays global and replicated,
  and kernels 11-12 run with ``owned`` (the pages this shard holds) over a
  forward-filled local table, as the JAX function passes them.
* :func:`local_shard_append`: the global append range ``[length, length +
  t)`` intersected with the shard, only those rows quantized and written
  (per-token scales: bit-identical to a single-device append).  Paged
  writes go through ``kvcache.paged_append`` / ``paged_prefill`` with
  ``pool_start``.

The four factories (``make_sharded_decode``, ``make_sharded_append``,
``make_sharded_paged_decode``, ``make_sharded_paged_append``) bind a mesh
and return functions of the rank's own tensors: q and the output hold the
rank's query heads (all of them without ``head_axis``), K/V appends its kv
heads, and the cache its shard.  :func:`dense_shard` and
:func:`paged_shard` cut a rank's shard out of a whole cache.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from sageattention_tpu_torch import kvcache
from sageattention_tpu_torch.parallel.mesh import axis_info, require_axis


def refuse_grad(*tensors) -> None:
    """The sharded decoders have no gradient: under grad with an input that
    requires one they raise, as ``jax.grad`` cannot pass the JAX package's
    decode kernels."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in tensors):
        raise NotImplementedError(
            "the sharded decoders have no gradient: the JAX package's decode kernels "
            "define no VJP (ROADMAP limits, 'gradients through the sharded decoders'); "
            "call them under torch.no_grad()"
        )


def merge_over_group(o, m, l, group, out_dtype=None):
    """The exact cross-shard LSE reduce of decode partials (the same math as
    ``decode_cuda.merge_decode_partials``): a row no shard contributed to
    (den == 0) gives 0, as the kernel's empty-row epilogue does.  Returns o
    in ``out_dtype`` (default o's)."""
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    w = l * torch.exp2(m - m_g)
    den = w.clone()
    dist.all_reduce(den, group=group)
    den = torch.where(den == 0.0, 1.0, den)
    num = w[..., None] * o.float()
    dist.all_reduce(num, group=group)
    return (num / den[..., None]).to(out_dtype or o.dtype)


def local_shard_decode(q, cache_shard: kvcache.QuantKVCache, lengths, *, shard: int,
                       sm_scale: float | None = None, window: int | None = None,
                       chunk: int = 4096):
    """Shard ``shard``'s partial decode over its ``S_local`` tokens of the
    dense cache: (o fp32, m, l), ``lengths`` global."""
    local_len = lengths.to(torch.int32) - shard * cache_shard.max_len
    return kvcache.sageattn_decode(q, cache_shard, local_len, sm_scale=sm_scale, chunk=chunk,
                                   window=window, return_state=True, out_dtype=torch.float32)


def forward_fill(vals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``vals`` forward-filled along dim 1 where ``valid`` (0 before the
    first valid entry)."""
    cols = torch.arange(vals.shape[1], device=vals.device).expand_as(vals)
    last = torch.where(valid, cols, -1).cummax(dim=1).values
    return torch.where(last >= 0, torch.gather(vals, 1, last.clamp_min(0)), 0)


def owned_pages(page_table: torch.Tensor, shard: int, pages_per_shard: int):
    """(owned, local table): the int32 [b, max_pages] mask of the logical
    pages whose physical page lives on ``shard``, and the table in the
    shard's page ids, forward-filled over the pages it does not own."""
    lo = shard * pages_per_shard
    owned = (page_table >= lo) & (page_table < lo + pages_per_shard)
    local = forward_fill(torch.where(owned, page_table - lo, 0), owned)
    return owned.to(torch.int32), local.to(torch.int32)


def local_paged_shard_decode(q, cache_shard: kvcache.PagedKVCache, lengths, *, shard: int,
                             sm_scale: float | None = None, window: int | None = None):
    """Shard ``shard``'s partial decode over the pages of the pool it holds
    (``cache_shard.page_table`` the global table): (o fp32, m, l)."""
    owned, local = owned_pages(cache_shard.page_table, shard, cache_shard.pages_k.shape[0])
    return kvcache.sageattn_paged_decode(q, dataclasses.replace(cache_shard, page_table=local),
                                         lengths, owned=owned, sm_scale=sm_scale, window=window,
                                         return_state=True, out_dtype=torch.float32)


def _write_window(buf, rows, start, offw, keep_len: int) -> None:
    """Write ``rows`` [b, h, w, (d)] at the ``w`` positions ``start + i`` of
    ``buf`` [b, h, S_local, (d)]: position p takes row ``p - offw`` where
    that is in [0, keep_len), else keeps its value.  The positions are
    distinct, so no two writes meet."""
    b, w = rows.shape[0], rows.shape[2]
    bi = torch.arange(b, device=buf.device)[:, None]
    pos = start[:, None] + torch.arange(w, device=buf.device)          # [b, w]
    j = pos - offw[:, None]
    use = (j >= 0) & (j < keep_len)
    idx = j.clamp(0, w - 1)
    idx = idx.view(b, 1, w, *([1] * (rows.dim() - 3))).expand_as(rows)
    new = torch.gather(rows, 2, idx)
    old = buf[bi, :, pos]                                              # [b, w, h, (d)]
    old = old.permute(0, 2, 1, *range(3, old.dim()))
    use = use.view(b, 1, w, *([1] * (rows.dim() - 3)))
    merged = torch.where(use, new, old)
    buf[bi, :, pos] = merged.permute(0, 2, 1, *range(3, merged.dim()))


def local_shard_append(cache_shard: kvcache.QuantKVCache, lengths, k_new, v_new, *,
                       shard: int, n_shards: int):
    """Shard ``shard``'s part of a global ``append_kv`` of t tokens at
    ``lengths``: the rows that land in its ``S_local`` positions, quantized
    and written in place, bit-identical to the single cache's.  Keeps
    ``append_kv``'s overflow rule (a block past the total capacity clamps to
    its end).  Returns (cache_shard, lengths + t).  Computed on the device:
    no host sync."""
    s_local = cache_shard.max_len
    b, h, t, d = k_new.shape
    dev = k_new.device
    glen = lengths.to(torch.int64).clamp_max(max(n_shards * s_local - t, 0))
    off = glen - shard * s_local                      # local position of the block's row 0
    w = min(t, s_local)
    start_j = (-off).clamp(0, t - w)                  # the block's rows in this shard's reach
    offw = off + start_j                              # local position of window row 0
    rows = (start_j[:, None] + torch.arange(w, device=dev))[:, None, :, None].expand(b, h, w, d)
    k_q, k_s = kvcache.quant_calibrated(torch.gather(k_new, 2, rows), cache_shard.k_mean,
                                        cache_shard.bits)
    v_q, v_s = kvcache.quant_calibrated(torch.gather(v_new, 2, rows), cache_shard.v_mean,
                                        cache_shard.bits)
    start = offw.clamp(0, max(s_local - w, 0))
    if cache_shard.bits == 4:
        # write_rows_packed drops the rows outside the shard itself
        kvcache.write_rows_packed(cache_shard.k_i8, k_q, offw)
        kvcache.write_rows_packed(cache_shard.v_i8, v_q, offw)
    else:
        _write_window(cache_shard.k_i8, k_q, start, offw, w)
        _write_window(cache_shard.v_i8, v_q, start, offw, w)
    _write_window(cache_shard.k_scale, k_s, start, offw, w)
    _write_window(cache_shard.v_scale, v_s, start, offw, w)
    return cache_shard, lengths + t


def dense_shard(cache: kvcache.QuantKVCache, *, shard: int = 0, n_shards: int = 1,
                head_shard: int = 0, n_head_shards: int = 1) -> kvcache.QuantKVCache:
    """A copy of one (sequence, kv-head) shard of a whole dense cache."""
    def cut(x, seq_dim):
        h = x.shape[1] // n_head_shards
        x = x[:, head_shard * h:(head_shard + 1) * h]
        if seq_dim is not None:
            s = x.shape[seq_dim] // n_shards
            x = x.narrow(seq_dim, shard * s, s)
        return x.contiguous().clone()

    return kvcache.QuantKVCache(k_i8=cut(cache.k_i8, 2), k_scale=cut(cache.k_scale, 2),
                                v_i8=cut(cache.v_i8, 2), v_scale=cut(cache.v_scale, 2),
                                k_mean=cut(cache.k_mean, None), v_mean=cut(cache.v_mean, None))


def paged_shard(cache: kvcache.PagedKVCache, *, shard: int = 0, n_shards: int = 1,
                head_shard: int = 0, n_head_shards: int = 1) -> kvcache.PagedKVCache:
    """A copy of one shard of a whole page pool: pages ``[shard*pp,
    (shard+1)*pp)`` and kv heads ``head_shard``; the table stays global."""
    pp = cache.pages_k.shape[0] // n_shards
    h = cache.pages_k.shape[1] // n_head_shards
    hs = slice(head_shard * h, (head_shard + 1) * h)

    def cut(x):
        return x[shard * pp:(shard + 1) * pp, hs].contiguous().clone()

    return dataclasses.replace(
        cache, pages_k=cut(cache.pages_k), pages_k_scale=cut(cache.pages_k_scale),
        pages_v=cut(cache.pages_v), pages_v_scale=cut(cache.pages_v_scale),
        page_table=cache.page_table.clone(), k_mean=cache.k_mean[:, hs].contiguous().clone(),
        v_mean=cache.v_mean[:, hs].contiguous().clone())


def _axes(mesh, axis, head_axis):
    for name in (axis, head_axis):
        if name is not None:
            require_axis(mesh, name)
    return axis_info(mesh, axis)


def make_sharded_decode(mesh, *, axis: str | None = "seq", head_axis: str | None = None,
                        sm_scale: float | None = None, window: int | None = None,
                        chunk: int = 4096):
    """``fn(q, cache_shard, lengths) -> o``: the decode of this rank's query
    heads over its shard of the dense cache, merged over ``axis``; q and o
    [b, hq / tp, t_q, d], ``lengths`` global.  Without ``axis`` the cache is
    split by heads alone and nothing is merged."""
    group, n, shard = _axes(mesh, axis, head_axis)

    def fn(q, cache_shard, lengths):
        refuse_grad(q)
        if axis is None:
            return kvcache.sageattn_decode(q, cache_shard, lengths, sm_scale=sm_scale,
                                           chunk=chunk, window=window)
        o, m, l = local_shard_decode(q, cache_shard, lengths, shard=shard, sm_scale=sm_scale,
                                     window=window, chunk=chunk)
        return merge_over_group(o, m, l, group, q.dtype)

    return fn


def make_sharded_append(mesh, *, axis: str | None = "seq", head_axis: str | None = None):
    """``fn(cache_shard, lengths, k_new, v_new) -> (cache_shard, lengths +
    t)``: a global append of this rank's kv heads [b, hkv / tp, t, d],
    written into its shard (in place)."""
    _, n, shard = _axes(mesh, axis, head_axis)

    def fn(cache_shard, lengths, k_new, v_new):
        refuse_grad(k_new, v_new)
        return local_shard_append(cache_shard, lengths, k_new, v_new, shard=shard, n_shards=n)

    return fn


def make_sharded_paged_decode(mesh, *, axis: str = "seq", head_axis: str | None = None,
                              sm_scale: float | None = None, window: int | None = None):
    """``fn(q, cache_shard, lengths) -> o`` over a page pool split on
    ``axis`` (and its kv heads on ``head_axis``): each rank's partial over
    the pages it holds (kernels 11-12 with ``owned``), one exact merge."""
    group, _, shard = _axes(mesh, axis, head_axis)

    def fn(q, cache_shard, lengths):
        refuse_grad(q)
        o, m, l = local_paged_shard_decode(q, cache_shard, lengths, shard=shard,
                                           sm_scale=sm_scale, window=window)
        return merge_over_group(o, m, l, group, q.dtype)

    return fn


def make_sharded_paged_append(mesh, *, axis: str = "seq", head_axis: str | None = None,
                              prefill: bool = False):
    """``fn(cache_shard, lengths, k_new, v_new) -> (cache_shard, lengths)``:
    each rank writes only the rows whose page it holds (``pool_start``),
    bit-identically to the global pool.  ``prefill=True`` is the
    page-granular bulk load of empty sequences (t a multiple of the page)."""
    _, _, shard = _axes(mesh, axis, head_axis)

    def fn(cache_shard, lengths, k_new, v_new):
        refuse_grad(k_new, v_new)
        start = shard * cache_shard.pages_k.shape[0]
        if prefill:
            return kvcache.paged_prefill(cache_shard, k_new, v_new, pool_start=start)
        return kvcache.paged_append(cache_shard, lengths, k_new, v_new, pool_start=start)

    return fn
