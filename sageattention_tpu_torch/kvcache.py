"""Quantized KV cache for decode serving: the counterpart of the JAX
package's ``kvcache.py``, on ``torch.Tensor``s.

K and V are stored as int8 codes (or two 4-bit codes a byte, ``bits=4``)
with one fp32 scale a token, so an append is a pure quantized write: no
requantization of what is cached.  The decode attention reads the cache
through the kernels of ``ops/decode_cuda.py`` (the dense cache, kernels 9
and 10) or through a page table (the paged cache, kernels 11 and 12).

    cache = init_kv_cache(b, h_kv, max_len, head_dim, device="cuda")
    cache, lengths = append_kv(cache, lengths, k_new, v_new)   # prefill
    o = sageattn_decode(q, cache, lengths)                     # per step

Where the JAX functions return new arrays, the appends here write into the
cache's tensors in place and return the same cache: a decode step would
otherwise copy a multi-GB cache.  The returned lengths are ``lengths + t``,
as in JAX.  Every write offset is computed on the device, so an append
never waits for the card.  The cache writes and the V-mean add-back are
plain tensor code, as they are XLA in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from sageattention_tpu_torch import quant
from sageattention_tpu_torch.ops import decode_cuda
from sageattention_tpu_torch.ops.decode_cuda import unpack_token_pairs

@dataclasses.dataclass
class QuantKVCache:
    """int8 (or packed 4-bit) K/V [b, h_kv, max_len, d] (``max_len/2`` rows
    packed) with per-token fp32 scales [b, h_kv, max_len], and the frozen
    per-channel means [b, h_kv, 1, d] subtracted before quantization
    (:func:`calibrate`; zero by default)."""

    k_i8: torch.Tensor
    k_scale: torch.Tensor
    v_i8: torch.Tensor
    v_scale: torch.Tensor
    k_mean: torch.Tensor
    v_mean: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k_scale.shape[2]

    @property
    def bits(self) -> int:
        return 4 if self.k_i8.shape[2] != self.k_scale.shape[2] else 8


def pack_token_pairs(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] two tokens a byte along the token axis
    (-2): byte (t, c) holds token 2t's channel c in the low nibble and token
    2t+1's in the high nibble."""
    t = q.shape[-2]
    assert t % 2 == 0, t
    lo = q[..., 0::2, :].to(torch.int8)
    hi = q[..., 1::2, :].to(torch.int8)
    return (hi << 4) | (lo & 0x0F)


def _cache_zeros(shape, bits: int, device) -> torch.Tensor:
    if bits == 4:
        assert shape[-2] % 2 == 0, shape
        shape = shape[:-2] + (shape[-2] // 2, shape[-1])
    return torch.zeros(shape, dtype=torch.int8, device=device)


def init_kv_cache(b: int, h_kv: int, max_len: int, head_dim: int, bits: int = 8,
                  device="cuda") -> QuantKVCache:
    """An empty dense cache; ``bits=4`` packs two tokens a byte (``max_len``
    even)."""
    assert bits in (8, 4), bits
    assert bits == 8 or max_len % 2 == 0, max_len
    f32 = dict(dtype=torch.float32, device=device)
    return QuantKVCache(
        k_i8=_cache_zeros((b, h_kv, max_len, head_dim), bits, device),
        k_scale=torch.full((b, h_kv, max_len), 1e-30, **f32),
        v_i8=_cache_zeros((b, h_kv, max_len, head_dim), bits, device),
        v_scale=torch.full((b, h_kv, max_len), 1e-30, **f32),
        k_mean=torch.zeros(b, h_kv, 1, head_dim, **f32),
        v_mean=torch.zeros(b, h_kv, 1, head_dim, **f32),
    )


def calibrate(cache, k_sample: torch.Tensor, v_sample: torch.Tensor,
              lengths: torch.Tensor | None = None):
    """Freeze per-channel K/V means from sample tokens [b, h_kv, t, d]
    (typically the prompt, before its append).  The K shift is
    softmax-invariant and the V shift is added back exactly, so both are
    free.  Must run on an empty cache: with ``lengths``, batches whose
    length is not 0 keep their frozen means.  Returns a cache sharing the
    K/V tensors, with new means."""
    k_m = k_sample.float().mean(dim=2, keepdim=True)
    v_m = v_sample.float().mean(dim=2, keepdim=True)
    if lengths is not None:
        empty = (lengths.to(torch.int32) == 0)[:, None, None, None]
        k_m = torch.where(empty, k_m, cache.k_mean)
        v_m = torch.where(empty, v_m, cache.v_mean)
    return dataclasses.replace(cache, k_mean=k_m, v_mean=v_m)


def _quant_rows(x: torch.Tensor, bits: int = 8):
    """Per-token int8 (+-127) or int4 (+-7) codes of [b, h, t, d], unpacked,
    and the fp32 scales [b, h, t]."""
    xf = x.float()
    qmax = 127.0 if bits == 8 else 7.0
    scale, r = quant.inv_scale(xf.abs().amax(dim=-1), qmax)
    q = quant.round_half_away(xf * r[..., None]).clamp(-qmax, qmax).to(torch.int8)
    return q, scale


def quant_calibrated(x: torch.Tensor, mean: torch.Tensor, bits: int):
    """The cache-write quantization of every append and prefill: fp32, minus
    the frozen per-channel mean, per-token codes (unpacked)."""
    return _quant_rows(x.float() - mean, bits)


def _batch_index(b: int, device) -> torch.Tensor:
    return torch.arange(b, device=device)[:, None]


def write_rows_packed(buf: torch.Tensor, rows: torch.Tensor, off: torch.Tensor) -> None:
    """Write ``rows[:, :, j]`` ([b, h, w, d] in [-8, 7]) to token ``off[i] +
    j`` of each batch's token-pair-packed buffer ``buf`` [b, h, S/2, d], in
    place; tokens outside [0, S) drop.  A read-modify-write of the byte
    window the rows can touch: the nibble a row shares a byte with is kept."""
    b, h, half, d = buf.shape
    w = rows.shape[2]
    wb = min(w // 2 + 1, half)
    off = off.to(torch.int64)
    first = off.clamp(0, 2 * half - 1) // 2
    b0 = first.clamp(0, half - wb)                                  # [b]
    bpos = b0[:, None] + torch.arange(wb, device=buf.device)        # [b, wb]
    bi = _batch_index(b, buf.device)
    old = buf[bi, :, bpos].permute(0, 2, 1, 3)                      # [b, h, wb, d]
    toks = unpack_token_pairs(old)                                  # [b, h, 2wb, d]
    pos = 2 * b0[:, None] + torch.arange(2 * wb, device=buf.device)
    j = pos - off[:, None]                                          # [b, 2wb]
    use = (j >= 0) & (j < w)
    new = torch.gather(rows, 2, j.clamp(0, w - 1)[:, None, :, None].expand(b, h, 2 * wb, d))
    merged = torch.where(use[:, None, :, None], new, toks)
    buf[bi, :, bpos] = pack_token_pairs(merged).permute(0, 2, 1, 3)


def _vmean_addback(o: torch.Tensor, lengths: torch.Tensor, v_mean: torch.Tensor) -> torch.Tensor:
    """The exact V-mean add-back (softmax rows sum to 1); a zero-length slot
    keeps its 0 output."""
    group = o.shape[1] // v_mean.shape[1]
    live = (lengths.to(torch.int32) > 0)[:, None, None, None]
    vm = torch.where(live, v_mean.repeat_interleave(group, dim=1), 0.0)
    return o + vm.to(o.dtype)


def append_kv(cache: QuantKVCache, lengths: torch.Tensor, k_new: torch.Tensor,
              v_new: torch.Tensor):
    """Quantize and write t new tokens at each batch's ``lengths`` offset,
    in place.  Returns (cache, lengths + t).  The caller owns capacity: an
    append past ``max_len`` clamps to the end and overwrites the tail, as
    JAX's ``dynamic_update_slice`` does."""
    k_q, k_s = quant_calibrated(k_new, cache.k_mean, cache.bits)
    v_q, v_s = quant_calibrated(v_new, cache.v_mean, cache.bits)
    b, h, t, d = k_new.shape
    S = cache.max_len
    off = lengths.to(torch.int64).clamp_max(max(S - t, 0))
    bi = _batch_index(b, k_new.device)
    # dynamic_update_slice clamps the start so that the update fits
    pos = off.clamp(0, max(S - t, 0))[:, None] + torch.arange(t, device=k_new.device)
    if cache.bits == 4:
        write_rows_packed(cache.k_i8, k_q, off)
        write_rows_packed(cache.v_i8, v_q, off)
    else:
        cache.k_i8[bi, :, pos] = k_q.permute(0, 2, 1, 3)
        cache.v_i8[bi, :, pos] = v_q.permute(0, 2, 1, 3)
    cache.k_scale[bi, :, pos] = k_s.permute(0, 2, 1)
    cache.v_scale[bi, :, pos] = v_s.permute(0, 2, 1)
    return cache, lengths + t


def sageattn_decode(q: torch.Tensor, cache: QuantKVCache, lengths: torch.Tensor, *,
                    sm_scale: float | None = None, chunk: int = 4096,
                    window: int | None = None, return_state: bool = False,
                    out_dtype: torch.dtype | None = None):
    """Decode attention of q [b, hq, t_q, d] against the cache, ``lengths``
    counting the new tokens (append them first).  t_q > 1 gets the causal
    tail; ``window`` reads only the chunks the sliding window reaches.
    ``return_state`` adds the (m, l) merge state.  o is in ``out_dtype``
    (default q's)."""
    res = decode_cuda.sage_decode_attention(
        q, cache.k_i8, cache.k_scale, cache.v_i8, cache.v_scale, lengths,
        sm_scale=sm_scale, chunk=chunk, window=window, return_state=return_state,
        out_dtype=out_dtype,
    )
    o = res[0] if return_state else res
    o = _vmean_addback(o, lengths, cache.v_mean)
    return (o, res[1], res[2]) if return_state else o


# ---------------------------------------------------------------------------
# the paged cache: a pool of fixed-size pages shared by all sequences, and
# a [b, max_pages] page table
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedKVCache:
    """Page pool [num_pages, h_kv, page, d] int8 (``page/2`` rows packed)
    with per-token scales [num_pages, h_kv, page], the [b, max_pages] int32
    page table, and the per-batch channel means."""

    pages_k: torch.Tensor
    pages_k_scale: torch.Tensor
    pages_v: torch.Tensor
    pages_v_scale: torch.Tensor
    page_table: torch.Tensor
    k_mean: torch.Tensor
    v_mean: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.pages_k_scale.shape[2]

    @property
    def bits(self) -> int:
        return 4 if self.pages_k.shape[2] != self.pages_k_scale.shape[2] else 8


def init_paged_kv_cache(num_pages: int, h_kv: int, head_dim: int, page_table: torch.Tensor,
                        page_size: int = 1024, bits: int = 8, device="cuda") -> PagedKVCache:
    assert bits in (8, 4), bits
    assert bits == 8 or page_size % 2 == 0, page_size
    b = page_table.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    return PagedKVCache(
        pages_k=_cache_zeros((num_pages, h_kv, page_size, head_dim), bits, device),
        pages_k_scale=torch.full((num_pages, h_kv, page_size), 1e-30, **f32),
        pages_v=_cache_zeros((num_pages, h_kv, page_size, head_dim), bits, device),
        pages_v_scale=torch.full((num_pages, h_kv, page_size), 1e-30, **f32),
        page_table=page_table.to(device=device, dtype=torch.int32),
        k_mean=torch.zeros(b, h_kv, 1, head_dim, **f32),
        v_mean=torch.zeros(b, h_kv, 1, head_dim, **f32),
    )


def _owned_rows(phys: torch.Tensor, n_pool: int, pool_start: int | None):
    """Pool-local page ids and, for a shard of a pool split over ranks
    (``pool_start`` its first global page id), the mask of the rows whose
    page it holds.  Torch indexing wraps a negative index and has no
    "drop" mode, so a shard writes the masked rows only."""
    if pool_start is None:
        return phys, None
    phys = phys - pool_start
    return phys, (phys >= 0) & (phys < n_pool)


def _put(pool: torch.Tensor, idx: tuple, rows: torch.Tensor, keep) -> None:
    """``pool[idx] = rows``, or only the rows ``keep`` marks."""
    if keep is None:
        pool[idx] = rows
    else:
        pool[tuple(i if isinstance(i, slice) else i[keep] for i in idx)] = rows[keep]


def paged_append(cache: PagedKVCache, lengths: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, pool_start: int | None = None):
    """Quantize and write t tokens a sequence at ``lengths``, following the
    page table across page boundaries, in place.  Appends past the table's
    span clamp to its end and overwrite the tail, as in JAX.  Returns
    (cache, lengths + t).  The table's entries must be valid page ids.

    ``pool_start``: when the pool is one shard of a pool split over ranks
    (``parallel.decode``), its first global page id.  The table keeps global
    ids; a row whose page another shard holds is dropped, so every token
    lands on exactly one shard, bit-identically to the global pool."""
    page = cache.page_size
    k_q, k_s = quant_calibrated(k_new, cache.k_mean, cache.bits)
    v_q, v_s = quant_calibrated(v_new, cache.v_mean, cache.bits)
    b, h, t, d = k_q.shape
    dev = k_new.device
    table = cache.page_table.to(torch.int64)
    n_pool = cache.pages_k.shape[0]
    span = table.shape[1] * page
    start = lengths.to(torch.int64).clamp_max(span - t)
    pos = start[:, None] + torch.arange(t, device=dev)             # [b, t]
    phys, keep = _owned_rows(torch.gather(table, 1, pos // page), n_pool, pool_start)
    off = pos % page

    if cache.bits == 4:
        # the packed pool: read-modify-write the logical byte window the
        # append touches, scattered physically through the table
        nb = min(t // 2 + 1, span // 2)
        b0 = (start // 2).clamp(0, span // 2 - nb)                 # [b]
        tok0 = 2 * (b0[:, None] + torch.arange(nb, device=dev))    # [b, nb]
        bphys, bkeep = _owned_rows(torch.gather(table, 1, tok0 // page), n_pool, pool_start)
        gphys = bphys.clamp(0, n_pool - 1)  # the bytes another shard holds are read, not kept
        brow = (tok0 % page) // 2
        gpos = (tok0[:, :, None] + torch.arange(2, device=dev)).reshape(b, 2 * nb)
        j = gpos - start[:, None]
        use = (j >= 0) & (j < t)
        for pool, rows in ((cache.pages_k, k_q), (cache.pages_v, v_q)):
            old = pool[gphys, :, brow].permute(0, 2, 1, 3)         # [b, h, nb, d]
            toks = unpack_token_pairs(old)
            new = torch.gather(rows, 2, j.clamp(0, t - 1)[:, None, :, None].expand(b, h, 2 * nb, d))
            merged = torch.where(use[:, None, :, None], new, toks)
            _put(pool, (bphys, slice(None), brow), pack_token_pairs(merged).permute(0, 2, 1, 3),
                 bkeep)
    else:
        _put(cache.pages_k, (phys, slice(None), off), k_q.permute(0, 2, 1, 3), keep)
        _put(cache.pages_v, (phys, slice(None), off), v_q.permute(0, 2, 1, 3), keep)
    _put(cache.pages_k_scale, (phys, slice(None), off), k_s.permute(0, 2, 1), keep)
    _put(cache.pages_v_scale, (phys, slice(None), off), v_s.permute(0, 2, 1), keep)
    return cache, lengths + t


def paged_prefill(cache: PagedKVCache, k: torch.Tensor, v: torch.Tensor,
                  pool_start: int | None = None):
    """Bulk-load empty sequences page by page through the table, in place:
    t (a multiple of the page size) tokens a sequence.  Returns (cache,
    lengths = t).  ``pool_start`` as in :func:`paged_append`: a shard writes
    only the pages it holds."""
    page = cache.page_size
    b, h, t, _ = k.shape
    assert t % page == 0, (t, page)
    n_used = t // page
    k_q, k_s = quant_calibrated(k, cache.k_mean, cache.bits)
    v_q, v_s = quant_calibrated(v, cache.v_mean, cache.bits)
    ids, keep = _owned_rows(cache.page_table[:, :n_used].reshape(-1).to(torch.int64),
                            cache.pages_k.shape[0], pool_start)

    def pages(rows):
        # [b, h, n_used * rpp, (d)] -> [b * n_used, h, rpp, (d)]
        r = rows.reshape(b, h, n_used, -1, *rows.shape[3:])
        return r.transpose(1, 2).reshape(b * n_used, h, *r.shape[3:])

    packed = pack_token_pairs if cache.bits == 4 else (lambda x: x)
    _put(cache.pages_k, (ids,), pages(packed(k_q)), keep)
    _put(cache.pages_v, (ids,), pages(packed(v_q)), keep)
    _put(cache.pages_k_scale, (ids,), pages(k_s), keep)
    _put(cache.pages_v_scale, (ids,), pages(v_s), keep)
    return cache, torch.full((b,), t, dtype=torch.int32, device=k.device)


def sageattn_paged_decode(q: torch.Tensor, cache: PagedKVCache, lengths: torch.Tensor, *,
                          owned: torch.Tensor | None = None,
                          sm_scale: float | None = None, window: int | None = None,
                          return_state: bool = False, out_dtype: torch.dtype | None = None):
    """Decode attention through the page table: the query semantics of
    :func:`sageattn_decode`, one page a chunk.  ``owned``: for a shard of a
    pool split over ranks (``parallel.decode``), the [b, max_pages] mask of
    the logical pages it contributes (with ``return_state=True``, for the
    exact merge)."""
    res = decode_cuda.sage_paged_decode_attention(
        q, cache.pages_k, cache.pages_k_scale, cache.pages_v, cache.pages_v_scale,
        cache.page_table, lengths, owned=owned,
        sm_scale=sm_scale, window=window, return_state=return_state, out_dtype=out_dtype,
    )
    o = res[0] if return_state else res
    o = _vmean_addback(o, lengths, cache.v_mean)
    return (o, res[1], res[2]) if return_state else o
