"""The split walk of decode kernels 9-12 (``csrc/decode_split_sm90.cuh``),
on the CPU: its host plan, and the numbers it stands for.

``split_plan`` is checked under ``hypothesis``: a cluster of at most 8 CTAs,
at least one split and no more than the chunks, every (chunk, slab) below
the length dealt to exactly one CTA of one split (``split_shares``, the
kernel's own partition), and the dense cache in chunks of C planned as
the paged cache in pages of C.  With a window (kernels 10 and 12) the
splits cut the window's ``n_live`` chunks from each length's first one,
and a row tile deals only the slabs that meet the keys its rows see: every
slab holding a live (row, key) pair of the tile goes to exactly one CTA of
one split, so each slab left out is wholly masked for the tile.

The kernel's function is the plain decode over each split's consecutive
chunk range (the paged plain version with ``owned`` cut to the range; the
dense cache seen as pages of one chunk), merged in split order with
``merge_decode_partials`` (m the largest, l the weights' sum).  That is
held against the JAX package's whole decode in interpret mode, as
``tests/test_torch_decode.py`` calls it, with and without a window: o
within 1e-5 (the merge sums in another order), m exact (a max), l within
1e-5 relative.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sageattention_tpu.ops import decode_pallas, paged_decode_pallas
from sageattention_tpu_torch.ops import decode_cuda

from test_torch_decode import _cache

_DIMS = (32, 40, 64, 72, 96, 128, 192, 256, 320, 384, 512)


@settings(max_examples=300, deadline=None)
@given(n_chunks=st.integers(1, 600), chunk=st.integers(1, 9000).map(lambda c: 2 * c),
       d=st.sampled_from(_DIMS), rows=st.integers(1, 2048), b=st.integers(1, 8),
       hkv=st.integers(1, 16), frac=st.floats(0.0, 1.0))
def test_split_plan_covers_every_slab_once(n_chunks, chunk, d, rows, b, hkv, frac):
    cl, splits = decode_cuda.split_plan(n_chunks, chunk, d, rows, b, hkv)
    assert cl in (1, 2, 4, 8)
    assert 1 <= splits <= min(n_chunks, decode_cuda.SPLITS_MAX)
    ranges = decode_cuda.split_ranges(n_chunks, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_chunks
    assert all(c0 < c1 for c0, c1 in ranges)  # no empty split
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))  # consecutive
    slab = decode_cuda.split_slab(d)
    if chunk <= slab:
        assert cl == 1  # a chunk of one slab or less is not shared
    if -(-rows // decode_cuda.SPLIT_RT) * hkv * b >= 4 * 132:
        assert splits == 1  # the row tiles already fill two waves of two CTAs an SM
    length = round(frac * n_chunks * chunk)
    if n_chunks * (-(-chunk // slab)) > 20000:
        return  # the dealing below is linear in the slabs
    dealt = [x for got in decode_cuda.split_shares(cl, splits, n_chunks, chunk, d, length).values()
             for x in got]
    want = [(ci, j) for ci in range(n_chunks) if ci * chunk < length
            for j in range(-(-min(chunk, length - ci * chunk) // slab))]
    assert sorted(dealt) == want  # each live slab once
    # a CTA's share fits the S it keeps on chip unless the chunk is above
    # 8 x 512 tokens
    if chunk <= decode_cuda.CL_MAX * decode_cuda.SPLIT_KEEP:
        for got in decode_cuda.split_shares(cl, splits, n_chunks, chunk, d,
                                            n_chunks * chunk).values():
            per = max([sum(c == ci for c, _ in got) for ci in range(n_chunks)])
            assert per * slab <= max(decode_cuda.SPLIT_KEEP, slab)


@settings(max_examples=200, deadline=None)
@given(n=st.integers(1, 64), c128=st.integers(1, 32), d=st.sampled_from(_DIMS),
       b=st.integers(1, 8), hq_hkv=st.sampled_from([(32, 8), (16, 16), (16, 8), (8, 2), (4, 1)]),
       t_q=st.integers(1, 8))
def test_dense_chunk_and_paged_page_plan_alike(n, c128, d, b, hq_hkv, t_q):
    """Dense in chunks of C and paged in pages of C take one plan, so that
    page = chunk stays bit-identical on the card."""
    hq, hkv = hq_hkv
    C = 128 * c128
    q_shape = (b, hq, t_q, d)
    chunk, n_kv, _ = decode_cuda.dense_plan(n * C, hq // hkv * t_q, t_q, C, None)
    if chunk != C:
        return  # the host rules chose another chunk (S itself, or an extend shrink)
    assert decode_cuda.dense_split_plan(q_shape, hkv, n * C, chunk) == \
        decode_cuda.paged_split_plan(q_shape, hkv, C, n)


def test_split_plan_at_the_serving_shapes():
    """The plans the servers' decode steps take (b, heads, d, chunk)."""
    plan = decode_cuda.split_plan
    assert plan(2, 4096, 128, 4, 4, 8) == (8, 2)       # llm_dense step
    assert plan(8, 1024, 128, 4, 4, 8) == (2, 8)       # llm_paged step
    assert plan(16, 4096, 128, 4, 1, 4) == (8, 16)     # a sharded_dense shard
    assert plan(128, 1024, 128, 4, 1, 8) == (2, 32)    # a sharded_paged shard
    assert plan(2, 4096, 256, 1, 4, 16) == (8, 2)      # the Gemma-7B step
    assert plan(512, 16, 512, 1, 4, 16) == (1, 9)      # pages of 16 at d 512
    assert plan(9, 1024, 128, 2048, 2, 8) == (2, 1)    # an extend block


def _split_decode(q, pool, table, lengths, owned, plan):
    """The plain decode of each split's chunk range, merged in split order:
    (o, m, l) as the kernel's merge gives them."""
    max_pages = table.shape[1]
    parts = []
    for c0, c1 in decode_cuda.split_ranges(max_pages, plan[1]):
        own = torch.zeros_like(table)
        own[:, c0:c1] = 1
        if owned is not None:
            own = own * owned
        parts.append(decode_cuda.sage_paged_decode_attention_plain(
            q, *pool, table, lengths, owned=own, return_state=True))
    o, m, l = (torch.stack(x) for x in zip(*parts))
    m_g = m.amax(dim=0)
    return decode_cuda.merge_decode_partials(o, m, l), m_g, (l * torch.exp2(m - m_g)).sum(0)


# kind, packed, t_q
CASES = [(kind, packed, t_q) for kind in ("dense", "paged", "owned") for packed in (False, True)
         for t_q in (1, 4)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{'int4' if c[1] else 'int8'}"
                         f"-tq{c[2]}")
def test_split_merge_matches_jax_decode(case):
    kind, packed, t_q = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    hq, hkv, d = 8, 2, 64
    C = 128 if kind == "dense" else 16
    n = 4 if kind == "dense" else 20
    S = C * n
    lengths = np.array([-5, 0, 1, C - 1, C, C + 1, S], np.int32)
    b = len(lengths)
    q = rng.standard_normal((b, hq, t_q, d)).astype(np.float32)
    if kind == "dense":
        k, ks, v, vs = _cache(rng, (b, hkv), S, d, packed)
        res_j = decode_pallas.sage_decode_attention(
            *(jnp.array(x) for x in (q, k, ks, v, vs, lengths)), chunk=C, return_state=True,
            interpret=True)
        # the dense cache as pages of one chunk, in order
        cb = k.shape[2] // n
        pool = [torch.tensor(x.reshape(b, hkv, n, x.shape[2] // n, *x.shape[3:]).swapaxes(1, 2)
                             .reshape(b * n, hkv, x.shape[2] // n, *x.shape[3:]).copy())
                for x in (k, ks, v, vs)]
        assert pool[0].shape[2] == cb
        table = torch.arange(b * n, dtype=torch.int32).reshape(b, n)
        owned = None
        plan = decode_cuda.dense_split_plan(q.shape, hkv, S, C)
    else:
        pages = b * n + 5
        k, ks, v, vs = _cache(rng, (pages, hkv), C, d, packed)
        tab = rng.permutation(pages)[:b * n].reshape(b, n).astype(np.int32)
        own = None
        if kind == "owned":
            own = (rng.random((b, n)) < 0.5).astype(np.int32)
        plan = decode_cuda.paged_split_plan(q.shape, hkv, C, n)
        if kind == "owned":
            c0, c1 = decode_cuda.split_ranges(n, plan[1])[0]
            own[:, c0:c1] = 0  # a split that holds no owned page
        res_j = paged_decode_pallas.sage_paged_decode_attention(
            *(jnp.array(x) for x in (q, k, ks, v, vs, tab, lengths)),
            owned=None if own is None else jnp.array(own), return_state=True, interpret=True)
        pool = [torch.tensor(x) for x in (k, ks, v, vs)]
        table = torch.tensor(tab)
        owned = None if own is None else torch.tensor(own)
    assert plan[1] > 1, plan  # the case splits the walk
    o, m, l = _split_decode(torch.tensor(q), pool, table, torch.tensor(lengths), owned, plan)
    np.testing.assert_allclose(o.numpy(), np.asarray(res_j[0], np.float32), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(m.numpy(), np.asarray(res_j[1]))
    np.testing.assert_allclose(l.numpy(), np.asarray(res_j[2]), rtol=1e-5, atol=0)
    # rows with no live key anywhere: o = 0, m = NEG_INIT, l = 0
    dead = np.asarray(res_j[2]) == 0
    assert dead.any()
    assert (o.numpy()[dead] == 0).all() and (m.numpy()[dead] == decode_cuda.NEG_INIT).all()


def _live_slabs(length, t_q, window, trows, chunk, n_chunks, slab):
    """{(chunk, slab)}: the slabs that hold a live (row, key) pair for rows
    of the query tokens ``trows`` (decode_body.cuh's Mask), over the cache's
    n_chunks x chunk keys."""
    out = set()
    for t in trows:
        hi = min(length - t_q + 1 + t, n_chunks * chunk)
        lo = 0 if window is None else max(length - t_q + t - window + 1, 0)
        for ci in range(max(lo, 0) // chunk, -(-hi // chunk) if hi > 0 else 0):
            a = max(lo - ci * chunk, 0)
            b = min(hi - ci * chunk, chunk)
            out.update((ci, j) for j in range(a // slab, -(-b // slab)))
    return out


@settings(max_examples=300, deadline=None)
@given(n_chunks=st.integers(1, 24), chunk=st.sampled_from([16, 48, 64, 128, 256, 640, 1024, 1536]),
       d=st.sampled_from(_DIMS), t_q=st.sampled_from([1, 2, 4, 5, 64, 100, 512]),
       group=st.sampled_from([1, 2, 4, 8]), window=st.one_of(st.none(), st.integers(1, 5000)),
       cl=st.sampled_from([1, 2, 4, 8]), splits=st.integers(1, 32), data=st.data())
def test_windowed_split_deals_each_live_slab_once(n_chunks, chunk, d, t_q, group, window, cl,
                                                   splits, data):
    """Over lengths (negative, 0, 1, about the window's first key, about
    chunk edges, S and past S), query tokens, windows, GQA groups (so row
    tiles of every query-token span) and plans: in each row tile, every slab
    holding a live (row, key) pair goes to exactly one CTA of one split, and
    every slab dealt lies in the walked chunks; so a slab left out is
    wholly masked for the tile."""
    S = n_chunks * chunk
    span = (window or 0) + t_q - 1
    length = data.draw(st.one_of(
        st.sampled_from([-7, 0, 1, span - 1, span, span + 1, chunk - 1, chunk, chunk + 1,
                         S - chunk + 1, S - 1, S, S + 1, S + 300]),
        st.integers(-20, S + 50)))
    n_live = None if window is None else min(n_chunks, -(-span // chunk) + 1)
    start, count = decode_cuda.walked_chunks(length, t_q, chunk, n_chunks, window, n_live)
    splits = min(splits, count)
    slab = decode_cuda.split_slab(d)
    rows = group * t_q
    tile = decode_cuda.SPLIT_RT
    for row0 in range(0, rows, tile):
        tokens = decode_cuda.tile_tokens(row0, rows, t_q)
        shares = decode_cuda.split_shares(cl, splits, n_chunks, chunk, d, length, t_q=t_q,
                                          window=window, n_live=n_live, tokens=tokens)
        dealt = [x for got in shares.values() for x in got]
        assert len(dealt) == len(set(dealt))  # no slab twice
        assert all(start <= ci < start + count and 0 <= j < -(-chunk // slab)
                   for ci, j in dealt)
        trows = sorted({r % t_q for r in range(row0, min(row0 + tile, rows))})
        live = _live_slabs(length, t_q, window, trows, chunk, n_chunks, slab)
        # the window's walked chunks hold every live key, as the Pallas kernel's do
        assert all(start <= ci < start + count for ci, _ in live)
        assert live <= set(dealt)  # each live slab once
        if window is None and t_q == 1:  # the whole walk below the length, as before
            assert set(dealt) == live


def test_window_split_plan_at_the_serving_shapes():
    """The plans of the windowed servers' decode steps and extend block."""
    dc = decode_cuda
    # llm_window_dense step: b 2, 32/8 heads of 128, S 9216, window 4096
    assert dc.dense_plan(9216, 4, 1, 4096, 4096) == (1536, 6, 4)
    assert dc.window_split_plan((2, 32, 1, 128), 8, 1536, 4) == (8, 4)  # 512 CTAs
    # llm_window_paged step: pages of 1024
    assert dc.paged_plan(1024, 9, 4, 4, 1, 4096) == 5
    assert dc.window_split_plan((2, 32, 1, 128), 8, 1024, 5) == (4, 5)  # 320 CTAs
    # the extend block (t_q 512): n_live 6 of 1024 tokens, one split
    assert dc.paged_plan(1024, 9, 2048, 4, 512, 4096) == 6
    assert dc.dense_plan(9216, 2048, 512, 4096, 4096) == (1024, 9, 6)
    assert dc.window_split_plan((2, 32, 512, 128), 8, 1024, 6) == (2, 1)  # 4,096 CTAs


def _window_split_decode(q, pool, table, lengths, owned, window, plan, n_live):
    """The plain windowed decode of each split's chunk range within each
    length's [start, start + n_live), merged in split order: (o, m, l) as
    the kernel's merge gives them."""
    t_q, page = q.shape[2], pool[1].shape[2]
    max_pages = table.shape[1]
    parts = []
    for c0, c1 in decode_cuda.split_ranges(n_live, plan[1]):
        own = torch.zeros_like(table)
        for bi, length in enumerate(lengths.tolist()):
            start = decode_cuda.window_start(length, window + t_q - 1, page, max_pages, n_live)
            own[bi, start + c0:start + c1] = 1
        if owned is not None:
            own = own * owned
        parts.append(decode_cuda.sage_paged_decode_attention_plain(
            q, *pool, table, lengths, owned=own, window=window, return_state=True))
    o, m, l = (torch.stack(x) for x in zip(*parts))
    m_g = m.amax(dim=0)
    return decode_cuda.merge_decode_partials(o, m, l), m_g, (l * torch.exp2(m - m_g)).sum(0)


# kind, packed, t_q (16: a small extend block, GQA 4 x 16 = 64 rows, four row tiles)
WINDOW_CASES = [(kind, packed, t_q) for kind in ("dense", "paged", "owned")
                for packed in (False, True) for t_q in (1, 4, 16)]


@pytest.mark.parametrize("case", WINDOW_CASES, ids=lambda c: f"{c[0]}-"
                         f"{'int4' if c[1] else 'int8'}-tq{c[2]}")
def test_window_split_merge_matches_jax_decode(case):
    kind, packed, t_q = case
    rng = np.random.default_rng(zlib.crc32(repr(("window",) + case).encode()))
    hq, hkv, d, window = 8, 2, 64, 200
    C = 128 if kind == "dense" else 16
    n = 8 if kind == "dense" else 24
    S = C * n
    lengths = np.array([-5, 0, 1, window - 1, window + t_q, 3 * C + 1, S, S + 3], np.int32)
    b = len(lengths)
    q = rng.standard_normal((b, hq, t_q, d)).astype(np.float32)
    rows = hq // hkv * t_q
    if kind == "dense":
        k, ks, v, vs = _cache(rng, (b, hkv), S, d, packed)
        chunk, n_kv, n_live = decode_cuda.dense_plan(S, rows, t_q, C, window)
        assert (chunk, n_kv) == (C, n)
        res_j = decode_pallas.sage_decode_attention(
            *(jnp.array(x) for x in (q, k, ks, v, vs, lengths)), chunk=C, window=window,
            return_state=True, interpret=True)
        # the dense cache as pages of one chunk, in order
        pool = [torch.tensor(x.reshape(b, hkv, n, x.shape[2] // n, *x.shape[3:]).swapaxes(1, 2)
                             .reshape(b * n, hkv, x.shape[2] // n, *x.shape[3:]).copy())
                for x in (k, ks, v, vs)]
        table = torch.arange(b * n, dtype=torch.int32).reshape(b, n)
        owned = None
    else:
        pages = b * n + 5
        k, ks, v, vs = _cache(rng, (pages, hkv), C, d, packed)
        tab = rng.permutation(pages)[:b * n].reshape(b, n).astype(np.int32)
        own = None
        if kind == "owned":
            own = (rng.random((b, n)) < 0.5).astype(np.int32)
        n_live = decode_cuda.paged_plan(C, n, rows, hq // hkv, t_q, window)
        res_j = paged_decode_pallas.sage_paged_decode_attention(
            *(jnp.array(x) for x in (q, k, ks, v, vs, tab, lengths)),
            owned=None if own is None else jnp.array(own), window=window, return_state=True,
            interpret=True)
        pool = [torch.tensor(x) for x in (k, ks, v, vs)]
        table = torch.tensor(tab)
        owned = None if own is None else torch.tensor(own)
    plan = decode_cuda.window_split_plan(q.shape, hkv, C, n_live)
    assert plan[1] > 1, plan  # the case splits the window's walk
    o, m, l = _window_split_decode(torch.tensor(q), pool, table, torch.tensor(lengths), owned,
                                   window, plan, n_live)
    # the port's own whole windowed decode, the splits' sums aside
    whole = decode_cuda.sage_paged_decode_attention_plain(
        torch.tensor(q), *pool, table, torch.tensor(lengths), owned=owned, window=window,
        return_state=True)
    np.testing.assert_allclose(o.numpy(), whole[0].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(m.numpy(), whole[1].numpy())
    np.testing.assert_allclose(l.numpy(), whole[2].numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(res_j[0], np.float32), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(m.numpy(), np.asarray(res_j[1]))
    np.testing.assert_allclose(l.numpy(), np.asarray(res_j[2]), rtol=1e-5, atol=0)
    # rows with no live key anywhere: o = 0, m = NEG_INIT, l = 0
    dead = np.asarray(res_j[2]) == 0
    assert dead.any()
    assert (o.numpy()[dead] == 0).all() and (m.numpy()[dead] == decode_cuda.NEG_INIT).all()
