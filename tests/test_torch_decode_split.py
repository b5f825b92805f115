"""The split walk of decode kernels 9 and 11 (``csrc/decode_split_sm90.cuh``),
on the CPU: its host plan, and the numbers it stands for.

``split_plan`` is checked under ``hypothesis``: a cluster of at most 8 CTAs,
at least one split and no more than the chunks, every (chunk, slab) below
the length dealt to exactly one CTA of one split (``split_shares``, the
kernel's own partition), and the dense cache in chunks of C planned as
the paged cache in pages of C.

The kernel's function is the plain decode over each split's consecutive
chunk range (the paged plain version with ``owned`` cut to the range; the
dense cache seen as pages of one chunk), merged in split order with
``merge_decode_partials`` (m the largest, l the weights' sum).  That is
held against the JAX package's whole decode in interpret mode, as
``tests/test_torch_decode.py`` calls it: o within 1e-5 (the merge sums in
another order), m exact (a max), l within 1e-5 relative.
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
