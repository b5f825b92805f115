"""The plain versions of decode kernels 9-12 against the JAX package's Pallas
kernels in interpret mode, on the CPU, from the same numpy inputs.

``sage_decode_attention`` (kernels 9 and 10) is held to
``decode_pallas.sage_decode_attention(..., interpret=True, chunk=...)`` with
the same chunk, and ``sage_paged_decode_attention`` (kernels 11 and 12) to
``paged_decode_pallas.sage_paged_decode_attention(..., interpret=True)``:
ragged and out-of-range lengths, GQA, t_q > 1 (the causal tail), the
sliding window, the packed int4 cache, ``return_state``, scrambled
16-token page tables and head dims other than 64 and 128 (32, 96, and 40
and 72, which are not multiples of 16).

Tolerances: the merge state's running max ``m`` is bit-exact (the Q scale,
the scores and the masks follow the same fp32 chain); ``o`` within 1e-5
and ``l`` within 1e-6 relative, the difference being the order of fp32
sums (XLA's reduction order against PyTorch's).  The host-side chunk rules
are checked exactly, and the outputs against an exact fp32 decode of the
unquantized K/V (cosine >= 0.999, int4 >= 0.98).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import decode_pallas, paged_decode_pallas
from sageattention_tpu_torch.ops import decode_cuda, reference
from sageattention_tpu_torch.utils.compare import cosine_similarity


def _cache(rng, lead, S, d, packed):
    rows = S // 2 if packed else S
    lo, hi = (-128, 128) if packed else (-127, 128)  # a packed byte holds any two nibbles
    k = rng.integers(lo, hi, (*lead, rows, d)).astype(np.int8)
    v = rng.integers(lo, hi, (*lead, rows, d)).astype(np.int8)
    ks = (rng.random((*lead, S)) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random((*lead, S)) * 0.05 + 0.01).astype(np.float32)
    return k, ks, v, vs


def _compare(res_t, res_j, return_state):
    if not return_state:
        res_t, res_j = (res_t,), (res_j,)
    o_t, o_j = res_t[0].float().numpy(), np.asarray(res_j[0], np.float32)
    np.testing.assert_allclose(o_t, o_j, atol=1e-5, rtol=1e-5)
    if return_state:
        np.testing.assert_array_equal(res_t[1].numpy(), np.asarray(res_j[1]))
        np.testing.assert_allclose(res_t[2].numpy(), np.asarray(res_j[2]), rtol=1e-6, atol=0)


DENSE = [
    # b, hq, hkv, t_q, S, d, lengths, chunk, window, packed, return_state
    (2, 8, 2, 1, 512, 64, [300, 200], 128, None, False, False),
    (3, 8, 2, 1, 512, 64, [-5, 512, 700], 256, None, False, True),
    (2, 4, 4, 3, 384, 32, [1, 0], 128, None, False, True),
    (2, 8, 2, 4, 512, 64, [512, 129], 128, None, True, True),
    (2, 8, 2, 1, 1024, 64, [1000, 37], 4096, 200, False, True),
    (2, 8, 2, 5, 1024, 64, [1000, 600], 256, 300, False, True),
    (1, 8, 2, 2, 2048, 64, [1999], 4096, 1100, True, True),
    # head dim 96: the kernels compute at 128 and read the cache at its own
    # head dim, the lanes past it zero
    (2, 8, 2, 1, 512, 96, [300, 200], 128, None, False, True),
    (2, 8, 2, 4, 512, 96, [512, 129], 128, 200, True, True),
    # head dims 40 and 72: not multiples of 16, so the cache rows are off
    # 16-byte alignment (the kernels read them byte by byte)
    (2, 8, 2, 1, 512, 40, [300, 200], 128, None, False, True),
    (2, 8, 2, 4, 512, 40, [512, 129], 128, 200, True, True),
    (2, 8, 2, 1, 512, 72, [300, 200], 128, None, False, True),
    (2, 8, 2, 3, 512, 72, [400, 129], 128, 200, True, True),
    # 128 rows a kv head (a GQA group of 2 x 64 query tokens): many P codes
    # a row, where one at a rounding tie moves with the exponential's last bit
    (1, 4, 2, 64, 1024, 64, [1000], 4096, 200, True, True),
]


@pytest.mark.parametrize("case", DENSE, ids=lambda c: f"b{c[0]}-hq{c[1]}-tq{c[3]}-S{c[4]}-w{c[8]}"
                         f"-{'int4' if c[9] else 'int8'}-state{int(c[10])}")
def test_dense_plain_matches_pallas(case):
    b, hq, hkv, t_q, S, d, lengths, chunk, window, packed, rs = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q = rng.standard_normal((b, hq, t_q, d)).astype(np.float32)
    k, ks, v, vs = _cache(rng, (b, hkv), S, d, packed)
    L = np.array(lengths, np.int32)
    res_j = decode_pallas.sage_decode_attention(
        *(jnp.array(x) for x in (q, k, ks, v, vs, L)), chunk=chunk, window=window,
        return_state=rs, interpret=True)
    res_t = decode_cuda.sage_decode_attention(
        *(torch.tensor(x) for x in (q, k, ks, v, vs, L)), chunk=chunk, window=window,
        return_state=rs)
    _compare(res_t, res_j, rs)


def test_xla_exp2_matches_jnp_exp2():
    """The plain decode's exponential within 1 ulp of ``jax.jit(jnp.exp2)``
    over 10^6 seeded floats in [-40, 0] (``torch.exp2`` is up to 17 ulp off)."""
    x = -40.0 * np.random.default_rng(0).random(10**6, dtype=np.float32)
    got = decode_cuda.xla_exp2(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.exp2)(jnp.asarray(x)))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert got.dtype == np.float32 and ulps.max() <= 1


PAGED = [
    # b, hq, hkv, t_q, page, pool, max_pages, d, lengths, window, packed
    (2, 8, 2, 1, 16, 40, 20, 64, [300, 17], None, False),
    (3, 8, 2, 3, 16, 40, 12, 64, [160, 0, -2], None, True),
    (2, 8, 2, 2, 16, 40, 20, 64, [300, 150], 64, False),
    (2, 4, 1, 1, 16, 40, 20, 32, [320, 99], 40, True),
    (2, 8, 2, 1, 16, 40, 20, 96, [300, 17], None, False),
    (2, 8, 2, 1, 16, 40, 20, 40, [300, 17], None, True),
    (2, 8, 2, 2, 16, 40, 20, 72, [300, 150], 64, False),
    (2, 8, 2, 1, 16, 40, 20, 72, [300, 17], None, True),
]


@pytest.mark.parametrize("case", PAGED, ids=lambda c: f"b{c[0]}-tq{c[3]}-w{c[9]}"
                         f"-{'int4' if c[10] else 'int8'}")
def test_paged_plain_matches_pallas(case):
    b, hq, hkv, t_q, page, pool, max_pages, d, lengths, window, packed = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q = rng.standard_normal((b, hq, t_q, d)).astype(np.float32)
    k, ks, v, vs = _cache(rng, (pool, hkv), page, d, packed)
    table = rng.permutation(pool)[:b * max_pages].reshape(b, max_pages).astype(np.int32)
    L = np.array(lengths, np.int32)
    args = (q, k, ks, v, vs, table, L)
    res_j = paged_decode_pallas.sage_paged_decode_attention(
        *(jnp.array(x) for x in args), window=window, return_state=True, interpret=True)
    res_t = decode_cuda.sage_paged_decode_attention(
        *(torch.tensor(x) for x in args), window=window, return_state=True)
    _compare(res_t, res_j, True)


def test_paged_with_page_equal_chunk_matches_dense():
    """One page a chunk through a scrambled table gives the dense numbers."""
    rng = np.random.default_rng(7)
    b, hq, hkv, d, page, n = 2, 8, 2, 64, 128, 4
    q = torch.tensor(rng.standard_normal((b, hq, 1, d)).astype(np.float32))
    k, ks, v, vs = (torch.tensor(x) for x in _cache(rng, (b, hkv), page * n, d, False))
    table = torch.tensor(rng.permutation(b * n).reshape(b, n).astype(np.int32))
    pool = [torch.empty(b * n, hkv, page, *x.shape[3:], dtype=x.dtype) for x in (k, ks, v, vs)]
    for bi in range(b):
        for j in range(n):
            for p, x in zip(pool, (k, ks, v, vs)):
                p[table[bi, j]] = x[bi, :, j * page:(j + 1) * page]
    lengths = torch.tensor([500, 129], dtype=torch.int32)
    o_d = decode_cuda.sage_decode_attention(q, k, ks, v, vs, lengths, chunk=page)
    o_p = decode_cuda.sage_paged_decode_attention(q, *pool, table, lengths)
    torch.testing.assert_close(o_p, o_d, rtol=0, atol=0)


@pytest.mark.parametrize("window", [None, 300])
def test_decode_tracks_exact_attention(window):
    """The quantized decode of a real cache against the exact fp32 decode of
    unquantized K/V: cosine >= 0.999 with int8, >= 0.98 with int4, whose +-7
    levels leave about 11% rms noise on each Gaussian K/V value (cosine near
    0.988 here), which a near-uniform softmax does not average away."""
    from sageattention_tpu_torch import kvcache

    rng = np.random.default_rng(8)
    b, hq, hkv, t_q, d, S = 2, 8, 2, 3, 64, 1024
    k = torch.tensor(rng.standard_normal((b, hkv, 900, d)).astype(np.float32))
    v = torch.tensor(rng.standard_normal((b, hkv, 900, d)).astype(np.float32))
    q = torch.tensor(rng.standard_normal((b, hq, t_q, d)).astype(np.float32))
    lengths = torch.tensor([900, 555], dtype=torch.int32)
    ref = reference.decode_reference(q, k, v, lengths, window=window)
    for bits, floor in ((8, 0.999), (4, 0.98)):
        cache = kvcache.init_kv_cache(b, hkv, S, d, bits=bits, device="cpu")
        cache, _ = kvcache.append_kv(cache, torch.zeros(b, dtype=torch.int32), k, v)
        o = kvcache.sageattn_decode(q, cache, lengths, window=window)
        for bi, n in enumerate(lengths.tolist()):
            assert cosine_similarity(o[bi], ref[bi]) >= floor, (bits, bi)


def test_host_rules_match_the_jax_package():
    """The chunk divisor, the extend-block shrink and the window plan."""
    for S, cap in ((512, 4096), (8192, 4096), (9216, 2048), (8320, 1024), (384, 256)):
        assert decode_cuda._chunk_divisor(S, cap) == decode_pallas._chunk_divisor(S, cap)
    with pytest.raises(ValueError, match="128-multiple divisor"):
        decode_cuda._chunk_divisor(1000, 512)
    # extend blocks of 512 tokens at GQA 32/8: a 1024-wide chunk; the window
    # plan of the windowed server's decode and extend steps
    assert decode_cuda.dense_plan(9216, 2048, 512, 4096, None) == (1024, 9, None)
    assert decode_cuda.dense_plan(9216, 4, 1, 4096, 4096) == (1536, 6, 4)
    assert decode_cuda.dense_plan(9216, 2048, 512, 4096, 4096) == (1024, 9, 6)
    assert decode_cuda.paged_plan(1024, 9, 2048, 4, 512, 4096) == 6
    with pytest.raises(ValueError, match="tile too large"):
        decode_cuda.paged_plan(2048, 9, 2048, 4, 512, None)


def test_owned_is_not_ported():
    """The sharded pool's ``owned`` mask is ported now (the test keeps its
    name): a partial decode needs ``return_state``, and a mask that owns
    every page gives the whole decode's numbers."""
    rng = np.random.default_rng(10)
    q = torch.tensor(rng.standard_normal((1, 2, 1, 32)).astype(np.float32))
    k, ks, v, vs = (torch.tensor(x) for x in _cache(rng, (2, 1), 16, 32, False))
    table = torch.tensor([[1, 0]], dtype=torch.int32)
    lengths = torch.tensor([27], dtype=torch.int32)
    owned = torch.ones(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="return_state"):
        decode_cuda.sage_paged_decode_attention(q, k, ks, v, vs, table, lengths, owned=owned)
    res = decode_cuda.sage_paged_decode_attention(q, k, ks, v, vs, table, lengths, owned=owned,
                                                  return_state=True)
    ref = decode_cuda.sage_paged_decode_attention(q, k, ks, v, vs, table, lengths,
                                                  return_state=True)
    for x, y in zip(res, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_merge_decode_partials_matches_jax():
    rng = np.random.default_rng(9)
    o = rng.standard_normal((3, 2, 4, 2, 16)).astype(np.float32)
    m = (rng.standard_normal((3, 2, 4, 2)) * 4).astype(np.float32)
    l = (rng.random((3, 2, 4, 2)) * 10).astype(np.float32)
    m[1, 0] = decode_cuda.NEG_INIT   # an empty shard
    l[1, 0] = 0.0
    m[:, 1, 0], l[:, 1, 0] = decode_cuda.NEG_INIT, 0.0   # a row empty everywhere
    t = decode_cuda.merge_decode_partials(*(torch.tensor(x) for x in (o, m, l)))
    j = decode_pallas.merge_decode_partials(*(jnp.array(x) for x in (o, m, l)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=1e-6)
    assert float(t[1, 0].abs().max()) == 0.0


def test_merge_of_shards_equals_one_decode():
    """Two decodes over the halves of a cache, merged, equal one decode over
    all of it to fp32 round-off (chunks are whole in both)."""
    rng = np.random.default_rng(10)
    b, hq, hkv, d, S = 2, 8, 2, 64, 512
    q = torch.tensor(rng.standard_normal((b, hq, 1, d)).astype(np.float32))
    k, ks, v, vs = (torch.tensor(x) for x in _cache(rng, (b, hkv), S, d, False))
    lengths = torch.tensor([500, 300], dtype=torch.int32)
    full = decode_cuda.sage_decode_attention(q, k, ks, v, vs, lengths, chunk=128)
    parts = [decode_cuda.sage_decode_attention(
        q, *(x[:, :, lo:lo + 256].contiguous() for x in (k, ks, v, vs)), lengths - lo,
        chunk=128, return_state=True) for lo in (0, 256)]
    merged = decode_cuda.merge_decode_partials(*(torch.stack(x) for x in zip(*parts)))
    torch.testing.assert_close(merged, full, atol=1e-5, rtol=1e-5)
