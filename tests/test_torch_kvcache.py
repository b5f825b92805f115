"""The port's quantized KV cache against the JAX package's ``kvcache``, on the
CPU, from the same numpy inputs.

Every write is bit-exact: the codes, the per-token scales and the means
(dense and paged appends, the paged bulk prefill, the packed int4
read-modify-write at odd offsets, the clamp of an append past the end,
``calibrate`` with its lengths guard).  The port writes in place; the JAX
functions return new arrays, which are compared with the port's tensors
after the write.  ``sageattn_decode`` adds the V mean back to the decode
kernel's output exactly as JAX does (bit-exact given the same kernel
output, checked through the plain version at fp32 round-off, 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import kvcache as jkv
from sageattention_tpu_torch import kvcache as tkv


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _same(t, j):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


def _same_cache(tc, jc):
    for name in ("k_i8", "k_scale", "v_i8", "v_scale", "k_mean", "v_mean"):
        _same(getattr(tc, name), getattr(jc, name))


def _same_paged(tc, jc):
    for name in ("pages_k", "pages_k_scale", "pages_v", "pages_v_scale", "k_mean", "v_mean"):
        _same(getattr(tc, name), getattr(jc, name))


def test_pack_unpack_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 8, (2, 3, 10, 16)).astype(np.int8)
    p_t = tkv.pack_token_pairs(torch.tensor(x))
    _same(p_t, jkv.pack_token_pairs(jnp.array(x)))
    _same(tkv.unpack_token_pairs(p_t), x)


@pytest.mark.parametrize("bits", [8, 4])
def test_append_kv_bit_exact(bits):
    """Prefill then decode-sized appends at ragged offsets, and an append
    past the end that clamps."""
    rng = np.random.default_rng(1)
    b, h, S, d = 3, 2, 64, 16
    tc = tkv.init_kv_cache(b, h, S, d, bits=bits, device="cpu")
    jc = jkv.init_kv_cache(b, h, S, d, bits=bits)
    lengths = np.array([0, 5, 0], np.int32)
    lt, lj = torch.tensor(lengths), jnp.array(lengths)
    for t in (7, 1, 3, 1):
        k, v = _rand(rng, (b, h, t, d), 2.0), _rand(rng, (b, h, t, d))
        tc, lt = tkv.append_kv(tc, lt, torch.tensor(k), torch.tensor(v))
        jc, lj = jkv.append_kv(jc, lj, jnp.array(k), jnp.array(v))
        _same_cache(tc, jc)
        _same(lt, lj)
    # past the end: clamps to the tail
    lt, lj = torch.tensor([60, 63, 10], dtype=torch.int32), jnp.array([60, 63, 10], jnp.int32)
    k, v = _rand(rng, (b, h, 6, d)), _rand(rng, (b, h, 6, d))
    tc, lt = tkv.append_kv(tc, lt, torch.tensor(k), torch.tensor(v))
    jc, lj = jkv.append_kv(jc, lj, jnp.array(k), jnp.array(v))
    _same_cache(tc, jc)
    _same(lt, lj)


@pytest.mark.parametrize("off", [-3, 0, 5, 8, 29])
def test_write_rows_packed_bit_exact(off):
    rng = np.random.default_rng(2)
    h, S, d, w = 2, 32, 8, 5
    buf = rng.integers(-128, 128, (h, S // 2, d)).astype(np.int8)
    rows = rng.integers(-8, 8, (h, w, d)).astype(np.int8)
    tb = torch.tensor(buf)[None].clone()
    tkv.write_rows_packed(tb, torch.tensor(rows)[None], torch.tensor([off]))
    _same(tb[0], jkv.write_rows_packed(jnp.array(buf), jnp.array(rows), jnp.int32(off)))


def test_calibrate_lengths_guard():
    rng = np.random.default_rng(3)
    b, h, S, d = 2, 2, 16, 8
    tc = tkv.init_kv_cache(b, h, S, d, bits=4, device="cpu")
    jc = jkv.init_kv_cache(b, h, S, d, bits=4)
    k0, v0 = _rand(rng, (b, h, 4, d)) + 1.0, _rand(rng, (b, h, 4, d)) - 2.0
    tc = tkv.calibrate(tc, torch.tensor(k0), torch.tensor(v0))
    jc = jkv.calibrate(jc, jnp.array(k0), jnp.array(v0))
    _same_cache(tc, jc)
    # batch 1 is live: its means stay frozen
    k1, v1 = _rand(rng, (b, h, 4, d)), _rand(rng, (b, h, 4, d))
    lengths = np.array([0, 4], np.int32)
    tc = tkv.calibrate(tc, torch.tensor(k1), torch.tensor(v1), torch.tensor(lengths))
    jc = jkv.calibrate(jc, jnp.array(k1), jnp.array(v1), jnp.array(lengths))
    _same_cache(tc, jc)
    _same(tc.k_mean[1], np.asarray(k0.mean(axis=2, keepdims=True)[1]))


def _tables(rng, b, n):
    return rng.permutation(b * n).reshape(b, n).astype(np.int32)


@pytest.mark.parametrize("bits", [8, 4])
def test_paged_append_and_prefill_bit_exact(bits):
    """A page-granular prefill, then appends that cross page boundaries
    through a scrambled table, and one past the table's span."""
    rng = np.random.default_rng(4)
    b, h, d, page, n = 2, 2, 8, 8, 4
    table = _tables(rng, b, n)
    tc = tkv.init_paged_kv_cache(b * n, h, d, torch.tensor(table), page_size=page, bits=bits,
                                 device="cpu")
    jc = jkv.init_paged_kv_cache(b * n, h, d, jnp.array(table), page_size=page, bits=bits)
    k, v = _rand(rng, (b, h, 16, d)), _rand(rng, (b, h, 16, d))
    tc, lt = tkv.paged_prefill(tc, torch.tensor(k), torch.tensor(v))
    jc, lj = jkv.paged_prefill(jc, jnp.array(k), jnp.array(v))
    _same_paged(tc, jc)
    _same(lt, lj)
    lt, lj = torch.tensor([16, 13], dtype=torch.int32), jnp.array([16, 13], jnp.int32)
    for t in (5, 1, 3):
        k, v = _rand(rng, (b, h, t, d)), _rand(rng, (b, h, t, d))
        tc, lt = tkv.paged_append(tc, lt, torch.tensor(k), torch.tensor(v))
        jc, lj = jkv.paged_append(jc, lj, jnp.array(k), jnp.array(v))
        _same_paged(tc, jc)
        _same(lt, lj)
    lt, lj = torch.tensor([31, 30], dtype=torch.int32), jnp.array([31, 30], jnp.int32)
    k, v = _rand(rng, (b, h, 4, d)), _rand(rng, (b, h, 4, d))
    tc, lt = tkv.paged_append(tc, lt, torch.tensor(k), torch.tensor(v))
    jc, lj = jkv.paged_append(jc, lj, jnp.array(k), jnp.array(v))
    _same_paged(tc, jc)


def test_vmean_addback_bit_exact():
    rng = np.random.default_rng(5)
    o = _rand(rng, (3, 4, 2, 8))
    vm = _rand(rng, (3, 2, 1, 8))
    lengths = np.array([0, 3, -1], np.int32)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        t = tkv._vmean_addback(torch.tensor(o).to(dtype), torch.tensor(lengths), torch.tensor(vm))
        j = jkv._vmean_addback(jnp.array(o).astype(jdt), jnp.array(lengths), jnp.array(vm))
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("paged", [False, True])
def test_sageattn_decode_with_means(paged):
    """The decode entry points over a calibrated int4 cache: the port's plain
    path against JAX's Pallas kernel in interpret mode (fp32, 1e-5)."""
    rng = np.random.default_rng(6)
    b, hq, h, d, S, page = 2, 4, 2, 16, 32, 8
    k, v = _rand(rng, (b, h, 20, d)) + 0.5, _rand(rng, (b, h, 20, d)) - 1.0
    q = _rand(rng, (b, hq, 1, d))
    lengths = np.array([20, 20], np.int32)
    if paged:
        table = _tables(rng, b, S // page)
        tc = tkv.init_paged_kv_cache(b * S // page, h, d, torch.tensor(table), page_size=page,
                                     bits=4, device="cpu")
        jc = jkv.init_paged_kv_cache(b * S // page, h, d, jnp.array(table), page_size=page,
                                     bits=4)
        t_fn, j_fn, t_app, j_app = (tkv.sageattn_paged_decode, jkv.sageattn_paged_decode,
                                    tkv.paged_append, jkv.paged_append)
    else:
        tc = tkv.init_kv_cache(b, h, S, d, bits=4, device="cpu")
        jc = jkv.init_kv_cache(b, h, S, d, bits=4)
        t_fn, j_fn, t_app, j_app = (tkv.sageattn_decode, jkv.sageattn_decode, tkv.append_kv,
                                    jkv.append_kv)
    tc = tkv.calibrate(tc, torch.tensor(k), torch.tensor(v))
    jc = jkv.calibrate(jc, jnp.array(k), jnp.array(v))
    zeros = np.zeros(b, np.int32)
    tc, _ = t_app(tc, torch.tensor(zeros), torch.tensor(k), torch.tensor(v))
    jc, _ = j_app(jc, jnp.array(zeros), jnp.array(k), jnp.array(v))
    o_t = t_fn(torch.tensor(q), tc, torch.tensor(lengths))
    o_j = j_fn(jnp.array(q), jc, jnp.array(lengths), interpret=True)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5, rtol=1e-5)
