"""The Q/K quantization options at head dims above 128 in the port, on the
CPU: ``smooth_q``, ``qk_bits=4`` and ``qk_quant_gran`` per_token /
per_subtile / per_block at d 256 and at 192 (padded to 256, as the JAX
package pads it, ``core.py:70-75``), through the plain version of the
pre-quantized forward (``attention_cuda.sage_attention_preq_plain``, which
the card's ``csrc/attention_fwd_preq_hd256.cu`` is held to by
``chip_smoke.py``), against the JAX package from the same numpy inputs.

* The plain pre-quantized forward at d 256 against the JAX
  ``quantized_attention_reference(..., score_col_bias=...)`` on the same
  codes and scales, per-tile K scales (two 64-column KV tiles a 128-row
  group on the card) and per-row ones: the same fp32 operations, so within
  atol 1e-5 (o and lse2).
* The whole op against ``core._sageattn_hnd(impl="xla", chunk_k=128)``
  with the same option, fp32 inputs, causal and not, GQA, at the
  tolerances ``tests/test_torch_qopts.py`` holds at 64 and 128: without a
  mean to take, o within atol 1e-5 and the LSE within 1e-4; with smooth_k's
  km or smooth_q's qm (summed in other orders), cosine >= 0.99999,
  max-abs <= 5e-3, LSE within 1e-3.  bf16 inputs in NHD within one bf16
  step at unit scale (atol 1e-2), and the fp8 entry point (e4m3 V codes on
  both sides).
* With a window (K smoothing off; under smooth_q a row whose Q codes sit a
  step apart, the two means summed in other orders, within 2e-3 of LSE)
  and through ``sageattn_varlen``
  (global and per-segment K smoothing) against the JAX ``sageattn_varlen
  (impl="xla", block_q=128, block_k=128)``.
* The exact-recompute gradient at 256 against ``jax.vjp`` of the JAX
  ``reference.attention_reference``: within 1e-4 of the largest entry.
* At d 256 an option takes the pre-quantized forward, the default
  options the default one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu import quant as jq
from sageattention_tpu.ops import reference as jref
from sageattention_tpu_torch import core
from sageattention_tpu_torch import quant as tq
from sageattention_tpu_torch import sageattn, sageattn_qk_int8_pv_fp8, sageattn_varlen
from sageattention_tpu_torch.ops import attention_cuda
from sageattention_tpu_torch.utils.compare import cosine_similarity

G = attention_cuda.K_GROUP
LOG2E = 1.4426950408889634
OPTIONS = {
    "smooth_q": dict(smooth_q=True),
    "int4": dict(qk_bits=4),
    "int4_smooth_q": dict(qk_bits=4, smooth_q=True),
    "per_token": dict(qk_quant_gran="per_token"),
    "per_subtile": dict(qk_quant_gran="per_subtile"),
    "per_block": dict(qk_quant_gran="per_block"),
    "per_block_int4_smooth_q": dict(qk_quant_gran="per_block", qk_bits=4, smooth_q=True),
}


def _rand(shape, seed, scale=1.0, mean=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + mean).astype(np.float32)


def _qkv(b, hq, hkv, sq, sk, d, seed):
    """Q with a per-channel offset (what smooth_q removes), K with one."""
    q = _rand((b, hq, sq, d), seed) + _rand((1, 1, 1, d), seed + 1, 0.7)
    k = _rand((b, hkv, sk, d), seed + 2, mean=0.5)
    v = _rand((b, hkv, sk, d), seed + 3)
    return q, k, v


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _close(o_t, l_t, o_j, l_j, *, means: bool):
    o_j, l_j = np.asarray(o_j), np.asarray(l_j)
    if not means:
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=1e-5)
        np.testing.assert_allclose(l_t.numpy(), l_j, atol=1e-4)
        return
    assert cosine_similarity(o_t, o_j) >= 0.99999
    assert np.abs(o_t.numpy() - o_j).max() <= 5e-3
    np.testing.assert_allclose(l_t.numpy(), l_j, atol=1e-3)


def _jax_op(q, k, v, *, causal, opts, smooth_k=True, pv_dtype="bf16", window=None):
    return jcore._sageattn_hnd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None, None, None, None,
        impl="xla", chunk_k=G, pv_dtype=pv_dtype, smooth_k=smooth_k, smooth_v=False,
        return_lse=True, is_causal=causal, sm_scale=None, block_q=128, block_k=128,
        window=window, qk_quant_gran=opts.get("qk_quant_gran", "auto"),
        qk_bits=opts.get("qk_bits", 8), smooth_q=opts.get("smooth_q", False))


@pytest.mark.parametrize("col_bias", [False, True], ids=["nobias", "colbias"])
@pytest.mark.parametrize("per_row", [False, True], ids=["tile_scales", "row_scales"])
@pytest.mark.parametrize("causal", [False, True])
def test_preq_plain_matches_jax_reference_hd256(causal, per_row, col_bias):
    b, hq, hkv, sq, sk, d = 1, 2, 1, 130, 333, 256
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=3)
    q_i8, q_sc = jq.quant_int8(jnp.asarray(q), scale_fold=d**-0.5 * LOG2E, bits=4)
    if per_row:
        k_i8, k_sc = jq.quant_int8(jnp.asarray(k), granularity="per_subtile")
        k_rows = k_sc
    else:
        k_i8, k_sc = jq.quant_int8_block_scales(jnp.asarray(k), group=G)
        k_rows = jnp.repeat(k_sc, G, axis=-1)[..., :sk]
    cb = _rand((b, hq, sk), 5, 0.5) if col_bias else None
    v_bf = torch.from_numpy(v).to(torch.bfloat16)
    o_j, l_j = jref.quantized_attention_reference(
        q_i8, q_sc, k_i8, k_rows, jnp.asarray(v_bf.float().numpy()), is_causal=causal,
        return_lse=True, score_col_bias=None if cb is None else jnp.asarray(cb),
        out_dtype=jnp.float32)
    o_t, l_t = attention_cuda.sage_attention_fwd_preq(
        *_t(q_i8, q_sc, k_i8, k_sc), v_bf, is_causal=causal, return_lse=True,
        out_dtype=torch.float32, col_bias=None if cb is None else torch.from_numpy(cb))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-5)


OP_CASES = {
    # name: (b, hq, hkv, sq, sk, d, causal)
    "d256_gqa_causal": (1, 4, 2, 256, 256, 256, True),
    "d256_noncausal_ragged": (1, 2, 2, 200, 333, 256, False),
    "d192_padded_gqa": (1, 4, 1, 130, 130, 192, True),
}


@pytest.mark.parametrize("smooth_k", [True, False], ids=["smooth_k", "no_smooth_k"])
@pytest.mark.parametrize("case", sorted(OP_CASES))
@pytest.mark.parametrize("opt", sorted(OPTIONS))
def test_op_matches_jax_fp32_hd256(opt, case, smooth_k):
    b, hq, hkv, sq, sk, d, causal = OP_CASES[case]
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=len(case) + len(opt))
    o_t, l_t = sageattn(*_t(q, k, v), is_causal=causal, return_lse=True, smooth_k=smooth_k,
                        **OPTIONS[opt])
    o_j, l_j = _jax_op(q, k, v, causal=causal, opts=OPTIONS[opt], smooth_k=smooth_k)
    assert o_t.dtype == torch.float32 and o_t.shape == (b, hq, sq, d)
    _close(o_t, l_t, o_j, l_j, means=smooth_k or "smooth_q" in OPTIONS[opt])


@pytest.mark.parametrize("d", [256, 192])
@pytest.mark.parametrize("opt", ["smooth_q", "int4_smooth_q", "per_subtile"])
def test_op_nhd_bf16_and_fp8_v_match_jax_hd256(opt, d):
    b, hq, hkv, s = 1, 4, 2, 200
    q, k, v = _qkv(b, hq, hkv, s, s, d, seed=11)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o_t = sageattn(*(x.transpose(1, 2) for x in (qb, kb, vb)), tensor_layout="NHD",
                   is_causal=True, **OPTIONS[opt])
    assert o_t.dtype == torch.bfloat16 and o_t.shape == (b, s, hq, d)
    as_j = [np.asarray(x.float().numpy()) for x in (qb, kb, vb)]
    o_j, _ = _jax_op(*(jnp.asarray(x).astype(jnp.bfloat16) for x in as_j), causal=True,
                     opts=OPTIONS[opt])
    np.testing.assert_allclose(o_t.transpose(1, 2).float().numpy(),
                               np.asarray(o_j.astype(jnp.float32)), atol=1e-2)
    o8, l8 = sageattn_qk_int8_pv_fp8(*_t(q, k, v), is_causal=True, return_lse=True,
                                     **OPTIONS[opt])
    o8_j, l8_j = _jax_op(q, k, v, causal=True, opts=OPTIONS[opt], pv_dtype="fp8")
    _close(o8, l8, o8_j, l8_j, means=True)


def _q_code_rows_equal(q, opts, d):
    """[b, hq, sq] bool: whether the port's Q codes of a row equal the JAX
    package's (jitted ``quant_int8`` of q, or of q - qm under smooth_q,
    whose mean the two sum in other orders)."""
    fold = d**-0.5 * LOG2E
    bits = opts.get("qk_bits", 8)
    qt = torch.from_numpy(q)
    jx = jnp.asarray(q)
    if opts.get("smooth_q"):
        qt = core._smooth_q(qt)[1]
        jx = jx - jnp.mean(jx, axis=-2, keepdims=True)
    codes_t, _ = tq.quant_int8(qt, scale_fold=fold, bits=bits)
    codes_j, _ = jax.jit(lambda x: jq.quant_int8(x, scale_fold=fold, bits=bits))(jx)
    return (codes_t.numpy() == np.asarray(codes_j)).all(axis=-1)


@pytest.mark.parametrize("opt", ["smooth_q", "int4", "per_block"])
def test_options_with_a_window_match_jax_hd256(opt):
    """With the window (K smoothing off, as in ``tests/test_torch_masks.py``).
    Under smooth_q one Q code of these inputs sits on a rounding edge of
    the two means (head 1, row 167: a step apart), which moves that row's
    LSE by 1.2e-3: every row whose codes agree is held to 1e-3, as at 64
    and 128, that row to 2e-3."""
    d = 256
    q, k, v = _qkv(1, 4, 2, 300, 300, d, seed=17)
    o_t, l_t = sageattn(*_t(q, k, v), is_causal=True, window=100, return_lse=True,
                        smooth_k=False, **OPTIONS[opt])
    o_j, l_j = _jax_op(q, k, v, causal=True, opts=OPTIONS[opt], smooth_k=False, window=100)
    if "smooth_q" not in OPTIONS[opt]:
        _close(o_t, l_t, o_j, l_j, means=False)
        return
    same = _q_code_rows_equal(q, OPTIONS[opt], d)
    assert same.mean() >= 0.999
    assert cosine_similarity(o_t, np.asarray(o_j)) >= 0.99999
    assert np.abs(o_t.numpy() - np.asarray(o_j)).max() <= 5e-3
    dl = np.abs(l_t.numpy() - np.asarray(l_j))
    assert dl[same].max() <= 1e-3 and dl.max() <= 2e-3


@pytest.mark.parametrize("mode", ["global", "per_segment"])
@pytest.mark.parametrize("opt", ["int4_smooth_q", "per_token"])
def test_varlen_options_match_jax_hd256(opt, mode):
    lens, hq, hkv, d = [128, 200, 56], 4, 2, 256
    rng = np.random.default_rng(19)
    t = sum(lens)
    q = (rng.standard_normal((t, hq, d)) + rng.standard_normal(d) * 0.7).astype(np.float32)
    k = (rng.standard_normal((t, hkv, d)) + 0.5).astype(np.float32)
    v = rng.standard_normal((t, hkv, d)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    o_t, l_t = sageattn_varlen(*_t(q, k, v, cu, cu), is_causal=True, return_lse=True,
                               smooth_k_mode=mode, **OPTIONS[opt])
    o_j, l_j = jcore.sageattn_varlen(*(jnp.asarray(x) for x in (q, k, v, cu, cu)),
                                     is_causal=True, return_lse=True, smooth_k_mode=mode,
                                     impl="xla", block_q=128, block_k=128, **OPTIONS[opt])
    _close(o_t, l_t, o_j, l_j, means=True)


@pytest.mark.parametrize("opt", ["smooth_q", "int4", "per_subtile"])
def test_recompute_gradients_match_jax_exact_vjp_hd256(opt):
    b, hq, hkv, s, d = 1, 4, 2, 160, 256
    q, k, v = _qkv(b, hq, hkv, s, s, d, seed=23)
    do = _rand((b, hq, s, d), 29)
    dlse = _rand((b, hq, s), 31)
    xs = [x.requires_grad_() for x in _t(q, k, v)]
    o, lse = sageattn(*xs, is_causal=True, return_lse=True, **OPTIONS[opt])
    assert type(o.grad_fn).__name__ == "RecomputeFunctionBackward"
    loss = (o * torch.from_numpy(do)).sum() + (lse * torch.from_numpy(dlse)).sum()
    g_t = torch.autograd.grad(loss, xs)

    def exact(q, k, v):
        return jref.attention_reference(q, k, v, is_causal=True, return_lse=True)

    _, vjp = jax.vjp(exact, *(jnp.asarray(x) for x in (q, k, v)))
    g_j = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    for name, a, w in zip("qkv", g_t, g_j):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("opts,kernel", [
    ({}, "sage_attention_fwd"),
    ({"qk_bits": 4, "smooth_q": True}, "sage_attention_fwd_preq"),
    ({"qk_quant_gran": "per_block"}, "sage_attention_fwd_preq"),
], ids=["default", "int4_smooth_q", "per_block"])
def test_options_take_the_pre_quantized_kernel_hd256(monkeypatch, opts, kernel):
    calls = []
    for name in ("sage_attention_fwd", "sage_attention_fwd_preq"):
        fn = getattr(attention_cuda, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls.append((_name, args[0].shape[-1]))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(attention_cuda, name, counted)
    q, k, v = _qkv(1, 2, 2, 128, 128, 192, seed=41)
    o = sageattn(*_t(q, k, v), **opts)
    assert calls == [(kernel, 256)] and o.shape == (1, 2, 128, 192)
