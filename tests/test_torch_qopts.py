"""The Q/K quantization options of the port's ``sageattn`` (``smooth_q``,
``qk_bits=4``, ``qk_quant_gran`` per_token / per_subtile / per_block)
against the JAX package, on the CPU, from the same numpy inputs.

* ``quant.quant_int8`` (every granularity, 8 and 4 bits, with and without
  a scale fold) and ``quant.quantize_qk`` without K smoothing: bit-exact
  with the jitted JAX functions.  With K smoothing the two K means are
  summed in other orders (1e-6 relative), which can move a K code by one
  step: codes within 1 on at most 1e-3 of the entries, scales within 1e-6
  relative.
* The plain kernels 2-4 at ``bits=4``: kernel 4 bit-exact with the JAX
  spec as compiled, kernel 3 bit-exact with the Pallas ``quant_k_chunked``
  in interpret mode fed the same km, kernel 2 (its own km) within one code
  step on at most 1e-3 of the entries.
* The plain pre-quantized forward against the JAX
  ``quantized_attention_reference(..., score_col_bias=...)`` on the same
  codes and scales (per-tile K scales expanded per row, or per-row ones):
  the same fp32 operations, so within atol 1e-5 (o) and 1e-5 (lse2).
* The whole op against ``core._sageattn_hnd(impl="xla", chunk_k=128)``
  with the same option, fp32 inputs: without a mean to take (no K or Q
  smoothing) both quantize the same inputs to the same codes, so o within
  atol 1e-5 and the LSE within 1e-4 (as ``tests/test_torch_core.py``).
  smooth_k's km and smooth_q's qm are summed in other orders than XLA's
  (1e-6 relative, ``tests/test_torch_quant.py``), which moves a code by
  one step where a value sits on a rounding edge, and a Q or K code step
  moves a row's scores by about 1 % of a step of the softmax: o cosine
  >= 0.99999, max-abs <= 5e-3, LSE within 1e-3.  bf16 inputs within one
  bf16 step at unit scale (atol 1e-2).  ``smooth_q`` also against the
  Pallas kernel in interpret mode (K smoothing off so that both quantize
  the same K): that kernel rounds P to bf16 before P.V, so cosine >=
  0.9999, max-abs <= 2e-2 and LSE within 2e-3, the limits of
  ``tests/test_torch_masks.py``.  The int4 Pallas kernel does not run on
  the CPU (``tests/test_api.py``), so int4 is held to the XLA path only.
* ``sageattn_varlen`` with the options against the JAX ``sageattn_varlen
  (impl="xla", block_q=128, block_k=128)``, global and per-segment K
  smoothing, at the tolerances above with a mean.
* The gradients with an option (exact recompute) against ``jax.vjp`` of
  the JAX ``reference.attention_reference``, with an LSE cotangent and a
  window too: both are exact fp32 attention, so within 1e-4 of the
  largest gradient entry.
* Which kernels run: the default options take the default forward, an
  option the pre-quantized one; its backward runs no kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu import quant as jq
from sageattention_tpu.ops import quant_pallas
from sageattention_tpu.ops import reference as jref
from sageattention_tpu_torch import quant as tq
from sageattention_tpu_torch import sageattn, sageattn_qk_int8_pv_fp8, sageattn_varlen
from sageattention_tpu_torch.ops import attention_cuda, attention_bwd_cuda, quant_cuda
from sageattention_tpu_torch.utils.compare import cosine_similarity

G = attention_cuda.K_GROUP
LOG2E = tq.LOG2E
GRANS = ("per_token", "per_subtile", "per_block")
# name -> the options; each is a path of sageattn outside its default kernels
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


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _close(o_t, l_t, o_j, l_j, *, means: bool):
    """The op's tolerances (module docstring): exact codes without a mean,
    a code step apart at most with one."""
    o_j, l_j = np.asarray(o_j), np.asarray(l_j)
    if not means:
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=1e-5)
        np.testing.assert_allclose(l_t.numpy(), l_j, atol=1e-4)
        return
    assert cosine_similarity(o_t, o_j) >= 0.99999
    assert np.abs(o_t.numpy() - o_j).max() <= 5e-3
    np.testing.assert_allclose(l_t.numpy(), l_j, atol=1e-3)


# --------------------------------------------------------------------------
# quantizers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fold", [1.0, 64**-0.5 * LOG2E], ids=["nofold", "fold"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("gran", GRANS)
def test_quant_int8_granularities_bit_exact(gran, bits, fold):
    x = _rand((2, 3, 200, 64), 1, 3.0)  # 200 rows: a ragged last group of each size
    x[0, 0, :40] = 0.0  # all-zero rows and groups take the 1e-30 floor
    q_t, s_t = tq.quant_int8(torch.from_numpy(x), granularity=gran, scale_fold=fold, bits=bits)
    q_j, s_j = jq.quant_int8(jnp.asarray(x), granularity=gran, scale_fold=fold, bits=bits)
    _eq(q_t, q_j)
    _eq(s_t, s_j)
    assert int(q_t.abs().max()) == (7 if bits == 4 else 127)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("gran", GRANS)
def test_quantize_qk_bit_exact_without_k_smoothing(gran, bits):
    q, k, _ = _qkv(1, 4, 2, 333, 333, 64, seed=2)
    out_t = tq.quantize_qk(*_t(q, k), sm_scale=0.125, granularity=gran, smooth_k=False,
                           bits=bits)
    out_j = jq.quantize_qk(jnp.asarray(q), jnp.asarray(k), sm_scale=0.125, granularity=gran,
                           smooth_k=False, bits=bits)
    for a, b in zip(out_t[:4], out_j[:4]):
        _eq(a, b)
    assert out_t[4] is None and out_j[4] is None


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_qk_with_k_smoothing(bits):
    q, k, _ = _qkv(1, 2, 2, 256, 256, 64, seed=3)
    q_t, qs_t, k_t, ks_t, km_t = tq.quantize_qk(*_t(q, k), sm_scale=0.125,
                                                granularity="per_subtile", bits=bits)
    q_j, qs_j, k_j, ks_j, km_j = jq.quantize_qk(jnp.asarray(q), jnp.asarray(k), sm_scale=0.125,
                                                granularity="per_subtile", bits=bits)
    _eq(q_t, q_j)
    _eq(qs_t, qs_j)
    np.testing.assert_allclose(km_t.numpy(), np.asarray(km_j), rtol=1e-6, atol=1e-7)
    diff = np.abs(k_t.numpy().astype(np.int32) - np.asarray(k_j).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(ks_t.numpy(), np.asarray(ks_j), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_quant_q_per_token_4bit_bit_exact(d, dtype):
    """Kernel 4's plain version at bits=4 against the JAX spec as compiled,
    whose codes and folded scales the JAX forward computes in its kernel."""
    jx = jnp.asarray(_rand((2, 3, 77, d), 4, 3.0)).astype(dtype)
    fold = d**-0.5 * LOG2E
    q_j, s_j = jq.quant_int8(jx, granularity="per_token", scale_fold=fold, bits=4)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    q_t, s_t = quant_cuda.quant_q_per_token(tx, scale_fold=fold, bits=4)
    _eq(q_t, q_j)
    _eq(s_t, s_j)
    assert int(q_t.abs().max()) == 7


@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (2, 1, 384, 128)])
def test_quant_k_4bit_matches_pallas(shape):
    k = _rand(shape, 5) + _rand(shape[:2] + (1, shape[3]), 6, 2.0)
    k_t = torch.from_numpy(k).to(torch.bfloat16)
    k_j = jnp.asarray(k_t.float().numpy()).astype(jnp.bfloat16)
    km_j = jnp.mean(k_j.astype(jnp.float32), axis=-2)
    q_j, s_j = quant_pallas.quant_k_chunked(k_j, km_j, group=G, bits=4, interpret=True)
    q_t, s_t = quant_cuda.quant_k_chunked(k_t, torch.from_numpy(np.array(km_j)), group=G, bits=4)
    _eq(q_t, q_j)
    _eq(s_t, s_j)
    assert int(q_t.abs().max()) == 7
    # kernel 2: the mean summed in another order
    q_j, s_j, km_j = quant_pallas.quant_k_fused_mean(k_j, group=G, bits=4, interpret=True)
    q_t, s_t, km_t = quant_cuda.quant_k_fused_mean(k_t, group=G, bits=4)
    np.testing.assert_allclose(km_t.numpy(), np.asarray(km_j), rtol=1e-6, atol=1e-7)
    diff = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)


# --------------------------------------------------------------------------
# the pre-quantized forward's plain version
# --------------------------------------------------------------------------


@pytest.mark.parametrize("col_bias", [False, True], ids=["nobias", "colbias"])
@pytest.mark.parametrize("per_row", [False, True], ids=["tile_scales", "row_scales"])
@pytest.mark.parametrize("causal", [False, True])
def test_preq_plain_matches_jax_reference(causal, per_row, col_bias):
    b, hq, hkv, sq, sk, d = 1, 4, 2, 200, 333, 64
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=7)
    q_i8, q_sc = jq.quant_int8(jnp.asarray(q), scale_fold=d**-0.5 * LOG2E, bits=4)
    if per_row:
        k_i8, k_sc = jq.quant_int8(jnp.asarray(k), granularity="per_subtile")
        k_rows = k_sc
    else:
        k_i8, k_sc = jq.quant_int8_block_scales(jnp.asarray(k), group=G)
        k_rows = jnp.repeat(k_sc, G, axis=-1)[..., :sk]
    cb = _rand((b, hq, sk), 8, 0.5) if col_bias else None
    v_bf = torch.from_numpy(v).to(torch.bfloat16)  # the kernel's V is bf16 (or codes)
    o_j, l_j = jref.quantized_attention_reference(
        q_i8, q_sc, k_i8, k_rows, jnp.asarray(v_bf.float().numpy()), is_causal=causal,
        return_lse=True, score_col_bias=None if cb is None else jnp.asarray(cb),
        out_dtype=jnp.float32)
    o_t, l_t = attention_cuda.sage_attention_fwd_preq(
        *_t(q_i8, q_sc, k_i8, k_sc), v_bf, is_causal=causal, return_lse=True,
        out_dtype=torch.float32, col_bias=None if cb is None else torch.from_numpy(cb))
    assert o_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-5)


def test_preq_wrapper_refuses_devices_it_has_no_kernel_for():
    def m(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    qi = m(1, 1, 128, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="meta"):
        attention_cuda.sage_attention_fwd_preq(qi, m(1, 1, 128), qi, m(1, 1, 1),
                                               m(1, 1, 128, 64, dtype=torch.bfloat16),
                                               is_causal=False)


# --------------------------------------------------------------------------
# the whole op against the JAX pipeline
# --------------------------------------------------------------------------


def _jax_op(q, k, v, *, causal, opts, smooth_k=True, impl="xla", pv_dtype="bf16",
            window=None):
    return jcore._sageattn_hnd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None, None, None, None,
        impl=impl, chunk_k=G, pv_dtype=pv_dtype, smooth_k=smooth_k, smooth_v=False,
        return_lse=True, is_causal=causal, sm_scale=None, block_q=128, block_k=128,
        window=window, qk_quant_gran=opts.get("qk_quant_gran", "auto"),
        qk_bits=opts.get("qk_bits", 8), smooth_q=opts.get("smooth_q", False))


OP_CASES = {
    # name: (b, hq, hkv, sq, sk, d, causal)
    "gqa_causal_ragged": (1, 4, 2, 200, 333, 64, True),
    "d128_b2": (2, 2, 2, 256, 256, 128, False),
    "d80_padded_gqa": (1, 4, 1, 130, 130, 80, False),
}


@pytest.mark.parametrize("smooth_k", [True, False], ids=["smooth_k", "no_smooth_k"])
@pytest.mark.parametrize("case", sorted(OP_CASES))
@pytest.mark.parametrize("opt", sorted(OPTIONS))
def test_op_matches_jax_fp32(opt, case, smooth_k):
    b, hq, hkv, sq, sk, d, causal = OP_CASES[case]
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=len(case) + len(opt))
    o_t, l_t = sageattn(*_t(q, k, v), is_causal=causal, return_lse=True, smooth_k=smooth_k,
                        **OPTIONS[opt])
    o_j, l_j = _jax_op(q, k, v, causal=causal, opts=OPTIONS[opt], smooth_k=smooth_k)
    assert o_t.dtype == torch.float32 and o_t.shape == (b, hq, sq, d)
    _close(o_t, l_t, o_j, l_j, means=smooth_k or "smooth_q" in OPTIONS[opt])


@pytest.mark.parametrize("opt", ["smooth_q", "int4_smooth_q", "per_subtile"])
def test_op_nhd_bf16_and_fp8_v_match_jax(opt):
    """NHD bf16 inputs (one bf16 step at unit scale) and the fp8 entry point
    with the option (fp8 V codes on both sides)."""
    b, hq, hkv, s, d = 1, 4, 2, 200, 64
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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_smooth_q_matches_pallas_interpret(d, causal):
    q, k, v = _qkv(1, 4, 2, 256, 256, d, seed=13 + d)
    o_t, l_t = sageattn(*_t(q, k, v), is_causal=causal, return_lse=True, smooth_k=False,
                        smooth_q=True)
    o_j, l_j = _jax_op(q, k, v, causal=causal, opts=dict(smooth_q=True), smooth_k=False,
                       impl="pallas")
    o_j, l_j = np.asarray(o_j, np.float32), np.asarray(l_j)
    assert cosine_similarity(o_t, o_j) >= 0.9999
    assert np.abs(o_t.numpy() - o_j).max() <= 2e-2
    np.testing.assert_allclose(l_t.numpy(), l_j, atol=2e-3)


@pytest.mark.parametrize("opt", ["smooth_q", "int4", "per_block"])
def test_options_with_a_window_match_jax(opt):
    """Masks run with the options: the window (K smoothing off, as in
    ``tests/test_torch_masks.py``)."""
    q, k, v = _qkv(1, 4, 2, 300, 300, 64, seed=17)
    o_t, l_t = sageattn(*_t(q, k, v), is_causal=True, window=100, return_lse=True,
                        smooth_k=False, **OPTIONS[opt])
    o_j, l_j = _jax_op(q, k, v, causal=True, opts=OPTIONS[opt], smooth_k=False, window=100)
    _close(o_t, l_t, o_j, l_j, means="smooth_q" in OPTIONS[opt])


# --------------------------------------------------------------------------
# varlen
# --------------------------------------------------------------------------


def _packed(lens, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    t = sum(lens)
    q = (rng.standard_normal((t, hq, d)) + rng.standard_normal(d) * 0.7).astype(np.float32)
    k = (rng.standard_normal((t, hkv, d)) + 0.5).astype(np.float32)
    v = rng.standard_normal((t, hkv, d)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return q, k, v, cu


@pytest.mark.parametrize("mode", ["global", "per_segment"])
@pytest.mark.parametrize("opt", ["smooth_q", "int4_smooth_q", "per_token", "per_block"])
def test_varlen_options_match_jax(opt, mode):
    q, k, v, cu = _packed([128, 200, 56], 4, 2, 64, seed=19)
    o_t, l_t = sageattn_varlen(*_t(q, k, v, cu, cu), is_causal=True, return_lse=True,
                               smooth_k_mode=mode, **OPTIONS[opt])
    o_j, l_j = jcore.sageattn_varlen(*(jnp.asarray(x) for x in (q, k, v, cu, cu)),
                                     is_causal=True, return_lse=True, smooth_k_mode=mode,
                                     impl="xla", block_q=128, block_k=128, **OPTIONS[opt])
    _close(o_t, l_t, o_j, l_j, means=True)


# --------------------------------------------------------------------------
# gradients: exact recompute
# --------------------------------------------------------------------------


def _jax_vjp(q, k, v, do, dlse, *, causal, window):
    def exact(q, k, v):
        mask = None if window is None else jref.window_band_mask(q.shape[2], k.shape[2], window)
        return jref.attention_reference(q, k, v, is_causal=causal, attn_mask=mask,
                                        return_lse=dlse is not None)

    _, vjp = jax.vjp(exact, *(jnp.asarray(x) for x in (q, k, v)))
    return vjp((jnp.asarray(do), jnp.asarray(dlse)) if dlse is not None else jnp.asarray(do))


GRAD_CASES = {
    # name: (b, hq, hkv, s, d, causal, window, with an LSE cotangent)
    "gqa_causal": (1, 4, 2, 200, 64, True, None, False),
    "noncausal_d128": (1, 2, 2, 128, 128, False, None, False),
    "lse": (1, 4, 2, 160, 64, False, None, True),
    "window_lse": (1, 4, 2, 200, 64, True, 64, True),
    "window": (2, 2, 1, 150, 64, True, 100, False),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
@pytest.mark.parametrize("opt", ["smooth_q", "int4", "per_subtile"])
def test_recompute_gradients_match_jax_exact_vjp(opt, case):
    b, hq, hkv, s, d, causal, window, with_lse = GRAD_CASES[case]
    q, k, v = _qkv(b, hq, hkv, s, s, d, seed=23 + len(case))
    do = _rand((b, hq, s, d), 29)
    dlse = _rand((b, hq, s), 31) if with_lse else None
    xs = [x.requires_grad_() for x in _t(q, k, v)]
    o, lse = sageattn(*xs, is_causal=causal, window=window, return_lse=True, **OPTIONS[opt])
    assert type(o.grad_fn).__name__ == "RecomputeFunctionBackward"
    loss = (o * torch.from_numpy(do)).sum()
    if with_lse:
        loss = loss + (lse * torch.from_numpy(dlse)).sum()
    g_t = torch.autograd.grad(loss, xs)
    g_j = _jax_vjp(q, k, v, do, dlse, causal=causal, window=window)
    for name, a, w in zip("qkv", g_t, g_j):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= 1e-4 * np.abs(w).max(), name


def test_recompute_gradient_of_the_lse_alone():
    """Only the LSE used: o gets no cotangent, the LSE's own is taken."""
    q, k, v = _qkv(1, 2, 2, 128, 128, 64, seed=37)
    dlse = _rand((1, 2, 128), 38)
    xs = [x.requires_grad_() for x in _t(q, k, v)]
    _, lse = sageattn(*xs, return_lse=True, smooth_q=True)
    g_t = torch.autograd.grad((lse * torch.from_numpy(dlse)).sum(), xs)
    g_j = _jax_vjp(q, k, v, np.zeros((1, 2, 128, 64), np.float32), dlse, causal=False,
                   window=None)
    for a, w in zip(g_t, g_j):
        w = np.asarray(w)
        assert np.abs(a.numpy() - w).max() <= 1e-4 * np.abs(w).max()


# --------------------------------------------------------------------------
# which kernels run
# --------------------------------------------------------------------------


def _spy(monkeypatch, calls, targets):
    for mod, name in targets:
        fn = getattr(mod, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls.append((_name, kwargs.get("bits")))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, counted)


WRAPPERS = ((quant_cuda, "k_channel_mean"), (quant_cuda, "quant_k_chunked"),
            (quant_cuda, "quant_q_per_token"), (attention_cuda, "sage_attention_fwd"),
            (attention_cuda, "sage_attention_fwd_masked"),
            (attention_cuda, "sage_attention_fwd_preq"),
            (attention_bwd_cuda, "sage_attention_bwd_dq"),
            (attention_bwd_cuda, "sage_attention_bwd_dkv"))


@pytest.mark.parametrize("opts,want", [
    ({}, [("k_channel_mean", None), ("quant_k_chunked", 8), ("sage_attention_fwd", None)]),
    ({"qk_bits": 4}, [("quant_q_per_token", 4), ("k_channel_mean", None),
                      ("quant_k_chunked", 4), ("sage_attention_fwd_preq", None)]),
    # smooth_q's qm is kernel 2's mean of Q, its centring fused into kernel 4
    ({"smooth_q": True}, [("k_channel_mean", None), ("quant_q_per_token", 8),
                          ("k_channel_mean", None), ("quant_k_chunked", 8),
                          ("sage_attention_fwd_preq", None)]),
    # Q and K by kernel 4 at 32 rows a scale, K's mean by kernel 2
    ({"qk_quant_gran": "per_subtile"}, [("quant_q_per_token", 8), ("k_channel_mean", None),
                                        ("quant_q_per_token", 8),
                                        ("sage_attention_fwd_preq", None)]),
], ids=["default", "int4", "smooth_q", "per_subtile"])
def test_options_take_the_pre_quantized_kernel(monkeypatch, opts, want):
    calls = []
    _spy(monkeypatch, calls, WRAPPERS)
    q, k, v = _qkv(1, 2, 2, 128, 128, 64, seed=41)
    xs = [x.requires_grad_() for x in _t(q, k, v)]
    o = sageattn(*xs, **opts)
    assert calls == want
    calls.clear()
    torch.autograd.grad(o.sum(), xs)
    # the default backward quantizes Q and runs dQ and dK/dV; an option's runs no kernel
    assert calls == ([] if opts else [("quant_q_per_token", None), ("sage_attention_bwd_dq", None),
                                      ("sage_attention_bwd_dkv", None)])
