"""Gradients through an additive ``attn_bias``: the port against the JAX
package's bias VJP, on the CPU, from the same numpy inputs.

* The plain bias backward (what the dQ and dK/dV wrappers run on CPU
  tensors) against ``attention_bwd_pallas.sage_attention_bwd(attn_bias=...,
  need_dbias=True, interpret=True)`` on the same quantized operands, o and
  base-2 LSE, one K scale per 128 rows, fp32 and bf16 biases, a row biased
  to -inf everywhere among them.  Both round the same fp32 values to bf16
  at the same places and differ in fp32 sum order only: dq, dk, dv and an
  fp32 dBias within cosine 0.99999 and 1e-3 of the largest entry; a bf16
  dBias is the same fp32 dS rounded once more, where a round-off
  difference can flip the last bit: within 1e-2 of the largest entry.
* ``sageattn``'s gradients of (q, k, v, bias) for a per-head [b, hq, sq,
  sk] bias (the fused route) against ``quantized_attention_vjp(attn_bias=
  ..., need_dbias=True, interpret=True)`` fed the forward of
  ``core._sageattn_hnd(impl="pallas")`` (interpret mode: the XLA path runs
  a bias through exact attention) and its K (and V) codes, with an LSE
  cotangent and V codes too.  The Pallas forward rounds P to bf16 before
  P.V, the port's plain forward does not, so the two o, hence rowsum(dO *
  O), differ by a bf16 rounding: cosine >= 0.99999, max-abs <= 5e-3 of the
  largest entry (the CPU runs measured 0.999999 and 3.3e-3).
* Against ``jax.vjp`` of the JAX ``reference.attention_reference`` with the
  bias (and the window band as its mask), the JAX package's exact VJP:
  ragged lengths, which the port's kernels take and the JAX fused backward
  does not (cosine >= 0.999, the quantized-against-exact level, and
  max-abs <= 3e-2 of the largest entry: the CPU runs measured at most
  1.1e-2, so an error local to the ragged edge still fails); and the
  forms that the JAX package sends to that exact VJP, which the port takes
  by exact recompute too (broadcast biases, a bias with a window or with
  ``smooth_q``): both exact fp32, so within 1e-4 of the largest entry.
* A row biased to -inf on every key: o = 0 and zero gradients and dBias on
  both routes, no NaN (the fused kernel's rule; a softmax gives NaN).
* A bias that needs no gradient writes no dBias, and q, k and v get the
  same gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu import quant as jquant
from sageattention_tpu.ops import attention_bwd_pallas
from sageattention_tpu.ops import reference as jreference
from sageattention_tpu_torch import sageattn
from sageattention_tpu_torch.ops import attention_bwd_cuda, attention_cuda
from sageattention_tpu_torch.utils.compare import cosine_similarity

LOG2E = 1.4426950408889634
G = attention_cuda.K_GROUP
V_CODES = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _rand(seed, shape, mean=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) + mean).astype(np.float32)


def _inputs(b, hq, hkv, sq, sk, d, seed, bias_shape=None):
    """q, k, v, dO and a bias (per head [b, hq, sq, sk] unless given)."""
    return (_rand(seed, (b, hq, sq, d)), _rand(seed + 1, (b, hkv, sk, d), mean=0.5),
            _rand(seed + 2, (b, hkv, sk, d)), _rand(seed + 3, (b, hq, sq, d)),
            _rand(seed + 4, bias_shape or (b, hq, sq, sk)))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _assert_close(got, want, cos_min, rel_max, names="q k v bias".split()):
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        cos = cosine_similarity(g, w)
        err = np.abs(g - w).max() / np.abs(w).max()
        assert cos >= cos_min and err <= rel_max, (name, cos, err)


def _grads(q, k, v, do, bias, dlse=None, bias_grad=True, **kwargs):
    """``sageattn``'s gradients of (q, k, v[, bias]) and its grad_fn's name."""
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    bt = _t(bias).requires_grad_(bias_grad)
    out = sageattn(*xs, attn_bias=bt, return_lse=dlse is not None, **kwargs)
    o = out[0] if dlse is not None else out
    loss = (o * _t(do)).sum()
    if dlse is not None:
        loss = loss + (out[1] * _t(dlse)).sum()
    return torch.autograd.grad(loss, xs + [bt] * bias_grad), type(o.grad_fn).__name__


# --------------------------------------------------------------------------
# the plain bias backward against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_plain_bias_backward_matches_pallas(causal, d, bias_dtype):
    b, hq, hkv, s = 1, 4, 2, 256
    q, k, v, do, bias = _inputs(b, hq, hkv, s, s, d, seed=d + causal)
    bias[0, 1, 7] = -np.inf  # a row with no live key: lse2 -inf
    sm = d**-0.5
    jb = jnp.asarray(bias).astype(bias_dtype)
    tb = _t(bias).to(getattr(torch, bias_dtype))
    km = jnp.mean(jnp.asarray(k), axis=-2)
    k_sm = jnp.asarray(k) - km[..., None, :]
    q_i8, q_scale = jquant.quant_int8(jnp.asarray(q), granularity="per_token",
                                      scale_fold=sm * LOG2E)
    k_i8, k_scale = jquant.quant_int8_block_scales(k_sm, group=G)
    v_bf, k_bf, q_bf = (jnp.asarray(x).astype(jnp.bfloat16) for x in (v, k_sm, q))
    ops = dict(q_i8=torch.from_numpy(np.array(q_i8)), q_scale=_t(q_scale),
               k_i8=torch.from_numpy(np.array(k_i8)), k_scale=_t(k_scale),
               v=_t(v_bf.astype(jnp.float32)).to(torch.bfloat16),
               do=_t(do).to(torch.bfloat16))
    # o and lse2 of the port's plain masked forward, fed to both backwards
    o, lse2 = attention_cuda.sage_attention_plain(
        _t(q), ops["k_i8"], ops["k_scale"], ops["v"], is_causal=causal, q_fold=sm * LOG2E,
        return_lse=True, masks=attention_cuda.Masks(bias=tb))
    assert torch.isneginf(lse2[0, 1, 7]) and (o[0, 1, 7] == 0).all()
    want = attention_bwd_pallas.sage_attention_bwd(
        q_i8, q_scale, k_i8, k_scale, k_bf, q_bf, v_bf, jnp.asarray(o.numpy()),
        jnp.asarray(lse2.numpy()), jnp.asarray(do), None, jb, is_causal=causal, sm_scale=sm,
        block_q=128, block_k=128, chunk_k=G, scale_group=G, need_dbias=True, interpret=True)
    ops.update(lse2=lse2, dvec=(_t(do) * o).sum(-1))
    kw = dict(is_causal=causal, sm_scale=sm, bias=tb)
    dq, dbias = attention_bwd_cuda.sage_attention_bwd_dq(
        k_sm=_t(k_bf.astype(jnp.float32)).to(torch.bfloat16), need_dbias=True, **ops, **kw)
    dk, dv = attention_bwd_cuda.sage_attention_bwd_dkv(
        q_bf=_t(q_bf.astype(jnp.float32)).to(torch.bfloat16), **ops, **kw)
    assert dbias.dtype == tb.dtype and dbias.shape == tb.shape
    _assert_close((dq, dk, dv), want[:3], cos_min=0.99999, rel_max=1e-3)
    _assert_close((dbias.float(),), (np.asarray(want[3].astype(jnp.float32)),),
                  cos_min=0.99999, rel_max=1e-3 if bias_dtype == "float32" else 1e-2,
                  names=["bias"])
    assert (dq[0, 1, 7] == 0).all() and (dbias[0, 1, 7] == 0).all()


# --------------------------------------------------------------------------
# sageattn's gradients against the JAX fused bias VJP
# --------------------------------------------------------------------------


def _jax_fused_bias_vjp(q, k, v, do, bias, *, causal, dlse=None, pv_dtype="bf16"):
    """The JAX fused bias backward on the forward of ``_sageattn_hnd(impl=
    "pallas")`` (which adds the bias as the port's forward does), with that
    forward's K quantization and, for V codes, its V quantization."""
    jq, jk, jv, jb = (jnp.asarray(x) for x in (q, k, v, bias))
    o, lse = jcore._sageattn_hnd(
        jq, jk, jv, None, None, None, None, jb, None, impl="pallas", chunk_k=G,
        qk_quant_gran="auto", pv_dtype=pv_dtype, smooth_k=True, smooth_v=False,
        return_lse=True, is_causal=causal, sm_scale=None, block_q=128, block_k=128)
    km = jnp.mean(jk, axis=-2)
    k_i8, k_scale = jquant.quant_int8_block_scales(jk - km[..., None, :], group=G)
    fwd_res = {"k_i8": k_i8, "k_scale": k_scale, "km": km}
    if pv_dtype in V_CODES:
        v_q, v_scale, v_mean = jquant.per_channel_quant(jv, dtype=V_CODES[pv_dtype],
                                                        smooth=False)
        fwd_res.update(v_q=v_q, v_scale=v_scale, v_mean=v_mean)
    return attention_bwd_pallas.quantized_attention_vjp(
        jq, jk, jv, jnp.asarray(do), is_causal=causal, sm_scale=None, o=o, lse_nat=lse,
        dlse=None if dlse is None else jnp.asarray(dlse), pv_dtype=pv_dtype, attn_bias=jb,
        need_dbias=True, fwd_res=fwd_res, interpret=True)


FUSED_CASES = {
    # name: (b, hq, hkv, s, d, causal, pv_dtype, with an LSE cotangent)
    "gqa_causal": (1, 4, 2, 256, 64, True, "bf16", False),
    "gqa_causal_lse": (1, 4, 2, 256, 64, True, "bf16", True),
    "d128_noncausal_lse": (1, 2, 2, 256, 128, False, "bf16", True),
    "int8_v_lse": (1, 4, 2, 256, 64, True, "int8", True),
    "fp8_v_b2": (2, 2, 1, 128, 64, False, "fp8", False),
}


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_bias_grads_match_jax_fused_vjp(name):
    b, hq, hkv, s, d, causal, pv_dtype, with_dlse = FUSED_CASES[name]
    q, k, v, do, bias = _inputs(b, hq, hkv, s, s, d, seed=10 + len(name))
    dlse = _rand(9, (b, hq, s)) if with_dlse else None
    want = _jax_fused_bias_vjp(q, k, v, do, bias, causal=causal, dlse=dlse, pv_dtype=pv_dtype)
    assert want is not None
    got, fn = _grads(q, k, v, do, bias, dlse, is_causal=causal, pv_dtype=pv_dtype)
    assert fn == "SageAttnFunctionBackward"
    _assert_close(got, want, cos_min=0.99999, rel_max=5e-3)


# --------------------------------------------------------------------------
# against the JAX exact VJP: ragged lengths and the exact route
# --------------------------------------------------------------------------


def _jax_exact_vjp(q, k, v, do, bias, *, causal, window=None, dlse=None):
    def exact(q, k, v, bias):
        mask = None if window is None else jreference.window_band_mask(q.shape[2], k.shape[2],
                                                                       window)
        return jreference.attention_reference(q, k, v, is_causal=causal, attn_bias=bias,
                                              attn_mask=mask, return_lse=dlse is not None)

    _, vjp = jax.vjp(exact, *(jnp.asarray(x) for x in (q, k, v, bias)))
    return vjp((jnp.asarray(do), jnp.asarray(dlse)) if dlse is not None else jnp.asarray(do))


EXACT_CASES = {
    # name: (b, hq, hkv, sq, sk, d, causal, bias shape or None for per head,
    #        sageattn kwargs, with an LSE cotangent, the route)
    "ragged_causal_200": (1, 4, 2, 200, 200, 64, True, None, {}, False, "fused"),
    "ragged_300x333_lse": (1, 4, 2, 300, 333, 64, False, None, {}, True, "fused"),
    "bias_sq_sk": (1, 4, 2, 192, 192, 64, True, (192, 192), {}, False, "exact"),
    "bias_heads_b2_lse": (2, 4, 2, 128, 160, 64, False, (1, 4, 128, 160), {}, True, "exact"),
    "bias_rows_broadcast": (1, 2, 2, 128, 200, 64, False, (1, 1, 1, 200), {}, False, "exact"),
    "window_bias": (1, 4, 2, 200, 200, 64, True, None, {"window": 64}, False, "exact"),
    "smooth_q_bias": (1, 4, 2, 128, 128, 64, True, None, {"smooth_q": True}, True, "exact"),
}


@pytest.mark.parametrize("name", sorted(EXACT_CASES))
def test_bias_grads_match_jax_exact_vjp(name):
    b, hq, hkv, sq, sk, d, causal, shape, kwargs, with_dlse, route = EXACT_CASES[name]
    q, k, v, do, bias = _inputs(b, hq, hkv, sq, sk, d, seed=30 + len(name), bias_shape=shape)
    dlse = _rand(11, (b, hq, sq)) if with_dlse else None
    want = _jax_exact_vjp(q, k, v, do, bias, causal=causal, window=kwargs.get("window"),
                          dlse=dlse)
    got, fn = _grads(q, k, v, do, bias, dlse, is_causal=causal, **kwargs)
    assert fn == {"fused": "SageAttnFunctionBackward", "exact": "RecomputeFunctionBackward"}[route]
    assert got[3].shape == bias.shape
    # quantized against exact attention; exact recompute against exact
    _assert_close(got, want, cos_min=0.999, rel_max=3e-2 if route == "fused" else 1e-4)


# --------------------------------------------------------------------------
# dead rows, and a fixed bias
# --------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["fused", "exact"])
def test_all_neg_inf_bias_row_gives_zero_gradients(route):
    """Row 5 biased to -inf on every key: the fused kernel's rule, o = 0
    and LSE -inf, so every gradient through that row is 0, with no NaN on
    either route (the exact one by a [sq, sk] bias, shared by every
    head)."""
    b, hq, hkv, s, d = 1, 2, 1, 128, 64
    q, k, v, do, bias = _inputs(b, hq, hkv, s, s, d, seed=50,
                                bias_shape=None if route == "fused" else (s, s))
    bias[..., 5, :] = -np.inf
    xs = [_t(x).requires_grad_() for x in (q, k, v, bias)]
    o, lse = sageattn(*xs[:3], attn_bias=xs[3], is_causal=True, return_lse=True)
    assert type(o.grad_fn).__name__ == {"fused": "SageAttnFunctionBackward",
                                        "exact": "RecomputeFunctionBackward"}[route]
    assert (o[:, :, 5] == 0).all() and torch.isneginf(lse[:, :, 5]).all()
    grads = torch.autograd.grad((o * _t(do)).sum(), xs)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    dq, dbias = grads[0], grads[3]
    assert (dq[:, :, 5] == 0).all() and (dbias[..., 5, :] == 0).all()
    assert dbias.abs().sum() > 0


@pytest.mark.parametrize("route", ["fused", "exact"])
def test_fixed_bias_computes_no_dbias(route, monkeypatch):
    """A bias that needs no gradient (ALiBi fixed while q, k, v train):
    the dQ wrapper is asked for no dBias (the fused route) and q, k and v
    get the gradients of the trainable-bias call."""
    calls = []
    dq_fn = attention_bwd_cuda.sage_attention_bwd_dq

    def spy(*args, **kwargs):
        calls.append((kwargs.get("bias") is not None, kwargs.get("need_dbias", False)))
        return dq_fn(*args, **kwargs)

    monkeypatch.setattr(attention_bwd_cuda, "sage_attention_bwd_dq", spy)
    q, k, v, do, bias = _inputs(1, 4, 2, 256, 256, 64, seed=60,
                                bias_shape=None if route == "fused" else (256, 256))
    kw = dict(is_causal=True, window=None if route == "fused" else 96)
    fixed, fn = _grads(q, k, v, do, bias, bias_grad=False, **kw)
    assert calls == ([(True, False)] if route == "fused" else [])
    trained, _ = _grads(q, k, v, do, bias, **kw)
    assert calls[1:] == ([(True, True)] if route == "fused" else [])
    assert len(fixed) == 3
    for a, t in zip(fixed, trained[:3]):
        torch.testing.assert_close(a, t, rtol=0, atol=0)
