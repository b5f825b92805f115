"""The port's backward against the JAX package's fused backward, on the CPU.

* Kernel 4's plain version (``quant_cuda.quant_q_per_token``) is bit-exact
  with the JAX spec ``quant.quant_int8(per_token, scale_fold)`` as compiled.
* The plain backward (what the dQ and dK/dV wrappers run on CPU tensors)
  against ``attention_bwd_pallas.sage_attention_bwd(..., interpret=True)``
  on the same quantized operands, one K scale per 128 rows.  Both round the
  same fp32 values to bf16 at the same places and differ in fp32 sum order
  only: cosine >= 0.99999 and max-abs <= 1e-3 * max|g|.
* ``sageattn``'s gradients (``SageAttnFunction``) against
  ``quantized_attention_vjp(interpret=True)`` fed the forward of
  ``core._sageattn_hnd(impl="xla", chunk_k=128)`` and its K codes:
  cosine >= 0.99999 (the two forwards' o, hence rowsum(dO * O), differ in
  fp32 round-off).  The JAX fused backward takes multiples of 128 only.
* At ragged lengths, where the JAX package falls back to its exact fp32
  recompute, the port's gradients against that exact VJP: cosine >= 0.999,
  the level ``tests/test_autodiff.py`` accepts between the two.
* With V codes (int8, fp8) or smooth-v, the gradients against
  ``quantized_attention_vjp(pv_dtype=..., smooth_v=..., fwd_res=...)`` fed
  the forward's V codes, scales and mean, at the bf16 tolerances.
* NHD gives HND's gradients, and the backward reuses the forward's K codes
  and V codes: it quantizes Q once and K and V never.
* A sliding window: the plain backward with the band against
  ``sage_attention_bwd(window=W, interpret=True)``, and ``sageattn``'s
  gradients against ``quantized_attention_vjp(window=W, interpret=True)``
  fed the windowed forward of ``_sageattn_hnd(impl="xla")``, at the
  tolerances above (multiples of 128, as the JAX fused backward takes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu import quant as jquant
from sageattention_tpu.ops import attention_bwd_pallas, attention_pallas
from sageattention_tpu.ops import reference as jreference
from sageattention_tpu_torch import sageattn
from sageattention_tpu_torch.ops import attention_bwd_cuda, attention_cuda, quant_cuda
from sageattention_tpu_torch.utils.compare import cosine_similarity

LOG2E = 1.4426950408889634
G = attention_cuda.K_GROUP


def _rand(seed, shape, mean=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) + mean).astype(np.float32)


def _qkv_do(b, hq, hkv, sq, sk, d, seed):
    return (_rand(seed, (b, hq, sq, d)), _rand(seed + 1, (b, hkv, sk, d), mean=0.5),
            _rand(seed + 2, (b, hkv, sk, d)), _rand(seed + 3, (b, hq, sq, d)))


def _t(x, requires_grad=False):
    return torch.from_numpy(np.array(x, dtype=np.float32)).requires_grad_(requires_grad)


def _bf16_t(x):
    """A JAX bf16 array as a torch bf16 tensor (exact)."""
    return _t(x.astype(jnp.float32)).to(torch.bfloat16)


def _assert_close_grads(got, want, cos_min, rel_max=None):
    for name, g, w in zip("qkv", got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        cos = cosine_similarity(g, w)
        assert cos >= cos_min, (name, cos)
        if rel_max is not None:
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= rel_max, (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
def test_quant_q_plain_bit_exact_with_jax_spec(d, dtype):
    x = _rand(5 + d, (2, 3, 77, d)) * 3
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-30 floor
    jx = jnp.asarray(x).astype(dtype)
    fold = d**-0.5 * LOG2E
    q_j, s_j = jquant.quant_int8(jx, granularity="per_token", scale_fold=fold)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    q_t, s_t = quant_cuda.quant_q_per_token(tx, scale_fold=fold)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


BWD_CASES = {
    # name: (b, hq, hkv, s, d, causal)
    "noncausal": (1, 2, 2, 256, 64, False),
    "causal": (1, 2, 2, 256, 64, True),
    "gqa_causal": (1, 4, 2, 256, 64, True),
    "d128": (1, 2, 2, 256, 128, False),
    "d128_gqa_causal_b2": (2, 4, 2, 128, 128, True),
}


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_plain_backward_matches_pallas(name):
    b, hq, hkv, s, d, causal = BWD_CASES[name]
    q, k, v, do = _qkv_do(b, hq, hkv, s, s, d, seed=len(name))
    sm = d**-0.5
    km = jnp.mean(jnp.asarray(k), axis=-2)
    k_sm = jnp.asarray(k) - km[..., None, :]
    q_i8, q_scale = jquant.quant_int8(jnp.asarray(q), granularity="per_token",
                                      scale_fold=sm * LOG2E)
    k_i8, k_scale = jquant.quant_int8_block_scales(k_sm, group=G)
    v_bf, k_bf, q_bf = (jnp.asarray(x).astype(jnp.bfloat16) for x in (v, k_sm, q))
    o, lse2 = attention_pallas.sage_attention_fused(
        q_i8, q_scale, k_i8, k_scale, v_bf, is_causal=causal, pv_dtype="bf16",
        return_lse=True, block_q=128, block_k=128, chunk_k=G, interpret=True)
    want = attention_bwd_pallas.sage_attention_bwd(
        q_i8, q_scale, k_i8, k_scale, k_bf, q_bf, v_bf, o, lse2, jnp.asarray(do),
        is_causal=causal, sm_scale=sm, block_q=128, block_k=128, chunk_k=G,
        scale_group=G, interpret=True)

    o_t = _t(np.asarray(o.astype(jnp.float32)))
    do_t = _t(do)
    dvec = (do_t * o_t).sum(-1)
    ops = dict(q_i8=torch.from_numpy(np.asarray(q_i8)), q_scale=_t(q_scale),
               k_i8=torch.from_numpy(np.asarray(k_i8)), k_scale=_t(k_scale), v=_bf16_t(v_bf),
               do=do_t.to(torch.bfloat16), lse2=_t(lse2), dvec=dvec)
    dq = attention_bwd_cuda.sage_attention_bwd_dq(
        k_sm=_bf16_t(k_bf), **ops, is_causal=causal, sm_scale=sm)
    dk, dv = attention_bwd_cuda.sage_attention_bwd_dkv(
        q_bf=_bf16_t(q_bf), **ops, is_causal=causal, sm_scale=sm)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    _assert_close_grads((dq, dk, dv), want, cos_min=0.99999, rel_max=1e-3)


V_CODES = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn, "fp8_e5m2": jnp.float8_e5m2}


def _jax_fused_vjp(q, k, v, do, *, causal, dlse=None, pv_dtype="bf16", smooth_v=False,
                   window=None):
    """The JAX fused backward on the forward of ``_sageattn_hnd(impl="xla")``
    with that forward's K quantization and, for V codes, its V quantization
    as residuals."""
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o, lse = jcore._sageattn_hnd(
        jq, jk, jv, None, None, None, None, None, None,
        impl="xla", chunk_k=G, qk_quant_gran="auto", pv_dtype=pv_dtype, smooth_k=True,
        smooth_v=smooth_v, return_lse=True, is_causal=causal, sm_scale=None,
        block_q=128, block_k=128, window=window)
    km = jnp.mean(jk, axis=-2)
    k_i8, k_scale = jquant.quant_int8_block_scales(jk - km[..., None, :], group=G)
    fwd_res = {"k_i8": k_i8, "k_scale": k_scale, "km": km}
    if pv_dtype in V_CODES:
        v_q, v_scale, v_mean = jquant.per_channel_quant(jv, dtype=V_CODES[pv_dtype],
                                                        smooth=smooth_v)
        fwd_res.update(v_q=v_q, v_scale=v_scale, v_mean=v_mean)
    return attention_bwd_pallas.quantized_attention_vjp(
        jq, jk, jv, jnp.asarray(do), is_causal=causal, sm_scale=None, o=o, lse_nat=lse,
        dlse=None if dlse is None else jnp.asarray(dlse), pv_dtype=pv_dtype,
        smooth_v=smooth_v, fwd_res=fwd_res, window=window, interpret=True)


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("name", ["noncausal", "gqa_causal", "d128"])
def test_sageattn_grad_matches_jax_fused_vjp(name, with_dlse):
    b, hq, hkv, s, d, causal = BWD_CASES[name]
    q, k, v, do = _qkv_do(b, hq, hkv, s, s, d, seed=40 + len(name))
    dlse = _rand(7, (b, hq, s)) if with_dlse else None
    want = _jax_fused_vjp(q, k, v, do, causal=causal, dlse=dlse)
    assert want is not None
    qt, kt, vt = (_t(x, True) for x in (q, k, v))
    out = sageattn(qt, kt, vt, is_causal=causal, return_lse=with_dlse)
    loss = (out[0] * _t(do)).sum() + (out[1] * _t(dlse)).sum() if with_dlse \
        else (out * _t(do)).sum()
    got = torch.autograd.grad(loss, (qt, kt, vt))
    _assert_close_grads(got, want, cos_min=0.99999, rel_max=2e-3)


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("pv_dtype,smooth_v", [("int8", False), ("fp8", False),
                                               ("fp8", True), ("bf16", True)])
@pytest.mark.parametrize("name", ["gqa_causal", "d128"])
def test_quantized_v_grads_match_jax_fused_vjp(name, pv_dtype, smooth_v, with_dlse):
    """V codes and smooth-v: both backwards multiply dO by the V the forward
    multiplied (the saved codes dequantized; raw V for bf16), at the
    tolerances of the bf16 case."""
    b, hq, hkv, s, d, causal = BWD_CASES[name]
    q, k, v, do = _qkv_do(b, hq, hkv, s, s, d, seed=60 + len(name))
    v = v + _rand(5, (b, hkv, 1, d))  # channel offsets, for smooth-v
    dlse = _rand(8, (b, hq, s)) if with_dlse else None
    want = _jax_fused_vjp(q, k, v, do, causal=causal, dlse=dlse, pv_dtype=pv_dtype,
                          smooth_v=smooth_v)
    assert want is not None
    qt, kt, vt = (_t(x, True) for x in (q, k, v))
    out = sageattn(qt, kt, vt, is_causal=causal, return_lse=with_dlse, pv_dtype=pv_dtype,
                   smooth_v=smooth_v)
    loss = (out[0] * _t(do)).sum() + (out[1] * _t(dlse)).sum() if with_dlse \
        else (out * _t(do)).sum()
    got = torch.autograd.grad(loss, (qt, kt, vt))
    _assert_close_grads(got, want, cos_min=0.99999, rel_max=2e-3)


RAGGED = {
    # name: (b, hq, hkv, sq, sk, d, causal)
    "causal_200": (1, 2, 2, 200, 200, 64, True),
    "gqa_300x1111": (1, 4, 2, 300, 1111, 64, False),
    "d80_causal_130": (2, 2, 1, 130, 130, 80, True),
}


@pytest.mark.parametrize("name", sorted(RAGGED))
def test_ragged_grads_match_exact_vjp(name):
    b, hq, hkv, sq, sk, d, causal = RAGGED[name]
    q, k, v, do = _qkv_do(b, hq, hkv, sq, sk, d, seed=80 + len(name))
    rep = hq // hkv

    def exact(q, k, v):
        kr, vr = jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1)
        return jreference.attention_reference(q, kr, vr, is_causal=causal)

    _, vjp = jax.vjp(exact, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (_t(x, True) for x in (q, k, v))
    got = torch.autograd.grad(sageattn(qt, kt, vt, is_causal=causal), (qt, kt, vt), _t(do))
    _assert_close_grads(got, want, cos_min=0.999)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nhd_grads_equal_hnd(dtype):
    q, k, v, do = _qkv_do(1, 4, 2, 200, 333, 64, seed=90)
    qh, kh, vh = (_t(x).to(dtype).requires_grad_() for x in (q, k, v))
    g_h = torch.autograd.grad(sageattn(qh, kh, vh, is_causal=True), (qh, kh, vh),
                              _t(do).to(dtype))
    qn, kn, vn = (_t(x).to(dtype).transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o_n = sageattn(qn, kn, vn, tensor_layout="NHD", is_causal=True)
    assert o_n.shape == (1, 200, 4, 64) and o_n.dtype == dtype
    g_n = torch.autograd.grad(o_n, (qn, kn, vn), _t(do).to(dtype).transpose(1, 2))
    for a, n in zip(g_h, g_n):
        assert a.dtype == dtype
        torch.testing.assert_close(n.transpose(1, 2), a, rtol=1e-6, atol=1e-6)


def test_backward_reuses_the_forward_quantization(monkeypatch):
    """The forward's K codes, K scales, mean and LSE ride the residuals:
    the backward launches no K quantizer and no forward, and quantizes Q
    once (the fault the JAX package's reuse path has: it never ran)."""
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(mod, name, counted)

    for mod, name in ((quant_cuda, "k_channel_mean"), (quant_cuda, "quant_k_chunked"),
                      (quant_cuda, "quant_q_per_token"), (attention_cuda, "sage_attention_fwd"),
                      (attention_bwd_cuda, "sage_attention_bwd_dq"),
                      (attention_bwd_cuda, "sage_attention_bwd_dkv")):
        spy(mod, name)
    q, k, v, do = _qkv_do(1, 2, 2, 128, 128, 64, seed=95)
    qt, kt, vt = (_t(x, True) for x in (q, k, v))
    o, lse = sageattn(qt, kt, vt, return_lse=True)
    assert calls == {"k_channel_mean": 1, "quant_k_chunked": 1, "sage_attention_fwd": 1}
    assert type(o.grad_fn).__name__ == "SageAttnFunctionBackward"
    calls.clear()
    torch.autograd.grad((o * _t(do)).sum() + lse.sum(), (qt, kt, vt))
    assert calls == {"quant_q_per_token": 1, "sage_attention_bwd_dq": 1,
                     "sage_attention_bwd_dkv": 1}


@pytest.mark.parametrize("pv_dtype", ["int8", "fp8"])
def test_backward_launches_no_v_quantizer(monkeypatch, pv_dtype):
    """The forward's V codes, scales and mean ride the residuals: the
    forward quantizes V once, the backward never."""
    calls = []
    for name in ("quant_v_per_channel", "quant_v_blocked", "v_channel_stats",
                 "quant_v_apply", "quant_v_per_channel_plain", "quant_v_blocked_plain"):
        fn = getattr(quant_cuda, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(quant_cuda, name, counted)
    q, k, v, do = _qkv_do(1, 2, 2, 128, 128, 64, seed=97)
    qt, kt, vt = (_t(x, True) for x in (q, k, v))
    o = sageattn(qt, kt, vt, pv_dtype=pv_dtype, smooth_v=True)
    assert calls == ["quant_v_per_channel", "quant_v_per_channel_plain"]
    calls.clear()
    torch.autograd.grad((o * _t(do)).sum(), (qt, kt, vt))
    assert calls == []


def test_no_grad_path_builds_no_graph():
    q, k, v, _ = _qkv_do(1, 2, 2, 128, 128, 64, seed=96)
    qt = _t(q, True)
    with torch.no_grad():
        o = sageattn(qt, _t(k), _t(v))
    assert o.grad_fn is None and not o.requires_grad


def test_bwd_wrappers_refuse_devices_they_have_no_kernel_for():
    """Only CPU tensors take the plain versions; anything else is the
    kernel's or an error, never a silent fallback."""
    def m(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    qi, ks = m(1, 1, 128, 64, dtype=torch.int8), m(1, 1, 1)
    bf, vec = m(1, 1, 128, 64, dtype=torch.bfloat16), m(1, 1, 128)
    with pytest.raises(ValueError):
        attention_bwd_cuda.sage_attention_bwd_dq(qi, vec, qi, ks, bf, bf, bf, vec, vec,
                                                 is_causal=False, sm_scale=0.125)
    with pytest.raises(ValueError):
        attention_bwd_cuda.sage_attention_bwd_dkv(qi, vec, bf, qi, ks, bf, bf, vec, vec,
                                                  is_causal=False, sm_scale=0.125)
    with pytest.raises(ValueError):
        quant_cuda.quant_q_per_token(m(1, 1, 128, 64), scale_fold=1.0)


WINDOW_CASES = {
    # name: (b, hq, hkv, s, d, window)
    "gqa_w100": (1, 4, 2, 256, 64, 100),
    "d128_w128": (1, 2, 2, 256, 128, 128),
    # (window 1 leaves one key a row: dS and dK are round-off around 0)
    "w2_b2": (2, 2, 1, 128, 64, 2),
    "w_past_the_sequence": (1, 2, 2, 128, 64, 500),
}


@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_plain_backward_window_matches_pallas(name):
    b, hq, hkv, s, d, window = WINDOW_CASES[name]
    q, k, v, do = _qkv_do(b, hq, hkv, s, s, d, seed=100 + len(name))
    sm = d**-0.5
    km = jnp.mean(jnp.asarray(k), axis=-2)
    k_sm = jnp.asarray(k) - km[..., None, :]
    q_i8, q_scale = jquant.quant_int8(jnp.asarray(q), granularity="per_token",
                                      scale_fold=sm * LOG2E)
    k_i8, k_scale = jquant.quant_int8_block_scales(k_sm, group=G)
    v_bf, k_bf, q_bf = (jnp.asarray(x).astype(jnp.bfloat16) for x in (v, k_sm, q))
    o, lse2 = attention_pallas.sage_attention_fused(
        q_i8, q_scale, k_i8, k_scale, v_bf, is_causal=True, pv_dtype="bf16", window=window,
        return_lse=True, block_q=128, block_k=128, chunk_k=G, interpret=True)
    want = attention_bwd_pallas.sage_attention_bwd(
        q_i8, q_scale, k_i8, k_scale, k_bf, q_bf, v_bf, o, lse2, jnp.asarray(do),
        is_causal=True, sm_scale=sm, block_q=128, block_k=128, chunk_k=G,
        scale_group=G, window=window, interpret=True)
    o_t, do_t = _t(np.asarray(o.astype(jnp.float32))), _t(do)
    ops = dict(q_i8=torch.from_numpy(np.asarray(q_i8)), q_scale=_t(q_scale),
               k_i8=torch.from_numpy(np.asarray(k_i8)), k_scale=_t(k_scale), v=_bf16_t(v_bf),
               do=do_t.to(torch.bfloat16), lse2=_t(lse2), dvec=(do_t * o_t).sum(-1))
    kw = dict(is_causal=True, sm_scale=sm, window=window)
    dq = attention_bwd_cuda.sage_attention_bwd_dq(k_sm=_bf16_t(k_bf), **ops, **kw)
    dk, dv = attention_bwd_cuda.sage_attention_bwd_dkv(q_bf=_bf16_t(q_bf), **ops, **kw)
    _assert_close_grads((dq, dk, dv), want, cos_min=0.99999, rel_max=1e-3)


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("name", ["gqa_w100", "d128_w128"])
def test_window_grads_match_jax_fused_vjp(name, with_dlse):
    b, hq, hkv, s, d, window = WINDOW_CASES[name]
    q, k, v, do = _qkv_do(b, hq, hkv, s, s, d, seed=120 + len(name))
    dlse = _rand(9, (b, hq, s)) if with_dlse else None
    want = _jax_fused_vjp(q, k, v, do, causal=True, dlse=dlse, window=window)
    assert want is not None
    qt, kt, vt = (_t(x, True) for x in (q, k, v))
    out = sageattn(qt, kt, vt, is_causal=True, window=window, return_lse=with_dlse)
    loss = (out[0] * _t(do)).sum() + (out[1] * _t(dlse)).sum() if with_dlse \
        else (out * _t(do)).sum()
    got = torch.autograd.grad(loss, (qt, kt, vt))
    _assert_close_grads(got, want, cos_min=0.99999, rel_max=2e-3)


def test_window_backward_refusals():
    """The window band needs causal and window >= 1 in the wrappers too."""
    x = torch.zeros(1, 1, 128, 64)
    i8, s1 = torch.zeros(1, 1, 128, 64, dtype=torch.int8), torch.zeros(1, 1, 1)
    row = torch.zeros(1, 1, 128)
    bf = x.to(torch.bfloat16)
    for causal, window in ((False, 8), (True, 0)):
        with pytest.raises(ValueError, match="window"):
            attention_bwd_cuda.sage_attention_bwd_dq(i8, row, i8, s1, bf, bf, bf, row, row,
                                                     is_causal=causal, sm_scale=0.125,
                                                     window=window)
        with pytest.raises(ValueError, match="window"):
            attention_bwd_cuda.sage_attention_bwd_dkv(i8, row, bf, i8, s1, bf, bf, row, row,
                                                      is_causal=causal, sm_scale=0.125,
                                                      window=window)
