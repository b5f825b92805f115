"""The port's ``sageattn`` against the JAX package's quantize-then-attend
pipeline ``core._sageattn_hnd(impl="xla", chunk_k=G)`` (CPU), with G the
port's K-scale group.  ``core._entry`` (behind the JAX ``sageattn``)
raises at this revision, so the tests call ``_sageattn_hnd`` directly.

Both sides quantize the same inputs to the same codes, so they agree up
to fp32 round-off: fp32 inputs within atol 1e-5, bf16 inputs within one
bf16 ulp at unit scale (atol 1e-2), natural-log LSE within atol 1e-4.
The quantized-V entry points (int8, fp8 e4m3 and e5m2 V codes, smooth-v)
are held to the same pipeline with the same ``pv_dtype``.  Against exact
fp32 attention the cosine stays above 0.999.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu_torch import (
    core,
    quant,
    sageattn,
    sageattn_qk_int8_pv_bf16,
    sageattn_qk_int8_pv_fp8,
    sageattn_qk_int8_pv_int8,
)
from sageattention_tpu_torch.ops import reference
from sageattention_tpu_torch.utils.compare import cosine_similarity

G = core.K_GROUP


def _jax_sageattn(q, k, v, *, causal, lse, smooth_k, sm_scale=None, pv_dtype="bf16",
                  smooth_v=False):
    return jcore._sageattn_hnd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None, None, None, None, None, None,
        impl="xla", chunk_k=G, qk_quant_gran="auto", pv_dtype=pv_dtype,
        smooth_k=smooth_k, smooth_v=smooth_v, return_lse=lse, is_causal=causal,
        sm_scale=sm_scale, block_q=128, block_k=128,
    )


def _qkv(b, hq, hkv, sq, sk, d, seed, mean=0.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = (rng.standard_normal((b, hkv, sk, d)) + mean).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    return q, k, v


CASES = {
    # name: (b, hq, hkv, sq, sk, d, causal)
    "square": (1, 2, 2, 256, 256, 64, False),
    "gqa": (1, 4, 2, 256, 256, 64, False),
    "causal_sq_ne_sk": (1, 2, 2, 200, 333, 64, True),
    "ragged": (2, 2, 1, 200, 333, 64, False),
    "d128_causal": (1, 2, 2, 256, 256, 128, True),
    "d80_padded": (1, 2, 2, 130, 130, 80, False),
}


@pytest.mark.parametrize("smooth_k", [True, False])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sageattn_matches_jax_fp32(name, smooth_k):
    b, hq, hkv, sq, sk, d, causal = CASES[name]
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=len(name), mean=0.5)
    o_t, lse_t = sageattn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          is_causal=causal, return_lse=True, smooth_k=smooth_k)
    o_j, lse_j = _jax_sageattn(q, k, v, causal=causal, lse=True, smooth_k=smooth_k)
    assert o_t.dtype == torch.float32 and o_t.shape == (b, hq, sq, d)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4)


# (pv_dtype, smooth_v) -> the port's entry point and its extra options
QUANT_V = {
    ("int8", False): (sageattn_qk_int8_pv_int8, {}),
    ("fp8", False): (sageattn_qk_int8_pv_fp8, {}),
    ("fp8_e5m2", False): (sageattn_qk_int8_pv_fp8, {"pv_dtype": "fp8_e5m2"}),
    ("int8", True): (sageattn_qk_int8_pv_int8, {"smooth_v": True}),
    ("fp8", True): (sageattn_qk_int8_pv_fp8, {"smooth_v": True}),
    ("bf16", True): (sageattn, {"smooth_v": True}),
}
# spacing of the code type at its largest values, in units of its scale
TOP_STEP = {"int8": 1.0, "fp8": 32.0, "fp8_e5m2": 8192.0}


def _one_code_step(v, pv_dtype):
    """The most one code step can move V: one code at the top of the range
    times the channel's scale; for bf16 V - mean, one bf16 ulp (2^-7
    relative) of the largest |V - mean|."""
    vt = torch.from_numpy(v)
    if pv_dtype == "bf16":
        return float(quant.sub_mean(vt)[0].abs().max()) * 2.0**-7
    _, scale, _ = quant.per_channel_quant(vt, dtype=quant.V_DTYPES[pv_dtype], smooth=True)
    return float(scale.max()) * TOP_STEP[pv_dtype]


@pytest.mark.parametrize("pv_dtype,smooth_v", sorted(QUANT_V))
@pytest.mark.parametrize("name", sorted(CASES))
def test_quantized_v_matches_jax_fp32(name, pv_dtype, smooth_v):
    """The quantized-V entry points against the JAX pipeline with the same
    ``pv_dtype`` / ``smooth_v``.  Without smooth-v both quantize V to the
    same codes: atol 1e-5.  With it the two means differ in fp32 round-off
    (another summation order), which can move a code by one step; o is a
    convex combination of V rows (the weights sum to 1), so it moves by at
    most one step of V: atol 1e-5 plus that step; and the cosine, which
    such rare steps barely move, at least 0.99999."""
    b, hq, hkv, sq, sk, d, causal = CASES[name]
    # Q and K as in test_sageattn_matches_jax_fp32; V with channel offsets
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=len(name), mean=0.5)
    v = v + np.random.default_rng(7).standard_normal((b, hkv, 1, d)).astype(np.float32)
    op, kw = QUANT_V[(pv_dtype, smooth_v)]
    o_t, lse_t = op(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    is_causal=causal, return_lse=True, **kw)
    o_j, lse_j = _jax_sageattn(q, k, v, causal=causal, lse=True, smooth_k=True,
                               pv_dtype=pv_dtype, smooth_v=smooth_v)
    o_j = np.asarray(o_j)
    assert o_t.dtype == torch.float32 and o_t.shape == (b, hq, sq, d)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4)
    if not smooth_v:
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=1e-5)
        return
    assert np.abs(o_t.numpy() - o_j).max() <= 1e-5 + _one_code_step(v, pv_dtype)
    assert cosine_similarity(o_t, o_j) >= 0.99999


def test_unknown_pv_dtype_raises():
    x = torch.zeros(1, 1, 128, 64)
    with pytest.raises(ValueError, match="pv_dtype"):
        sageattn(x, x, x, pv_dtype="fp4")
    with pytest.raises(ValueError, match="pv_dtype"):
        sageattn(x.clone().requires_grad_(), x, x, pv_dtype="int4")


@pytest.mark.parametrize("causal", [False, True])
def test_sageattn_nhd_bf16_matches_jax(causal):
    b, hq, hkv, s, d = 1, 4, 2, 200, 64
    q, k, v = _qkv(b, hq, hkv, s, s, d, seed=11)
    q_b, k_b, v_b = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o_t = sageattn(q_b.transpose(1, 2), k_b.transpose(1, 2), v_b.transpose(1, 2),
                   tensor_layout="NHD", is_causal=causal)
    assert o_t.dtype == torch.bfloat16 and o_t.shape == (b, s, hq, d)
    as_j = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q_b, k_b, v_b)]
    o_j = _jax_sageattn(*as_j, causal=causal, lse=False, smooth_k=True)
    np.testing.assert_allclose(
        o_t.transpose(1, 2).float().numpy(), np.asarray(o_j.astype(jnp.float32)), atol=1e-2)


def test_sm_scale_is_passed_through():
    q, k, v = _qkv(1, 2, 2, 128, 128, 64, seed=12)
    o_t = sageattn_qk_int8_pv_bf16(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), sm_scale=0.3)
    o_j = _jax_sageattn(q, k, v, causal=False, lse=False, smooth_k=True, sm_scale=0.3)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_sageattn_close_to_exact_attention(causal):
    q, k, v = _qkv(1, 4, 2, 300, 300, 64, seed=13, mean=1.0)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = sageattn(qt, kt, vt, is_causal=causal, return_lse=True)
    o_r, lse_r = reference.attention_reference(qt, kt, vt, is_causal=causal, return_lse=True)
    assert cosine_similarity(o, o_r) > 0.999
    np.testing.assert_allclose(lse.numpy(), lse_r.numpy(), atol=5e-2)


@pytest.mark.parametrize(
    "kwargs,grad,exc,match",
    [
        # the Q/K options are ported (tests/test_torch_qopts.py); a TPU launch
        # option beside them still raises, and so do values they do not take
        ({"smooth_q": True, "block_q": 64}, False, NotImplementedError, "launch configuration"),
        # the masks are ported (tests/test_torch_masks.py) and a lone bias
        # has a gradient (tests/test_torch_bias_grad.py); what still raises:
        # a bool mask, or a bias beside segment ids, under grad, a lone side
        # of a pair, a window without causal or below 1
        ({"attn_mask": torch.ones(128, 128, dtype=torch.bool)}, True, NotImplementedError,
         "no gradient"),
        ({"attn_bias": torch.zeros(128, 128), "q_segment_ids": torch.zeros(1, 128),
          "kv_segment_ids": torch.zeros(1, 128)}, True, NotImplementedError, "no gradient"),
        ({"q_segment_ids": torch.zeros(1, 128, dtype=torch.int32)}, False, ValueError,
         "together"),
        ({"kv_segment_ids": torch.zeros(1, 128, dtype=torch.int32)}, False, ValueError,
         "together"),
        ({"q_positions": torch.arange(128)[None]}, False, ValueError, "together"),
        ({"kv_positions": torch.arange(128)[None]}, False, ValueError, "together"),
        ({"window": 16}, False, ValueError, "is_causal"),
        ({"window": 0, "is_causal": True}, False, ValueError, ">= 1"),
        ({"qk_bits": 3}, False, ValueError, "qk_bits"),
        ({"qk_quant_gran": "per_warp"}, False, ValueError, "qk_quant_gran"),
    ],
    ids=["smooth_q", "attn_mask", "attn_bias", "q_segment_ids", "kv_segment_ids",
         "q_positions", "kv_positions", "window", "window_below_1", "qk_bits",
         "qk_quant_gran"],
)
def test_unsupported_options_raise(kwargs, grad, exc, match):
    x = torch.zeros(1, 1, 128, 64)
    kwargs = dict(kwargs)
    causal = kwargs.pop("is_causal", False)
    with pytest.raises(exc, match=match):
        sageattn(x.clone().requires_grad_(grad), x, x, is_causal=causal, **kwargs)


def test_gradients_and_large_head_dims_raise():
    """Gradients are ported (tests/test_torch_autodiff.py): an input that
    requires grad gives a differentiable output, and what the forward
    refuses the differentiable path refuses too.  Head dims up to 512 run,
    forward and backward (padded to 256, tests/test_torch_hd256.py, or to
    384 and 512, tests/test_torch_hd512.py, whose gradient is exact
    recompute); above 512 they raise naming ROADMAP; the Q/K options run up
    to 512 (tests/test_torch_preq_hd256.py, tests/test_torch_hd512.py)."""
    x = torch.zeros(1, 1, 128, 64, requires_grad=True)
    assert sageattn(x, x, x).requires_grad
    for d in (192, 256, 320):
        y = torch.randn(1, 1, 128, d, generator=torch.Generator().manual_seed(d))
        assert sageattn(y, y, y).shape == y.shape
        yg = y.clone().requires_grad_()
        (g,) = torch.autograd.grad(sageattn(yg, y, y).sum(), yg)
        assert g.shape == y.shape and bool(torch.isfinite(g).all())
    y = torch.zeros(1, 1, 128, 640)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sageattn(y, y, y)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sageattn(y.clone().requires_grad_(), y, y)
    y = torch.randn(1, 1, 128, 256, generator=torch.Generator().manual_seed(5))
    y320 = torch.randn(1, 1, 128, 320, generator=torch.Generator().manual_seed(6))
    for opts in ({"smooth_q": True}, {"qk_bits": 4}, {"qk_quant_gran": "per_block"}):
        assert sageattn(y, y, y, **opts).shape == y.shape
        assert sageattn(y320, y320, y320, **opts).shape == y320.shape
        yg = y320.clone().requires_grad_()
        (g,) = torch.autograd.grad(sageattn(yg, y320, y320, **opts).sum(), yg)
        assert g.shape == y320.shape and bool(torch.isfinite(g).all())
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sageattn(*[torch.zeros(1, 1, 128, 640)] * 3, **opts)
    with pytest.raises(TypeError):
        sageattn(y, y, y, not_an_option=1)
