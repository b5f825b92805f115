"""The port's baselines (``baselines.py``), its ``"sdpa"`` and ``"flash"``
model backends and ``sage_attention_fn`` against the JAX package, on the
CPU.

* ``sdpa`` and ``flash`` against the JAX ``baselines.sdpa`` (XLA
  attention), HND and NHD, causal, GQA, a scale: fp32 within 1e-5.
* ``flash_int8_pertensor``: its per-tensor codes bit-exact with the JAX
  ``qdq`` (``baselines.py:108-114``, written out here with the JAX
  ``quant.round_half_away``: it is local to the JAX function), then the
  attention on those bf16 values against the JAX ``baselines.sdpa`` on the
  same values (bf16 outputs: 1e-2).
* ``flash`` raises where the flash backend cannot run (a V head dim
  unlike Q's here), where the JAX version falls back to XLA attention.
* The ``"sdpa"`` backend's window against the JAX backend ``_sdpa``
  (``local_window_size``), the ``"flash"`` backend's GQA against the JAX
  ``baselines.sdpa``; unknown kwargs refused.
* ``sage_attention_fn``: unmasked against the JAX ``core._sageattn_hnd(
  impl="xla", chunk_k=K_GROUP)`` (``core._entry`` raises at this revision;
  fp32 within 1e-5, as ``tests/test_torch_core.py``), masked and biased
  against the port's ``sageattn`` on the flattened operands, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import baselines as jbase
from sageattention_tpu import core as jcore
from sageattention_tpu import quant as jquant
from sageattention_tpu.models.attention import _sdpa as j_sdpa_backend
from sageattention_tpu_torch import baselines, models, sageattn
from sageattention_tpu_torch.core import K_GROUP
from sageattention_tpu_torch.models.attention import sage_attention_fn


def _qkv(b, hq, hkv, sq, sk, d, seed, layout="HND"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    if layout == "NHD":
        q, k, v = (np.ascontiguousarray(x.swapaxes(1, 2)) for x in (q, k, v))
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


CASES = {  # name: (b, hq, hkv, sq, sk, d, causal, sm_scale)
    "square": (2, 2, 2, 64, 64, 32, False, None),
    "causal": (1, 2, 2, 80, 80, 64, True, None),
    "gqa": (1, 4, 2, 48, 72, 32, False, 0.1),
    "cross": (1, 2, 2, 96, 16, 64, False, None),
}


@pytest.mark.parametrize("layout", ["HND", "NHD"])
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("fn", ["sdpa", "flash"])
def test_baseline_matches_jax_sdpa(fn, name, layout):
    b, hq, hkv, sq, sk, d, causal, scale = CASES[name]
    q, k, v = _qkv(b, hq, hkv, sq, sk, d, seed=len(name), layout=layout)
    o_t = getattr(baselines, fn)(*_t(q, k, v), tensor_layout=layout, is_causal=causal,
                                 sm_scale=scale)
    o_j = jbase.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tensor_layout=layout,
                     is_causal=causal, sm_scale=scale)
    assert o_t.shape == q.shape and o_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)


def _jax_qdq(x):
    """The JAX ``baselines.flash_int8_pertensor``'s ``qdq``, line for line."""
    scale = jnp.maximum(jnp.max(jnp.abs(x.astype(jnp.float32))), 1e-30) / 127.0
    xi = jnp.clip(jquant.round_half_away(x.astype(jnp.float32) / scale), -127, 127)
    return (xi.astype(jnp.int8).astype(jnp.float32) * scale).astype(jnp.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pertensor_codes_bit_exact(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 77, 64)).astype(np.float32) * 3.0
    # ties: values exactly half a step off a code
    x.flat[:5] = np.array([0.5, -0.5, 1.5, -2.5, 126.5], np.float32) * (np.abs(x).max() / 127)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    got = baselines.qdq_pertensor(xt)
    want = np.asarray(_jax_qdq(xj).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_int8_pertensor_matches_jax(causal):
    q, k, v = _qkv(1, 2, 2, 64, 64, 32, seed=4)
    o_t = baselines.flash_int8_pertensor(*_t(q, k, v), is_causal=causal)
    qj, kj, vj = (_jax_qdq(jnp.asarray(x)) for x in (q, k, v))
    o_j = jbase.sdpa(qj, kj, vj, is_causal=causal)
    assert o_t.dtype == torch.bfloat16
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j.astype(jnp.float32)),
                               atol=1e-2)


def test_flash_raises_where_flash_cannot_run():
    """V with another head dim than Q and K: SDPA runs it, flash does not."""
    q, k, _ = _t(*_qkv(1, 2, 2, 32, 32, 32, seed=5))
    v = torch.randn(1, 2, 32, 64)
    with pytest.raises(RuntimeError, match="No available kernel"):
        baselines.flash(q, k, v)
    assert baselines.sdpa(q, k, v).shape == (1, 2, 32, 64)


@pytest.mark.parametrize("window", [1, 7, 32])
@pytest.mark.parametrize("gqa", [False, True])
def test_sdpa_backend_window_matches_jax(window, gqa):
    """Each query sees its last ``window`` keys, itself included."""
    q, k, v = _qkv(1, 4, 2 if gqa else 4, 64, 64, 32, seed=window)
    o_t = models.attention(*_t(q, k, v), is_causal=True, backend="sdpa", window=window)
    o_j = j_sdpa_backend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True,
                         sm_scale=None, window=window)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)


@pytest.mark.parametrize("backend", ["sdpa", "flash"])
def test_backends_gqa_and_causal_match_jax(backend):
    q, k, v = _qkv(2, 8, 2, 40, 40, 64, seed=6)
    o_t = models.attention(*_t(q, k, v), is_causal=True, sm_scale=0.2, backend=backend)
    o_j = jbase.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True,
                     sm_scale=0.2)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)


def test_backends_refuse_what_they_cannot_do():
    q, k, v = _t(*_qkv(1, 2, 2, 16, 16, 32, seed=7))
    for backend in ("sdpa", "flash"):
        with pytest.raises(TypeError, match="does not support"):
            models.attention(q, k, v, backend=backend, attn_mask=torch.ones(16, 16).bool())
    with pytest.raises(TypeError, match="does not support"):
        models.attention(q, k, v, backend="flash", window=4, is_causal=True)
    with pytest.raises(ValueError, match="window requires is_causal"):
        models.attention(q, k, v, backend="sdpa", window=4)


def _jax_sage(q, k, v, causal):
    return jcore._sageattn_hnd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None, None, None, None,
        impl="xla", chunk_k=K_GROUP, qk_quant_gran="auto", pv_dtype="bf16", smooth_k=True,
        smooth_v=False, return_lse=False, is_causal=causal, sm_scale=None, block_q=128,
        block_k=128)


@pytest.mark.parametrize("causal", [False, True])
def test_sage_attention_fn_matches_jax(causal):
    """flax's convention, [batch..., s, h, d] with two batch dims, unmasked."""
    q, k, v = _qkv(6, 4, 2, 130, 130, 64, seed=8)
    o_j = np.asarray(_jax_sage(q, k, v, causal))          # HND [6, 4, 130, 64]

    def flax(x):  # HND [6, h, s, d] -> [2, 3, s, h, d]
        t = torch.from_numpy(x).transpose(1, 2)
        return t.reshape(2, 3, *t.shape[1:])

    o_t = sage_attention_fn(flax(q), flax(k), flax(v), is_causal=causal,
                            precision=None, dropout_rng=None, dtype=torch.float32)
    assert o_t.shape == (2, 3, 130, 4, 64)
    np.testing.assert_allclose(o_t.reshape(6, 130, 4, 64).transpose(1, 2).numpy(), o_j,
                               atol=1e-5)


def test_sage_attention_fn_masks_and_biases_as_sageattn():
    """A float 0/1 mask counts as boolean, a bias broadcasts to [b, h, sq,
    sk]; both against ``sageattn`` in NHD on the flattened operands."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, s, 4, 32)).astype(np.float32))
               for s in (40, 24, 24))
    mask = torch.from_numpy((rng.random((2, 1, 1, 40, 24)) > 0.3).astype(np.float32))
    mask[..., 0] = 1.0  # every row keeps a key
    bias = torch.from_numpy(rng.standard_normal((4, 40, 24)).astype(np.float32))
    o_t = sage_attention_fn(q, k, v, bias=bias, mask=mask)
    flat = [x.reshape(6, *x.shape[2:]) for x in (q, k, v)]
    want = sageattn(*flat, tensor_layout="NHD",
                    attn_mask=mask.expand(2, 3, 1, 40, 24).reshape(6, 1, 40, 24).bool(),
                    attn_bias=bias.expand(2, 3, 4, 40, 24).reshape(6, 4, 40, 24))
    assert torch.equal(o_t, want.reshape(2, 3, 40, 4, 32))
    # the float mask is a mask, not a +1 bias
    assert not torch.equal(sage_attention_fn(q, k, v, mask=mask),
                           sage_attention_fn(q, k, v, bias=mask))


def test_sage_attention_fn_options_and_refusals():
    q = torch.randn(2, 16, 2, 32)
    with pytest.raises(NotImplementedError, match="dropout"):
        sage_attention_fn(q, q, q, dropout_rate=0.1, deterministic=False)
    # dropout with deterministic=True is no dropout; flax plumbing is dropped
    base = sage_attention_fn(q, q, q)
    assert torch.equal(sage_attention_fn(q, q, q, dropout_rate=0.1, deterministic=True,
                                         broadcast_dropout=True, module=None), base)
    # sageattn's options pass through
    assert torch.equal(sage_attention_fn(q, q, q, smooth_k=False),
                       sageattn(q, q, q, tensor_layout="NHD", smooth_k=False))
    assert sage_attention_fn(q, q, q, dtype=torch.bfloat16).dtype == torch.bfloat16
