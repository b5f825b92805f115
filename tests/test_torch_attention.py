"""The port's fused attention (its plain version, on the CPU) against the
Pallas kernel ``sage_attention_fused`` in interpret mode, on the same
operands: unquantized Q (both quantize it per row with the
``sm_scale*log2e`` fold), the same int8 K codes with one scale per
128-row group, and bf16 V or the same int8 / fp8 V codes with their
per-channel scales and smooth-v mean.

Tolerances: o cosine >= 0.9999 and max-abs <= 2e-2 (the Pallas kernel
rounds P to bf16 before P.V, the plain version keeps fp32), base-2 LSE
within 1e-3.  The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import quant
from sageattention_tpu.ops import quant_pallas
from sageattention_tpu.ops.attention_pallas import sage_attention_fused
from sageattention_tpu_torch.ops import attention_cuda
from sageattention_tpu_torch.utils.compare import cosine_similarity

LOG2E = 1.4426950408889634
G = attention_cuda.K_GROUP


def _inputs(b, hq, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    k_j = jnp.asarray(k)
    km = jnp.mean(k_j, axis=-2)
    k_i8, k_scale = quant_pallas.quant_k_chunked(k_j, km, group=G, interpret=True)
    v_bf = jnp.asarray(v).astype(jnp.bfloat16)
    return q, np.array(k_i8), np.array(k_scale), v_bf


def _run_both(b, hq, hkv, s, d, causal, seed):
    q, k_i8, k_scale, v_bf = _inputs(b, hq, hkv, s, d, seed)
    fold = d**-0.5 * LOG2E
    o_j, l_j = sage_attention_fused(
        jnp.asarray(q), None, jnp.asarray(k_i8), jnp.asarray(k_scale), v_bf,
        is_causal=causal, pv_dtype="bf16", q_fold=fold, return_lse=True,
        block_q=128, block_k=128, sub_q=128, chunk_k=G, out_dtype=jnp.float32,
        interpret=True,
    )
    o_t, l_t = attention_cuda.sage_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k_i8), torch.from_numpy(k_scale),
        torch.from_numpy(np.array(v_bf.astype(jnp.float32))).to(torch.bfloat16),
        is_causal=causal, q_fold=fold, return_lse=True,
    )
    return o_t, l_t, np.asarray(o_j), np.asarray(l_j)


@pytest.mark.parametrize(
    "b,hq,hkv,s,causal",
    [
        (1, 2, 2, 256, False),   # non-causal
        (1, 2, 2, 256, True),    # causal
        (1, 4, 2, 256, False),   # GQA
        (2, 4, 1, 128, True),    # GQA, causal, batch 2
    ],
)
def test_plain_attention_matches_pallas(b, hq, hkv, s, causal):
    o_t, l_t, o_j, l_j = _run_both(b, hq, hkv, s, 64, causal, seed=b * 100 + hq + s)
    assert o_t.dtype == torch.float32 and o_t.shape == (b, hq, s, 64)
    assert cosine_similarity(o_t, o_j) >= 0.9999
    np.testing.assert_allclose(o_t.numpy(), o_j, atol=2e-2)
    np.testing.assert_allclose(l_t.numpy(), l_j, atol=1e-3)


V_CODES = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn, "fp8_e5m2": jnp.float8_e5m2}


@pytest.mark.parametrize("with_mean", [False, True])
@pytest.mark.parametrize("pv_dtype", sorted(V_CODES))
@pytest.mark.parametrize("b,hq,hkv,s,causal", [(1, 2, 2, 256, False), (1, 4, 2, 256, True)])
def test_plain_attention_with_v_codes_matches_pallas(b, hq, hkv, s, causal, pv_dtype,
                                                     with_mean):
    """int8 / fp8 V codes with per-channel scales and, optionally, the
    smooth-v mean: the same codes fed to both, at the bf16 tolerances."""
    q, k_i8, k_scale, _ = _inputs(b, hq, hkv, s, 64, seed=s + hq + len(pv_dtype))
    v = np.random.default_rng(9).standard_normal((b, hkv, s, 64)).astype(np.float32) + 1.0
    v_q, v_scale, v_mean = quant.per_channel_quant(jnp.asarray(v), dtype=V_CODES[pv_dtype],
                                                   smooth=with_mean)
    fold = 64**-0.5 * LOG2E
    o_j, l_j = sage_attention_fused(
        jnp.asarray(q), None, jnp.asarray(k_i8), jnp.asarray(k_scale), v_q, v_scale, v_mean,
        is_causal=causal, pv_dtype=pv_dtype, q_fold=fold, return_lse=True,
        block_q=128, block_k=128, sub_q=128, chunk_k=G, out_dtype=jnp.float32,
        interpret=True,
    )
    codes = torch.from_numpy(np.asarray(v_q).view(np.uint8).copy()).view(
        {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}[pv_dtype])
    o_t, l_t = attention_cuda.sage_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k_i8), torch.from_numpy(k_scale), codes,
        torch.from_numpy(np.array(v_scale)),
        torch.from_numpy(np.array(v_mean)) if with_mean else None,
        is_causal=causal, q_fold=fold, return_lse=True,
    )
    o_j, l_j = np.asarray(o_j), np.asarray(l_j)
    assert o_t.dtype == torch.float32 and o_t.shape == (b, hq, s, 64)
    assert cosine_similarity(o_t, o_j) >= 0.9999
    np.testing.assert_allclose(o_t.numpy(), o_j, atol=2e-2)
    np.testing.assert_allclose(l_t.numpy(), l_j, atol=1e-3)


def test_plain_attention_without_lse_returns_o_only():
    q, k_i8, k_scale, v_bf = _inputs(1, 2, 2, 128, 64, seed=5)
    out = attention_cuda.sage_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k_i8), torch.from_numpy(k_scale),
        torch.from_numpy(np.array(v_bf.astype(jnp.float32))).to(torch.bfloat16),
        is_causal=False, q_fold=0.125 * LOG2E,
    )
    assert isinstance(out, torch.Tensor) and out.shape == (1, 2, 128, 64)


@pytest.mark.parametrize("v_dtype,with_scale", [
    (torch.int8, False),             # codes without their scales
    (torch.float8_e4m3fn, False),
    (torch.float8_e5m2, False),
    (torch.bfloat16, True),          # bf16 V with a scale
])
@pytest.mark.parametrize("fn", ["sage_attention_fwd", "sage_attention_plain"])
def test_v_scale_is_given_exactly_with_v_codes(fn, v_dtype, with_scale):
    """A mismatch would return o in code units (or scaled twice): it raises."""
    q, k_i8, k_scale, _ = _inputs(1, 2, 2, 128, 64, seed=6)
    v = torch.zeros(1, 2, 128, 64).to(v_dtype)
    v_scale = torch.ones(1, 2, 64) if with_scale else None
    with pytest.raises(ValueError, match="v_scale"):
        getattr(attention_cuda, fn)(
            torch.from_numpy(q), torch.from_numpy(k_i8), torch.from_numpy(k_scale), v,
            v_scale, is_causal=False, q_fold=0.125 * LOG2E, return_lse=False)


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    """Only CPU tensors take the plain version; anything else is the
    kernel's or an error, never a silent fallback."""
    q = torch.empty(1, 1, 128, 64, device="meta")
    k = torch.empty(1, 1, 128, 64, dtype=torch.int8, device="meta")
    ks = torch.empty(1, 1, 1, device="meta")
    v = torch.empty(1, 1, 128, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        attention_cuda.sage_attention_fwd(q, k, ks, v, is_causal=False, q_fold=1.0)
