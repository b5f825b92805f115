"""The port's fused attention (its plain version, on the CPU) against the
Pallas kernel ``sage_attention_fused`` in interpret mode, on the same
operands: unquantized Q (both quantize it per row with the
``sm_scale*log2e`` fold), the same int8 K codes with one scale per
128-row group, and bf16 V.

Tolerances: o cosine >= 0.9999 and max-abs <= 2e-2 (the Pallas kernel
rounds P to bf16 before P.V, the plain version keeps fp32), base-2 LSE
within 1e-3.  The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_plain_attention_without_lse_returns_o_only():
    q, k_i8, k_scale, v_bf = _inputs(1, 2, 2, 128, 64, seed=5)
    out = attention_cuda.sage_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k_i8), torch.from_numpy(k_scale),
        torch.from_numpy(np.array(v_bf.astype(jnp.float32))).to(torch.bfloat16),
        is_causal=False, q_fold=0.125 * LOG2E,
    )
    assert isinstance(out, torch.Tensor) and out.shape == (1, 2, 128, 64)


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    """Only CPU tensors take the plain version; anything else is the
    kernel's or an error, never a silent fallback."""
    q = torch.empty(1, 1, 128, 64, device="meta")
    k = torch.empty(1, 1, 128, 64, dtype=torch.int8, device="meta")
    ks = torch.empty(1, 1, 1, device="meta")
    v = torch.empty(1, 1, 128, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        attention_cuda.sage_attention_fwd(q, k, ks, v, is_causal=False, q_fold=1.0)
