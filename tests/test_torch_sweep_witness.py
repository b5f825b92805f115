"""The accuracy sweep's thin rows, read through the JAX package too.

``chip_smoke.py``'s accuracy sweep (``bench/bench_accuracy.py``'s
configurations) holds each 8-bit row to a floor against exact fp32
attention.  On "biased" inputs (channel means linspace(-5, 5) on Q and
linspace(3, -3) on K, bf16) the cosine of "int8 no smoothing", the default
and "fp8 PV" sits within a few 1e-4 of 0.999 and moves with the seed.  This
file is the second witness that such a reading is the quantized
arithmetic's and not the port's: on the same bf16 inputs, the port's
``sageattn`` (the plain versions on CPU tensors) and the JAX package's
``core._sageattn_hnd(impl="xla")`` give the same cosine against exact
attention to 1e-5, seed by seed.  Run with ``-s`` to print the readings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu_torch import core, sageattn
from sageattention_tpu_torch.ops import reference
from sageattention_tpu_torch.utils.compare import cosine_similarity

# name: (sageattn kwargs; the JAX pipeline's smooth_k and pv_dtype)
CONFIGS = {
    "int8 default (smooth_k)": ({}, (True, "bf16")),
    "int8 no smoothing": ({"smooth_k": False}, (False, "bf16")),
    "fp8 PV": ({"pv_dtype": "fp8"}, (True, "fp8")),
}
SHAPE = (1, 2, 4096, 128)  # the Wan2.1 head dim, two heads, a shorter sequence


def _biased_inputs(seed):
    """bench/bench_accuracy.py's "biased" q, k, v in fp32, to be cast to bf16."""
    rng = np.random.default_rng(seed)
    d = SHAPE[-1]
    q, k, v = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(3))
    q = q + np.linspace(-5, 5, d, dtype=np.float32)
    k = k + np.linspace(3, -3, d, dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sweep_row_cosine_matches_jax(name, seed):
    kwargs, (smooth_k, pv_dtype) = CONFIGS[name]
    q, k, v = _biased_inputs(seed)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o_exact = reference.attention_reference(tq.float(), tk.float(), tv.float())
    o_port = sageattn(tq, tk, tv, **kwargs).float()
    o_jax = jcore._sageattn_hnd(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        None, None, None, None, None, None,
        impl="xla", chunk_k=core.K_GROUP, qk_quant_gran="auto", pv_dtype=pv_dtype,
        smooth_k=smooth_k, smooth_v=False, return_lse=False, is_causal=False, sm_scale=None,
        block_q=128, block_k=128)
    o_jax = torch.from_numpy(np.array(o_jax.astype(jnp.float32)))
    cos_port = cosine_similarity(o_port, o_exact)
    cos_jax = cosine_similarity(o_jax, o_exact)
    print(f"{name} seed {seed} {SHAPE}: vs exact, port {cos_port:.7f}, JAX {cos_jax:.7f}")
    assert abs(cos_port - cos_jax) <= 1e-5, (cos_port, cos_jax)
    assert cosine_similarity(o_port, o_jax) >= 0.99999
