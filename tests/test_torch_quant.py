"""The port's quantizers against the JAX package's (CPU).

* ``sageattention_tpu_torch.quant`` against ``sageattention_tpu.quant``:
  bit-exact (the same fp32 operations in the same order), except the
  mean of ``sub_mean``, which XLA sums in another order (1e-6 relative).
* The port's K quantizer (``ops.quant_cuda``, its plain version on CPU
  tensors) against the Pallas kernels in interpret mode:
  ``quant_k_chunked`` with the same km is bit-exact;
  ``quant_k_fused_mean`` computes km itself, so km agrees to 1e-6
  relative and the codes may differ by 1 on at most 1e-4 of the entries
  (the mean's summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import quant as jq
from sageattention_tpu.ops import quant_pallas
from sageattention_tpu_torch import quant as tq
from sageattention_tpu_torch.ops import quant_cuda


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_round_half_away_ties_and_edges():
    x = np.array(
        [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 126.5, -126.5, 0.49999997, -0.49999997,
         0.0, -0.0, 3.0, 1e-30, 7.4999995],
        np.float32,
    )
    _eq(tq.round_half_away(torch.from_numpy(x)), jq.round_half_away(jnp.asarray(x)))


def test_round_half_away_random_differs_from_torch_round():
    x = _rand((1_000_000,), 0, 60.0)
    x[::1000] = np.round(x[::1000]) + 0.5  # plenty of exact ties
    t = torch.from_numpy(x)
    _eq(tq.round_half_away(t), jq.round_half_away(jnp.asarray(x)))
    assert (torch.round(t) != tq.round_half_away(t)).any()


@pytest.mark.parametrize("fold", [1.0, 64**-0.5 * tq.LOG2E])
def test_quant_int8_per_token_bit_exact(fold):
    x = _rand((2, 3, 77, 64), 1, 3.0)
    q_t, s_t = tq.quant_int8(torch.from_numpy(x), scale_fold=fold)
    q_j, s_j = jq.quant_int8(jnp.asarray(x), granularity="per_token", scale_fold=fold)
    _eq(q_t, q_j)
    _eq(s_t, s_j)


@pytest.mark.parametrize("s,group", [(256, 128), (200, 128), (333, 64)])
def test_quant_int8_block_scales_bit_exact(s, group):
    x = _rand((1, 2, s, 64), 2, 2.0)
    q_t, s_t = tq.quant_int8_block_scales(torch.from_numpy(x), group=group)
    q_j, s_j = jq.quant_int8_block_scales(jnp.asarray(x), group=group)
    _eq(q_t, q_j)
    _eq(s_t, s_j)


@pytest.mark.parametrize("s", [96, 256, 333])
def test_sub_mean(s):
    """The mean agrees to 1e-6 relative, not bit for bit: XLA's CPU
    reduction sums in another order than torch's.  Given the same mean,
    the subtraction is bit-exact."""
    x = _rand((2, 2, s, 64), 3) + 1.5
    c_t, m_t = tq.sub_mean(torch.from_numpy(x))
    c_j, m_j = jq.sub_mean(jnp.asarray(x))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6, atol=1e-6)
    _eq(torch.from_numpy(x) - torch.from_numpy(np.array(m_j))[..., None, :],
        jnp.asarray(x) - m_j[..., None, :])


def _k_bf16(shape, seed):
    k = _rand(shape, seed) + _rand(shape[:2] + (1, shape[3]), seed + 1, 2.0)
    return torch.from_numpy(k).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (2, 1, 384, 128)])
def test_quant_k_chunked_matches_pallas(shape):
    k_t = _k_bf16(shape, 4)
    k_j = jnp.asarray(k_t.float().numpy()).astype(jnp.bfloat16)
    km_j = jnp.mean(k_j.astype(jnp.float32), axis=-2)
    q_j, s_j = quant_pallas.quant_k_chunked(k_j, km_j, group=128, interpret=True)
    q_t, s_t = quant_cuda.quant_k_chunked(k_t, torch.from_numpy(np.array(km_j)), group=128)
    _eq(q_t, q_j)
    _eq(s_t, s_j)


def test_quant_k_chunked_ragged_matches_spec():
    """s % G != 0: the live-rows-only amax of the tail group."""
    k_t = _k_bf16((1, 2, 200, 64), 5)
    km = quant_cuda.k_channel_mean(k_t)
    q_t, s_t = quant_cuda.quant_k_chunked(k_t, km, group=128)
    ks = jnp.asarray(k_t.float().numpy()) - jnp.asarray(km.numpy())[..., None, :]
    q_j, s_j = jq.quant_int8_block_scales(ks, group=128)
    _eq(q_t, q_j)
    _eq(s_t, s_j)
    assert s_t.shape == (1, 2, 2)


@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (1, 3, 512, 128)])
def test_quant_k_fused_mean_matches_pallas(shape):
    k_t = _k_bf16(shape, 6)
    k_j = jnp.asarray(k_t.float().numpy()).astype(jnp.bfloat16)
    q_j, s_j, km_j = quant_pallas.quant_k_fused_mean(k_j, group=128, interpret=True)
    q_t, s_t, km_t = quant_cuda.quant_k_fused_mean(k_t, group=128)
    np.testing.assert_allclose(km_t.numpy(), np.asarray(km_j), rtol=1e-6, atol=1e-7)
    diff = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j).astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)


def test_quant_k_without_smoothing():
    k_t = _k_bf16((1, 1, 256, 64), 7)
    q_t, s_t, km = quant_cuda.quant_k_fused_mean(k_t, group=128, smooth=False)
    assert km is None
    q_j, s_j = jq.quant_int8_block_scales(jnp.asarray(k_t.float().numpy()), group=128)
    _eq(q_t, q_j)
    _eq(s_t, s_j)
