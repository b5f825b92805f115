"""The port's ``sageattn_varlen`` against the JAX package's, on the CPU.

The JAX function runs its XLA pipeline (``impl="xla"``) with 128-row K
blocks, so that its K-scale group is the port's; it passes segment ids to
the kernel where the port passes each row's key range, the same mask for
packed sequences.  Both quantize the same inputs the same way (int8 V by
default): o within atol 1e-5 and the LSE within 1e-4 with global K
smoothing (fp32 inputs).  With per-segment smoothing the two per-sequence
K means are summed in different orders, which can move a K code by a
step: cosine >= 0.99999 and max-abs <= 1e-3.

Packed sequences whose lengths are multiples of 128 share their K-scale
groups with separate calls, so varlen with per-segment smoothing and bf16
P.V gives each sequence's own ``sageattn`` up to the order of the K-mean
sums (the same step of a K code): cosine >= 0.99999, LSE within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu_torch import sageattn, sageattn_varlen
from sageattention_tpu_torch.utils.compare import cosine_similarity


def _packed(lens_q, lens_k, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    tq, tk = sum(lens_q), sum(lens_k)
    q = rng.standard_normal((tq, hq, d)).astype(np.float32)
    k = (rng.standard_normal((tk, hkv, d)) + 0.5).astype(np.float32)
    v = rng.standard_normal((tk, hkv, d)).astype(np.float32)
    cu_q = np.concatenate([[0], np.cumsum(lens_q)]).astype(np.int32)
    cu_k = np.concatenate([[0], np.cumsum(lens_k)]).astype(np.int32)
    return q, k, v, cu_q, cu_k


CASES = {
    # name: (lens_q, lens_k, hq, hkv, d, causal)
    "causal_gqa": ([128, 200, 56], [128, 200, 56], 4, 2, 64, True),
    "causal_d128": ([300, 84], [300, 84], 4, 2, 128, True),
    "cross_lengths": ([64, 136, 184], [200, 50, 134], 4, 2, 64, False),
    "one_sequence": ([200], [200], 2, 2, 64, False),
}


@pytest.mark.parametrize("return_lse", [False, True])
@pytest.mark.parametrize("mode", ["global", "per_segment"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_varlen_matches_jax(name, mode, return_lse):
    lens_q, lens_k, hq, hkv, d, causal = CASES[name]
    q, k, v, cu_q, cu_k = _packed(lens_q, lens_k, hq, hkv, d, seed=len(name))
    out_t = sageattn_varlen(*(torch.from_numpy(x) for x in (q, k, v, cu_q, cu_k)),
                            max_seqlen_q=max(lens_q), max_seqlen_k=max(lens_k),
                            is_causal=causal, return_lse=return_lse, smooth_k_mode=mode)
    out_j = jcore.sageattn_varlen(*(jnp.asarray(x) for x in (q, k, v, cu_q, cu_k)),
                                  is_causal=causal, return_lse=return_lse, smooth_k_mode=mode,
                                  impl="xla", block_q=128, block_k=128)
    o_t, lse_t = out_t if return_lse else (out_t, None)
    o_j, lse_j = (np.asarray(x) for x in out_j) if return_lse else (np.asarray(out_j), None)
    assert o_t.shape == q.shape and o_t.dtype == torch.float32
    if mode == "global":
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=1e-5)
    else:
        assert cosine_similarity(o_t, o_j) >= 0.99999
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=1e-3)
    if return_lse:
        assert lse_t.shape == (hq, q.shape[0])
        np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_equals_separate_calls(causal):
    """Sequences of 128-multiple lengths: varlen (per-segment smoothing, bf16
    P.V) against one ``sageattn`` per sequence, o and LSE."""
    lens = [256, 128, 384]
    q, k, v, cu, _ = _packed(lens, lens, 4, 2, 64, seed=7)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = sageattn_varlen(qt, kt, vt, torch.from_numpy(cu), torch.from_numpy(cu),
                             is_causal=causal, return_lse=True, smooth_k_mode="per_segment",
                             pv_dtype="bf16")
    for i in range(len(lens)):
        s = slice(int(cu[i]), int(cu[i + 1]))
        o_i, lse_i = sageattn(qt[None, s], kt[None, s], vt[None, s], tensor_layout="NHD",
                              is_causal=causal, return_lse=True)
        assert cosine_similarity(o[s], o_i[0]) >= 0.99999
        np.testing.assert_allclose(lse[:, s].numpy(), lse_i[0].numpy(), atol=1e-3)


def test_varlen_defaults_to_int8_v():
    lens = [200, 100]
    q, k, v, cu, _ = _packed(lens, lens, 2, 2, 64, seed=8)
    args = [torch.from_numpy(x) for x in (q, k, v, cu, cu)]
    torch.testing.assert_close(sageattn_varlen(*args), sageattn_varlen(*args, pv_dtype="int8"),
                               rtol=0, atol=0)
    assert not torch.equal(sageattn_varlen(*args), sageattn_varlen(*args, pv_dtype="bf16"))


def _args(requires_grad=False):
    x = torch.zeros(256, 2, 64, requires_grad=requires_grad)
    cu = torch.tensor([0, 128, 256], dtype=torch.int32)
    return x, torch.zeros(256, 2, 64), torch.zeros(256, 2, 64), cu, cu


@pytest.mark.parametrize("kwargs,exc,match", [
    # the Q/K options are taken (tests/test_torch_qopts.py): a TPU launch
    # option beside them raises, and so do values they do not take
    ({"smooth_q": True, "impl": "xla"}, NotImplementedError, "launch configuration"),
    ({"qk_bits": 3}, ValueError, "qk_bits"),
    ({"qk_quant_gran": "per_warp"}, ValueError, "qk_quant_gran"),
    ({"block_q": 256}, NotImplementedError, "launch configuration"),
    ({"impl": "xla"}, NotImplementedError, "launch configuration"),
    ({"window": 16}, TypeError, "window"),
    ({"not_an_option": 1}, TypeError, "not_an_option"),
    ({"smooth_k_mode": "per_head"}, ValueError, "smooth_k_mode"),
], ids=["smooth_q", "qk_bits", "qk_quant_gran", "block_q", "impl", "window", "unknown",
        "smooth_k_mode"])
def test_varlen_refusals(kwargs, exc, match):
    with pytest.raises(exc, match=match):
        sageattn_varlen(*_args(), **kwargs)


def test_varlen_causal_packing_checks_and_no_grad():
    x, k, v, cu, _ = _args()
    with pytest.raises(ValueError, match="cu_seqlens_q == cu_seqlens_k"):
        sageattn_varlen(x, k, v, cu, torch.tensor([0, 100, 256], dtype=torch.int32),
                        is_causal=True)
    with pytest.raises(ValueError, match="same shape"):
        sageattn_varlen(x, k, v, cu, torch.tensor([0, 256], dtype=torch.int32), is_causal=True)
    with pytest.raises(ValueError, match="matching q/k packing"):
        sageattn_varlen(x[:128], k, v, cu, cu, is_causal=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        sageattn_varlen(*_args(requires_grad=True))
