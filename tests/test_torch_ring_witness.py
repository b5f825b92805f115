"""The ring's distance from ``sageattn`` of the whole sequence, read through
the JAX package too.

``chip_smoke.py`` holds a world of 4's KV ring against the one op over the
whole sequence at cosine >= 0.9999.  The two quantize the same attention
independently: each ring step smooths and quantizes its own block of K
(its own channel mean, K-scale groups that restart at the block's first
token), the whole op the whole K at once.  So they differ by about as much
as either differs from exact attention, not by round-off.  This file is
the witness that the gap is the algorithm's and not the port's: at
reduced copies of the chip's two ring layers (the CogVideoX-2B layer at
its length with 2 heads, 4 blocks of 4,444 tokens whose K-scale groups
restart mid-group; the llm-8b-gqa prefill layer, causal, at 8,192 tokens),
on the same bf16 inputs, the JAX ring rebuilt from
``_sageattn_hnd(impl="xla")`` steps and ``ring._merge`` stands as far from
the JAX whole op as the port's ring from the port's whole op (cosines
equal to 1e-6), both at >= 0.9999, and both rings are as close to exact
attention as their whole op (within 1e-4).  Run with ``-s`` to print the
readings.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parallel import jax_ring, jax_step

from sageattention_tpu_torch import core
from sageattention_tpu_torch.ops import reference
from sageattention_tpu_torch.parallel import ring
from sageattention_tpu_torch.utils.compare import cosine_similarity

N = 4  # ranks of the ring
# name: (b, hq, hkv, s, d, causal), the chip's layers with fewer heads and tokens
LAYERS = {
    "cogvideox-2b layer": (1, 2, 2, 17776, 64, False),
    "llm-8b-gqa prefill layer": (1, 4, 1, 8192, 128, True),
}


def _inputs(seed, b, hq, hkv, s, d):
    """The chip's ring inputs: q and v standard normal, k offset by 0.5, bf16."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) + 0.5).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]


def _port_ring(q, k, v, causal):
    """A world of ``N``'s ring, rank after rank and step after step."""
    sl = q.shape[2] // N
    outs = []
    for idx in range(N):
        qi = q[:, :, idx * sl:(idx + 1) * sl]
        o_acc, lse_acc = ring.init_state(qi)
        for step in range(N):
            src = (idx - step) % N
            part = ring.ring_step(qi, k[:, :, src * sl:(src + 1) * sl],
                                  v[:, :, src * sl:(src + 1) * sl], src=src, idx=idx,
                                  is_causal=causal)
            if part is not None:
                o_acc, lse_acc = ring._merge(o_acc, lse_acc, part[0], part[1])
        outs.append(ring.finish(o_acc, lse_acc, q.dtype, True)[0])
    return torch.cat(outs, dim=2)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_ring_gap_to_whole_op_matches_jax(name, seed):
    b, hq, hkv, s, d, causal = LAYERS[name]
    q, k, v = _inputs(seed, b, hq, hkv, s, d)
    ex = reference.attention_reference(q.float(), k.float(), v.float(), is_causal=causal)
    o_ring = _port_ring(q, k, v, causal).float()
    o_whole = core.sageattn(q, k, v, is_causal=causal).float()
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    j_ring = torch.from_numpy(jax_ring(jq, jk, jv, N, causal, True)[0])
    j_whole = torch.from_numpy(np.array(jax_step(jq, jk, jv, causal, True)[0].astype(jnp.float32)))
    gap_port = cosine_similarity(o_ring, o_whole)
    gap_jax = cosine_similarity(j_ring, j_whole)
    cos = {n: cosine_similarity(o, ex) for n, o in
           (("port ring", o_ring), ("port whole", o_whole), ("jax ring", j_ring),
            ("jax whole", j_whole))}
    print(f"\n{name} seed {seed}: ring vs whole op, port {gap_port:.7f}, jax {gap_jax:.7f}; "
          "vs exact " + ", ".join(f"{n} {c:.7f}" for n, c in cos.items()))
    assert abs(gap_port - gap_jax) <= 1e-6
    assert gap_port >= 0.9999 and gap_jax >= 0.9999
    assert cos["port ring"] >= cos["port whole"] - 1e-4
    assert cos["jax ring"] >= cos["jax whole"] - 1e-4
