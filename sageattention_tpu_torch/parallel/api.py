"""Composed parallel attention: data (and the CFG pair) x ring x Ulysses.

The counterpart of the JAX package's ``parallel/api.py`` and of xDiT's
launch matrix: ``--use_cfg_parallel`` is the "data" dim of the mesh,
``--ring_degree`` the "seq" dim (the KV ring), ``--ulysses_degree`` the
"heads" dim (the head all-to-all).  The contract is ``shard_map``'s global
view: every rank passes the same global q, k, v and gets the global output
(and LSE).  Inside, each rank takes its batch block by its "data"
coordinate and its sequence block by its ("seq", "heads") coordinate,
seq-major as the JAX spec ``P(data, None, (seq, heads), None)`` lays it
out; runs Ulysses over "heads" with the ring over "seq" as its inner
attention (or either alone); and all-gathers the blocks back.  Axes of
size 1, or that the mesh lacks, compose away.

Differentiable end to end, as the JAX function is ("a training step can
jax.grad straight through this function"): the leaves are ``sageattn``'s
differentiable op or the ring's (:class:`ring.RingFunction`), Ulysses'
all-to-alls transpose to the inverse all-to-alls, and the global view's
cut and all-gather to each other (``mesh.global_view``), so each rank's
gradient of q, k, v is the whole global gradient, identical on every rank.
Every rank must call backward.
"""

from __future__ import annotations

from sageattention_tpu_torch import core
from sageattention_tpu_torch.parallel.mesh import axis_info, global_view
from sageattention_tpu_torch.parallel.ring import ring_sageattn
from sageattention_tpu_torch.parallel.ulysses import ulysses_sageattn


def make_parallel_sageattn(mesh, *, data_axis: str | None = "data",
                           ring_axis: str | None = "seq", ulysses_axis: str | None = "heads",
                           is_causal: bool = False, sm_scale: float | None = None,
                           tensor_layout: str = "HND", **attn_kwargs):
    """``fn(q, k, v)``: SageAttention of global tensors (HND [b, h, S, d] or
    NHD) over ``mesh``; returns the global o (and, with ``return_lse``, the
    global LSE [b, h, S]) on every rank.  ``attn_kwargs`` go to each
    leaf's ``sageattn``."""
    if tensor_layout not in ("HND", "NHD"):
        raise ValueError(f"bad tensor_layout {tensor_layout!r}")
    return_lse = bool(attn_kwargs.pop("return_lse", False))
    rgroup, rn, _ = axis_info(mesh, ring_axis)
    ugroup, un, _ = axis_info(mesh, ulysses_axis)
    take, give = global_view(mesh, data_axis, (ring_axis, ulysses_axis))

    def leaf(q, k, v):
        """The ring over ``ring_axis``, or the local op: Ulysses' inner."""
        if rn > 1:
            return ring_sageattn(q, k, v, rgroup, is_causal=is_causal, sm_scale=sm_scale,
                                 return_lse=return_lse, **attn_kwargs)
        return core.sageattn(q, k, v, is_causal=is_causal, sm_scale=sm_scale,
                             return_lse=return_lse, **attn_kwargs)

    def fn(q, k, v):
        if tensor_layout == "NHD":
            q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        ql, kl, vl = take(q), take(k), take(v)
        if un > 1:
            out = ulysses_sageattn(ql, kl, vl, ugroup, is_causal=is_causal, sm_scale=sm_scale,
                                   return_lse=return_lse, inner=leaf)
        else:
            out = leaf(ql, kl, vl)
        o, lse = out if return_lse else (out, None)
        o = give(o)
        o = o.transpose(1, 2) if tensor_layout == "NHD" else o
        return (o, give(lse)) if return_lse else o

    return fn
