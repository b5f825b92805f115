"""Ulysses sequence parallelism (the head all-to-all) over a process group.

The counterpart of the JAX package's ``parallel/ulysses.py``.  Activations
arrive sequence-sharded; one ``dist.all_to_all_single`` swaps the shard
dim from the sequence to the heads, so that each rank runs whole-sequence
attention on a subset of the heads, and a second swaps back.  Because each
rank sees the whole sequence, every single-card option (causal, masks,
the Q/K options) applies unchanged.  Heads and kv heads must divide by the
group's size.

Differentiable, as in the JAX package: the local attention is
``sageattn``'s differentiable op (or the ring, which is), and each
all-to-all's transpose is the inverse all-to-all (:func:`seq_to_heads` and
:func:`heads_to_seq` are each other's backward).  Every rank of the group
must call backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sageattention_tpu_torch import core
from sageattention_tpu_torch.parallel.mesh import (axis_info, global_view, require_axis,
                                                    with_transpose)


def _local_attention(q, k, v, *, is_causal, sm_scale, return_lse, **attn_kwargs):
    """The single-card leaf: the port's ``sageattn``, which routes tensor
    kwargs (ids, positions, masks, biases) itself."""
    return core.sageattn(q, k, v, is_causal=is_causal, sm_scale=sm_scale,
                         return_lse=return_lse, **attn_kwargs)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """dim 0 of ``x`` [n, ...] scattered to the n ranks, gathered back
    in rank order."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    b, h, s = x.shape[:3]
    rest = x.shape[3:]
    y = _all_to_all(x.reshape(b, n, h // n, s, *rest).movedim(1, 0), group)  # [n(src), b, h/n, s, ..]
    return y.movedim(0, 2).reshape(b, h // n, n * s, *rest)


def _heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    b, hn, s = x.shape[:3]
    rest = x.shape[3:]
    y = _all_to_all(x.reshape(b, hn, n, s // n, *rest).movedim(2, 0), group)  # [n(src), b, ..]
    return y.movedim(0, 1).reshape(b, n * hn, s // n, *rest)


def seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[b, h, s/n, ...] sequence blocks -> [b, h/n, s, ...] head blocks;
    differentiable, its backward :func:`heads_to_seq`."""
    return with_transpose(x, lambda t: _seq_to_heads(t, group, n),
                          lambda g: _heads_to_seq(g, group, n))


def heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[b, h/n, s, ...] head blocks -> [b, h, s/n, ...] sequence blocks;
    differentiable, its backward :func:`seq_to_heads`."""
    return with_transpose(x, lambda t: _heads_to_seq(t, group, n),
                          lambda g: _seq_to_heads(g, group, n))


def ulysses_sageattn(q, k, v, group=None, *, is_causal: bool = False, sm_scale=None,
                     return_lse: bool = False, inner=None, **attn_kwargs):
    """Ulysses attention on this rank's sequence blocks q, k, v [b, h,
    s_local, d] (HND), the global sequence being the blocks in rank order of
    ``group``.  ``inner(qg, kg, vg)`` runs the attention of the swapped
    [b, h/n, S, d] blocks (default the local ``sageattn``; the API passes
    the ring); it must honour ``return_lse`` with an LSE [b, h/n, S]."""
    n = dist.get_world_size(group)
    hq, hkv = q.shape[1], k.shape[1]
    if hq % n or hkv % n:
        raise ValueError(
            f"Ulysses requires heads ({hq}) and kv heads ({hkv}) divisible by the group "
            f"size {n}; shard fewer ways or use ring attention"
        )
    if inner is None:
        def inner(qg, kg, vg):
            return _local_attention(qg, kg, vg, is_causal=is_causal, sm_scale=sm_scale,
                                    return_lse=return_lse, **attn_kwargs)
    if n == 1:
        return inner(q, k, v)
    out = inner(*(seq_to_heads(x, group, n) for x in (q, k, v)))
    if return_lse:
        o, lse = out
        return heads_to_seq(o, group, n), heads_to_seq(lse, group, n)
    return heads_to_seq(out, group, n)


def make_ulysses_attention(mesh, axis_name: str = "heads", *, is_causal: bool = False,
                           data_axis: str | None = "data", **attn_kwargs):
    """Ulysses attention in the global view (as ``ring.make_ring_attention``):
    the batch over ``data_axis``, the sequence over ``axis_name``."""
    require_axis(mesh, axis_name)
    group = axis_info(mesh, axis_name)[0]
    take, give = global_view(mesh, data_axis, (axis_name,))
    return_lse = bool(attn_kwargs.pop("return_lse", False))

    def fn(q, k, v):
        out = ulysses_sageattn(take(q), take(k), take(v), group, is_causal=is_causal,
                               return_lse=return_lse, **attn_kwargs)
        return tuple(map(give, out)) if return_lse else give(out)

    return fn
