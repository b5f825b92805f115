"""Ring (context-parallel) attention over a process group.

The counterpart of the JAX package's ``parallel/ring.py``.  Each rank holds
a block of the sequence: its queries stay, and the K/V blocks travel round
the ring, ``(rank + 1) % n`` receiving from ``rank``, while each rank
attends its queries to the block in hand and merges the partials by their
natural-log LSEs.  The next step's rotation (``dist.batch_isend_irecv``
into fresh buffers, which the running step does not read) is issued before
the step's attention, so the transfer can overlap the kernel.

Causal masking is decided on host integers, as the JAX ``lax.switch`` is:
blocks from earlier ranks attend in full, the rank's own block runs the
aligned causal kernel, later blocks are skipped (weight 0 in the merge).
A step is :func:`ring_step`, so that one process can run every rank's
steps in turn.  Forward only in the port.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sageattention_tpu_torch import core
from sageattention_tpu_torch.parallel.mesh import (axis_info, gather_shards, global_view,
                                                    refuse_grad, require_axis)

# Finite "masked" LSE sentinel of the merge: exp(_NEG - m) is exactly 0 for
# any real m, and the running max stays finite.
_NEG = -1e30


def _merge(o_acc, lse_acc, o_i, lse_i):
    """The streaming LSE merge of two attention partials (fp32)."""
    m = torch.maximum(lse_acc, lse_i)
    w_acc = torch.exp(lse_acc - m)
    w_i = torch.exp(lse_i - m)
    denom = w_acc + w_i
    o = (o_acc * w_acc[..., None] + o_i * w_i[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


def init_state(q):
    """The merge's empty state for q [b, h, s, d]: (o 0, LSE ``_NEG``)."""
    b, h, s, d = q.shape
    return (torch.zeros(b, h, s, d, dtype=torch.float32, device=q.device),
            torch.full((b, h, s), _NEG, dtype=torch.float32, device=q.device))


def finish(o_acc, lse_acc, dtype, return_lse: bool):
    """The merged output in ``dtype``; a row no step reached reports LSE -inf,
    the public contract."""
    o = o_acc.to(dtype)
    if not return_lse:
        return o
    return o, torch.where(lse_acc < _NEG / 2, float("-inf"), lse_acc)


def ring_step(q, kb, vb, *, src: int, idx: int, is_causal: bool, sm_scale=None,
              **attn_kwargs):
    """Rank ``idx``'s attention to rank ``src``'s K/V block: (o fp32,
    natural-log LSE), or None where causal masking leaves nothing (a later
    block).  The step reads q in fp32 (the same values, so the same Q
    codes), so that the kernel writes o in fp32: a bf16 partial would add a
    rounding of its own to every step before the merge."""
    if is_causal and src > idx:
        return None
    return core.sageattn(q.float(), kb, vb, is_causal=is_causal and src == idx,
                         sm_scale=sm_scale, return_lse=True, **attn_kwargs)


def ring_sageattn(q, k, v, group=None, *, is_causal: bool = False, sm_scale=None,
                  return_lse: bool = False, **attn_kwargs):
    """Ring attention on this rank's blocks q, k, v [b, h, s_local, d] (HND),
    the global sequence being the blocks in the order of the ranks of
    ``group`` (the default group when None).  ``attn_kwargs`` go to every
    step's ``sageattn``."""
    refuse_grad(q, k, v)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    o_acc, lse_acc = init_state(q)
    kb, vb = k.contiguous(), v.contiguous()
    send_to = dist.get_global_rank(group, (idx + 1) % n) if group is not None else (idx + 1) % n
    recv_from = dist.get_global_rank(group, (idx - 1) % n) if group is not None else (idx - 1) % n
    for step in range(n):
        reqs = ()
        if step < n - 1:
            k_next, v_next = torch.empty_like(kb), torch.empty_like(vb)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, kb, send_to, group),
                dist.P2POp(dist.isend, vb, send_to, group),
                dist.P2POp(dist.irecv, k_next, recv_from, group),
                dist.P2POp(dist.irecv, v_next, recv_from, group),
            ])
        part = ring_step(q, kb, vb, src=(idx - step) % n, idx=idx, is_causal=is_causal,
                         sm_scale=sm_scale, **attn_kwargs)
        if part is not None:
            o_acc, lse_acc = _merge(o_acc, lse_acc, part[0], part[1])
        for r in reqs:
            r.wait()
        if reqs:
            kb, vb = k_next, v_next
    return finish(o_acc, lse_acc, q.dtype, return_lse)


def allgather_sageattn(q, k, v, group=None, *, is_causal: bool = False, sm_scale=None,
                       return_lse: bool = False, **attn_kwargs):
    """All-gather context parallelism on this rank's blocks: the whole K/V
    gathered, one attention of the local queries against it.  Simpler than
    the ring, for a K/V that fits replicated.  Causal masking goes through
    positions (the query block's offset in the gathered K/V is the rank's),
    which run the masked kernel; forward only, as in the JAX package."""
    refuse_grad(q, k, v)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    b, _, s_loc, d = q.shape
    k_full = gather_shards(k, 2, group, n)
    v_full = gather_shards(v, 2, group, n)
    kw = dict(attn_kwargs)
    if is_causal:
        dev = q.device
        kw["q_positions"] = (idx * s_loc + torch.arange(s_loc, device=dev)).expand(b, s_loc)
        kw["kv_positions"] = torch.arange(n * s_loc, device=dev).expand(b, n * s_loc)
    return core.sageattn(q, k_full, v_full, is_causal=False,
                         sm_scale=d**-0.5 if sm_scale is None else sm_scale,
                         return_lse=return_lse, **kw)


def make_ring_attention(mesh, axis_name: str = "seq", *, is_causal: bool = False,
                        data_axis: str | None = "data", **attn_kwargs):
    """Ring attention in the global view: every rank passes the same global
    [b, h, S, d] q, k, v and gets the global output (and LSE with
    ``return_lse=True``); the batch splits over ``data_axis`` (composed away
    when the mesh lacks it), the sequence over ``axis_name``."""
    require_axis(mesh, axis_name)
    group = axis_info(mesh, axis_name)[0]
    take, give = global_view(mesh, data_axis, (axis_name,))
    return_lse = bool(attn_kwargs.pop("return_lse", False))

    def fn(q, k, v):
        refuse_grad(q, k, v)
        out = ring_sageattn(take(q), take(k), take(v), group, is_causal=is_causal,
                            return_lse=return_lse, **attn_kwargs)
        return tuple(map(give, out)) if return_lse else give(out)

    return fn
