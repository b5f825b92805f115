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
steps in turn.

Differentiable (:class:`RingFunction`), as the JAX ring is through
``ppermute``'s transpose.  The forward keeps each step's residuals, as
JAX's unrolled loop does: the step's graph through ``sageattn`` (its q,
the K/V block it attended in fp32, the block's K codes, scales and mean,
its o and LSE).  The backward splits the merged output's cotangents over
the steps (:func:`merge_cotangents`), runs each step's own backward
(:func:`ring_step_vjp`: the fused quantized backward, kernels 4, 7 and 8
on the card), adds dq up on the rank, and sends each block's dK/dV
partials home the other way round the ring in fp32, n - 1 hops that every
rank issues whether its steps ran or were skipped.  So a rank holds the
K/V blocks of every step that ran (the all-gather's memory), not O(1).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sageattention_tpu_torch import core
from sageattention_tpu_torch.parallel.mesh import (axis_info, gather_blocks, global_view,
                                                    require_axis)

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
    rounding of its own to every step before the merge.  Under grad, with
    inputs that require it, the step is ``sageattn``'s differentiable op."""
    if is_causal and src > idx:
        return None
    return core.sageattn(q.float(), kb, vb, is_causal=is_causal and src == idx,
                         sm_scale=sm_scale, return_lse=True, **attn_kwargs)


def ring_partials(q, blocks, *, idx: int, is_causal: bool, sm_scale=None, grad: bool = False,
                  **attn_kwargs):
    """Rank ``idx``'s steps over ``blocks``, its (src, K block, V block) in
    the order they reach it: the merged (o_acc, LSE acc) fp32 and the
    steps.  With ``grad`` each step that ran is (o_i, lse_i, inputs), its
    graph built on fp32 leaves ``inputs`` = (q, K block, V block) (the same
    q leaf for every step; fp32 K/V, so that the dK/dV partials come back
    unrounded; the values, so the codes, are the blocks'); without, (o_i,
    lse_i).  A skipped step is None."""
    o_acc, lse_acc = init_state(q)
    qs = q.detach().float().requires_grad_() if grad else q.float()
    steps = []
    for src, kb, vb in blocks:
        if grad:
            kb, vb = (x.detach().float().requires_grad_() for x in (kb, vb))
        with torch.set_grad_enabled(grad):
            part = ring_step(qs, kb, vb, src=src, idx=idx, is_causal=is_causal,
                             sm_scale=sm_scale, **attn_kwargs)
        if part is not None:
            o_acc, lse_acc = _merge(o_acc, lse_acc, part[0].detach(), part[1].detach())
            if grad:
                part = (*part, (qs, kb, vb))
        steps.append(part)
    return o_acc, lse_acc, steps


def merge_cotangents(steps, o, lse, do, dlse):
    """The merge's VJP: each step's (do_i, dlse_i), None for a skipped step.
    With w_i = exp(lse_i - lse), o = sum w_i o_i and lse = log sum exp
    lse_i, so do_i = w_i do and dlse_i = w_i (rowsum(do (o_i - o)) +
    dlse), what ``jax.vjp`` of the JAX ``ring._merge`` hands each step.
    ``do`` or ``dlse`` may be None (no cotangent); ``o``, ``lse`` are the
    merged fp32 state."""
    dof = None if do is None else do.float()
    out = []
    for step in steps:
        if step is None:
            out.append(None)
            continue
        o_i, lse_i = step[0], step[1]
        w = torch.exp(lse_i.detach() - lse)
        g = torch.zeros_like(lse) if dlse is None else dlse.float()
        if dof is None:
            do_i = torch.zeros_like(o_i)
        else:
            g = g + (dof * (o_i.detach() - o)).sum(dim=-1)
            do_i = w[..., None] * dof
        out.append((do_i, w * g))
    return out


def ring_step_vjp(step, do_i, dlse_i):
    """(dq, dk, dv) fp32 of one step that ran, from its graph
    (:func:`ring_partials` with ``grad``) and its cotangents
    (:func:`merge_cotangents`): on the card, kernel 4 on q, then kernels
    7 and 8 (or the exact recompute of a Q/K option)."""
    o_i, lse_i, inputs = step
    return torch.autograd.grad((o_i, lse_i), inputs, (do_i, dlse_i))


def _peers(group, idx: int, n: int):
    """The global ranks after and before ``idx`` on the ring of ``group``."""
    def rank(i):
        return dist.get_global_rank(group, i % n) if group is not None else i % n

    return rank(idx + 1), rank(idx - 1)


def _rotating_blocks(k, v, group, idx: int, n: int):
    """(src, K block, V block) at each step of the ring: the block in hand,
    the next one's transfer issued before it is yielded and awaited
    after."""
    nxt, prv = _peers(group, idx, n)
    kb, vb = k.contiguous(), v.contiguous()
    for step in range(n):
        reqs = ()
        if step < n - 1:
            k_next, v_next = torch.empty_like(kb), torch.empty_like(vb)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, kb, nxt, group),
                dist.P2POp(dist.isend, vb, nxt, group),
                dist.P2POp(dist.irecv, k_next, prv, group),
                dist.P2POp(dist.irecv, v_next, prv, group),
            ])
        yield (idx - step) % n, kb, vb
        for r in reqs:
            r.wait()
        if reqs:
            kb, vb = k_next, v_next


class RingFunction(torch.autograd.Function):
    """The ring with its gradient.  ``apply(q, k, v, group, is_causal,
    sm_scale, return_lse, attn_kwargs)`` returns o, or (o, lse); both are
    differentiable.

    Backward, every rank at once (as under DDP, every rank must call
    backward, or its peers wait on its hops): the steps in reverse ring
    order, each step's VJP computed while the previous hop is in flight;
    dq summed on the rank; the dK/dV accumulator of the block in hand
    (fp32) sent to rank - 1 and the next one received from rank + 1, so
    after the n - 1 hops each rank holds its own block's gradient, which
    is cast to k's and v's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, group, is_causal, sm_scale, return_lse, attn_kwargs):
        ctx.set_materialize_grads(False)
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        o_acc, lse_acc, steps = ring_partials(
            q, _rotating_blocks(k, v, group, idx, n), idx=idx, is_causal=is_causal,
            sm_scale=sm_scale, grad=True, **attn_kwargs)
        ctx.state = (o_acc, lse_acc, steps)
        ctx.group, ctx.n, ctx.idx = group, n, idx
        ctx.like = [(x.shape, x.dtype) for x in (q, k, v)]  # of the gradients
        return finish(o_acc, lse_acc, q.dtype, return_lse)

    @staticmethod
    def backward(ctx, do, dlse=None):
        o_acc, lse_acc, steps = ctx.state
        ctx.state = None
        cts = merge_cotangents(steps, o_acc, lse_acc, do, dlse)
        nxt, prv = _peers(ctx.group, ctx.idx, ctx.n)
        dq, dk, dv = (torch.zeros(shape, dtype=torch.float32, device=o_acc.device)
                      for shape, _ in ctx.like)
        reqs = ()
        for s in reversed(range(ctx.n)):
            g = ring_step_vjp(steps[s], *cts[s]) if steps[s] is not None else None
            for r in reqs:  # the accumulator of this step's block, from rank + 1
                r.wait()
            if reqs:
                dk, dv = dk_in, dv_in
            if g is not None:
                dq += g[0]
                dk, dv = dk + g[1], dv + g[2]
            if s:
                dk_in, dv_in = torch.empty_like(dk), torch.empty_like(dv)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, dk, prv, ctx.group),
                    dist.P2POp(dist.isend, dv, prv, ctx.group),
                    dist.P2POp(dist.irecv, dk_in, nxt, ctx.group),
                    dist.P2POp(dist.irecv, dv_in, nxt, ctx.group),
                ])
        (_, qd), (_, kd), (_, vd) = ctx.like
        return dq.to(qd), dk.to(kd), dv.to(vd), None, None, None, None, None


def ring_sageattn(q, k, v, group=None, *, is_causal: bool = False, sm_scale=None,
                  return_lse: bool = False, **attn_kwargs):
    """Ring attention on this rank's blocks q, k, v [b, h, s_local, d] (HND),
    the global sequence being the blocks in the order of the ranks of
    ``group`` (the default group when None).  ``attn_kwargs`` go to every
    step's ``sageattn``.  Under grad, with an input that requires it, the
    call is :class:`RingFunction`: every rank of ``group`` must then call
    backward."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return RingFunction.apply(q, k, v, group, is_causal, sm_scale, return_lse, attn_kwargs)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    o_acc, lse_acc, _ = ring_partials(q, _rotating_blocks(k, v, group, idx, n), idx=idx,
                                      is_causal=is_causal, sm_scale=sm_scale, **attn_kwargs)
    return finish(o_acc, lse_acc, q.dtype, return_lse)


def allgather_sageattn(q, k, v, group=None, *, is_causal: bool = False, sm_scale=None,
                       return_lse: bool = False, **attn_kwargs):
    """All-gather context parallelism on this rank's blocks: the whole K/V
    gathered, one attention of the local queries against it.  Simpler than
    the ring, for a K/V that fits replicated.  Causal masking goes through
    positions (the query block's offset in the gathered K/V is the rank's),
    which run the masked kernel and have no gradient, as in the JAX
    package: causal, it raises under grad.  Non-causal it is
    differentiable, the gathered K/V's gradient reduce-scattered home."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    b, _, s_loc, d = q.shape
    kw = dict(attn_kwargs)
    if is_causal:
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            raise NotImplementedError(
                "causal allgather_sageattn masks by positions, which have no gradient (nor in "
                "the JAX package): use ring_sageattn for a causal gradient, or call it under "
                "torch.no_grad()")
        dev = q.device
        kw["q_positions"] = (idx * s_loc + torch.arange(s_loc, device=dev)).expand(b, s_loc)
        kw["kv_positions"] = torch.arange(n * s_loc, device=dev).expand(b, n * s_loc)
    k_full = gather_blocks(k, 2, group, n)
    v_full = gather_blocks(v, 2, group, n)
    return core.sageattn(q, k_full, v_full, is_causal=False,
                         sm_scale=d**-0.5 if sm_scale is None else sm_scale,
                         return_lse=return_lse, **kw)


def make_ring_attention(mesh, axis_name: str = "seq", *, is_causal: bool = False,
                        data_axis: str | None = "data", **attn_kwargs):
    """Ring attention in the global view: every rank passes the same global
    [b, h, S, d] q, k, v and gets the global output (and LSE with
    ``return_lse=True``); the batch splits over ``data_axis`` (composed away
    when the mesh lacks it), the sequence over ``axis_name``.
    Differentiable: each rank's gradient of q, k, v is the whole global
    one (``mesh.global_view``)."""
    require_axis(mesh, axis_name)
    group = axis_info(mesh, axis_name)[0]
    take, give = global_view(mesh, data_axis, (axis_name,))
    return_lse = bool(attn_kwargs.pop("return_lse", False))

    def fn(q, k, v):
        out = ring_sageattn(take(q), take(k), take(v), group, is_causal=is_causal,
                            return_lse=return_lse, **attn_kwargs)
        return tuple(map(give, out)) if return_lse else give(out)

    return fn
