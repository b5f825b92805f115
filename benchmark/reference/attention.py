"""Exact softmax attention in fp32, in blocks of query rows so that the
scores of a 119,056-token sequence fit: the forward, and for training an
autograd function whose backward recomputes the probabilities block by
block from the saved log-sum-exp.  Plain PyTorch; nothing of the program.
"""

from __future__ import annotations

import math

import torch

BLOCK_ELEMENTS = 1 << 29  # fp32 scores held at once: 2 GiB


def _blocks(bh: int, sq: int, sk: int):
    rows = max(1, min(sq, BLOCK_ELEMENTS // sk))
    heads = max(1, min(bh, BLOCK_ELEMENTS // (rows * sk)))
    for g0 in range(0, bh, heads):
        for q0 in range(0, sq, rows):
            yield slice(g0, min(bh, g0 + heads)), slice(q0, min(sq, q0 + rows))


def forward(q, k, v, scale: float, lse: bool = False):
    """softmax(q k^T scale) v for q [B, sq, d], k and v [B, sk, d] (B =
    batch x heads), and with ``lse`` the natural log-sum-exp of each row."""
    bh, sq, _ = q.shape
    o = torch.empty_like(q)
    out_lse = torch.empty(bh, sq, device=q.device, dtype=q.dtype) if lse else None
    for g, r in _blocks(bh, sq, k.shape[1]):
        s = torch.bmm(q[g, r], k[g].transpose(1, 2)).mul_(scale)
        if lse:
            m = s.amax(dim=-1, keepdim=True)
            p = s.sub_(m).exp_()
            den = p.sum(dim=-1, keepdim=True)
            o[g, r] = torch.bmm(p, v[g]).div_(den)
            out_lse[g, r] = (m + den.log()).squeeze(-1)
        else:
            o[g, r] = torch.bmm(torch.softmax(s, dim=-1), v[g])
        del s
    return o, out_lse


class Exact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = forward(q, k, v, scale, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale = ctx.scale
        dq = torch.empty_like(q)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        for g, r in _blocks(q.shape[0], q.shape[1], k.shape[1]):
            p = torch.bmm(q[g, r], k[g].transpose(1, 2)).mul_(scale)
            p = p.sub_(lse[g, r, None]).exp_()
            dob = do[g, r]
            dv[g] += torch.bmm(p.transpose(1, 2), dob)
            dp = torch.bmm(dob, v[g].transpose(1, 2))
            dp.sub_((dob * o[g, r]).sum(dim=-1, keepdim=True))
            ds = p.mul_(dp)
            dq[g, r] = torch.bmm(ds, k[g]).mul_(scale)
            dk[g] += torch.bmm(ds.transpose(1, 2), q[g, r]).mul_(scale)
        return dq, dk, dv, None


def attention(q, k, v, grad: bool = False):
    """Attention on [b, h, s, d] fp32 tensors with scale d^-1/2."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    flat = (q.reshape(b * h, sq, d), k.reshape(b * h, sk, d), v.reshape(b * h, sk, d))
    scale = 1.0 / math.sqrt(d)
    o = Exact.apply(*flat, scale) if grad else forward(*flat, scale)[0]
    return o.reshape(b, h, sq, d)
