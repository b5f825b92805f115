"""AdamW as the configuration states it (decoupled weight decay, bias
corrections), written out in fp32: the reference's optimizer."""

from __future__ import annotations

import torch


class AdamW:
    def __init__(self, params: dict, lr: float, betas, eps: float, weight_decay: float):
        self.params, self.lr, self.eps, self.wd = params, lr, eps, weight_decay
        self.b1, self.b2 = betas
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - self.lr * self.wd)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k] / c1, denom, value=-self.lr)
