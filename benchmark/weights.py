"""Seeded weights, made on the device in one draw: every parameter a view
of one flat fp32 buffer (the type the port keeps its parameters in).

Each view of the standard-normal draw is then scaled in place by its
kind: a matrix by 1/sqrt(fan_in) (lecun-normal), a bias by 0.02, a norm's
scale to 1 + 0.1 z, the positional embedding by 0.02.  Non-zero biases and
norm scales keep every parameter in play for the comparison.  The same
seed gives the same weights, so the reference draws them again after the
window rather than keeping a second copy resident.
"""

from __future__ import annotations

import math

import torch

from benchmark import feed

SCALE = {"bias": 0.02, "pos": 0.02}


def make(shapes: dict, seed: int, device) -> dict:
    """name -> tensor for ``shapes`` (name -> (shape, kind))."""
    sizes = [math.prod(shape) for shape, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=feed.generator(device, seed, "weights"),
                       device=device)
    out = {}
    with torch.no_grad():
        for (name, (shape, kind)), view in zip(shapes.items(), flat.split(sizes)):
            view = view.view(shape)
            if kind == "weight":
                view.mul_(1.0 / math.sqrt(shape[1]))
            elif kind == "norm":
                view.mul_(0.1).add_(1.0)
            else:
                view.mul_(SCALE[kind])
            out[name] = view
    return out
