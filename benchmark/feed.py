"""The one generator of every traffic mix: what a cell's client sends,
made on the device from ``--seed`` and the mix's parameters
(``traffic/<name>.json``), so that the same seed sends the same work.

A denoise request is a pair (latents, text embedding): fp32 noise
[batch, F, H, W, C] (the sampler's state) and a bf16 text embedding
[batch, text tokens, text width], followed by ``steps_per_request`` Euler
steps at the timesteps :func:`schedule` gives.  A fine-tuning step takes a
new clip: bf16 clean latents and text, and its (t, eps) draw.
"""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the stream named by ``keys`` under ``seed``."""
    digest = hashlib.blake2b(repr((int(seed),) + keys).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(device, seed: int, *keys) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *keys))
    return gen


def _latent_shape(model: dict, geo) -> tuple:
    return (geo.batch, geo.latent_frames, geo.latent_height, geo.latent_width,
            model["latent_channels"])


def request(model: dict, geo, seed: int, index: int, device):
    """Request ``index``'s (fp32 noise, bf16 text embedding)."""
    gen = generator(device, seed, "request", index)
    lat = torch.randn(_latent_shape(model, geo), generator=gen, device=device)
    txt = torch.randn(geo.batch, geo.text_tokens, model["text_dim"], generator=gen, device=device)
    return lat, txt.to(torch.bfloat16)


def schedule(traffic: dict) -> list:
    """The integer timestep of each step of a request: 999 - i (999 // steps)."""
    steps = traffic["steps_per_request"]
    return [999 - i * (999 // steps) for i in range(steps)]


def clip(model: dict, geo, seed: int, step: int, device):
    """Fine-tuning step ``step``'s batch: (x0 bf16, text bf16, t fp32 in
    [0, 1) per sample, eps fp32 N(0, 1) shaped like x0)."""
    gen = generator(device, seed, "clip", step)
    x0 = torch.randn(_latent_shape(model, geo), generator=gen, device=device)
    txt = torch.randn(geo.batch, geo.text_tokens, model["text_dim"], generator=gen, device=device)
    t = torch.rand(geo.batch, generator=gen, device=device)
    eps = torch.randn(x0.shape, generator=gen, device=device)
    return x0.to(torch.bfloat16), txt.to(torch.bfloat16), t, eps
