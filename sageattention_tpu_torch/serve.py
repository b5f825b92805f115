"""Denoise server for the video DiT: the counterpart of the JAX package's
``examples/common.py`` run loop.

``load_model`` builds a :class:`models.VideoDiT` (or, with ``model_cls``,
a ``DualStreamVideoDiT`` or ``CrossAttnVideoDiT``) with seeded random
weights (or takes converted ones), ``denoise_step`` is one Euler step of
the mock flow ``x <- x - (1/50) * eps(x, t)``, and ``serve`` answers a
list of requests, each a (latents, text embedding) pair, timing every
step with CUDA events.

Entry points that build state default to ``device="cuda"`` and raise when
no GPU is present, unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math
import time

import torch

from sageattention_tpu_torch.models.configs import DiTConfig
from sageattention_tpu_torch.models.dit import VideoDiT

TEXT_DIM = 512
LATENT_CHANNELS = 16


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


@torch.no_grad()
def init_weights(model: torch.nn.Module, seed: int) -> None:
    """Seeded random weights: Linear weights ~ N(0, 1/fan_in) (flax's
    lecun-normal scale), biases 0, LayerNorm scale 1, ``pos_embed`` ~
    N(0, 0.02^2).  Drawn on the model's device from one generator."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, p in model.named_parameters():
        if name == "pos_embed":
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02)
        elif name.endswith("norm.weight"):
            p.fill_(1.0)
        elif p.dim() == 2:
            std = 1.0 / math.sqrt(p.shape[1])
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)
        else:
            p.zero_()


def load_model(cfg: DiTConfig, *, device="cuda", dtype=torch.bfloat16,
               seed: int = 0, state_dict: dict | None = None,
               model_cls: type[VideoDiT] = VideoDiT) -> VideoDiT:
    """A ``model_cls`` (VideoDiT, DualStreamVideoDiT or CrossAttnVideoDiT)
    on ``device`` in eval mode, with seeded random weights or the given
    (converted) ``state_dict``."""
    dev = resolve_device(device)
    model = model_cls(cfg, latent_channels=LATENT_CHANNELS, text_dim=TEXT_DIM,
                      dtype=dtype, device=dev)
    if state_dict is None:
        init_weights(model, seed)
    else:
        model.load_state_dict(state_dict)
    return model.eval()


def make_requests(cfg: DiTConfig, n: int, *, device="cuda", seed: int = 0,
                  dtype=torch.bfloat16, batch: int = 1):
    """``n`` seeded (latents [batch,F,H,W,16], text [batch,Lt,512]) requests
    (``batch=2``: a classifier-free-guidance pair)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape = (batch, cfg.latent_frames, cfg.latent_height, cfg.latent_width,
             LATENT_CHANNELS)
    return [
        (torch.randn(shape, generator=gen, device=dev).to(dtype),
         torch.randn(batch, cfg.text_len, TEXT_DIM, generator=gen, device=dev).to(dtype))
        for _ in range(n)
    ]


@torch.no_grad()
def denoise_step(model: VideoDiT, lat, txt, t):
    """One Euler step of the mock flow: x <- x - (1/50) * eps(x, t)."""
    eps = model(lat, txt, t)
    return lat - (1.0 / 50) * eps.to(lat.dtype)


def timesteps(steps: int, batch: int, device) -> list[torch.Tensor]:
    """The example runner's schedule: 999 - i * (999 // steps)."""
    return [
        torch.full((batch,), 999 - i * (999 // max(steps, 1)), device=device)
        for i in range(steps)
    ]


@torch.no_grad()
def serve(model: VideoDiT, requests, steps: int) -> dict:
    """Answer each request with ``steps`` denoise steps.

    Returns {"outputs": final latents per request, "step_ms": the time of
    every step, from CUDA events on the card or the host clock on the
    CPU, "device": the device name}."""
    dev = next(model.parameters()).device
    outputs, step_ms = [], []
    for lat, txt in requests:
        for t in timesteps(steps, lat.shape[0], dev):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                lat = denoise_step(model, lat, txt, t)
                end.record()
                end.synchronize()
                step_ms.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                lat = denoise_step(model, lat, txt, t)
                step_ms.append((time.perf_counter() - t0) * 1e3)
        outputs.append(lat)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"outputs": outputs, "step_ms": step_ms, "device": name}


def parallel_config(cfg: DiTConfig, mesh, *, ring_axis: str = "seq",
                    ulysses_axis: str = "heads") -> DiTConfig:
    """``cfg`` fitted to the mesh: the heads must divide by the Ulysses degree,
    and the text length is padded so that the sequence divides by the
    sequence-parallel degree (ring x Ulysses), as the JAX example pads it."""
    from sageattention_tpu_torch.parallel.mesh import axis_info

    _, rn, _ = axis_info(mesh, ring_axis)
    _, un, _ = axis_info(mesh, ulysses_axis)
    if cfg.heads % un:
        raise ValueError(f"heads ({cfg.heads}) must divide by the Ulysses degree {un}")
    return cfg.scaled(text_len=cfg.text_len + (-cfg.seq_len) % (rn * un))


@torch.no_grad()
def serve_parallel(model: VideoDiT, requests, steps: int, mesh, *, data_axis: str = "data",
                   ring_axis: str = "seq", ulysses_axis: str = "heads") -> dict:
    """:func:`serve` with every attention of the model through the
    "sage_parallel" backend over ``mesh``: the loop of the JAX package's
    ``examples/parallel_video.py``.  Each rank runs the model on the whole
    requests (a CFG pair is ``make_requests(..., batch=2)``, split over the
    "data" dim) and attention on its blocks; every rank ends with the same
    outputs.  The model's config must fit the mesh (:func:`parallel_config`).
    The backend and mesh are set back when it returns."""
    from sageattention_tpu_torch import models

    prev = models.get_attention_backend()
    models.set_mesh(mesh, data_axis, ring_axis, ulysses_axis)
    models.set_attention_backend("sage_parallel")
    try:
        return serve(model, requests, steps)
    finally:
        models.set_attention_backend(prev)
        models.set_mesh(None)
