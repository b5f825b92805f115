"""Rectified-flow training of the video DiT: the counterpart of the JAX
package's ``examples/train_dit.py`` training step (its CLI, data
parallelism and checkpointing are not ported).

``load_trainer`` builds a :class:`models.VideoDiT` with fp32 parameters and
bf16 compute (flax's semantics) and ``torch.optim.AdamW(lr=1e-4,
weight_decay=0.01)`` with optax ``adamw``'s defaults (betas 0.9/0.999, eps
1e-8, decay on every parameter).  ``flow_loss`` is the example's loss with
the timestep ``t`` and the noise ``eps`` passed in; ``train_step`` runs
forward, backward (through the attention backend's gradient: the fused
quantized backward for ``"sage"``) and the optimizer step; ``train`` runs
steps and times each with CUDA events.

Entry points that build state default to ``device="cuda"`` and raise when
no GPU is present, unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from sageattention_tpu_torch import serve
from sageattention_tpu_torch.models.configs import DiTConfig
from sageattention_tpu_torch.models.dit import VideoDiT


@dataclasses.dataclass
class Trainer:
    model: VideoDiT
    opt: torch.optim.AdamW


def load_trainer(cfg: DiTConfig, *, device="cuda", seed: int = 0, dtype=torch.bfloat16,
                 state_dict: dict | None = None) -> Trainer:
    """A VideoDiT in train mode (fp32 parameters, ``dtype`` compute) with
    seeded random weights or the given (converted) ``state_dict``, and its
    AdamW optimizer."""
    model = serve.load_model(cfg, device=device, dtype=dtype, seed=seed,
                             state_dict=state_dict).train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    return Trainer(model, opt)


def flow_loss(model: VideoDiT, x0, txt, t, eps):
    """Rectified-flow matching (``train_dit.py`` ``loss_fn``): x_t = (1-t)
    x0 + t eps, and the model regresses the velocity eps - x0.  ``t`` [b]
    fp32 in [0, 1), ``eps`` fp32 shaped like ``x0``."""
    tb = t.float()[:, None, None, None, None]
    x_t = ((1 - tb) * x0.float() + tb * eps).to(x0.dtype)
    pred = model(x_t, txt, (t * 1000).to(torch.int32))
    target = eps - x0.float()
    return torch.mean((pred.float() - target) ** 2)


def draw_t_eps(x0, gen: torch.Generator):
    """One (t, eps) draw: t ~ U[0, 1) per sample, eps ~ N(0, 1) fp32."""
    t = torch.rand(x0.shape[0], generator=gen, device=x0.device)
    eps = torch.randn(x0.shape, generator=gen, device=x0.device)
    return t, eps


def train_step(trainer: Trainer, x0, txt, t, eps) -> torch.Tensor:
    """Forward, backward and one AdamW step; returns the loss (detached)."""
    trainer.opt.zero_grad(set_to_none=True)
    loss = flow_loss(trainer.model, x0, txt, t, eps)
    loss.backward()
    trainer.opt.step()
    return loss.detach()


def train(trainer: Trainer, x0, txt, steps: int, *, seed: int = 0,
          fixed_noise: bool = False) -> dict:
    """``steps`` training steps on the batch (x0, txt).  (t, eps) come from a
    ``torch.Generator`` seeded with ``seed``: a new draw every step, or one
    draw for all steps with ``fixed_noise``.

    Returns {"losses": the loss of every step, "step_ms": the time of every
    step, from CUDA events on the card or the host clock on the CPU,
    "device": the device name}."""
    dev = x0.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t, eps = draw_t_eps(x0, gen)
    losses, step_ms = [], []
    for i in range(steps):
        if i and not fixed_noise:
            t, eps = draw_t_eps(x0, gen)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = train_step(trainer, x0, txt, t, eps)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            loss = train_step(trainer, x0, txt, t, eps)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"losses": losses, "step_ms": step_ms, "device": name}
