"""Rectified-flow training of the video DiT: the counterpart of the JAX
package's ``examples/train_dit.py`` as functions, its CLI aside: the
training step, data parallelism (``--dp``) and checkpoint and resume
(``--ckpt_dir`` / ``--ckpt_every``).

``load_trainer`` builds a :class:`models.VideoDiT` with fp32 parameters and
bf16 compute (flax's semantics) and ``torch.optim.AdamW(lr=1e-4,
weight_decay=0.01)`` with optax ``adamw``'s defaults (betas 0.9/0.999, eps
1e-8, decay on every parameter).  ``flow_loss`` is the example's loss with
the timestep ``t`` and the noise ``eps`` passed in; ``train_step`` runs
forward, backward (through the attention backend's gradient: the fused
quantized backward for ``"sage"``, the ring's and Ulysses' for
``"sage_parallel"``) and the optimizer step; ``train`` runs steps and
times each with CUDA events.

Data parallelism: ``data`` is a process group, or a device mesh whose
"data" dim is the group (``parallel.make_mesh``).  Each rank trains on its
own block of the batch; the gradients and the loss are summed over the
group and divided by its size before AdamW (gloo has no ``ReduceOp.AVG``),
the example's ``pmean`` over "data"; a group of one composes away.
``train`` draws each step's (t, eps) from a generator seeded by the seed,
the step and the rank's data coordinate, the example's ``fold_in(key,
axis_index)`` of ``PRNGKey(100 + i)``: ranks draw apart, and a resumed run
draws what an uninterrupted one would.  Under ``torchrun`` join the group
first (``parallel.mesh.initialize_multihost``, NCCL, a card a rank); on
the CPU, gloo through a ``FileStore``.  Every rank must take every step.

Checkpoints: :func:`save_checkpoint` writes the model's and AdamW's state
dicts and the step (``torch.save``), keeping the two newest, orbax's
``max_to_keep=2``; :func:`restore_latest` loads the newest and returns the
step to go on from.

Entry points that build state default to ``device="cuda"`` and raise when
no GPU is present, unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sageattention_tpu_torch import serve
from sageattention_tpu_torch.models.configs import DiTConfig
from sageattention_tpu_torch.models.dit import VideoDiT
from sageattention_tpu_torch.parallel.mesh import axis_info, take_shard

KEEP = 2  # checkpoints kept
_CKPT = re.compile(r"step_(\d+)\.pt")


@dataclasses.dataclass
class Trainer:
    model: VideoDiT
    opt: torch.optim.AdamW


def data_info(data):
    """(group, size, this rank's coordinate) of a data-parallel ``data``:
    None (no data parallelism), a process group, or a device mesh (its
    "data" dim, composed away when it has none)."""
    if data is None:
        return None, 1, 0
    if isinstance(data, DeviceMesh):
        return axis_info(data, "data")
    return data, dist.get_world_size(data), dist.get_rank(data)


def load_trainer(cfg: DiTConfig, *, device="cuda", seed: int = 0, dtype=torch.bfloat16,
                 state_dict: dict | None = None, data=None) -> Trainer:
    """A VideoDiT in train mode (fp32 parameters, ``dtype`` compute) with
    seeded random weights or the given (converted) ``state_dict``, and its
    AdamW optimizer.  With ``data``, the replicas start from the weights of
    the group's rank 0 (broadcast)."""
    model = serve.load_model(cfg, device=device, dtype=dtype, seed=seed,
                             state_dict=state_dict).train()
    group, n, _ = data_info(data)
    if n > 1:
        src = dist.get_global_rank(group, 0)
        for x in model.state_dict().values():
            dist.broadcast(x, src=src, group=group)
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


def step_noise(x0, seed: int, step: int, coord: int = 0):
    """Step ``step``'s (t, eps) for the rank at data coordinate ``coord``
    (:func:`draw_t_eps` from a generator seeded by the three)."""
    gen = torch.Generator(device=x0.device)
    gen.manual_seed(((seed * 1_000_003 + step) * 65_537 + coord) % (2**63))
    return draw_t_eps(x0, gen)


def train_step(trainer: Trainer, x0, txt, t, eps, data=None) -> torch.Tensor:
    """Forward, backward and one AdamW step on this rank's batch; returns
    the loss (detached).  With ``data`` the gradients and the loss are
    averaged over the group first (one all-reduce of a flat fp32 buffer;
    every rank's graph reaches the same parameters)."""
    group, n, _ = data_info(data)
    trainer.opt.zero_grad(set_to_none=True)
    loss = flow_loss(trainer.model, x0, txt, t, eps)
    loss.backward()
    loss = loss.detach()
    if n > 1:
        grads = [p.grad for p in trainer.model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.reshape(1).float()])
        dist.all_reduce(flat, group=group)
        flat /= n
        for g, avg in zip(grads, flat.split([g.numel() for g in grads] + [1])):
            g.copy_(avg.view_as(g))
        loss = flat[-1]
    trainer.opt.step()
    return loss


def _checkpoints(directory) -> list:
    """(step, path) of every checkpoint in ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    found = ((_CKPT.fullmatch(f), f) for f in os.listdir(directory))
    return sorted((int(m.group(1)), os.path.join(directory, f)) for m, f in found if m)


def save_checkpoint(trainer: Trainer, directory, step: int) -> None:
    """Write the model's and AdamW's state dicts and ``step`` to
    ``directory/step_<step>.pt`` and keep the :data:`KEEP` newest.  Under
    ``torch.distributed`` only the world's rank 0 writes, and every rank
    then meets at a barrier (every rank calls it, as every rank takes the
    same steps)."""
    distributed = dist.is_initialized() and dist.get_world_size() > 1
    if not distributed or dist.get_rank() == 0:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"step_{step:08d}.pt")
        torch.save({"model": trainer.model.state_dict(), "opt": trainer.opt.state_dict(),
                    "step": step}, path + ".tmp")
        os.replace(path + ".tmp", path)
        for _, old in _checkpoints(directory)[:-KEEP]:
            os.remove(old)
    if distributed:
        dist.barrier()


def restore_latest(trainer: Trainer, directory) -> int:
    """Load the newest checkpoint of ``directory`` into ``trainer``; returns
    the step after it, or 0 when there is none."""
    found = _checkpoints(directory)
    if not found:
        return 0
    # on the host first: the model's and AdamW's loads move each tensor where
    # its parameter lives (AdamW's step counts stay on the host, as it keeps them)
    ckpt = torch.load(found[-1][1], map_location="cpu")
    trainer.model.load_state_dict(ckpt["model"])
    trainer.opt.load_state_dict(ckpt["opt"])
    return ckpt["step"] + 1


def train(trainer: Trainer, x0, txt, steps: int, *, seed: int = 0, fixed_noise: bool = False,
          data=None, start: int = 0, ckpt_dir=None, ckpt_every: int = 5) -> dict:
    """Steps ``start`` .. ``start + steps - 1`` on the batch (x0, txt), of
    which each rank of ``data`` takes its block.  (t, eps) come from
    :func:`step_noise`: a new draw every step, or step 0's for all steps
    with ``fixed_noise``.  With ``ckpt_dir`` a checkpoint is saved after
    every ``ckpt_every``-th step and after the last.

    Returns {"losses": the loss of every step (averaged over ``data``),
    "step_ms": the time of every step, from CUDA events on the card or the
    host clock on the CPU, "device": the device name}."""
    dev = x0.device
    _, n, coord = data_info(data)
    x0, txt = take_shard(x0, 0, n, coord), take_shard(txt, 0, n, coord)
    losses, step_ms = [], []
    for i in range(start, start + steps):
        t, eps = step_noise(x0, seed, 0 if fixed_noise else i, coord)
        if dev.type == "cuda":
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            loss = train_step(trainer, x0, txt, t, eps, data)
            end.record()
            end.synchronize()
            step_ms.append(begin.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            loss = train_step(trainer, x0, txt, t, eps, data)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        if ckpt_dir is not None and ((i + 1) % ckpt_every == 0 or i == start + steps - 1):
            save_checkpoint(trainer, ckpt_dir, i)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"losses": losses, "step_ms": step_ms, "device": name}
