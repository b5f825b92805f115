"""The fine-tuning job: rectified-flow steps through the port's
``train.train_step`` (forward, backward, AdamW) on a trainer that
``train.load_trainer`` builds from the benchmark's weights, every step on
a new clip with its own (t, eps) from the seed (``feed.clip``).

The reference follows the trainer's first ``followed_steps`` steps.  The
first is set-up's warm step; the others are the window's first steps, so
the compared numbers cover timed steps.  Set-up reads the first gradient
as AdamW holds it after that step (its first moment over 1 - beta1); the
window keeps each step's loss on the device and, once the last followed
step has finished, copies the parameters to the host on a side stream,
which AdamW's next step waits for.  The parameters' change over the
followed steps is taken from that copy after the window, so nothing of
the check stays on the card while it is timed.
"""

from __future__ import annotations

import torch

from benchmark import compare, feed, weights
from benchmark import window as win
from benchmark.jobs.common import dims, port_model
from benchmark.reference import nn as ref_nn
from benchmark.reference.adamw import AdamW


class Job:
    metric = "train_step_ms"
    training = True

    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.traffic, self.geo, self.m = cell.traffic, cell.geometry, dims(cell)
        self.ref = cell.reference()
        self.followed = self.traffic["followed_steps"]

    def setup(self) -> None:
        from sageattention_tpu_torch import models, train

        cfg, cls = port_model(self.cell)
        if cls is not models.VideoDiT:
            raise ValueError("train.load_trainer builds a VideoDiT")
        models.set_attention_backend(self.traffic["attention"])
        self.train_step = train.train_step
        t = self.traffic
        sd = weights.make(self.ref.param_shapes(self.m), self.seed, self.device)
        self.trainer = train.load_trainer(cfg, device=self.device, state_dict=sd, lr=t["lr"])
        opt, params = self.trainer.opt, dict(self.trainer.model.named_parameters())
        if opt.defaults["betas"] != tuple(t["betas"]) or opt.defaults["eps"] != t["eps"] or \
                opt.defaults["weight_decay"] != t["weight_decay"]:
            raise ValueError(f"the port's AdamW {opt.defaults} is not the mix's {t}")
        # the warm step is the first followed step: clip 0, through the window's own call
        self.losses = [self.train_step(self.trainer, *feed.clip(self.m, self.geo, self.seed, 0,
                                                                self.device))]
        # a parameter AdamW did not step holds no moment: a zero gradient
        moments = {n: opt.state[p].get("exp_avg", torch.zeros_like(p)) for n, p in params.items()}
        self.grad = compare.leaf_norms(moments, 1.0 / (1.0 - t["betas"][0]))
        del sd, moments
        self.params = params
        pin = self.device.type == "cuda"
        flat = torch.empty(sum(p.numel() for p in params.values()), pin_memory=pin)
        self.snapshot = {n: v.view(p.shape) for (n, p), v in
                         zip(params.items(), flat.split([p.numel() for p in params.values()]))}
        self.copy_stream = torch.cuda.Stream(self.device) if pin else None
        if pin:
            torch.cuda.synchronize(self.device)

    def _take_snapshot(self) -> None:
        """Copy the parameters to the host after the step just dispatched,
        on a side stream on the card; AdamW's next step waits for it."""
        if self.copy_stream is None:
            for n, p in self.params.items():
                self.snapshot[n].copy_(p.detach())
            return
        stepped = torch.cuda.Event()
        stepped.record()
        copied = torch.cuda.Event()
        with torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(stepped)
            for n, p in self.params.items():
                self.snapshot[n].copy_(p.detach(), non_blocking=True)
            copied.record()

        def wait_for_copy(optimizer, args, kwargs):
            torch.cuda.current_stream().wait_event(copied)
            handle.remove()

        handle = self.trainer.opt.register_step_pre_hook(wait_for_copy)

    def _dispatch(self, i: int) -> None:
        clip = feed.clip(self.m, self.geo, self.seed, 1 + i, self.device)
        self.losses.append(self.train_step(self.trainer, *clip))
        if i == self.followed - 2:
            self._take_snapshot()

    def window(self, *, seconds=None, steps=None, span=None):
        w = win.drive(self._dispatch, self.device, seconds=seconds, steps=steps, span=span)
        failed = int((~torch.isfinite(torch.stack(self.losses[1:1 + w.steps]))).sum())
        return w, {self.metric: w.seconds * 1e3 / w.steps}, failed

    def release(self) -> None:
        """Free the program's state; keep the followed steps' readings."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        losses = torch.stack(self.losses[:self.followed]).tolist()
        self.readings = {"losses": losses, "grad": self.grad, "change": None}
        self.trainer = self.params = self.copy_stream = None
        self.losses = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def follow(self, prec=ref_nn.EXACT, half_batch: bool = False) -> dict:
        """The reference's losses, first gradient and change over the
        followed steps, from the same weights and clips; ``half_batch``
        plants the fault of a loss taken over half of the clip."""
        t = self.traffic
        p0 = weights.make(self.ref.param_shapes(self.m), self.seed, self.device)
        params = {k: v.detach().clone().requires_grad_() for k, v in p0.items()}
        opt = AdamW(params, t["lr"], t["betas"], t["eps"], t["weight_decay"])
        losses = []
        with ref_nn.fp32_matmuls():
            for k in range(self.followed):
                x0, txt, tt, eps = feed.clip(self.m, self.geo, self.seed, k, self.device)
                tb = tt[:, None, None, None, None]
                x_t = (1 - tb) * x0.float() + tb * eps
                pred = self.ref.forward(params, x_t, txt, (tt * 1000).to(torch.int32), self.m,
                                        prec=prec, grad=True)
                err = (pred - (eps - x0.float())) ** 2
                loss = (err[:, : err.shape[1] // 2] if half_batch else err).mean()
                grads = torch.autograd.grad(loss, list(params.values()))
                del pred, err
                if k == 0:
                    grad = compare.leaf_norms(dict(zip(params, grads)))
                opt.step(dict(zip(params, grads)))
                losses.append(loss.item())
                del grads, loss
        change = compare.leaf_norms({k: params[k].detach() - p0[k] for k in params})
        return {"losses": losses, "grad": grad, "change": change}

    def _change(self) -> dict:
        """The program's change over the followed steps: the host copy
        against the seed's weights, leaf by leaf on the device."""
        p0 = weights.make(self.ref.param_shapes(self.m), self.seed, self.device)
        return {n: (self.snapshot[n].to(self.device) - p0[n]).double().norm().item()
                for n in self.snapshot}

    def check(self, control: bool = False, half_batch: bool = False) -> dict:
        if self.readings["change"] is None:
            self.readings["change"] = self._change()
            self.snapshot = None
        ref = self.follow()
        program, info = compare.training_readings(self.readings, ref)
        out = {"program": program, "info": info, "control": {}}
        if control:
            out["control"], out["control_info"] = compare.training_readings(
                self.follow(ref_nn.CONTROL), ref)
        if half_batch:
            out["half_batch"], out["half_batch_info"] = compare.training_readings(
                self.follow(half_batch=True), ref)
        return out
