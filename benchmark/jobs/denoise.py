"""The denoise job: one client sends seeded requests back to back, each
``steps_per_request`` Euler steps through the port's
``serve.denoise_step`` (x <- x - ``euler_step`` eps(x, t)), the model
loaded by ``serve.load_model`` from the benchmark's weights with every
attention through the mix's backend.

Two answers are compared with the reference once the window has closed:
the first step of the window's first request (the start: its input is
the benchmark's own noise) and one more step drawn from the seed among
the other steps finished in the window (reservoir sampling, so the draw
needs no step count ahead).  The later step's input is the state the
port's previous step left; each step is a function of its input alone,
so the reference takes that input and judges the step's answer.
"""

from __future__ import annotations

import dataclasses
import random

import torch

from benchmark import compare, feed, weights
from benchmark import window as win
from benchmark.jobs.common import dims, port_model
from benchmark.reference import nn as ref_nn

WARM_STEPS = 2


@dataclasses.dataclass
class Step:
    index: int        # step within its request
    inp: torch.Tensor
    out: torch.Tensor
    text: torch.Tensor


class Job:
    metric = "denoise_step_ms"
    training = False

    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.traffic, self.geo, self.m = cell.traffic, cell.geometry, dims(cell)
        self.ref = cell.reference()

    def setup(self) -> None:
        from sageattention_tpu_torch import models, serve

        cfg, cls = port_model(self.cell)
        sd = weights.make(self.ref.param_shapes(self.m), self.seed, self.device)
        proc = models.SageAttnProcessor(backend=self.traffic["attention"])
        self.model = serve.load_model(cfg, device=self.device, state_dict=sd, model_cls=cls,
                                      processor=proc)
        del sd
        self.denoise_step = serve.denoise_step
        self.times = [torch.full((self.geo.batch,), t, device=self.device)
                      for t in feed.schedule(self.traffic)]
        # the warm steps go through the window's own code, on request -1
        self._reset(first_request=-1)
        for i in range(WARM_STEPS):
            self._dispatch(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._reset(first_request=0)

    def _reset(self, first_request: int) -> None:
        self.request, self.j, self.lat, self.txt = first_request - 1, len(self.times), None, None
        self.recent, self.kept, self.flags, self.seen = {}, {}, [], 0
        self.rng = random.Random(feed.sub_seed(self.seed, "sample"))

    def _dispatch(self, i: int) -> None:
        if self.j == len(self.times):
            self.request += 1
            self.lat, self.txt = feed.request(self.m, self.geo, self.seed, self.request,
                                              self.device)
            self.j = 0
        out = self.denoise_step(self.model, self.lat, self.txt, self.times[self.j])
        self.flags.append(torch.isfinite(out).all())
        self.recent[i] = Step(self.j, self.lat, out, self.txt)
        self.recent.pop(i - 3, None)
        self.lat, self.j = out, self.j + 1

    def _done(self, i: int) -> None:
        if i == 0:
            self.kept["start"] = self.recent[i]
            return
        self.seen += 1
        if self.rng.random() * self.seen < 1:
            self.kept["step"] = self.recent[i]

    def window(self, *, seconds=None, steps=None, span=None):
        w = win.drive(self._dispatch, self.device, seconds=seconds, steps=steps,
                      on_done=self._done, span=span)
        failed = int((~torch.stack(self.flags[:w.steps])).sum())
        return w, {self.metric: w.seconds * 1e3 / w.steps}, failed

    def release(self) -> None:
        """Free the program's state: the model and all but the kept steps."""
        self.model = self.lat = self.txt = None
        self.recent.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """{"program": readings} and, with ``control``, the control's (the
        reference in fp8 in the program's place) on the same inputs."""
        params = weights.make(self.ref.param_shapes(self.m), self.seed, self.device)
        times = feed.schedule(self.traffic)
        out = {"program": {}, "control": {}}
        with ref_nn.fp32_matmuls(), torch.no_grad():
            for where, s in sorted(self.kept.items()):
                t = torch.full((self.geo.batch,), times[s.index], device=self.device)
                step = -self.traffic["euler_step"]
                ref = step * self.ref.forward(params, s.inp, s.text, t, self.m)
                for k, v in compare.update_readings(s.out - s.inp, ref).items():
                    out["program"][f"{where}_{k}"] = v
                if control:
                    ctl = step * self.ref.forward(params, s.inp, s.text, t, self.m,
                                                  prec=ref_nn.CONTROL)
                    for k, v in compare.update_readings(ctl, ref).items():
                        out["control"][f"{where}_{k}"] = v
                del ref
        return out
