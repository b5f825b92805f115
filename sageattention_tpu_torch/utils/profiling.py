"""Profiling helpers (reference: hand-rolled hipEvent pairs in
gfx942.hip:196-199 and CUDA-event timing in bench/utils.py:7-33 — replaced
by a ``torch.profiler`` trace plus a per-stage wall timer).  The
counterpart of the JAX package's ``utils/profiling.py``.

* :func:`trace` — context manager around ``torch.profiler.profile`` (CPU
  and, where a GPU is present, CUDA activities) that writes a Chrome /
  Perfetto trace file into the log directory: open it in
  ``chrome://tracing`` or ui.perfetto.dev to see per-kernel device time.
* :class:`StageTimer` — coarse per-stage wall timing with a device barrier
  per stage, the analogue of the reference's event pairs around
  QK/softmax/SV stages.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Record a device profile: ``with trace("prof") as path: step()``.

    Yields the path of the trace file (``<log_dir>/<pid>.<ns>.pt.trace.json``),
    written when the block ends.  ``create_perfetto_link`` would upload the
    trace, which needs a network: it raises."""
    if create_perfetto_link:
        raise ValueError("create_perfetto_link uploads the trace and needs a network; open the "
                         "written file in ui.perfetto.dev instead")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield path
        if cuda:  # the block's kernels end inside the trace
            _sync_all()
    prof.export_chrome_trace(path)


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in ``x`` (nested lists, tuples, dicts)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _cuda_devices(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _cuda_devices(y, out)
    return out


class StageTimer:
    """Named wall-clock stage timing with a device barrier per stage.

    Append the stage's outputs to the yielded holder so the barrier
    waits on THAT stage's devices (CUDA launches are asynchronous — without
    it the time would land on whichever later stage happens to block)::

        t = StageTimer()
        with t("quant") as hold:
            qkv = quantize(...)
            hold.append(qkv)
        with t("attention") as hold:
            hold.append(kernel(...))
        print(t.report())

    With nothing in the holder the barrier synchronizes every visible CUDA
    device.  Times accumulate per name.
    """

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = time.perf_counter()
        result_holder = []
        yield result_holder
        if result_holder:
            for dev in _cuda_devices(result_holder, set()):
                torch.cuda.synchronize(dev)
        elif torch.cuda.is_available():
            _sync_all()
        self.times[name] = self.times.get(name, 0.0) + (time.perf_counter() - start)

    def report(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [
            f"{k:>20s}: {v*1e3:9.3f} ms ({v/total*100:5.1f}%)"
            for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
