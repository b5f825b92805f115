"""The measured window: steps dispatched back to back, timed by the host
clock over all of them.

Step i is dispatched before the host waits for step i - 1 to finish, so
the device always holds the next step and never waits for the host; the
host stays at most one step ahead.  The window closes at the first of
those waits that ends past the deadline: the steps finished by then are
counted, and the window's length is the host time from its opening to
that wait.  The step still in flight is not counted; it is waited for
after the window, outside the measurement.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


@dataclasses.dataclass(frozen=True)
class Window:
    steps: int        # steps finished inside the window
    dispatched: int   # steps dispatched while it was open (steps + 1)
    seconds: float    # its length on the host clock
    ends: tuple       # host time, from the opening, at which each step was seen finished


class _Marker:
    """A CUDA event after a step, or nothing on the CPU, where a step has
    finished when its call returns."""

    def __init__(self, device: torch.device):
        self.event = torch.cuda.Event() if device.type == "cuda" else None
        if self.event is not None:
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(dispatch, device, *, seconds: float | None = None, steps: int | None = None,
          on_done=None, span=None) -> Window:
    """Run ``dispatch(i)`` for i = 0, 1, ... until ``seconds`` have passed
    (or ``steps`` steps have finished); ``on_done(i)`` is called once step
    i is known to have finished.  ``span``, a context manager, is open
    exactly while the window is (the trace's annotation of it)."""
    if (seconds is None) == (steps is None):
        raise ValueError("give seconds or steps")
    device = torch.device(device)
    _sync(device)
    with span if span is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        deadline = None if seconds is None else t0 + seconds
        dispatch(0)
        prev, i, ends = _Marker(device), 1, []
        while True:
            dispatch(i)
            marker = _Marker(device)
            prev.wait()
            now = time.perf_counter()
            ends.append(now - t0)
            if on_done is not None:
                on_done(i - 1)
            if (deadline is not None and now >= deadline) or (steps is not None and i >= steps):
                break
            prev, i = marker, i + 1
    window = Window(steps=i, dispatched=i + 1, seconds=now - t0, ends=tuple(ends))
    _sync(device)
    return window
