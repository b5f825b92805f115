"""The device trace of a measured window, reduced to what the per-layer
metrics and the result's breakdown read.

The grouping is a copy of ``chip_smoke.py``'s ``profile_device``: the
device spans of ``torch.profiler`` (kernels, copies, sets; not the
annotations, which span kernels already counted) grouped by kernel name,
and the device's busy time as the union of the spans.  One change: the
V-code widening (``widen_v_kernel``, launched by
``attention_cuda.widen_v_codes``) belongs to the quantizer group, where
the copy in ``chip_smoke.py`` leaves it in "other".  The events are
read raw, not through ``prof.events()``.  Everything is clipped to the
window, whose bounds are the host annotation :data:`WINDOW` that the
harness opens and closes around it.
"""

from __future__ import annotations

import bisect
import dataclasses

WINDOW = "benchmark.window"
GROUPS = ("sage_attn_fwd", "sage_attn_bwd", "sage_decode", "quant", "gemm", "other")
TOP = 10            # entries in each list of the breakdown
LABELLED_GAPS = 1000  # the longest idle gaps, each named by the host op around it


def group_of(name: str) -> str:
    low = name.lower()
    if "sage_attn_fwd" in low:
        return "sage_attn_fwd"
    if "sage_attn_bwd" in low:
        return "sage_attn_bwd"
    if "decode_kernel" in low:  # kernels 9-12
        return "sage_decode"
    if "quant" in low or "channel_mean" in low or "widen_v" in low:  # kernels 2-6, widening
        return "quant"
    if any(w in low for w in ("gemm", "cutlass", "nvjet", "xmma")):
        return "gemm"
    return "other"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    device: bool  # a span on the device, else a host op
    start_us: float
    end_us: float


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    group_s: dict       # seconds of device time by group
    kernels: dict       # name -> seconds
    idle_gaps: list     # [[what the host was doing, seconds], ...]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_ops(self, n: int = TOP) -> list:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], secs] for name, secs in rows]


def events_of(prof) -> list:
    """The events of a finished ``torch.profiler.profile``, read from its
    raw results: building ``prof.events()`` takes minutes at 10^5 events."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == torch.autograd.DeviceType.CUDA
        if device and e.is_user_annotation():
            continue
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), device, start, start + e.duration_ns() / 1e3))
    return out


def _union(spans):
    """Disjoint, sorted segments covering ``spans``."""
    segs = []
    for a, b in sorted(spans):
        if segs and a <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], b)
        else:
            segs.append([a, b])
    return segs


def _label_gaps(gaps, host):
    """Name each gap (a, b) by the innermost host op open at its middle."""
    host = sorted(host, key=lambda e: e.start_us)
    starts = [e.start_us for e in host]
    by_label = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = "host: no op open"
        i = bisect.bisect_right(starts, mid)
        for e in reversed(host[max(0, i - 5000):i]):  # the latest start that covers mid
            if e.end_us >= mid:
                label = e.name
                break
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e6
    return by_label


def reduce(events: list) -> Trace:
    """The window's device time by group and by kernel, its busy time and
    its idle gaps, from ``events`` (:func:`events_of`)."""
    marks = [e for e in events if not e.device and e.name == WINDOW]
    if len(marks) != 1:
        raise ValueError(f"want one {WINDOW!r} annotation in the trace, found {len(marks)}")
    w0, w1 = marks[0].start_us, marks[0].end_us
    spans, kernels = [], {}
    group_s = dict.fromkeys(GROUPS, 0.0)
    for e in events:
        if not e.device or e.end_us <= w0 or e.start_us >= w1:
            continue
        a, b = max(e.start_us, w0), min(e.end_us, w1)
        spans.append((a, b))
        secs = (b - a) / 1e6
        kernels[e.name] = kernels.get(e.name, 0.0) + secs
        group_s[group_of(e.name)] += secs
    segs = _union(spans)
    busy = sum(b - a for a, b in segs) / 1e6
    edges = [w0] + [x for s in segs for x in s] + [w1]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])
    host = [e for e in events if not e.device and e.name != WINDOW]
    by_label = _label_gaps(gaps[:LABELLED_GAPS], host)
    rest = sum(b - a for a, b in gaps[LABELLED_GAPS:]) / 1e6
    if rest:
        by_label[f"the {len(gaps) - LABELLED_GAPS} shorter gaps"] = rest
    idle = sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:TOP]
    return Trace((w1 - w0) / 1e6, busy, group_s, kernels, idle)
