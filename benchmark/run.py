"""One run of one benchmark cell.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It sets the cell up (weights from the seed,
the port's model or trainer, warm steps at the cell's shapes), measures
``--seconds`` of back-to-back steps (:mod:`benchmark.window`), frees the
program's state, compares what the timed path produced with the plain
reference, and prints one JSON line: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
``torch.profiler`` over the window.  It measures on the card only: without
one it exits with 2 and prints no result.  The port's kernel builds go to
``build/`` in the checkout (``SAGEATTN_TORCH_BUILD``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from benchmark import cells, profile, roofline

# no module of these may be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "sageattention_tpu")
GIB = 1 << 30


def process_start() -> float:
    """The epoch time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def cache_dirs(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ.setdefault("SAGEATTN_TORCH_BUILD", str(build))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def launch_counters() -> list:
    """(wrapper, counter attribute) of every launch counter of the port's
    kernel wrappers."""
    from sageattention_tpu_torch.ops import attention_bwd_cuda, attention_cuda, quant_cuda

    out = []
    for mod in (attention_cuda, quant_cuda, attention_bwd_cuda):
        for fn in vars(mod).values():
            if callable(fn) and hasattr(fn, "launches"):
                out += [(fn, a) for a in vars(fn) if a.endswith("launches")]
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def execute(cell, seed: int, *, seconds=None, steps=None, trace: bool = False, device="cuda",
            started: float | None = None) -> dict:
    """Set up, measure, free and check one run; the result's line as a dict."""
    import torch

    started = time.time() if started is None else started
    on_card = torch.device(device).type == "cuda"
    job = cell.job_module().Job(cell, seed, device)
    entered = time.time()
    job.setup()
    setup_s = time.time() - started
    _log(f"set-up {setup_s:.3f} s: {entered - started:.3f} s to the harness (interpreter, "
         f"imports), {setup_s - (entered - started):.3f} s in the job's (CUDA, weights, model, "
         f"warm steps)")
    counters = launch_counters() if on_card else []
    for fn, attr in counters:
        setattr(fn, attr, 0)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        from torch.profiler import ProfilerActivity, record_function
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with torch.profiler.profile(activities=activities) as prof:
            w, e2e, failed = job.window(seconds=seconds, steps=steps,
                                        span=record_function(profile.WINDOW))
    else:
        w, e2e, failed = job.window(seconds=seconds, steps=steps)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    launches = {f"{fn.__name__}.{a}": getattr(fn, a) for fn, a in counters if getattr(fn, a)}
    _log(f"window: {w.steps} steps in {w.seconds:.6f} s ({w.dispatched} dispatched); kernel "
         f"launches a dispatched step: "
         f"{ {k: v / w.dispatched for k, v in sorted(launches.items())} }")
    gaps = [round((b - a) * 1e3, 3) for a, b in zip((0.0,) + w.ends, w.ends)]
    _log(f"host ms between step ends: first {gaps[:4]}, last {gaps[-4:]}")
    if trace:
        tr = profile.reduce(profile.events_of(prof))
        del prof
    job.release()
    e2e.update(setup_s=setup_s, peak_mem_gib=peak / GIB)
    if trace:
        metrics = per_layer(cell, tr, w.steps, job.training)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    t0 = time.time()
    from benchmark import compare
    readings = job.check()
    correct, checks = compare.verdict(readings["program"], cell.limits)
    _log(f"reference check: {time.time() - t0:.1f} s; not compared: {readings.get('info', {})}")
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": w.steps, "failed": failed, "metrics": metrics,
              "device": dev}
    if trace:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps}
    result["checks"] = checks
    return result


def per_layer(cell, tr, steps: int, training: bool) -> dict:
    """Each per-layer metric of the cell its reader finds something for."""
    from types import SimpleNamespace

    m, g = cell.model, cell.geometry
    ref = cell.reference()
    ctx = SimpleNamespace(trace=tr, steps=steps, training=training,
                          pv=roofline.pv_type(cell.traffic["attention"]),
                          linears=ref.linears(m, g.batch, g.text_tokens, g.video_tokens),
                          attentions=ref.attentions(m, g.batch, g.text_tokens, g.video_tokens))
    out = {}
    for metric in cell.per_layer:
        value = cells.metric_reader(metric["name"])(ctx)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def card_note() -> str:
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
        return q.stdout.strip() or q.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: not measuring")
        return 2
    cache_dirs(cells.ROOT)
    result = execute(cell, args.seed, seconds=args.seconds, trace=bool(args.trace),
                     started=started)
    _log(f"peaks (H100 SXM data sheet): bf16 989 TFLOP/s, int8 / e4m3 1979 T/s, 3.35 TB/s; "
         f"card: {card_note()}")
    found = forbidden_modules()
    if found:
        _log(f"loaded after the window: {found}; the benchmark runs the port without JAX")
        return 3
    for name, c in result["checks"].items():
        _log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
