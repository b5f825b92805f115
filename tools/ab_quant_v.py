#!/usr/bin/env python3
"""A/B of kernel 6's first pass (``quant_v_stats`` in ``csrc/quant_v.cu``):
this tree against another.

    mkdir -p scratch/other && git archive <rev> | tar -x -C scratch/other
    python3 tools/ab_quant_v.py scratch/other

Builds ``sageattention_tpu_torch/csrc/quant_v.cu`` of both trees, each
with its own ``ops/_build.py``, and feeds both the same bf16 V at the
Wan2.1-T2V-1.3B layer shape (1, 12, 33,272, 128) and at (1, 8, 16,384, d)
for d 64, 128, 256, 384 and 512, in blocks of 512 rows as
``quant_cuda.v_channel_stats`` launches it.  For each it says whether the
blocks' max and min are bit-identical between the trees and with a plain
PyTorch reduction, how far the sums are apart (relative; the order of the
fp32 additions may differ), and times each tree with CUDA events in the
order other, this, this, other (each the median of 20 samples of 10 calls
back to back, after 3 warm-up calls) beside the byte bound (V read once, the three [bh, blocks, d] fp32
results written once, at 3.35e12 bytes a second).  Prints the registers
of both libraries' instances.  Needs one CUDA card; ends with one JSON
line, and exits 1 if a max or min differs or a sum is more than 1e-5
relative from the plain one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
PEAK_BYTES_S = 3.35e12
BLOCK_ROWS = 512  # quant_cuda.V_BLOCK_ROWS
SHAPES = {"wan2.1 layer": (1, 12, 33272, 128),
          **{f"d{d}": (1, 8, 16384, d) for d in (64, 128, 256, 384, 512)}}


def load_build(tree: pathlib.Path, name: str):
    """``ops/_build.py`` of ``tree`` as a module of its own."""
    path = tree / "sageattention_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def registers(build) -> list[str]:
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-res-usage", str(build._target("quant_v"))],
                         capture_output=True, text=True, timeout=120).stdout
    rows, fn = [], None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+)", line)
        if m and fn:
            rows.append(f"{fn[-60:]}: {m.group(1)} registers, {m.group(2)} bytes of stack")
    return rows


def stats(build, v, parts=None):
    """The blocks' (max, min, sum), each fp32 [bh, blocks, d], from one
    launch (into ``parts`` where given)."""
    import torch

    b, h, s, d = v.shape
    n = -(-s // BLOCK_ROWS)
    parts = parts or [torch.empty(b * h, n, d, device="cuda") for _ in range(3)]
    err = build.lib("quant_v").quant_v_stats(
        v.data_ptr(), *(x.data_ptr() for x in parts), b * h, s, d, BLOCK_ROWS, 1,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"quant_v_stats launch failed: cudaError {err}")
    return parts


def plain(v):
    """The same blocks' statistics in PyTorch (the sum in fp64)."""
    import torch
    import torch.nn.functional as F

    b, h, s, d = v.shape
    n = -(-s // BLOCK_ROWS)
    x = F.pad(v.float().reshape(b * h, s, d), (0, 0, 0, n * BLOCK_ROWS - s), value=float("nan"))
    x = x.reshape(b * h, n, BLOCK_ROWS, d)
    live = ~torch.isnan(x)
    mx = torch.where(live, x, float("-inf")).amax(2)
    mn = torch.where(live, x, float("inf")).amin(2)
    sm = torch.where(live, x, 0.0).double().sum(2)
    return mx, mn, sm


def time_ms(fn, inner: int = 10) -> float:
    """Median over 20 samples of the mean of ``inner`` back-to-back calls,
    after 3 warm-up calls, so the launches queue ahead of the card."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z) / inner)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, help="the other tree's root")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    builds = {"other": load_build(args.other.resolve(), "build_other"),
              "this": load_build(ROOT, "build_this")}
    with ThreadPoolExecutor(2) as pool:  # one nvcc a tree, at once
        list(pool.map(lambda b: b.lib("quant_v"), builds.values()))
    for tree, build in builds.items():
        for row in registers(build):
            print(f"resources ({tree}) quant_v {row}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    out, ok = {}, True
    for name, shape in SHAPES.items():
        v = (torch.randn(*shape, generator=gen, device="cuda") * 2 + 0.3).to(torch.bfloat16)
        res = {t: stats(b, v) for t, b in builds.items()}
        p_mx, p_mn, p_sm = plain(v)
        torch.cuda.synchronize()
        same = {t: bool(torch.equal(r[0], p_mx) and torch.equal(r[1], p_mn))
                for t, r in res.items()}
        rel = {t: ((r[2].double() - p_sm).abs() / (p_sm.abs() + 1e-3)).max().item()
               for t, r in res.items()}
        sums_equal = bool(torch.equal(res["this"][2], res["other"][2]))
        ms = {"other": [], "this": []}
        for t in ("other", "this", "this", "other"):
            ms[t].append(time_ms(lambda t=t: stats(builds[t], v, res[t])))
        ms = {t: statistics.mean(x) for t, x in ms.items()}
        n = -(-shape[2] // BLOCK_ROWS)
        moved = v.numel() * 2 + 3 * shape[0] * shape[1] * n * shape[3] * 4
        bound = moved / PEAK_BYTES_S * 1e3
        ok = ok and all(same.values()) and max(rel.values()) <= 1e-5
        out[name] = {"shape": list(shape), "max_min_plain_exact": same, "sum_rel_to_plain": rel,
                     "sums_bit_identical_between_trees": sums_equal, "ms": ms,
                     "bound_ms": bound, "this_over_other": ms["this"] / ms["other"]}
        print(f"quant_v_stats {name} {shape}: max/min vs plain exact {same}; sums vs plain "
              f"(rel) {rel}; sums identical between trees {sums_equal}; ms other "
              f"{ms['other']:.4f}, this {ms['this']:.4f} (ratio {ms['this'] / ms['other']:.3f});"
              f" bound {bound:.4f} ms (bytes)", flush=True)
        del v, res, p_mx, p_mn, p_sm
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    print(json.dumps({"ok": ok, "quant_v_stats": out}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
