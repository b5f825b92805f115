#!/usr/bin/env python3
"""A/B of the V quantizers of ``csrc/quant_v.cu``, kernel 5
(``quant_v_per_channel``) and kernel 6's first pass (``quant_v_stats``):
this tree against another, through both trees' C entry points.

    mkdir -p scratch/other && git archive <rev> | tar -x -C scratch/other
    python3 tools/ab_quant_v.py scratch/other

Builds ``sageattention_tpu_torch/csrc/quant_v.cu`` of both trees (this
one into ``build/``, the other with its own ``ops/_build.py`` into its own
``build/``).  Kernel 5: the CogVideoX-2B layer (1, 30, 17,776, 64) bf16
with e4m3, int8 and e5m2 codes, smooth-v off and on, (1, 16, 4096, d) for
d 64-512 (int8), fp32 V at d 128 and 512, and slabs of exactly 4 MB (the
largest kernel 5 takes); a tree whose entry point takes kernel 5's plan
gets this tree's (``quant_cuda.quant_v_plan``), an older one (without a
plan argument) its own arguments; this tree is also timed on the best
plan of the other kind than its own (``alt``: the column split where it
takes clusters, else the best cluster size; ``quant_v_device_plan`` with
``cls`` narrowed), and with ``--variants`` on
every cluster size, with all the rows it can staged and with half as
many, at a few cases.  Without smooth-v the codes and scales must be bit-identical
between the trees and with the plain version; with it, it says how far
each tree's mean is from the plain one, whether this tree's codes and
scales are bit-exact given its own mean, and whether its mean is the sum
in its plan's order over s (``quant_cuda.v_partition_mean``) bit for
bit.  The
clusters the card holds at once (``cudaOccupancyMaxActiveClusters``) at
16 and 8 CTAs are printed for each head dim.  Kernel 6's first pass: bf16
V at the Wan2.1-T2V-1.3B layer shape (1, 12, 33,272, 128) and at (1, 8,
16,384, d) for d 64-512, in blocks of 512 rows as
``quant_cuda.v_channel_stats`` launches it: whether the blocks' max and
min are bit-identical between the trees and with a plain PyTorch
reduction, and how far the sums are apart (relative; the order of the
fp32 additions may differ).  Each case is timed with CUDA events in the
order other, this, this, other (kernel 5: other, this, alt, this, other;
each the median of 20 samples of 10 calls
back to back, queued behind a 1 ms sleep on the card, after 3 warm-up
calls; kernel 5's trees all write the same output tensors, as its time
moves with where they lie), kernel 5 also by ``torch.profiler``'s kernel times, beside its
byte bound (V read once,
the results written once, at 3.35e12 bytes a second).  Prints the
registers and stack of both libraries' instances.  Needs one CUDA card;
ends with one JSON line, and exits 1 if a kernel 5 code or scale differs
where the arithmetic is fixed (without smooth-v; with it, given this
tree's mean), a kernel 6 max or min differs, or a kernel 6 sum is more
than 1e-5 relative from the plain one.
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
sys.path.insert(0, str(ROOT))

from sageattention_tpu_torch.utils.timing import queued_ms  # noqa: E402

PEAK_BYTES_S = 3.35e12
BLOCK_ROWS = 512  # quant_cuda.V_BLOCK_ROWS
SHAPES = {"wan2.1 layer": (1, 12, 33272, 128),
          **{f"d{d}": (1, 8, 16384, d) for d in (64, 128, 256, 384, 512)}}
COG = (1, 30, 17776, 64)
# kernel 5: name -> (shape, fp32 V, code, smooth-v)
K5_CASES = {**{f"cogvideox layer {c}{' smooth' if sm else ''}": (COG, False, c, sm)
               for c in ("e4m3", "int8", "e5m2") for sm in (False, True)},
            **{f"d{d}": ((1, 16, 4096, d), False, "int8", False) for d in (64, 128, 256, 384, 512)},
            "d512 smooth": ((1, 16, 4096, 512), False, "int8", True),
            "d128 fp32": ((1, 16, 4096, 128), True, "int8", False),
            "d512 fp32 smooth": ((1, 8, 1500, 512), True, "e4m3", True),
            "4 MB slabs d64": ((1, 16, 32768, 64), False, "e4m3", False),
            "4 MB slabs d512 fp32": ((1, 16, 2048, 512), True, "int8", False)}


def load_build(tree: pathlib.Path, name: str):
    """``ops/_build.py`` of ``tree`` as a module of its own."""
    path = tree / "sageattention_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def registers(build, lib: str = "quant_v") -> list[str]:
    """Registers and stack bytes of each kernel of ``lib`` as ``build`` built it."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-res-usage", str(build._target(lib))],
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


def device_ms(fn, kernel: str, calls: int = 20) -> float:
    """The mean device time of the kernels whose name holds ``kernel`` over
    ``calls`` calls of ``fn``, as ``torch.profiler`` records them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    return sum(spans) / len(spans) / 1e3 if spans else float("nan")


# the cases --variants times this tree on every cluster size, each with all
# the rows it can staged and with half as many
K5_VARIANT_CASES = ("cogvideox layer e4m3", "d64", "d128", "d128 fp32")


def plan_variants(qc, call, v, dtype, want, smooth) -> dict:
    """This tree's kernel 5 on other plans than its own, each bit-identical
    with its own plan's codes and scales (without smooth-v)."""
    import torch

    fn, a = call
    b, h, s, d = v.shape
    out = {}
    for cl in (1, 2, 4, 8, 16):
        base = qc.quant_v_device_plan(v, cls=(cl,))
        for vname, vp in ((f"cl {cl}", base),
                          (f"cl {cl} half staged", base._replace(stage_rows=base.stage_rows // 2))):
            room = qc.v_cluster_room(v.device, cl, qc.v_smem_bytes(vp.stage_rows, d,
                                                                   v.element_size()),
                                     v.dtype == torch.bfloat16)
            vp = vp._replace(clusters=max(1, min(b * h, room)))
            o, sc = torch.empty_like(want[0]), torch.empty_like(want[1])
            va = (a[0], o.data_ptr(), sc.data_ptr()) + a[3:10] + tuple(vp) + a[-1:]
            err = fn(*va)
            if err:
                raise RuntimeError(f"quant_v_per_channel variant {vname} {tuple(vp)}: {err}")
            torch.cuda.synchronize()
            exact = smooth or bool(torch.equal(o.view(torch.uint8), want[0].view(torch.uint8))
                                   and torch.equal(sc, want[1]))
            ms = queued_ms(lambda va=va: fn(*va))
            out[vname] = {"plan": vp._asdict(), "bit_exact": exact, "ms": ms}
            print(f"  variant {vname} {tuple(vp)}: bit-exact {exact}; ms {ms:.4f}", flush=True)
    return out


def kernel5(builds, gen, variants: bool = False) -> tuple[dict, bool]:
    """Kernel 5's cases (``K5_CASES``), this tree against the other."""
    import torch
    from sageattention_tpu_torch.ops import quant_cuda as qc

    other = builds["other"]
    old_form = len(other.SIGNATURES["quant_v"]["quant_v_per_channel"]) == 11
    dev = torch.device("cuda", 0)
    for d in (64, 128, 256, 384, 512):
        smem = qc.v_smem_bytes(qc.V_STAGE_BYTES // (d * 2), d, 2)
        room = {cl: qc.v_cluster_room(dev, cl, smem, True) for cl in (16, 8)}
        print(f"quant_v_per_channel d{d} bf16: clusters of 16 / 8 CTAs at once {room} with "
              f"{smem} B of shared memory a CTA", flush=True)

    def entry(tree, v, o, sc, m):
        a = qc.quant_v_args(v, o, sc, m)
        fn = builds["this"].lib("quant_v").quant_v_per_channel
        if tree == "this":
            return fn, a
        if tree == "alt":  # this tree on the best plan of the other kind
            cls = (0,) if qc.quant_v_device_plan(v).cl else qc.V_PLAN_SIZES[1:]
            return fn, a[:10] + tuple(qc.quant_v_device_plan(v, cls=cls)) + a[-1:]
        return other.lib("quant_v").quant_v_per_channel, (a[:10] + a[-1:] if old_form else a)

    def same(a, b):
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    out, ok = {}, True
    for name, (shape, f32, code, smooth) in K5_CASES.items():
        b, h, s, d = shape
        dtype = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}[code]
        v = (torch.randn(*shape, generator=gen, device="cuda")
             + torch.randn(b, h, 1, d, generator=gen, device="cuda") * 3)
        v = v if f32 else v.to(torch.bfloat16)
        # every tree writes the same outputs: the time moves with where they lie
        o = torch.empty(shape, dtype=dtype, device="cuda")
        sc = torch.empty(b, h, d, device="cuda")
        m = torch.empty(b, h, d, device="cuda") if smooth else None
        res, calls = {}, {}
        for tree in ("other", "this", "alt"):
            fn, a = entry(tree, v, o, sc, m)
            calls[tree] = (fn, a)
            err = fn(*a)
            if err:
                raise RuntimeError(f"{tree} quant_v_per_channel {name}: cudaError {err}")
            res[tree] = tuple(x.clone() if x is not None else None for x in (o, sc, m))
        q_p, sc_p, m_p = qc.quant_v_per_channel_plain(v, dtype=dtype, smooth=smooth)
        torch.cuda.synchronize()
        row = {"shape": list(shape), "fp32": f32, "code": code, "smooth": smooth}
        if not smooth:
            exact = {t: same(o, q_p) and torch.equal(sc, sc_p) for t, (o, sc, _) in res.items()}
            ok = ok and all(exact.values())
            row["bit_exact_with_plain"] = exact
            what = f"bit-exact with plain {exact}"
        else:
            rel = {t: ((m - m_p).abs() / (m_p.abs() + 1e-3)).max().item()
                   for t, (_, _, m) in res.items()}
            o, sc, m = res["this"]
            q_m, sc_m, _ = qc.quant_v_per_channel_plain(v.float() - m[..., None, :], dtype=dtype,
                                                         smooth=False)
            given = same(o, q_m) and torch.equal(sc, sc_m)
            ordered = bool(torch.equal(m, qc.v_partition_mean(v, qc.quant_v_device_plan(v))))
            ok = ok and given and max(rel.values()) <= 1e-5
            row.update(mean_rel_to_plain=rel, bit_exact_given_mean=given,
                       mean_is_plan_order_sum=ordered)
            what = (f"mean vs plain (rel) {rel}; this bit-exact given its mean {given}; its "
                    f"mean the plan-order sum bit for bit {ordered}")
        ms = {"other": [], "this": [], "alt": []}
        for t in ("other", "this", "alt", "this", "other"):
            fn, a = calls[t]
            ms[t].append(queued_ms(lambda fn=fn, a=a: fn(*a)))
        ms = {t: statistics.mean(x) for t, x in ms.items()}
        dev = {t: device_ms(lambda fn=fn, a=a: fn(*a), "quant_v_")
               for t, (fn, a) in calls.items()}
        row["device_ms"] = dev
        moved = v.numel() * v.element_size() + v.numel() + b * h * d * 4 * (2 if smooth else 1)
        bound = moved / PEAK_BYTES_S * 1e3
        plan = qc.quant_v_device_plan(v)
        if variants and name in K5_VARIANT_CASES:
            row["variants"] = plan_variants(qc, calls["this"], v, dtype, res["this"], smooth)
            ok = ok and all(x["bit_exact"] for x in row["variants"].values())
        ratio = ms["this"] / ms["other"]
        row.update(ms=ms, this_over_other=ratio, bound_ms=bound, plan=plan._asdict())
        out[name] = row
        print(f"quant_v_per_channel {name} {shape} {'fp32' if f32 else 'bf16'} {code}: {what}; "
              f"ms other {ms['other']:.4f}, this {ms['this']:.4f} (ratio {ratio:.3f}"
              f"{', SLOWER' if ratio > 1.02 else ''}), this on the other kind of plan "
              f"{ms['alt']:.4f}; device (profiler) other {dev['other']:.4f}, this "
              f"{dev['this']:.4f}, alt {dev['alt']:.4f}; bound {bound:.4f} ms (bytes); plan "
              f"{tuple(plan)}", flush=True)
        del v, res, calls, q_p, sc_p, m_p
        torch.cuda.empty_cache()
    return out, ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, help="the other tree's root")
    ap.add_argument("--variants", action="store_true",
                    help="also time kernel 5 on every cluster size at "
                    + ", ".join(K5_VARIANT_CASES))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from sageattention_tpu_torch.ops import _build

    builds = {"other": load_build(args.other.resolve(), "build_other"), "this": _build}
    with ThreadPoolExecutor(2) as pool:  # one nvcc a tree, at once
        list(pool.map(lambda b: b.lib("quant_v"), builds.values()))
    for tree, build in builds.items():
        for row in registers(build):
            print(f"resources ({tree}) quant_v {row}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    k5, ok = kernel5(builds, gen, args.variants)
    out = {}
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
            ms[t].append(queued_ms(lambda t=t: stats(builds[t], v, res[t])))
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
    print(json.dumps({"ok": ok, "quant_v_per_channel": k5, "quant_v_stats": out}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
