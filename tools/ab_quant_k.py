#!/usr/bin/env python3
"""A/B of kernel 3 (``quant_k_chunked`` in ``csrc/quant_k.cu``): this tree
against another, through both trees' C entry points.

    mkdir -p scratch/other && git archive <rev> | tar -x -C scratch/other
    python3 tools/ab_quant_k.py scratch/other

Builds ``sageattention_tpu_torch/csrc/quant_k.cu`` of both trees (this
one into ``build/``, the other with its own ``ops/_build.py`` into its own
``build/``) and feeds both the same K and km at the CogVideoX-2B layer
(1, 30, 17,776, 64) (bf16 with km at 8 and 4 bits, without km, fp32), at
(4, 16, 4096, d) for d 64-512 (bf16; fp32 at 128 and 512) and ragged at
(4, 16, 4001, d) for d 384 and 512 at 4 bits.  A tree whose entry point
takes kernel 3's plan gets this tree's plan (``quant_cuda.quant_k_plan``);
an older one (without a plan argument) its own arguments.  For each case it
says whether the codes and scales are bit-identical between the trees and
with the plain version (``quant_cuda.quant_k_chunked_plain``), and times
each tree with CUDA events in the order other, this, this, other (each the
median of 20 samples of 10 calls back to back, queued behind a 1 ms sleep
on the card, after 3 warm-up calls) and by ``torch.profiler``'s kernel
times, beside the byte bound (K read once, the codes, km and scales once, at
3.35e12 B/s) and the floor at the card's measured copy rate (2.868e12 B/s,
PERF.md "Measured rates").  Prints this tree's plan for each case and
the registers and stack of both libraries' instances; with
``--variants``, also this tree's time on other plans (the ring where the
plan holds the tile in registers; else one tile a CTA, one CTA an SM with
a deep ring, two CTAs an SM, units of half the rows) at a few cases, each
held bit-exact too.  Needs one CUDA
card; ends with one JSON line, and exits 1 if a code or scale differs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from ab_quant_v import device_ms, load_build, registers  # noqa: E402

from sageattention_tpu_torch.utils.timing import queued_ms  # noqa: E402

PEAK_BYTES_S = 3.35e12
COPY_BYTES_S = 2.868e12
COG = (1, 30, 17776, 64)
# name: (shape, fp32 K, bits, with km)
CASES = {"cogvideox layer": (COG, False, 8, True),
         "cogvideox layer 4 bits": (COG, False, 4, True),
         "cogvideox layer no smoothing": (COG, False, 8, False),
         "cogvideox layer fp32": (COG, True, 8, True),
         **{f"d{d}": ((4, 16, 4096, d), False, 8, True) for d in (64, 128, 256, 384, 512)},
         **{f"d{d} fp32": ((4, 16, 4096, d), True, 8, True) for d in (128, 512)},
         **{f"d{d} ragged 4 bits": ((4, 16, 4001, d), False, 4, True) for d in (384, 512)}}


# the cases --variants times this tree on other plans than its own
VARIANT_CASES = ("cogvideox layer", "d128", "d512", "d512 fp32")


def variant_plans(qc, plan, n_tiles: int, sms: int, unit_bytes: int) -> dict:
    """Other plans for kernel 3 than ``plan``, each still valid.  For a
    tile in registers: the ring with one tile a CTA, and a ring of three
    with four CTAs an SM.  For the ring: one tile a CTA (a ring of just its
    units), one CTA an SM with a deep ring, two CTAs an SM, and units of
    half the rows."""
    if plan.stages == 0:
        return {"ring, one tile a CTA": plan._replace(stages=1),
                "ring of three, four CTAs an SM": plan._replace(stages=3,
                                                                grid=min(n_tiles, 4 * sms))}
    upt = plan.staged_rows // plan.unit_rows
    out = {"one tile a CTA": plan._replace(stages=max(upt, 1), grid=n_tiles),
           "one CTA an SM": plan._replace(
               stages=min(qc.K_MAX_STAGES, qc.K_RING_BYTES // unit_bytes), grid=sms)}
    two = min(qc.K_MAX_STAGES, qc.K_RING_BYTES // 2 // unit_bytes)
    if two >= upt + 1:
        out["two CTAs an SM"] = plan._replace(stages=two, grid=min(n_tiles, 2 * sms))
    if plan.unit_rows >= 16 and 2 * plan.stages <= qc.K_MAX_STAGES:
        out["half units"] = plan._replace(unit_rows=plan.unit_rows // 2, stages=2 * plan.stages)
    return out


def variants(qc, build, k, km, bits, plan, ki_p, ks_p) -> dict:
    """This tree's kernel 3 on ``variant_plans``: bit-exact with the plain
    version, and its time and device time."""
    import torch

    b, h, s, d = k.shape
    out, sc = torch.empty_like(ki_p), torch.empty_like(ks_p)
    a = qc.quant_k_args(k, km, out, sc, group=128, bits=bits)
    fn = build.lib("quant_k").quant_k_chunked
    n_tiles = b * h * -(-s // 128)
    rows = {}
    for vname, vp in variant_plans(qc, plan, n_tiles, qc._sm_count(k.device),
                                   plan.unit_rows * d * k.element_size()).items():
        va = a[:11] + tuple(vp) + a[-1:]
        out.zero_()
        err = fn(*va)
        if err:
            raise RuntimeError(f"quant_k_chunked variant {vname} {tuple(vp)}: cudaError {err}")
        torch.cuda.synchronize()
        exact = bool(torch.equal(out, ki_p) and torch.equal(sc, ks_p))
        ms = queued_ms(lambda va=va: fn(*va))
        dev = device_ms(lambda va=va: fn(*va), "quant_k_")
        rows[vname] = {"plan": vp._asdict(), "bit_exact": exact, "ms": ms, "device_ms": dev}
        print(f"  variant {vname} {tuple(vp)}: bit-exact {exact}; ms {ms:.4f}, device {dev:.4f}",
              flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, help="the other tree's root")
    ap.add_argument("--variants", action="store_true",
                    help="also time this tree on other plans at " + ", ".join(VARIANT_CASES))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import quant_cuda as qc

    other = load_build(args.other.resolve(), "build_other")
    builds = {"other": other, "this": _build}
    with ThreadPoolExecutor(2) as pool:  # one nvcc a tree, at once
        list(pool.map(lambda b: b.lib("quant_k"), builds.values()))
    for tree, build in builds.items():
        for row in registers(build, "quant_k"):
            print(f"resources ({tree}) quant_k {row}", flush=True)
    old_form = len(other.SIGNATURES["quant_k"]["quant_k_chunked"]) == 12

    def entry(tree, k, km, out, sc, bits):
        a = qc.quant_k_args(k, km, out, sc, group=128, bits=bits)
        if tree == "this":
            return _build.lib("quant_k").quant_k_chunked, a
        fn = other.lib("quant_k").quant_k_chunked
        return fn, (a[:11] + a[-1:] if old_form else a)  # no plan argument

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    out, ok = {}, True
    for name, (shape, f32, bits, with_km) in CASES.items():
        b, h, s, d = shape
        k = (torch.randn(*shape, generator=gen, device="cuda")
             + torch.randn(b, h, 1, d, generator=gen, device="cuda") * 3)
        k = k if f32 else k.to(torch.bfloat16)
        km = qc.k_channel_mean_plain(k) if with_km else None
        res, calls = {}, {}
        for tree in builds:
            o = torch.empty(shape, dtype=torch.int8, device="cuda")
            sc = torch.empty(b, h, -(-s // 128), device="cuda")
            fn, a = entry(tree, k, km, o, sc, bits)
            calls[tree] = (fn, a)
            err = fn(*a)
            if err:
                raise RuntimeError(f"{tree} quant_k_chunked {name}: cudaError {err}")
            res[tree] = (o, sc)
        ki_p, ks_p = qc.quant_k_chunked_plain(k, km, group=128, bits=bits)
        torch.cuda.synchronize()
        same = {t: bool(torch.equal(o, ki_p) and torch.equal(sc, ks_p))
                for t, (o, sc) in res.items()}
        ms = {"other": [], "this": []}
        for t in ("other", "this", "this", "other"):
            fn, a = calls[t]
            ms[t].append(queued_ms(lambda fn=fn, a=a: fn(*a)))
        ms = {t: statistics.mean(x) for t, x in ms.items()}
        dev = {t: device_ms(lambda fn=fn, a=a: fn(*a), "quant_k_")
               for t, (fn, a) in calls.items()}
        moved = k.numel() * k.element_size() + k.numel() + b * h * (d + -(-s // 128)) * 4
        bound, floor = moved / PEAK_BYTES_S * 1e3, moved / COPY_BYTES_S * 1e3
        plan = qc.quant_k_plan(b * h, s, d, k.element_size(), 128, qc._sm_count(k.device))
        ok = ok and all(same.values())
        ratio = ms["this"] / ms["other"]
        out[name] = {"shape": list(shape), "fp32": f32, "bits": bits, "km": with_km,
                     "bit_exact_with_plain": same, "ms": ms, "device_ms": dev,
                     "this_over_other": ratio,
                     "bound_ms": bound, "copy_floor_ms": floor, "plan": plan._asdict()}
        print(f"quant_k_chunked {name} {shape} {'fp32' if f32 else 'bf16'} {bits} bits "
              f"{'km' if with_km else 'no km'}: bit-exact with plain {same}; ms other "
              f"{ms['other']:.4f}, this {ms['this']:.4f} (ratio {ratio:.3f}"
              f"{', SLOWER' if ratio > 1.02 else ''}); device (profiler) other "
              f"{dev['other']:.4f}, this {dev['this']:.4f}; bound {bound:.4f} ms, copy floor "
              f"{floor:.4f} ms; plan {tuple(plan)}", flush=True)
        if args.variants and name in VARIANT_CASES:
            out[name]["variants"] = variants(qc, _build, k, km, bits, plan, ki_p, ks_p)
            ok = ok and all(v["bit_exact"] for v in out[name]["variants"].values())
        del k, km, res, calls, ki_p, ks_p
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    print(json.dumps({"ok": ok, "quant_k_chunked": out}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
