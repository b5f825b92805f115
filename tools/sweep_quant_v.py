#!/usr/bin/env python3
"""Kernel 5's plans (``quant_v_per_channel`` in ``csrc/quant_v.cu``) timed
on the card, and the fit of ``quant_cuda.quant_v_plan``'s time model.

    python3 tools/sweep_quant_v.py --out chiprun_out/sweep_a.json [--seed 7]
    python3 tools/sweep_quant_v.py --fit chiprun_out/sweep_a.json [chiprun_out/sweep_b.json]

On a CUDA card: for V [bh, s, d] at ``shapes()`` (bf16 and fp32; d
64-512; slabs of 1/16, 1/4, 0.57 (the CogVideoX-2B slab's share) and all
of the 4 MB that kernel 5 takes, all but the last a few rows short of a
round length; bh 2, 4, 8, 16, 30, 48 and 64), each candidate of
``quant_cuda.V_PLAN_SIZES`` as ``quant_v_device_plan(v, cls=(cl,))``
makes it with the card's room for clusters (recorded beside it, and the
room with one CTA an SM), through the C entry point
with int8 codes and no smooth-v: its codes and scales must equal the
plain version's, and it is timed with V hot in L2 where it fits
(``utils.timing.queued_ms``) and cold (``utils.timing.cold_ms``, the L2
flushed before each call).  Writes every time to ``--out`` and prints a
line a shape; exits 1 if a candidate's codes or scales differ.

``--fit FILE [FILE ...]`` (no card needed): the coefficients of
``V_COLUMN_US`` and ``V_CLUSTER_US`` that make ``quant_cuda.v_plan_us``
closest to the first file's queued times (least squares on the relative
error, coefficients at least 0), and, for the fitted and for the shipped
coefficients, on each file, how much slower than the fastest candidate
measured each shape's pick (as ``quant_v_plan`` makes it, with
``V_CLUSTER_MARGIN``) is, hot and cold (the mean, the largest, the
shapes more than 5 % slower) and at how many shapes the pick is more than
2 % slower than the column split.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sageattention_tpu_torch.ops import quant_cuda as qc  # noqa: E402

FRACTIONS = (1 / 16, 1 / 4, 0.57, 1.0)
HEADS = (2, 4, 8, 16, 30, 48, 64)


def shapes() -> list[tuple[int, int, int, int]]:
    """(bh, s, d, itemsize) of the sweep."""
    out = []
    for isz in (2, 4):
        for d in qc.HEAD_DIMS:
            top = qc.V_SINGLE_PASS_BYTES // (d * isz)
            for f in FRACTIONS:
                s = top if f == 1.0 else int(top * f) - 3
                out += [(bh, s, d, isz) for bh in HEADS]
    return out


def sweep(out_path: pathlib.Path, seed: int) -> int:
    import torch
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.utils.timing import cold_ms, queued_ms

    lib = _build.lib("quant_v")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows, ok = [], True
    for bh, s, d, isz in shapes():
        dt = torch.bfloat16 if isz == 2 else torch.float32
        v = (torch.randn(1, bh, s, d, generator=gen, device="cuda")
             + torch.randn(1, bh, 1, d, generator=gen, device="cuda") * 3).to(dt)
        q_p, sc_p, _ = qc.quant_v_per_channel_plain(v, dtype=torch.int8, smooth=False)
        o = torch.empty_like(q_p)
        sc = torch.empty_like(sc_p)
        a = qc.quant_v_args(v, o, sc, None)
        row = {"bh": bh, "s": s, "d": d, "itemsize": isz,
               "plan": list(qc.quant_v_device_plan(v)), "candidates": []}
        for cl in qc.V_PLAN_SIZES:
            try:
                plan = qc.quant_v_device_plan(v, cls=(cl,))
            except ValueError:  # the card cannot place such a cluster
                continue
            args = a[:10] + tuple(plan) + a[-1:]
            o.zero_()
            err = lib.quant_v_per_channel(*args)
            if err:
                raise RuntimeError(f"quant_v_per_channel {tuple(plan)}: cudaError {err}")
            torch.cuda.synchronize()
            exact = bool(torch.equal(o, q_p) and torch.equal(sc, sc_p))
            ok = ok and exact
            hot = queued_ms(lambda: lib.quant_v_per_channel(*args))
            cold = cold_ms(lambda: lib.quant_v_per_channel(*args))
            room1 = None if cl == 0 else qc.v_cluster_room(
                v.device, cl, qc.v_smem_bytes(qc.V_STAGE_BYTES // (d * isz), d, isz), isz == 2)
            row["candidates"].append({"plan": list(plan), "room1": room1, "bit_exact": exact,
                                      "hot_ms": hot, "cold_ms": cold})
        best = min(row["candidates"], key=lambda c: c["hot_ms"])
        print(f"sweep bh {bh} s {s} d {d} {'bf16' if isz == 2 else 'fp32'}: plan "
              f"{tuple(row['plan'])}; hot ms " + ", ".join(
                  f"cl {c['plan'][0]} {c['hot_ms']:.4f}" for c in row["candidates"])
              + "; cold ms " + ", ".join(f"{c['cold_ms']:.4f}" for c in row["candidates"])
              + f"; fastest hot cl {best['plan'][0]}", flush=True)
        rows.append(row)
        del v, q_p, sc_p, o, sc
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({"card": card, "torch": torch.__version__, "seed": seed,
                                    "shapes": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": ok, "shapes": len(rows), "out": str(out_path)}))
    return 0 if ok else 1


def _us(coef, r, c) -> float:
    return qc.v_plan_us(qc.VPlan(*c["plan"]), r["bh"], r["s"], r["d"], r["itemsize"],
                        room1=c["room1"], coef=coef)


def fit(paths: list[pathlib.Path]) -> int:
    import numpy as np
    from scipy.optimize import least_squares

    runs = [json.loads(p.read_text()) for p in paths]
    times = [(r, c) for r in runs[0]["shapes"] for c in r["candidates"]]
    shipped = (qc.V_COLUMN_US, qc.V_CLUSTER_US)
    fitted = list(shipped)
    for i, kind in enumerate(("column", "cluster")):
        mine = [(r, c) for r, c in times if (c["plan"][0] == 0) == (i == 0)]
        t = np.array([c["hot_ms"] * 1e3 for _, c in mine])

        def resid(x, mine=mine, t=t, i=i):
            coef = tuple(x) if i == 0 else fitted[0], tuple(x) if i == 1 else fitted[1]
            return np.array([_us(coef, r, c) for r, c in mine]) / t - 1

        res = least_squares(resid, np.array(shipped[i]), bounds=(0, np.inf))
        fitted[i] = tuple(float(f"{x:.4g}") for x in res.x)
        rel = np.abs(resid(res.x))
        print(f"{kind}: coefficients {fitted[i]} over {len(t)} times; relative error median "
              f"{np.median(rel):.3f}, largest {rel.max():.3f}")
    report = {"fitted": {"column": fitted[0], "cluster": fitted[1]}}
    for name, coef in (("fitted", tuple(fitted)), ("shipped", shipped)):
        for path, run in zip(paths, runs):
            for when in ("hot_ms", "cold_ms"):
                slow, vs_col, worst = [], [], []
                for r in run["shapes"]:
                    pick = min(r["candidates"], key=lambda c: (
                        _us(coef, r, c) * (qc.V_CLUSTER_MARGIN if c["plan"][0] else 1),
                        c["plan"][0]))
                    col = next(c for c in r["candidates"] if c["plan"][0] == 0)
                    x = pick[when] / min(c[when] for c in r["candidates"])
                    slow.append(x)
                    vs_col.append(pick[when] / col[when])
                    if x > 1.05:
                        worst.append((r["bh"], r["s"], r["d"], r["itemsize"], pick["plan"][0],
                                      round(x, 3)))
                slow, vs_col = np.asarray(slow), np.asarray(vs_col)
                key = f"{name} {path.name} {when}"
                report[key] = {"mean": float(slow.mean()), "largest": float(slow.max()),
                               "over_5pct": worst, "over_column_2pct": int((vs_col > 1.02).sum()),
                               "largest_over_column": float(vs_col.max())}
                print(f"{key}: the pick over the fastest candidate, mean {slow.mean():.4f}, "
                      f"largest {slow.max():.3f}, over 1.05 at {len(worst)} of {len(slow)} "
                      f"shapes; over the column split by more than 2 % at "
                      f"{int((vs_col > 1.02).sum())} (largest {vs_col.max():.3f}); over 1.05 at "
                      f"(bh, s, d, itemsize, cl, ratio) {worst}")
        print(f"card: {runs[0]['card']}")
    print(json.dumps(report))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=pathlib.Path, default=ROOT / "chiprun_out" / "sweep_quant_v.json")
    ap.add_argument("--seed", type=int, default=7, help="the seed of V")
    ap.add_argument("--fit", type=pathlib.Path, nargs="+",
                    help="fit the time model to the first sweep's file; judge it on each")
    args = ap.parse_args()
    if args.fit:
        return fit(args.fit)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    return sweep(args.out, args.seed)


if __name__ == "__main__":
    sys.exit(main())
