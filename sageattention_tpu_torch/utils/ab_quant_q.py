"""A/B of kernel 4 (``quant_q_per_token``, ``csrc/quant_q.cu``): this tree
against another, through both trees' C entry points.

Run from the repository root on a card, with a checkout of the other
revision (``git archive REV | tar -x -C DIR``)::

    python -m sageattention_tpu_torch.utils.ab_quant_q DIR [--rows]

Builds ``sageattention_tpu_torch/csrc/quant_q.cu`` of both trees (this one
into ``build/``, the other with its own ``ops/_build.py`` into its own
``build/``, one ``nvcc`` a tree, at once) and prints the registers and stack
of both libraries' instances.  It feeds both the same Q, per-token and
without a mean (what every revision's kernel 4 computes), at the kernel
table's shapes: the CogVideoX-2B layer (1, 30, 17,776, 64) (bf16 at 8 and 4
bits, fp32), the Wan2.1 layer (1, 12, 33,272, 128), (1, 16, 4096, d) for d
64-512 (bf16; fp32 at 128 and 512) and ragged (2, 16, 4001, d) at 384 and
512 at 4 bits.  A tree whose entry point is ``quant_q_per_token`` (one row
a scale, no plan) gets its own arguments; one with ``quant_rows`` this
tree's, with this tree's plan.  For each case it says whether the codes and
scales are bit-identical between the trees and with the plain version
(``quant_cuda.quant_q_per_token_plain``), and times each tree with CUDA
events in the order other, this, this, other (each the median of 20
samples of 10 calls back to back, queued behind a 1 ms sleep on the card,
after 3 warm-up calls) and by ``torch.profiler``'s kernel times, beside the
byte bound (Q read once, the codes and scales written once, at 3.35e12
B/s) and the floor at the card's measured copy rate (2.868e12 B/s, PERF.md
"Measured rates").  With ``--rows`` it also times this tree alone at every
group and form of the Q/K options (``ab_common.rows_cases``: 1, 32 and 128
rows a scale; x, x less kernel 2's mean, that cast back) at the
CogVideoX-2B and Wan2.1 layers and, at 128 rows, (1, 16, 4096, d) for d
256-512 in bf16 and fp32, each held bit-exact with the plain version.
Needs one CUDA card; ends with one JSON line, and exits 1 if a code or
scale differs or this tree runs a case more than 3 % slower than the
other.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from sageattention_tpu_torch.utils import ab_common

PEAK_BYTES_S = 3.35e12
COPY_BYTES_S = 2.868e12
SLOWER = 1.03  # this tree over the other beyond which a case fails
LOG2E = 1.4426950408889634
COG = (1, 30, 17776, 64)
# name: (shape, fp32 Q, bits)
CASES = {"cogvideox layer": (COG, False, 8),
         "cogvideox layer 4 bits": (COG, False, 4),
         "cogvideox layer fp32": (COG, True, 8),
         "wan layer": ((1, 12, 33272, 128), False, 8),
         **{f"d{d}": ((1, 16, 4096, d), False, 8) for d in (64, 128, 256, 384, 512)},
         **{f"d{d} fp32": ((1, 16, 4096, d), True, 8) for d in (128, 512)},
         **{f"d{d} ragged 4 bits": ((2, 16, 4001, d), False, 4) for d in (384, 512)}}


def rows_times(gen) -> tuple[dict, bool]:
    """This tree's kernel 4 at every group and form (``--rows``), each held
    bit-exact with its plain version, and timed."""
    import torch
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import quant_cuda as qc
    from sageattention_tpu_torch.utils.timing import queued_ms

    lib = _build.lib("quant_q")
    out, ok = {}, True
    cases = [(COG, False), ((1, 12, 33272, 128), False)]
    cases += [((1, 16, 4096, d), f32) for d in (256, 384, 512) for f32 in (False, True)]
    for shape, f32 in cases:
        b, h, s, d = shape
        x = ab_common.offset_rows(gen, shape, "fp32" if f32 else "bf16")
        mean = qc.k_channel_mean(x)
        fold = d**-0.5 * LOG2E
        for group, form, m, c in ab_common.rows_cases(x, mean):
            if shape[-1] > 128 and group != 128:
                continue
            plan = qc.quant_q_plan(b * h, s, d, x.element_size(), group, mean=m is not None)
            kw = dict(scale_fold=fold, group=group, cast=c)
            o = torch.empty(shape, dtype=torch.int8, device="cuda")
            sc = torch.empty(shape[:3], device="cuda")
            args = qc.quant_q_args(x, o, sc, mean=m, plan=plan, **kw)
            _build.check(lib.quant_rows(*args), "quant_rows")
            o_p, sc_p = qc.quant_q_per_token_plain(x, m, **kw)
            exact = bool(torch.equal(o, o_p) and torch.equal(sc, sc_p))
            ms = queued_ms(lambda: lib.quant_rows(*args))
            moved = x.numel() * (x.element_size() + 1) + b * h * s * 4
            key = f"{shape} {x.dtype} group {group} {form} plan {tuple(plan)}"
            out[key] = {"bit_exact": exact, "ms": ms, "bound_ms": moved / PEAK_BYTES_S * 1e3}
            ok = ok and exact
            print(f"rows {key}: bit-exact {exact}; ms {ms:.4f} (bound "
                  f"{out[key]['bound_ms']:.4f})", flush=True)
        del x, mean
        torch.cuda.empty_cache()
    return out, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, help="the other tree's root")
    ap.add_argument("--rows", action="store_true",
                    help="also time this tree at every group and form of the Q/K options")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from sageattention_tpu_torch import quant
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import quant_cuda as qc
    from sageattention_tpu_torch.utils.timing import queued_ms

    other = ab_common.load_build(args.other.resolve(), "build_other")
    builds = {"other": other, "this": _build}
    with ThreadPoolExecutor(2) as pool:  # one nvcc a tree, at once
        list(pool.map(lambda b: b.lib("quant_q"), builds.values()))
    for tree, build in builds.items():
        for row in ab_common.registers(build, "quant_q"):
            print(f"resources ({tree}) quant_q {row}", flush=True)
    old_form = "quant_q_per_token" in other.SIGNATURES["quant_q"]

    def entry(tree, q, out, sc, bits):
        a = qc.quant_q_args(q, out, sc, scale_fold=q.shape[-1]**-0.5 * LOG2E, bits=bits)
        if tree == "this":
            return _build.lib("quant_q").quant_rows, a
        if not old_form:
            return other.lib("quant_q").quant_rows, a
        b, h, s, d = q.shape
        qmax = quant.qk_qmax(bits)
        old = (q.data_ptr(), out.data_ptr(), sc.data_ptr(), b * h * s, d,
               int(q.dtype == torch.float32), a[10], qmax, a[12], a[-1])
        return other.lib("quant_q").quant_q_per_token, old

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    out, ok = {}, True
    for name, (shape, f32, bits) in CASES.items():
        b, h, s, d = shape
        q = torch.randn(*shape, generator=gen, device="cuda") * 3
        q = q if f32 else q.to(torch.bfloat16)
        res, calls = {}, {}
        for tree in builds:
            o = torch.empty(shape, dtype=torch.int8, device="cuda")
            sc = torch.empty(shape[:3], device="cuda")
            fn, a = entry(tree, q, o, sc, bits)
            calls[tree] = (fn, a)
            err = fn(*a)
            if err:
                raise RuntimeError(f"{tree} kernel 4 {name}: cudaError {err}")
            res[tree] = (o, sc)
        o_p, sc_p = qc.quant_q_per_token_plain(q, scale_fold=d**-0.5 * LOG2E, bits=bits)
        torch.cuda.synchronize()
        same = {t: bool(torch.equal(o, o_p) and torch.equal(sc, sc_p))
                for t, (o, sc) in res.items()}
        same["trees"] = bool(torch.equal(res["this"][0], res["other"][0])
                             and torch.equal(res["this"][1], res["other"][1]))
        ms = {"other": [], "this": []}
        for t in ("other", "this", "this", "other"):
            fn, a = calls[t]
            ms[t].append(queued_ms(lambda fn=fn, a=a: fn(*a)))
        ms = {t: statistics.mean(x) for t, x in ms.items()}
        dev = {t: ab_common.device_ms(lambda fn=fn, a=a: fn(*a), "quant_")
               for t, (fn, a) in calls.items()}
        moved = q.numel() * (q.element_size() + 1) + b * h * s * 4
        bound, floor = moved / PEAK_BYTES_S * 1e3, moved / COPY_BYTES_S * 1e3
        ratio = ms["this"] / ms["other"]
        plan = qc.quant_q_plan(b * h, s, d, q.element_size(), 1)
        ok = ok and all(same.values()) and ratio <= SLOWER
        out[name] = {"shape": list(shape), "fp32": f32, "bits": bits, "bit_exact": same,
                     "ms": ms, "device_ms": dev, "this_over_other": ratio, "bound_ms": bound,
                     "copy_floor_ms": floor, "plan": plan._asdict()}
        print(f"kernel 4 {name} {shape} {'fp32' if f32 else 'bf16'} {bits} bits: bit-exact "
              f"{same}; ms other {ms['other']:.4f}, this {ms['this']:.4f} (ratio {ratio:.3f}"
              f"{', SLOWER' if ratio > SLOWER else ''}); device (profiler) other "
              f"{dev['other']:.4f}, this {dev['this']:.4f}; bound {bound:.4f} ms, copy floor "
              f"{floor:.4f} ms; plan {tuple(plan)}", flush=True)
        del q, res, calls, o_p, sc_p
        torch.cuda.empty_cache()
    summary = {"ok": None, "quant_q_per_token": out}
    if args.rows:
        summary["rows"], rows_ok = rows_times(gen)
        ok = ok and rows_ok
    summary["ok"] = ok
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
