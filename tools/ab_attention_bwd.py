#!/usr/bin/env python3
"""A/B of the port's backward kernels (dQ, dK/dV): this tree against another.

    mkdir -p scratch/other && git archive <rev> | tar -x -C scratch/other
    python3 tools/ab_attention_bwd.py scratch/other

Builds ``sageattention_tpu_torch/csrc/attention_bwd.cu`` of both trees,
each with its own ``ops/_build.py``, and feeds both, through the C entry
points, the same operands, made as the op makes them (this tree's forward
on seeded bf16 q, k, v and dO, with the bias where there is one) at the
shapes the trainers and the LLM run.  Without a bias (``sage_attn_bwd_dq``,
``sage_attn_bwd_dkv``):

- the CogVideoX-2B layer (1, 30, 17,776, 64), non-causal;
- the llm-8b-gqa layer (1, 32/8, 4,096, 128), causal, and with a window of
  1,024;
- the d 256 layer trainer's (1, 16/16, 4,096, 256), causal.

With a bias (``sage_attn_bwd_dq_bias`` with dBias, ``sage_attn_bwd_dkv_bias``),
causal ALiBi: CogVideoX-2B's 30 heads of 64 at 4,096 tokens and the
llm-8b-gqa layer with an fp32 bias, the llm-8b-gqa layer with a bf16 one,
and the d 256 layer trainer's shape with an fp32 one.  There this tree's
kernels run both ways of reading the bias (``bias_kind`` bit 1: the
producer's TMA ring, or each thread's loads; dK/dV at 256 loads it either
way), timed against each other too (tma, loads, loads, tma), and the two
must give the same bits.

Each kernel is timed with CUDA events in the order other, this, this,
other (median of 10 calls after 2 warm-up calls each); its outputs are
compared between the trees and with the plain versions (``agreement``:
cosine in fp64 and max-abs over the largest plain entry; the plain
versions on three heads at the CogVideoX-2B layer, where a head's scores
take 1.3 GB).  It prints the registers and stack of every instance of
both trees' backward library (``cuobjdump``; the rate probe's go to the
JSON line), and whether each instance without a bias, and the probe's,
kept its registers and stack, and whether their SASS is the same
instruction for instruction (this tree's bias-free instances carry a
BIAS template argument of 0 and an empty bias parameter, both dropped to pair
them with the other tree's; the bias instances were redesigned and are
not paired).  Needs one CUDA card; ends with one JSON line; exits 1 if
this tree's output disagrees with the plain version (cosine < 0.9999 or
max-abs > 1e-2 of the largest entry, dBias included; the two ways of
reading a bias not bit-identical), if one of this tree's kernels is slower than the
other's at a shape, if a paired instance's registers or stack moved, or if
fewer than the 18 bias-free instances were paired.
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
# name: (b, hq, hkv, s, d, causal, window, heads compared with the plain versions)
SHAPES = {
    "cogvideox-2b layer": (1, 30, 30, 17776, 64, False, None, (0, 15, 29)),
    "llm-8b-gqa layer causal": (1, 32, 8, 4096, 128, True, None, None),
    "llm-8b-gqa layer window 1024": (1, 32, 8, 4096, 128, True, 1024, None),
    "d256 layer trainer causal": (1, 16, 16, 4096, 256, True, None, None),
}
# name: (b, hq, hkv, s, d, the ALiBi bias's dtype), causal
BIAS_SHAPES = {
    "d64 (1, 30/30, 4096, 64) causal, fp32 ALiBi": (1, 30, 30, 4096, 64, "float32"),
    "llm-8b-gqa layer causal, fp32 ALiBi": (1, 32, 8, 4096, 128, "float32"),
    "llm-8b-gqa layer causal, bf16 ALiBi": (1, 32, 8, 4096, 128, "bfloat16"),
    "d256 layer trainer causal, fp32 ALiBi": (1, 16, 16, 4096, 256, "float32"),
}
BIAS_FREE_INSTANCES = 18  # dQ and dK/dV x d 64, 128, 256 x non-causal, causal, window
DQ_IN = ("q_i8", "q_scale", "k_i8", "k_scale", "k_sm", "v", "do", "lse2", "dvec")
DKV_IN = ("q_i8", "q_scale", "q_bf", "k_i8", "k_scale", "v", "do", "lse2", "dvec")


def load_build(tree: pathlib.Path, name: str):
    """``ops/_build.py`` of ``tree`` as a module of its own."""
    path = tree / "sageattention_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def instance_registers(build, lib: str) -> dict:
    """{kernel instance (mangled name): (registers, stack bytes)} of a
    built library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-res-usage", str(build._target(lib))],
                         capture_output=True, text=True, timeout=120).stdout
    rows, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            # the anonymous namespace's name holds hashes of the source's path
            fn = re.sub(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w*?_cu_[0-9a-f]{8}", "NS", m.group(1))
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+)", line)
        if m and fn:
            rows[fn] = (int(m.group(1)), int(m.group(2)))
    return rows


def instance_sass(build, lib: str) -> dict:
    """{kernel instance (mangled name, namespace hashes dropped): its SASS
    instructions, without addresses and encodings} of a built library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(build._target(lib))], capture_output=True,
                         text=True, timeout=300).stdout
    code, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = re.sub(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w*?_cu_[0-9a-f]{8}", "NS", m.group(1))
            code[fn] = []
            continue
        ins = re.sub(r"/\*[^*]*\*/", "", line).strip()
        if fn and ins and not ins.startswith("."):
            code[fn].append(ins)
    return code


def pair_name(fn: str) -> str:
    """This tree's name of an instance without a bias as the other tree
    gives it: without the BIAS template argument (0, the last) and the
    bias parameter (``BiasOf<BIAS>``, mangled as the ``std::conditional``
    it aliases); other names unchanged."""
    m = re.fullmatch(r"(.*_tma_kernelI.*)Li0E(EEv.*?)NSt11conditionalI.*4typeE", fn)
    return m.group(1) + m.group(2) if m else fn


def alibi(hq: int, s: int, dtype):
    """The standard ALiBi bias [1, hq, s, s]: -2^(-8 h / hq) |row - col|."""
    import torch

    slopes = 2.0 ** (-8.0 * torch.arange(1, hq + 1, device="cuda", dtype=torch.float32) / hq)
    idx = torch.arange(s, device="cuda")
    return (-slopes[:, None, None] * (idx[:, None] - idx[None, :]).abs().float())[None].to(dtype)


def operands(gen, b, hq, hkv, s, d, causal, window, bias=None):
    """The backward kernels' operands as the op builds them: this tree's
    forward on random bf16 q, k, v (the masked forward with a bias), then
    ``backward_operands``."""
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import autodiff

    q = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = (torch.randn(b, hkv, s, d, generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
    v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    do = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    masks = core._masks(q, k, is_causal=causal, attn_bias=bias, window=window)
    f = core._forward(q, k, v, is_causal=causal, sm_scale=None, smooth_k=True,
                      return_lse=True, masks=masks)
    ops = autodiff.backward_operands(q, k, v, do, o=f.o, k_i8=f.k_i8, km=f.km, dlse=None,
                                     sm_scale=f.sm_scale)
    ops.update(k_i8=f.k_i8, k_scale=f.k_scale, lse2=f.lse2)
    return ops, f.sm_scale


def agreement(g, gp) -> tuple[float, float]:
    """(cosine in fp64, max-abs error / max |gp|)."""
    a, b = g.double().flatten(), gp.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    cos = 1.0 if na == 0 and nb == 0 else (a @ b).item() / max(na * nb, 1e-300)
    return cos, (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bias_cells(builds, gen, bwd, stream, result) -> list:
    """The BIAS_SHAPES cells: dQ with dBias and dK/dV, timed (other, this,
    this, other; this tree's two forms, tma, loads, loads, tma) and held to
    the plain versions; returns the failures."""
    import torch

    bad = []
    for cell, (b, hq, hkv, s, d, dtype) in BIAS_SHAPES.items():
        bias = alibi(hq, s, getattr(torch, dtype))
        ops, sm = operands(gen, b, hq, hkv, s, d, True, None, bias=bias)
        ptr = {n: x.data_ptr() for n, x in ops.items()}
        bf16 = int(bias.dtype == torch.bfloat16)
        shape = (b, hq, hkv, s, s, d, 1)
        # the other tree's form (bias_kind bit 0 only), this tree's two
        forms = {"other": ("other", bf16), "this": ("this", bf16), "this loads": ("this", bf16 | 2)}
        outs = {f: (torch.empty(b, hq, s, d, device="cuda"), torch.empty_like(bias),
                    torch.empty(b, hkv, s, d, device="cuda"),
                    torch.empty(b, hkv, s, d, device="cuda")) for f in forms}

        def dq(f):
            t, kind = forms[f]
            e = builds[t].lib("attention_bwd").sage_attn_bwd_dq_bias(
                *[ptr[n] for n in DQ_IN], outs[f][0].data_ptr(), bias.data_ptr(),
                outs[f][1].data_ptr(), *shape, kind, 128, sm, stream())
            if e:
                raise RuntimeError(f"sage_attn_bwd_dq_bias ({f}) failed: cudaError {e}")

        def dkv(f):
            t, kind = forms[f]
            e = builds[t].lib("attention_bwd").sage_attn_bwd_dkv_bias(
                *[ptr[n] for n in DKV_IN], outs[f][2].data_ptr(), outs[f][3].data_ptr(),
                bias.data_ptr(), *shape, kind, 128, sm, stream())
            if e:
                raise RuntimeError(f"sage_attn_bwd_dkv_bias ({f}) failed: cudaError {e}")

        r = result["cells"][cell] = {"shape": [b, hq, hkv, s, d], "causal": True,
                                     "bias": f"{dtype} ALiBi [1, {hq}, s, s]"}
        for name, call, order in (("dq_bias", dq, ("other", "this", "this", "other")),
                                  ("dq_bias_forms", dq, ("this", "this loads", "this loads",
                                                         "this")),
                                  ("dkv_bias", dkv, ("other", "this", "this", "other")),
                                  ("dkv_bias_forms", dkv, ("this", "this loads", "this loads",
                                                           "this"))):
            ms = {}
            for f in order:
                ms.setdefault(f, []).append(cuda_ms(lambda f=f: call(f)))
            a, z = order[0], order[1]
            r[name + "_ms"] = {**ms, "ratio": statistics.mean(ms[z]) / statistics.mean(ms[a])}
            if not name.endswith("_forms") and min(ms["this"]) > max(ms["other"]):
                bad.append(f"{cell} {name}: slower than the other tree")
            print(f"{cell} {(b, hq, hkv, s, d)} {name}: " + ", ".join(
                f"{f} {v} ms" for f, v in ms.items()) + f" (ratio {z}/{a} "
                f"{r[name + '_ms']['ratio']:.3f})", flush=True)
        torch.cuda.synchronize()
        kw = dict(is_causal=True, sm_scale=sm, bias=bias)
        plain = (*bwd.sage_attention_bwd_dq_plain(*[ops[n] for n in DQ_IN], need_dbias=True,
                                                  **kw),
                 *bwd.sage_attention_bwd_dkv_plain(*[ops[n] for n in DKV_IN], **kw))
        same = all(bool(torch.equal(x, y)) for x, y in zip(outs["this"], outs["this loads"]))
        r["forms_bit_identical"] = same
        if not same:
            bad.append(f"{cell}: the TMA and the loads forms differ")
        for i, gname in enumerate(("dq", "dbias", "dk", "dv")):
            c_tt, rel_tt = agreement(outs["this"][i], outs["other"][i])
            c_this, rel_this = agreement(outs["this"][i], plain[i])
            c_other, rel_other = agreement(outs["other"][i], plain[i])
            r[gname] = {"cos_trees": c_tt, "rel_trees": rel_tt, "cos_plain_this": c_this,
                        "rel_plain_this": rel_this, "cos_plain_other": c_other,
                        "rel_plain_other": rel_other,
                        "finite": bool(torch.isfinite(outs["this"][i]).all())}
            if not (r[gname]["finite"] and c_this >= 0.9999 and rel_this <= 1e-2):
                bad.append(f"{cell} {gname}: this tree disagrees with the plain version")
            print(f"{cell} {gname}: trees cos {c_tt:.7f} rel {rel_tt:.3e}; vs plain this cos "
                  f"{c_this:.7f} rel {rel_this:.3e}, other cos {c_other:.7f} rel "
                  f"{rel_other:.3e}", flush=True)
        print(f"{cell}: the bias by TMA and by loads bit-identical {same}", flush=True)
        del ops, plain, outs, bias
        torch.cuda.empty_cache()
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, help="root of the other tree")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_attention_bwd: no CUDA device", file=sys.stderr)
        return 1
    from sageattention_tpu_torch.ops import attention_bwd_cuda as bwd

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    builds = {"other": load_build(args.other.resolve(), "other_build"),
              "this": load_build(ROOT, "this_build")}
    libs = ("attention_bwd", "probe_mma")
    with ThreadPoolExecutor(4) as pool:  # one nvcc a (tree, source), at once
        list(pool.map(lambda tl: builds[tl[0]].lib(tl[1]),
                      [(t, lib) for t in builds for lib in libs]))
    result = {"card": card, "registers": {}, "cells": {}}
    moved_any = False
    paired_bias_free = 0
    for lib in libs:
        regs = {t: instance_registers(b, lib) for t, b in builds.items()}
        regs["this"] = {pair_name(fn): v for fn, v in regs["this"].items()}
        for t in builds if lib == "attention_bwd" else ():  # the probe's: in the JSON line
            for fn, (r, st) in sorted(regs[t].items()):
                print(f"resources ({t}) {lib} {fn[:110]}: {r} registers, {st} bytes of stack",
                      flush=True)
        common = sorted(set(regs["this"]) & set(regs["other"]))
        moved = [f"{fn[:90]}: {regs['other'][fn]} -> {regs['this'][fn]}" for fn in common
                 if regs["this"][fn] != regs["other"][fn]]
        moved_any |= bool(moved)
        if lib == "attention_bwd":
            paired_bias_free = sum("_tma_kernel" in fn for fn in common)
            # the paired instances' machine code, instruction for instruction
            sass = {t: instance_sass(b, lib) for t, b in builds.items()}
            sass["this"] = {pair_name(fn): v for fn, v in sass["this"].items()}
            same = [fn for fn in common if sass["this"].get(fn) == sass["other"].get(fn)]
            result["registers"][lib + "_sass_identical"] = len(same)
            print(f"sass {lib}: {len(same)} of {len(common)} paired instances identical "
                  f"instruction for instruction; differing: "
                  f"{[fn[:90] for fn in common if fn not in same]}", flush=True)
        result["registers"][lib] = {"common": len(common), "moved": moved,
                                    "this": {fn: list(v) for fn, v in regs["this"].items()}}
        print(f"registers {lib}: {len(common)} instances in both trees, {len(moved)} moved "
              f"{moved}", flush=True)
    print(f"bias-free instances paired: {paired_bias_free} of {BIAS_FREE_INSTANCES}", flush=True)

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    bad = []
    for cell, (b, hq, hkv, s, d, causal, window, heads) in SHAPES.items():
        ops, sm = operands(gen, b, hq, hkv, s, d, causal, window)
        ptr = {n: x.data_ptr() for n, x in ops.items()}
        outs = {t: (torch.empty(b, hq, s, d, device="cuda"),
                    torch.empty(b, hkv, s, d, device="cuda"),
                    torch.empty(b, hkv, s, d, device="cuda")) for t in builds}
        shape = (b, hq, hkv, s, s, d, int(causal), window or 0, 128, sm)

        def dq(t):
            e = builds[t].lib("attention_bwd").sage_attn_bwd_dq(
                *[ptr[n] for n in DQ_IN], outs[t][0].data_ptr(), *shape, stream())
            if e:
                raise RuntimeError(f"sage_attn_bwd_dq ({t}) failed: cudaError {e}")

        def dkv(t):
            e = builds[t].lib("attention_bwd").sage_attn_bwd_dkv(
                *[ptr[n] for n in DKV_IN], outs[t][1].data_ptr(), outs[t][2].data_ptr(),
                *shape, stream())
            if e:
                raise RuntimeError(f"sage_attn_bwd_dkv ({t}) failed: cudaError {e}")

        r = result["cells"][cell] = {"shape": [b, hq, hkv, s, d], "causal": causal,
                                     "window": window}
        for name, call in (("dq", dq), ("dkv", dkv)):
            ms = {t: [] for t in builds}
            for t in ("other", "this", "this", "other"):
                ms[t].append(cuda_ms(lambda t=t: call(t)))
            r[name + "_ms"] = {"other": ms["other"], "this": ms["this"],
                               "ratio": statistics.mean(ms["this"]) / statistics.mean(ms["other"])}
            if min(ms["this"]) > max(ms["other"]):
                bad.append(f"{cell} {name}: slower than the other tree")
            print(f"{cell} {(b, hq, hkv, s, d)} causal={causal} window={window} {name}: other "
                  f"{ms['other']} ms, this {ms['this']} ms (ratio {r[name + '_ms']['ratio']:.3f})",
                  flush=True)
        torch.cuda.synchronize()
        kw = dict(is_causal=causal, sm_scale=sm, window=window)
        sel = list(heads) if heads is not None else None
        pops = ops if sel is None else {n: x[:, sel].contiguous() for n, x in ops.items()}
        plain = (bwd.sage_attention_bwd_dq_plain(*[pops[n] for n in DQ_IN], **kw),
                 *bwd.sage_attention_bwd_dkv_plain(*[pops[n] for n in DKV_IN], **kw))
        for i, gname in enumerate(("dq", "dk", "dv")):
            got = {t: outs[t][i] if sel is None else outs[t][i][:, sel] for t in builds}
            c_tt, rel_tt = agreement(got["this"], got["other"])
            c_this, rel_this = agreement(got["this"], plain[i])
            c_other, rel_other = agreement(got["other"], plain[i])
            r[gname] = {"cos_trees": c_tt, "rel_trees": rel_tt, "cos_plain_this": c_this,
                        "rel_plain_this": rel_this, "cos_plain_other": c_other,
                        "rel_plain_other": rel_other,
                        "finite": bool(torch.isfinite(outs["this"][i]).all())}
            if not (r[gname]["finite"] and c_this >= 0.9999 and rel_this <= 1e-2):
                bad.append(f"{cell} {gname}: this tree disagrees with the plain version")
            print(f"{cell} {gname}: trees cos {c_tt:.7f} rel {rel_tt:.3e}; vs plain this cos "
                  f"{c_this:.7f} rel {rel_this:.3e}, other cos {c_other:.7f} rel "
                  f"{rel_other:.3e} (heads {heads if heads else 'all'})", flush=True)
        del ops, pops, plain, outs
        torch.cuda.empty_cache()
    bad += bias_cells(builds, gen, bwd, stream, result)
    result["failed"] = bad + (["a shared instance's registers or stack moved"] if moved_any
                              else []) + (
        [f"{paired_bias_free} bias-free instances paired, not {BIAS_FREE_INSTANCES}"]
        if paired_bias_free != BIAS_FREE_INSTANCES else [])
    print(json.dumps(result), flush=True)
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
