#!/usr/bin/env python3
"""A/B of the port's forward kernels with bf16 V: this tree against another.

    mkdir -p scratch/other && git archive <rev> | tar -x -C scratch/other
    python3 tools/ab_attention_fwd.py scratch/other

Builds ``sageattention_tpu_torch/csrc/attention_fwd.cu`` of both trees,
each with its own ``ops/_build.py`` (so with its own flags and C
signature), feeds both the same bf16 Q, int8 K codes, K scales and bf16 V
at the CogVideoX-2B layer shape (1, 30, 17,776, 64) and the
Wan2.1-T2V-1.3B one (1, 12, 33,272, 128), non-causal, says whether the
outputs are bit-identical, and times each with CUDA events in the order
other, this, this, other (median of 20 calls after 3 warm-up calls each).
The masked instances (``attention_fwd_masked.cu``) the same way, with a
causal window of 1024 at (1, 32/8 heads, 4096, 128) and (1, 8/2, 4096,
64).  It also prints the registers of every forward kernel instance of
both trees' libraries.  Then it builds every attention library the two
trees share (the pre-quantized forward, the D = 256 sources, the
backward), compares each kernel instance's registers and stack between
the trees, and checks through the C entry points that the D = 256
forward (causal and not) and its masked instance (a window), the
pre-quantized forward at d 64, 128 and 256 (per-tile and per-row K
scales, a column bias, causal) and the bias instances of dQ, dK/dV at d
64, 128 and 256 (causal and not) give bit-identical outputs on the same
operands.  The backward's instances without a bias are not bit-identical
with an older tree's (their wgmma sums in another order):
``tools/ab_attention_bwd.py`` holds them to the plain versions and times
them.  Needs one CUDA card; ends
with one JSON line, and exits 1 if any of those outputs differ or any
shared instance's registers or stack moved.
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
LOG2E = 1.4426950408889634
SHAPES = {"cogvideox-2b layer": (1, 30, 17776, 64), "wan2.1 layer": (1, 12, 33272, 128)}
# masked cells: (b, hq, hkv, s, d), causal with a window
MASKED = {"llm-8b-gqa layer window 1024": (1, 32, 8, 4096, 128, 1024),
          "d64 gqa layer window 1024": (1, 8, 2, 4096, 64, 1024)}


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


def registers(build, lib: str = "attention_fwd") -> list[str]:
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
        if m and fn and "sage_attn_fwd_kernel" in fn:
            rows.append(f"{lib} {fn[:90]}: {m.group(1)} registers, {m.group(2)} bytes of stack")
    return rows


def launch(fn, q, k_i8, k_scale, v, o, fold_mul: float) -> None:
    """One forward call through either C signature: before V codes (18
    arguments) or with v_scale, v_mean and the V kind (21)."""
    import torch

    b, hq, sq, d = q.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    head = (q.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(), v.data_ptr())
    if len(fn.argtypes) == 18:
        err = fn(*head, o.data_ptr(), None, b, hq, hkv, sq, sk, d, 0, 0, 0, 128, fold_mul,
                 stream)
    else:
        err = fn(*head, None, None, o.data_ptr(), None, b, hq, hkv, sq, sk, d, 0, 0, 0, 0,
                 128, fold_mul, stream)
    if err:
        raise RuntimeError(f"sage_attn_fwd launch failed: cudaError {err}")


def launch_masked(fn, q, k_i8, k_scale, v, o, fold_mul: float, hkv: int, window: int) -> None:
    """One causal windowed call of the masked kernel (its C signature is
    the same in every tree that has it)."""
    import torch

    b, hq, sq, d = q.shape
    err = fn(q.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(), v.data_ptr(), None, None,
             o.data_ptr(), None, b, hq, hkv, sq, sq, d, 1, 0, 0, 0, 128, fold_mul,
             torch.cuda.current_stream().cuda_stream, *([None] * 9), *([0] * 10), window, 0)
    if err:
        raise RuntimeError(f"sage_attn_fwd_masked launch failed: cudaError {err}")


def ab_all(builds: dict, gen) -> dict:
    """Registers of every shared attention library's instances, and the
    pre-quantized forward (d 64, 128, 256) and the backward's bias
    instances (d 64, 128, 256) bit for bit, through the C entry points."""
    import torch

    out = {"registers": {}, "outputs": {}}
    libs = [lib for lib in ("attention_fwd", "attention_fwd_masked", "attention_fwd_preq",
                            "attention_fwd_hd256", "attention_fwd_masked_hd256",
                            "attention_fwd_preq_hd256", "attention_bwd")
            if all(lib in b.SIGNATURES for b in builds.values())]
    with ThreadPoolExecutor(2 * len(libs)) as pool:  # one nvcc a (tree, source), at once
        list(pool.map(lambda tl: builds[tl[0]].lib(tl[1]),
                      [(t, lib) for t in builds for lib in libs]))
    for lib in libs:
        regs = {t: instance_registers(b, lib) for t, b in builds.items()}
        common = sorted(set(regs["this"]) & set(regs["other"]))
        moved = [f"{fn[:80]}: {regs['other'][fn]} -> {regs['this'][fn]}" for fn in common
                 if regs["this"][fn] != regs["other"][fn]]
        out["registers"][lib] = {"common": len(common), "moved": moved,
                                 "only_this": len(set(regs["this"]) - set(regs["other"]))}
        print(f"registers {lib}: {len(common)} instances in both trees, {len(moved)} moved "
              f"{moved}; {out['registers'][lib]['only_this']} only in this tree", flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    def same(name, call):
        res = {t: call(builds[t]) for t in ("other", "this")}
        torch.cuda.synchronize()
        ok = all(torch.equal(a, b) for a, b in zip(res["other"], res["this"]))
        out["outputs"][name] = ok
        print(f"outputs {name}: bit-identical {ok}", flush=True)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def bf(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def pos(*shape, lo=0.5):
        return torch.rand(*shape, generator=gen, device="cuda") + lo

    b, hq, hkv, s = 1, 8, 2, 1000
    fold_mul = 1 / 127 * 256**-0.5 * LOG2E
    q, k_i8, v = bf(b, hq, s, 256), i8(b, hkv, s, 256), bf(b, hkv, s, 256)
    k_sc = pos(b, hkv, -(-s // 128)) * 1e-2
    for causal in (0, 1):
        def fwd256(build, causal=causal):
            o = torch.empty_like(q)
            lse = torch.empty(b, hq, s, device="cuda")
            err = build.lib("attention_fwd_hd256").sage_attn_fwd_hd256(
                q.data_ptr(), k_i8.data_ptr(), k_sc.data_ptr(), v.data_ptr(), None, None,
                o.data_ptr(), lse.data_ptr(), b, hq, hkv, s, s, 256, causal, 0, 0, 1, 128,
                fold_mul, stream)
            if err:
                raise RuntimeError(f"sage_attn_fwd_hd256 failed: cudaError {err}")
            return o, lse

        same(f"forward d256 causal={causal}", fwd256)

    def masked256(build):
        o = torch.empty_like(q)
        launch_masked(build.lib("attention_fwd_masked_hd256").sage_attn_fwd_masked_hd256, q,
                      k_i8, k_sc, v, o, fold_mul, hkv, 300)
        return (o,)

    same("masked d256 window 300", masked256)
    for d in (64, 128, 256):
        for per_row, col in ((False, False), (True, True)):
            q_i8, k_i8, v = i8(b, hq, s, d), i8(b, hkv, s, d), bf(b, hkv, s, d)
            q_sc = pos(b, hq, s) * 1e-3
            k_sc = pos(b, hkv, s if per_row else -(-s // 128)) * 1e-2
            cb = torch.randn(b, hq, s, generator=gen, device="cuda") if col else None

            def preq(build, q_i8=q_i8, k_i8=k_i8, v=v, q_sc=q_sc, k_sc=k_sc, cb=cb, d=d,
                     per_row=per_row):
                o = torch.empty(b, hq, s, d, device="cuda", dtype=torch.bfloat16)
                lse = torch.empty(b, hq, s, device="cuda")
                sfx = "_hd256" if d == 256 else ""  # D = 256 has a source of its own
                err = getattr(build.lib("attention_fwd_preq" + sfx), "sage_attn_fwd_preq" + sfx)(
                    q_i8.data_ptr(), k_i8.data_ptr(), k_sc.data_ptr(), v.data_ptr(), None,
                    None, o.data_ptr(), lse.data_ptr(), b, hq, hkv, s, s, d, 1, 0, 1, 128,
                    int(per_row), 0, q_sc.data_ptr(), cb.data_ptr() if cb is not None else None,
                    stream, 0, *([None] * 9), *([0] * 10), 0, 0)
                if err:
                    raise RuntimeError(f"sage_attn_fwd_preq failed: cudaError {err}")
                return o, lse

            same(f"preq d{d} per_row={per_row} col_bias={col}", preq)
    # the backward's bias instances; those without a bias were redesigned
    # (TMA and wgmma) and are held to the plain versions by ab_attention_bwd.py
    for d in (64, 128, 256):
        for causal in (0, 1):
            ops = dict(q_i8=i8(b, hq, s, d), q_scale=pos(b, hq, s) * 1e-3,
                       q_bf=bf(b, hq, s, d), k_i8=i8(b, hkv, s, d),
                       k_scale=pos(b, hkv, -(-s // 128)) * 1e-2, k_sm=bf(b, hkv, s, d),
                       v=bf(b, hkv, s, d), do=bf(b, hq, s, d),
                       lse2=torch.randn(b, hq, s, generator=gen, device="cuda") + 12,
                       dvec=torch.randn(b, hq, s, generator=gen, device="cuda") * 1e-2)
            bias = torch.randn(b, hq, s, s, generator=gen, device="cuda")

            def bwd(build, ops=ops, d=d, causal=causal, bias=bias):
                lib = build.lib("attention_bwd")
                dq = torch.empty(b, hq, s, d, device="cuda")
                dk, dv = (torch.empty(b, hkv, s, d, device="cuda") for _ in range(2))
                dbias = torch.empty_like(bias)
                p = {n: x.data_ptr() for n, x in ops.items()}
                dq_in = [p[n] for n in ("q_i8", "q_scale", "k_i8", "k_scale", "k_sm", "v",
                                        "do", "lse2", "dvec")]
                kv_in = [p[n] for n in ("q_i8", "q_scale", "q_bf", "k_i8", "k_scale", "v",
                                        "do", "lse2", "dvec")]
                e1 = lib.sage_attn_bwd_dq_bias(*dq_in, dq.data_ptr(), bias.data_ptr(),
                                               dbias.data_ptr(), b, hq, hkv, s, s, d, causal, 0,
                                               128, d**-0.5, stream)
                e2 = lib.sage_attn_bwd_dkv_bias(*kv_in, dk.data_ptr(), dv.data_ptr(),
                                                bias.data_ptr(), b, hq, hkv, s, s, d, causal, 0,
                                                128, d**-0.5, stream)
                if e1 or e2:
                    raise RuntimeError(f"backward launch failed: cudaError {e1} {e2}")
                return dq, dk, dv, dbias

            same(f"backward d{d} causal={causal} bias=True", bwd)
    return out


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, help="root of the other tree")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_attention_fwd: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    builds = {"other": load_build(args.other.resolve(), "other_build"),
              "this": load_build(ROOT, "this_build")}
    with ThreadPoolExecutor(4) as pool:
        libs = dict(zip(builds, pool.map(lambda b: b.lib("attention_fwd"), builds.values())))
        masked = dict(zip(builds, pool.map(lambda b: b.lib("attention_fwd_masked"),
                                           builds.values())))
    for tree, build in builds.items():
        for lib in ("attention_fwd", "attention_fwd_masked"):
            for row in registers(build, lib):
                print(f"resources ({tree}) {row}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    result = {"card": card}
    for cell, (b, h, s, d) in SHAPES.items():
        q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        k_i8 = torch.randint(-127, 128, (b, h, s, d), generator=gen, device="cuda",
                             dtype=torch.int8)
        k_scale = torch.full((b, h, -(-s // 128)), 2 / 127, device="cuda")
        v = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        fold_mul = (torch.tensor(1 / 127, dtype=torch.float32)
                    * torch.tensor(d**-0.5 * LOG2E, dtype=torch.float32)).item()
        outs = {t: torch.empty_like(q) for t in libs}
        calls = {t: (lambda t=t: launch(libs[t].sage_attn_fwd, q, k_i8, k_scale, v, outs[t],
                                        fold_mul)) for t in libs}
        times = {t: [] for t in libs}
        for t in ("other", "this", "this", "other"):
            times[t].append(cuda_ms(calls[t]))
        torch.cuda.synchronize()
        same = torch.equal(outs["other"], outs["this"])
        diff = (outs["other"].float() - outs["this"].float()).abs().max().item()
        result[cell] = {"shape": [b, h, s, d], "ms_other": times["other"],
                        "ms_this": times["this"], "bit_identical": same, "max_abs_diff": diff}
        print(f"{cell} {(b, h, s, d)} bf16 V: other {times['other']} ms, this "
              f"{times['this']} ms; outputs bit-identical {same} (max abs diff {diff:.3e})",
              flush=True)
        del q, k_i8, k_scale, v, outs
        torch.cuda.empty_cache()
    for cell, (b, hq, hkv, s, d, window) in MASKED.items():
        q = torch.randn(b, hq, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        k_i8 = torch.randint(-127, 128, (b, hkv, s, d), generator=gen, device="cuda",
                             dtype=torch.int8)
        k_scale = torch.full((b, hkv, -(-s // 128)), 2 / 127, device="cuda")
        v = torch.randn(b, hkv, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        fold_mul = (torch.tensor(1 / 127, dtype=torch.float32)
                    * torch.tensor(d**-0.5 * LOG2E, dtype=torch.float32)).item()
        outs = {t: torch.empty_like(q) for t in masked}
        calls = {t: (lambda t=t: launch_masked(masked[t].sage_attn_fwd_masked, q, k_i8, k_scale,
                                               v, outs[t], fold_mul, hkv, window))
                 for t in masked}
        times = {t: [] for t in masked}
        for t in ("other", "this", "this", "other"):
            times[t].append(cuda_ms(calls[t]))
        torch.cuda.synchronize()
        same = torch.equal(outs["other"], outs["this"])
        result[cell] = {"shape": [b, hq, hkv, s, d], "window": window,
                        "ms_other": times["other"], "ms_this": times["this"],
                        "bit_identical": same}
        print(f"{cell} masked {(b, hq, hkv, s, d)}: other {times['other']} ms, this "
              f"{times['this']} ms; outputs bit-identical {same}", flush=True)
        del q, k_i8, k_scale, v, outs
        torch.cuda.empty_cache()
    result["all"] = ab_all(builds, gen)
    print(json.dumps(result), flush=True)
    moved = any(r["moved"] for r in result["all"]["registers"].values())
    return 0 if all(result["all"]["outputs"].values()) and not moved else 1


if __name__ == "__main__":
    sys.exit(main())
