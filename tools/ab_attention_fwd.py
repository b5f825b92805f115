#!/usr/bin/env python3
"""A/B of the port's forward kernels: this tree against another.

    mkdir -p scratch/other && git archive <rev> | tar -x -C scratch/other
    python3 tools/ab_attention_fwd.py scratch/other

Builds every attention library of both trees, each with its own
``ops/_build.py`` (so with its own flags and C signatures), and through
the C entry points:

- the unmasked forward (a TMA-fed ``wgmma`` kernel in both trees:
  ``csrc/attention_fwd_sm90.cuh``, and ``csrc/attention_fwd_sm90_wide.cuh``
  at 384 and 512; V codes widened to bf16 first by ``csrc/widen_v.cu``,
  timed with it), at the CogVideoX-2B layer (1, 30, 17,776, 64) and the
  Wan2.1-T2V-1.3B one (1, 12, 33,272, 128), non-causal, the Gemma-7B
  layer (4, 16/16, 4,096, 256), causal, and that layer widened to d 320
  (padded to 384), 384 and 512, causal, with bf16 V (and e4m3 codes at the
  first two and at 512): each tree's output held to this tree's plain
  version on three heads (cosine >= 0.9999, max-abs <= 2e-2), the two
  trees' outputs bit-identical, and times in the order other, this, this,
  other (CUDA events, median of 20 calls after 3 warm-up calls each); the
  pre-quantized unmasked forward at d 64-512 (per-tile and per-row K
  scales, a column bias, causal) bit-identical in both trees and held to
  its plain version, and timed against the other tree at (4, 16/16, 4096,
  384 and 512) and (1, 16/8, 3001, 320) causal with +-7 codes and a
  column bias; every unmasked instance keeps its registers and stack
  (``cuobjdump``; this tree's instances carry one or two template
  arguments more, MASKED and SBIAS, which are 0 in them), and the tool
  prints how many of them kept their SASS instruction for instruction;
- the masked instances (the masked forward at every head dim, and the
  masked pre-quantized one), which this tree runs on the same ``wgmma``
  kernels and the other tree may run on its ``mma.sync`` body: this
  tree's held to the plain version through the wrappers at a ragged
  length at every head dim (a window, varlen's ranges, a padding mask
  with dead rows, ALiBi causal and not, in bf16 too, segment ids and
  positions; the pre-quantized forward with varlen's ranges and a
  window), dead rows exactly 0 with LSE -inf, and both trees timed
  through the C entry points at the masked forward's cells (``MASKED``);
- ``fwd_grid``'s heads-first grid order (``csrc/attention_fwd_sm90.cuh``:
  a causal launch of at most two waves of CTAs puts the Q tile on the
  slowest grid axis) at the wide kernel's 64-row tiles: this tree's wide
  forward against a copy of it built under ``build/`` with that order off,
  at (1, 16/16, 1024, 384 and 512) causal, times in the order on, off,
  off, on, outputs bit-identical.

It prints the registers of every forward kernel instance of both trees.
The backward (dQ and dK/dV, with a bias and without) is A/B'd by
``tools/ab_attention_bwd.py``.  Needs one CUDA card; ends with one JSON
line, and exits 1 if an unmasked instance's outputs differ from the other
tree's or its registers or stack moved, if an instance disagrees with its
plain version, if a wide unmasked instance is slower than the other
tree's, or if the grid orders' outputs differ.
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
LOG2E = 1.4426950408889634
# the unmasked forward: (b, h, s, d, causal, V types, heads held to the plain
# version); a d that is no kernel head dim is padded with zeros to one
SHAPES = {"cogvideox-2b layer": (1, 30, 17776, 64, False, ("bf16", "e4m3"), (0, 15, 29)),
          "wan2.1 layer": (1, 12, 33272, 128, False, ("bf16", "e4m3"), (0, 6, 11)),
          "gemma-7b layer": (4, 16, 4096, 256, True, ("bf16",), (0, 7, 15)),
          "gemma-7b layer at d320": (4, 16, 4096, 320, True, ("bf16",), (0, 7, 15)),
          "gemma-7b layer at d384": (4, 16, 4096, 384, True, ("bf16",), (0, 7, 15)),
          "gemma-7b layer at d512": (4, 16, 4096, 512, True, ("bf16", "e4m3"), (0, 7, 15))}
# the pre-quantized wide forward timed against the other tree: (b, hq, hkv, s, d)
PREQ_WIDE = {"gemma-7b layer at d384": (4, 16, 16, 4096, 384),
             "gemma-7b layer at d512": (4, 16, 16, 4096, 512),
             "(1, 16/8, 3001) at d320": (1, 16, 8, 3001, 320)}
V_KINDS = {"bf16": 0, "e4m3": 2}
# causal wide calls of at most two waves of 64-row tiles, which fwd_grid
# orders heads first: (b, h, s, d)
HEADS_FIRST = {"(1, 16/16, 1024) at d384": (1, 16, 1024, 384),
               "(1, 16/16, 1024) at d512": (1, 16, 1024, 512)}
# the masked forward's timed cells: (b, hq, hkv, s, d, the mask), causal
VARLEN_LENS = (4096, 2048, 1536, 512)
MASKED = {"llm_window_dense prefill window 4096": (2, 32, 8, 8192, 128, "window 4096"),
          "varlen, four prompts": (1, 32, 8, 8192, 128, "varlen"),
          "gemma-2 local layer window 4096 d256": (1, 16, 8, 8192, 256, "window 4096"),
          "window 4096 d512": (1, 16, 8, 8192, 512, "window 4096"),
          "window 1000 d320": (1, 16, 8, 3001, 320, "window 1000"),
          "ALiBi bias fp32": (1, 32, 8, 4096, 128, "alibi"),
          "d64 gqa layer window 1024": (1, 8, 2, 4096, 64, "window 1024")}


def load_build(tree: pathlib.Path, name: str):
    """``ops/_build.py`` of ``tree`` as a module of its own."""
    path = tree / "sageattention_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def instance_key(fn: str) -> str:
    """A kernel instance's name without the template arguments this tree's
    ``wgmma`` forward kernels have more (MASKED, and SBIAS at 64-256; 0 in
    the unmasked instances) and their mask operand, so that an unmasked
    instance pairs with the other tree's."""
    if "MaskArgs" not in fn:
        return fn
    head, tail = fn.split("EEv", 1)
    extra = "Lb0ELb0E" if "sage_attn_fwd_sm90_kernel" in head else "Lb0E"
    if not head.endswith(extra):
        return fn  # a masked instance: no counterpart
    return head[:-len(extra)] + "EEv" + re.sub(r"N?St11conditional.*$", "", tail)


def instance_registers(build, lib: str) -> dict:
    """{kernel instance (mangled name, :func:`instance_key`): (registers,
    stack bytes)} of a built library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-res-usage", str(build._target(lib))],
                         capture_output=True, text=True, timeout=120).stdout
    rows, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            # the anonymous namespace's name holds hashes of the source's path
            fn = instance_key(re.sub(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w*?_cu_[0-9a-f]{8}", "NS",
                                     m.group(1)))
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+)", line)
        if m and fn:
            rows[fn] = (int(m.group(1)), int(m.group(2)))
    return rows


def instance_sass(build, lib: str) -> dict:
    """{kernel instance (:func:`instance_key`): its SASS instructions, the
    addresses and encodings taken out} of a built library."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(build._target(lib))], capture_output=True,
                         text=True, timeout=300).stdout
    code, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = instance_key(re.sub(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w*?_cu_[0-9a-f]{8}", "NS",
                                     m.group(1)))
            code[fn] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if fn and m:
            code[fn].append(m.group(1))
    return code


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
        if m and fn and "sage_attn_fwd" in fn:
            rows.append(f"{lib} {fn[:90]}: {m.group(1)} registers, {m.group(2)} bytes of stack")
    return rows


def launch(fn, q, k_i8, k_scale, v, o, fold_mul: float, causal: int = 0, v_scale=None,
           v_kind: int = 0, lse=None) -> None:
    """One forward call through either C signature: before V codes (18
    arguments, bf16 V only) or with v_scale, v_mean and the V kind (21)."""
    import torch

    b, hq, sq, d = q.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    head = (q.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(), v.data_ptr())
    lp = lse.data_ptr() if lse is not None else None
    if len(fn.argtypes) == 18:
        err = fn(*head, o.data_ptr(), lp, b, hq, hkv, sq, sk, d, causal, 0, int(lse is not None),
                 128, fold_mul, stream)
    else:
        err = fn(*head, v_scale.data_ptr() if v_scale is not None else None, None, o.data_ptr(),
                 lp, b, hq, hkv, sq, sk, d, causal, 0, v_kind, int(lse is not None), 128,
                 fold_mul, stream)
    if err:
        raise RuntimeError(f"sage_attn_fwd launch failed: cudaError {err}")


def mask_operands(masks, sq: int, sk: int, causal: bool) -> tuple:
    """The masked entry points' mask arguments (nine pointers, ten strides,
    the window, the bias type) as ``ops/attention_cuda.py`` passes them,
    and the liveness table among them (to keep it alive)."""
    import torch
    from sageattention_tpu_torch.ops import attention_cuda as ac

    live = ac.tile_liveness(masks, sq, sk)

    def ptr(x):
        return x.data_ptr() if x is not None else None

    args = (ptr(masks.q_seg), ptr(masks.kv_seg), ptr(masks.kv_lo), ptr(masks.kv_hi),
            ptr(masks.q_pos), ptr(masks.kv_pos), ptr(masks.mask), ptr(masks.bias), ptr(live),
            *ac.broadcast_strides(masks.mask), *ac.broadcast_strides(masks.bias),
            *([0, 0] if live is None else ac.broadcast_strides(live)[:2]),
            ac.window_arg(masks.window, causal),
            int(masks.bias is not None and masks.bias.dtype == torch.bfloat16))
    return args, live


def launch_masked(fn, q, k_i8, k_scale, v, o, fold_mul: float, hkv: int, margs) -> None:
    """One causal call of the masked kernel with the mask arguments
    ``margs`` (:func:`mask_operands`; the C signature is the same in every
    tree that has it), bf16 q and V."""
    import torch

    b, hq, sq, d = q.shape
    err = fn(q.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(), v.data_ptr(), None, None,
             o.data_ptr(), None, b, hq, hkv, sq, k_i8.shape[2], d, 1, 0, 0, 0, 128, fold_mul,
             torch.cuda.current_stream().cuda_stream, *margs)
    if err:
        raise RuntimeError(f"sage_attn_fwd_masked launch failed: cudaError {err}")


def masked_cell(gen, b, hq, hkv, s, d, kind):
    """q, K codes and scales, V (bf16, at the kernel's head dim) and the
    masks of a timed masked cell."""
    import itertools

    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import _build, quant_cuda
    from sageattention_tpu_torch.ops.attention_cuda import Masks

    dp = _build.pad_head_dim(d)
    q, k, v = (torch.nn.functional.pad(torch.randn(b, h, s, d, generator=gen, device="cuda"),
                                       (0, dp - d)).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    k_i8, k_scale, _ = quant_cuda.quant_k_fused_mean(k, group=128)
    if kind == "varlen":
        cu = torch.tensor([0, *itertools.accumulate(VARLEN_LENS)], device="cuda")
        _, _, lo, hi = core.varlen_rows(cu, cu, s, s)
        masks = Masks(kv_lo=lo[None].contiguous(), kv_hi=hi[None].contiguous())
    elif kind == "alibi":
        slopes = 2.0 ** (-8.0 * torch.arange(1, hq + 1, device="cuda") / hq)
        idx = torch.arange(s, device="cuda")
        masks = Masks(bias=(-slopes[:, None, None] * (idx[:, None] - idx[None, :]).abs())[None]
                      .float().contiguous())
    else:
        masks = Masks(window=int(kind.split()[1]))
    return q, k_i8, k_scale, v, masks, dp


def check_masked_vs_plain(gen) -> dict:
    """This tree's masked forward (every head dim) and masked pre-quantized
    forward against their plain versions through the wrappers, with
    ``chip_smoke.py``'s comparisons (cosine >= 0.9999, max-abs <= 2e-2,
    lse2 <= 1e-3, the same dead rows, 0 and -inf): {case: "ok" or the
    failure}."""
    import itertools

    import torch
    import chip_smoke as cs
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops.attention_cuda import Masks

    out = {}
    results = {"sage_attn_fwd_masked": {}, "sage_attn_fwd_preq": {}}

    def run(name, fn):
        try:
            fn()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 -- recorded, the run goes on
            out[name] = f"{type(e).__name__}: {e}"
            print(f"masked vs plain {name}: FAILED {out[name]}", flush=True)

    b, hq, hkv, s = 1, 4, 2, 1000
    for d in (64, 128, 256, 384, 512):
        q, k, v, k_i8, k_sc = cs.layer_operands(gen, b, s, hq=hq, hkv=hkv, d=d)
        idx = torch.arange(s, device="cuda")
        pad = (idx[None, :] < s - 100) & ~((idx[:, None] >= 128) & (idx[:, None] < 256))
        pad[s - 40:] = False
        ids = ((idx // 150) % 3).int()[None]
        pos = cs.zigzag(s).int()[None]
        alibi = cs.alibi(hq, s)
        lens = (500, 250, 250)
        cu = torch.tensor([0, *itertools.accumulate(lens)], device="cuda")
        _, _, lo, hi = core.varlen_rows(cu, cu, s, s)
        varlen = Masks(kv_lo=lo[None].contiguous(), kv_hi=hi[None].contiguous())
        cases = [("window 200", True, dict(window=200)),
                 ("padding mask with dead rows", False, dict(attn_mask=pad[None, None])),
                 ("ALiBi", True, dict(attn_bias=alibi)),
                 ("ALiBi", False, dict(attn_bias=alibi)),
                 ("ALiBi bf16", True, dict(attn_bias=alibi.to(torch.bfloat16))),
                 ("segment ids", False, dict(q_segment_ids=ids, kv_segment_ids=ids)),
                 ("zig-zag positions", False, dict(q_positions=pos, kv_positions=pos))]
        for name, causal, kw in cases:
            masks = core._masks(q, k, is_causal=causal, **kw)
            run(f"d{d} {name} causal={causal}", lambda: cs.compare_masked(
                f"d{d} {name}", q, k_i8, k_sc, v, masks, causal, (0, 3), results))
        run(f"d{d} varlen {lens}", lambda: cs.compare_masked(
            f"d{d} varlen {lens}", q, k_i8, k_sc, v, varlen, True, (0, 3), results))
        for opts in cs.QOPTS.values():
            for mname, masks in (("varlen", varlen), ("window 200", Masks(window=200))):
                run(f"d{d} preq {opts} {mname}", lambda: cs.compare_preq(
                    f"d{d} {mname}", q, k, v, opts, True, (0, 3), results, masks=masks))
        del q, k, v, k_i8, k_sc
    return out


def agree(got, want) -> tuple[float, float]:
    """(cosine in fp64, max abs difference) of a kernel's output and the
    plain version's."""
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    return (cosine_similarity(got.float().cpu(), want.float().cpu()),
            (got.float() - want.float()).abs().max().item())


def ab_all(builds: dict, gen) -> dict:
    """Registers of every shared forward library's instances; the unmasked
    ones at a ragged length (the forward at d 256, 384 and 512, the
    pre-quantized forward at d 64-512) bit for bit in both trees through
    the C entry points and against the plain versions."""
    import torch
    from sageattention_tpu_torch.ops import attention_cuda

    out = {"registers": {}, "sass": {}, "outputs": {}, "plain": {}}
    libs = [lib for lib in ("attention_fwd", "attention_fwd_masked", "attention_fwd_preq",
                            "attention_fwd_hd256", "attention_fwd_masked_hd256",
                            "attention_fwd_preq_hd256", "attention_fwd_wide",
                            "attention_fwd_masked_wide", "attention_fwd_preq_wide")
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
        code = {t: instance_sass(b, lib) for t, b in builds.items()}
        same = [fn for fn in common if code["this"].get(fn) == code["other"].get(fn)]
        out["sass"][lib] = {"common": len(common), "identical": len(same)}
        print(f"sass {lib}: {len(same)} of the {len(common)} instances in both trees have the "
              f"same instructions", flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    def same(name, call):
        res = {t: call(builds[t]) for t in ("other", "this")}
        torch.cuda.synchronize()
        ok = all(torch.equal(a, b) for a, b in zip(res["other"], res["this"]))
        out["outputs"][name] = ok
        print(f"outputs {name}: bit-identical {ok}", flush=True)
        return res

    def vs_plain(name, call, plain):
        """Both trees' (o, lse2), bit-identical, against the plain
        version's; this tree's must agree (cosine >= 0.9999, max-abs <=
        2e-2, lse2 <= 1e-3)."""
        res = same(name, call)
        o_p, l_p = plain()
        torch.cuda.synchronize()
        row = {}
        for t, (o, lse) in res.items():
            cos, err = agree(o, o_p)
            row[t] = {"cos": cos, "max_abs": err, "lse2_max_abs": (lse - l_p).abs().max().item()}
        r = row["this"]
        row["ok"] = (r["cos"] >= 0.9999 and r["max_abs"] <= 2e-2 and r["lse2_max_abs"] <= 1e-3
                     and bool(torch.isfinite(res["this"][0]).all()))
        out["plain"][name] = row
        print(f"plain {name}: this {row['this']}, other {row['other']}; ok {row['ok']}",
              flush=True)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def bf(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def pos(*shape, lo=0.5):
        return torch.rand(*shape, generator=gen, device="cuda") + lo

    b, hq, hkv, s = 1, 8, 2, 1000
    fold = 256**-0.5 * LOG2E
    fold_mul = 1 / 127 * fold
    q, k_i8, v = bf(b, hq, s, 256), i8(b, hkv, s, 256), bf(b, hkv, s, 256)
    k_sc = pos(b, hkv, -(-s // 128)) * 1e-2
    for causal in (0, 1):
        def fwd256(build, causal=causal):
            o = torch.empty_like(q)
            lse = torch.empty(b, hq, s, device="cuda")
            launch(build.lib("attention_fwd_hd256").sage_attn_fwd_hd256, q, k_i8, k_sc, v, o,
                   fold_mul, causal, lse=lse)
            return o, lse

        vs_plain(f"forward d256 causal={causal} at {s}", fwd256,
                 lambda causal=causal: attention_cuda.sage_attention_plain(
                     q, k_i8, k_sc, v, is_causal=bool(causal), q_fold=fold, return_lse=True))

    # the wide instances (384 and 512) against the plain version
    for d in (384, 512):
        fold = d**-0.5 * LOG2E
        fold_w = 1 / 127 * fold
        qw, kw, vw = bf(b, hq, s, d), i8(b, hkv, s, d), bf(b, hkv, s, d)
        for causal in (0, 1):
            def wide(build, causal=causal, qw=qw, kw=kw, vw=vw, fold_w=fold_w):
                o = torch.empty_like(qw)
                lse = torch.empty(b, hq, s, device="cuda")
                launch(build.lib("attention_fwd_wide").sage_attn_fwd_wide, qw, kw, k_sc, vw, o,
                       fold_w, causal, lse=lse)
                return o, lse

            vs_plain(f"forward d{d} causal={causal} at {s}", wide,
                     lambda causal=causal, qw=qw, kw=kw, vw=vw, fold=fold:
                     attention_cuda.sage_attention_plain(qw, kw, k_sc, vw, is_causal=bool(causal),
                                                         q_fold=fold, return_lse=True))
    # the pre-quantized unmasked forward against the plain version
    for d in (64, 128, 256, 384, 512):
        for per_row, col in ((False, False), (True, True)):
            q_i8, k_q, v_q = i8(b, hq, s, d), i8(b, hkv, s, d), bf(b, hkv, s, d)
            q_sc = pos(b, hq, s) * 1e-3
            k_s = pos(b, hkv, s if per_row else -(-s // 128)) * 1e-2
            cb = torch.randn(b, hq, s, generator=gen, device="cuda") if col else None

            def preq(build, q_i8=q_i8, k_q=k_q, v_q=v_q, q_sc=q_sc, k_s=k_s, cb=cb, d=d,
                     per_row=per_row):
                o = torch.empty(b, hq, s, d, device="cuda", dtype=torch.bfloat16)
                lse = torch.empty(b, hq, s, device="cuda")
                sfx = attention_cuda.instances(d)
                err = getattr(build.lib("attention_fwd_preq" + sfx),
                              "sage_attn_fwd_preq" + sfx)(
                    q_i8.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), None,
                    None, o.data_ptr(), lse.data_ptr(), b, hq, hkv, s, s, d, 1, 0, 1, 128,
                    int(per_row), 0, q_sc.data_ptr(),
                    cb.data_ptr() if cb is not None else None, stream, 0,
                    *([None] * 9), *([0] * 10), 0, 0)
                if err:
                    raise RuntimeError(f"sage_attn_fwd_preq failed: cudaError {err}")
                return o, lse

            vs_plain(f"preq d{d} per_row={per_row} col_bias={col}", preq,
                     lambda q_i8=q_i8, q_sc=q_sc, k_q=k_q, k_s=k_s, v_q=v_q, cb=cb:
                     attention_cuda.sage_attention_preq_plain(
                         q_i8, q_sc, k_q, k_s, v_q, is_causal=True, return_lse=True,
                         col_bias=cb))
    return out


def ab_preq_wide(builds, gen, b, hq, hkv, s, d) -> dict:
    """The pre-quantized wide forward's time in both trees (other, this,
    this, other) at (b, hq/hkv, s, d) causal: +-7 codes (4 bits) with
    per-row Q and per-tile K scales, a column bias, bf16 V and output; this
    tree's output against its plain version on three query heads."""
    import torch
    from sageattention_tpu_torch.ops import _build, attention_cuda

    dp = _build.pad_head_dim(d)
    pad = (0, dp - d)
    q_i8 = torch.nn.functional.pad(torch.randint(-7, 8, (b, hq, s, d), generator=gen,
                                                 device="cuda", dtype=torch.int8), pad)
    k_i8 = torch.nn.functional.pad(torch.randint(-7, 8, (b, hkv, s, d), generator=gen,
                                                 device="cuda", dtype=torch.int8), pad)
    q_sc = (torch.rand(b, hq, s, generator=gen, device="cuda") + 0.5) * 2e-2 * d**-0.5
    k_sc = (torch.rand(b, hkv, -(-s // 128), generator=gen, device="cuda") + 0.5) * 0.3
    v = torch.nn.functional.pad(torch.randn(b, hkv, s, d, generator=gen, device="cuda"),
                                pad).to(torch.bfloat16)
    cb = torch.randn(b, hq, s, generator=gen, device="cuda") * 0.5
    stream = torch.cuda.current_stream().cuda_stream
    outs = {t: torch.empty(b, hq, s, dp, device="cuda", dtype=torch.bfloat16) for t in builds}

    def call(t):
        err = builds[t].lib("attention_fwd_preq_wide").sage_attn_fwd_preq_wide(
            q_i8.data_ptr(), k_i8.data_ptr(), k_sc.data_ptr(), v.data_ptr(), None, None,
            outs[t].data_ptr(), None, b, hq, hkv, s, s, dp, 1, 0, 0, 128, 0, 0, q_sc.data_ptr(),
            cb.data_ptr(), stream, 0, *([None] * 9), *([0] * 10), 0, 0)
        if err:
            raise RuntimeError(f"sage_attn_fwd_preq_wide failed: cudaError {err}")

    times = {t: [] for t in builds}
    for t in ("other", "this", "this", "other"):
        times[t].append(cuda_ms(lambda t=t: call(t)))
    hs = [0, hq // 2, hq - 1]
    kvs = [h // (hq // hkv) for h in hs]
    plain = attention_cuda.sage_attention_preq_plain(
        q_i8[:, hs].contiguous(), q_sc[:, hs].contiguous(), k_i8[:, kvs].contiguous(),
        k_sc[:, kvs].contiguous(), v[:, kvs].contiguous(), is_causal=True, return_lse=False,
        col_bias=cb[:, hs].contiguous())
    torch.cuda.synchronize()
    cos, err = agree(outs["this"][:, hs], plain)
    row = {"shape": [b, hq, hkv, s, d], "d_pad": dp, "ms_other": times["other"],
           "ms_this": times["this"],
           "ratio": statistics.mean(times["this"]) / statistics.mean(times["other"]),
           "cos_plain": cos, "max_abs_plain": err}
    print(f"preq wide {(b, hq, hkv, s, d)} causal, +-7 codes, column bias: other "
          f"{times['other']} ms, this {times['this']} ms (ratio {row['ratio']:.3f}); vs plain on "
          f"heads {hs}: cos {cos}, max abs {err}", flush=True)
    if not (cos >= 0.9999 and err <= 2e-2):
        raise AssertionError(f"preq wide {(b, hq, hkv, s, d)}: this tree disagrees with plain")
    return row


def tiles_first_tree() -> pathlib.Path:
    """A copy of this tree's kernels and ``ops/_build.py`` under
    ``build/``, with ``fwd_grid``'s heads-first order off: every launch
    puts the Q tile on the fastest grid axis."""
    dst = ROOT / "build" / "ab_tiles_first"
    pkg = dst / "sageattention_tpu_torch"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "sageattention_tpu_torch" / "csrc", pkg / "csrc")
    (pkg / "ops").mkdir(parents=True)
    shutil.copy(ROOT / "sageattention_tpu_torch" / "ops" / "_build.py", pkg / "ops")
    hdr = pkg / "csrc" / "attention_fwd_sm90.cuh"
    rule = "*heads_first = causal && "
    text = hdr.read_text()
    if text.count(rule) != 1:
        raise RuntimeError(f"fwd_grid's rule {rule!r} not found once in {hdr}")
    hdr.write_text(text.replace(rule, "*heads_first = false && "))
    return dst


def ab_heads_first(this, tiles_first, gen, b, h, s, d) -> dict:
    """The wide forward at (b, h/h, s, d) causal, bf16 q and V, with
    ``fwd_grid``'s heads-first order (``this``) and without it
    (``tiles_first``): times in the order on, off, off, on; the outputs
    must be bit-identical."""
    import torch
    from sageattention_tpu_torch.ops import quant_cuda

    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    k_i8, k_scale, _ = quant_cuda.quant_k_fused_mean(k, group=128)
    mul = 1 / 127 * d**-0.5 * LOG2E
    builds = {"on": this, "off": tiles_first}
    outs = {t: torch.empty_like(q) for t in builds}
    times = {t: [] for t in builds}
    for t in ("on", "off", "off", "on"):
        fn = builds[t].lib("attention_fwd_wide").sage_attn_fwd_wide
        times[t].append(cuda_ms(lambda fn=fn, t=t: launch(fn, q, k_i8, k_scale, v, outs[t], mul,
                                                          1)))
    torch.cuda.synchronize()
    same = torch.equal(outs["on"], outs["off"])
    row = {"shape": [b, h, s, d], "ctas": b * h * -(-s // 64), "ms_heads_first": times["on"],
           "ms_tiles_first": times["off"],
           "ratio": statistics.mean(times["on"]) / statistics.mean(times["off"]),
           "bit_identical": same}
    print(f"grid order {(b, h, s, d)} causal, {row['ctas']} CTAs: heads first {times['on']} ms, "
          f"tiles first {times['off']} ms (ratio {row['ratio']:.3f}); outputs bit-identical "
          f"{same}", flush=True)
    return row


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
    names = ("attention_fwd", "attention_fwd_hd256", "attention_fwd_masked",
             "attention_fwd_masked_hd256", "attention_fwd_masked_wide", "attention_fwd_wide",
             "attention_fwd_preq_wide")
    tiles_first = load_build(tiles_first_tree(), "tiles_first_build")
    with ThreadPoolExecutor(2 * len(names) + 1) as pool:  # one nvcc a (tree, source), at once
        list(pool.map(lambda tl: tl[0].lib(tl[1]),
                      [(b, lib) for b in builds.values() for lib in names]
                      + [(tiles_first, "attention_fwd_wide")]))
    for tree, build in builds.items():
        for lib in names:
            for row in registers(build, lib):
                print(f"resources ({tree}) {row}", flush=True)

    from sageattention_tpu_torch import quant
    from sageattention_tpu_torch.ops import _build, attention_cuda, quant_cuda

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    result = {"card": card, "failed": []}
    for cell, (b, h, s, d, causal, vtypes, heads) in SHAPES.items():
        dp = _build.pad_head_dim(d)
        q, k, v = (torch.nn.functional.pad(
            torch.randn(b, h, s, d, generator=gen, device="cuda"), (0, dp - d)).to(torch.bfloat16)
            for _ in range(3))
        k_i8, k_scale, _ = quant_cuda.quant_k_fused_mean(k, group=128)
        fold = d**-0.5 * LOG2E
        lib = "attention_fwd" + attention_cuda.instances(dp)
        fns = {t: getattr(b_.lib(lib), "sage_attn_fwd" + attention_cuda.instances(dp))
               for t, b_ in builds.items()}
        for vt in vtypes:
            if vt == "bf16":
                vx, vs = v, None
            else:
                vx, vs, _ = quant_cuda.quant_v_per_channel(v, dtype=quant.V_DTYPES["fp8"])
            outs = {t: torch.empty_like(q) for t in builds}
            mul = quant.fold_multiplier(fold)
            # this tree's entry takes bf16 V: its wrapper widens codes first,
            # and that pass is timed with the call; the other tree's takes the
            # codes where its entry accepts them (before the wgmma kernels),
            # else the same widening
            other_codes = vt == "bf16"
            if not other_codes:
                try:
                    launch(fns["other"], q, k_i8, k_scale, vx, outs["other"], mul, int(causal),
                           vs, V_KINDS[vt])
                    other_codes = True
                except RuntimeError:
                    pass
            widen = attention_cuda.widen_v_codes
            calls = {"other": lambda: launch(fns["other"], q, k_i8, k_scale,
                                             vx if other_codes else widen(vx), outs["other"],
                                             mul, int(causal), vs,
                                             V_KINDS[vt] if other_codes else 0),
                     "this": lambda: launch(fns["this"], q, k_i8, k_scale,
                                            vx if vt == "bf16" else widen(vx), outs["this"], mul,
                                            int(causal), vs, 0)}
            times = {t: [] for t in builds}
            for t in ("other", "this", "this", "other"):
                times[t].append(cuda_ms(calls[t]))
            torch.cuda.synchronize()
            hs = list(heads)  # hq = hkv in these cells
            plain = attention_cuda.sage_attention_plain(
                q[:, hs].contiguous(), k_i8[:, hs].contiguous(), k_scale[:, hs].contiguous(),
                vx[:, hs].contiguous(), vs[:, hs].contiguous() if vs is not None else None, None,
                is_causal=causal, q_fold=fold, return_lse=False)
            cos, err = {}, {}
            for t in builds:
                cos[t], err[t] = agree(outs[t][:, hs], plain)
            diff = (outs["other"].float() - outs["this"].float()).abs().max().item()
            ok = cos["this"] >= 0.9999 and err["this"] <= 2e-2 and bool(
                torch.isfinite(outs["this"]).all())
            if not torch.equal(outs["other"], outs["this"]):
                result["failed"].append(f"{cell} {vt}: not bit-identical to the other tree")
            ratio = statistics.mean(times["this"]) / statistics.mean(times["other"])
            result[f"{cell} {vt}"] = {
                "shape": [b, h, s, d], "d_pad": dp, "causal": causal,
                "ms_other": times["other"], "ms_this": times["this"], "ratio": ratio,
                "cos_plain": cos, "max_abs_plain": err,
                "max_abs_trees": diff}
            if not ok:
                result["failed"].append(f"{cell} {vt}: this tree disagrees with the plain version")
            if dp > 256 and ratio > 1:
                result["failed"].append(f"{cell} {vt}: slower than the other tree")
            print(f"{cell} {(b, h, s, d)} causal={causal} V {vt}: other {times['other']} ms, "
                  f"this {times['this']} ms (ratio {ratio:.3f}); vs plain on heads {heads}: "
                  f"cos {cos}, max abs {err}; trees differ by {diff:.3e}", flush=True)
            del outs, plain
        del q, k, v, k_i8, k_scale
        torch.cuda.empty_cache()
    for cell, (b, hq, hkv, s, d) in PREQ_WIDE.items():
        result[f"preq {cell}"] = ab_preq_wide(builds, gen, b, hq, hkv, s, d)
        if result[f"preq {cell}"]["ratio"] > 1:
            result["failed"].append(f"preq {cell}: slower than the other tree")
    for cell, (b, hq, hkv, s, d, kind) in MASKED.items():
        q, k_i8, k_scale, v, masks, dp = masked_cell(gen, b, hq, hkv, s, d, kind)
        margs, live = mask_operands(masks, s, s, True)
        fold_mul = quant.fold_multiplier(d**-0.5 * LOG2E)
        lib = "attention_fwd_masked" + attention_cuda.instances(dp)
        fns = {t: getattr(b_.lib(lib), "sage_attn_fwd_masked" + attention_cuda.instances(dp))
               for t, b_ in builds.items()}
        outs = {t: torch.empty_like(q) for t in builds}
        calls = {t: (lambda t=t: launch_masked(fns[t], q, k_i8, k_scale, v, outs[t], fold_mul,
                                               hkv, margs))
                 for t in builds}
        times = {t: [] for t in builds}
        for t in ("other", "this", "this", "other"):
            times[t].append(cuda_ms(calls[t], reps=10))
        torch.cuda.synchronize()
        cos, err = agree(outs["this"], outs["other"])
        ratio = statistics.mean(times["this"]) / statistics.mean(times["other"])
        result[cell] = {"shape": [b, hq, hkv, s, d], "d_pad": dp, "mask": kind,
                        "ms_other": times["other"], "ms_this": times["this"], "ratio": ratio,
                        "cos_trees": cos, "max_abs_trees": err}
        print(f"{cell} masked {(b, hq, hkv, s, d)} {kind}: other {times['other']} ms, this "
              f"{times['this']} ms (ratio {ratio:.3f}); the trees' outputs cos {cos:.6f}, max "
              f"abs {err:.3e}", flush=True)
        del q, k_i8, k_scale, v, outs, masks, margs, live
        torch.cuda.empty_cache()
    result["masked_vs_plain"] = check_masked_vs_plain(gen)
    result["failed"] += [f"masked {n}: {r}" for n, r in result["masked_vs_plain"].items()
                         if r != "ok"]
    for cell, (b, h, s, d) in HEADS_FIRST.items():
        result[f"grid order {cell}"] = ab_heads_first(builds["this"], tiles_first, gen, b, h, s, d)
    result["all"] = ab_all(builds, gen)
    al = result["all"]
    result["failed"] += [f"{n}: not bit-identical" for n, ok in al["outputs"].items() if not ok]
    result["failed"] += [f"{n}: disagrees with the plain version" for n, r in al["plain"].items()
                         if not r["ok"]]
    result["failed"] += [f"{n}: outputs not bit-identical" for n, r in result.items()
                         if isinstance(r, dict) and r.get("bit_identical") is False]
    result["failed"] += [f"{lib}: registers or stack moved" for lib, r in al["registers"].items()
                         if r["moved"]]
    print(json.dumps(result), flush=True)
    print(f"failed: {result['failed']}", flush=True)
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
