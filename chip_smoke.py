#!/usr/bin/env python3
"""Smoke run of sageattention_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # everything, one card
    python3 chip_smoke.py --profile  # and device time by kernel of one step

Phases, each of which raises (and so exits non-zero) when it fails:

1. card and build: the card's name and power limit, the torch and CUDA
   versions, and every kernel built from ``sageattention_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) into ``build/``;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and the op against exact fp32 attention;
3. the server: the CogVideoX-2B VideoDiT at full width (seq 17,776,
   hidden 1920, 30 heads x 64) in bf16 with seeded random weights,
   answering 2 requests x 2 denoise steps; the launch counts of every
   kernel are zeroed just before and read just after, and must equal
   layers x steps; one step's eps is checked against exact attention at
   depth 2;
4. each kernel's time at the model shape (CUDA events, median of 10+
   after warm-up) beside its bound, its plain version's time and, where
   one PyTorch call computes the same function, that call's time.

It prints one ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.  It imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM data-sheet peaks (dense)
PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS_S = 1979e12
PEAK_BF16_FLOP_S = 989e12

COG = dict(b=1, h=30, s=17776, d=64)  # one CogVideoX-2B attention layer
COG_DEPTH = 30  # the server runs all of CogVideoX-2B's layers


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` single-call times from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def check_quant(gen, results):
    import torch
    from sageattention_tpu_torch.ops import quant_cuda

    for b, h, s, d in ((1, 30, 17776, 64), (2, 8, 4096, 128)):
        k = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
        k = k + torch.randn(b, h, 1, d, generator=gen, device="cuda").to(torch.bfloat16) * 3
        km = quant_cuda.k_channel_mean(k)
        km_ref = quant_cuda.k_channel_mean_plain(k)
        km_err = ((km - km_ref).abs() / (km_ref.abs() + 1e-3)).max().item()
        # the chunked kernel with the plain km: bit-exact with the spec
        ki, ks = quant_cuda.quant_k_chunked(k, km_ref, group=128)
        ki_ref, ks_ref = quant_cuda.quant_k_chunked_plain(k, km_ref, group=128)
        torch.cuda.synchronize()
        exact = torch.equal(ki, ki_ref) and torch.equal(ks, ks_ref)
        # the whole prologue (kernel km): codes within +-1 on <= 1e-4
        kf, sf, _ = quant_cuda.quant_k_fused_mean(k, group=128)
        diff = (kf.int() - ki_ref.int()).abs()
        frac = (diff > 0).float().mean().item()
        s_rel = ((sf - ks_ref).abs() / ks_ref).max().item()
        log(f"quant_k {(b, h, s, d)}: km max rel err {km_err:.3e}; chunked "
            f"bit-exact {exact}; fused codes off {frac:.2e} (max {diff.max().item()}), "
            f"scales max rel {s_rel:.2e}")
        require(km_err <= 1e-5, "k_channel_mean disagrees with its plain version")
        require(exact, "quant_k_chunked is not bit-exact with the spec")
        require(diff.max().item() <= 1 and frac <= 1e-4, "quant_k codes disagree")
        require(s_rel <= 1e-6, "quant_k scales disagree beyond rtol 1e-6")
        if (b, h, s, d) == (1, 30, 17776, 64):
            results["k_channel_mean"]["max_abs_err"] = (km - km_ref).abs().max().item()
            results["quant_k_chunked"]["max_abs_err"] = float(
                (ki.int() - ki_ref.int()).abs().max().item())


def check_attention(gen, results):
    import torch
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda, reference
    from sageattention_tpu_torch.utils.compare import cosine_similarity, max_abs_err

    cases = [
        # name, b, hq, hkv, sq, sk, d, causal, q heads compared (None: all);
        # at the model shape a few heads across the range, so that the plain
        # version's [s,s] scores stay small
        ("cogvideox layer", 1, 30, 30, 17776, 17776, 64, False, (0, 15, 29)),
        ("causal gqa lse", 1, 32, 8, 2048, 2048, 128, True, None),
        ("ragged causal", 1, 4, 4, 1000, 1000, 64, True, None),
        ("rectangular", 2, 4, 2, 300, 1111, 64, False, None),
    ]
    for name, b, hq, hkv, sq, sk, d, causal, heads in cases:
        q = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(b, hkv, sk, d, generator=gen, device="cuda").to(torch.bfloat16)
        k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(k, group=128)
        fold = d**-0.5 * core.LOG2E
        o, l2 = attention_cuda.sage_attention_fwd(q, k_i8, k_sc, v, is_causal=causal,
                                                  q_fold=fold, return_lse=True)
        # each compared q head with its own kv head (GQA: h // (hq // hkv))
        hs = list(heads) if heads is not None else list(range(hq))
        kvs = [h // (hq // hkv) for h in hs]
        o_p, l2_p = attention_cuda.sage_attention_plain(
            q[:, hs].contiguous(), k_i8[:, kvs].contiguous(), k_sc[:, kvs].contiguous(),
            v[:, kvs].contiguous(), is_causal=causal, q_fold=fold, return_lse=True)
        torch.cuda.synchronize()
        o_k, l2_k = o[:, hs].float(), l2[:, hs]
        cos = cosine_similarity(o_k.cpu(), o_p.float().cpu())
        err = (o_k - o_p.float()).abs().max().item()
        lerr = (l2_k - l2_p).abs().max().item()
        finite = bool(torch.isfinite(o).all()) and bool(torch.isfinite(l2).all())
        log(f"attention {name} {(b, hq, hkv, sq, sk, d)} causal={causal}: cos "
            f"{cos:.6f}, max abs {err:.3e}, lse2 max abs {lerr:.3e} (heads "
            f"{heads if heads is not None else 'all'}); "
            f"finite {finite}")
        require(finite, f"attention {name}: non-finite output")
        require(cos >= 0.9999 and err <= 2e-2 and lerr <= 1e-3,
                f"attention {name} disagrees with its plain version")
        if name == "cogvideox layer":
            results["sage_attn_fwd"]["max_abs_err"] = err

    # the op on the card against the same op on the CPU (the plain
    # versions), across input dtypes, a padded head dim and GQA
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        q = torch.randn(1, 4, 300, 96, generator=gen, device="cuda").to(dtype)
        k = torch.randn(1, 2, 517, 96, generator=gen, device="cuda").to(dtype)
        v = torch.randn(1, 2, 517, 96, generator=gen, device="cuda").to(dtype)
        o, lse = core.sageattn(q, k, v, is_causal=True, return_lse=True)
        o_c, lse_c = core.sageattn(q.cpu(), k.cpu(), v.cpu(), is_causal=True,
                                   return_lse=True)
        cos = cosine_similarity(o.float().cpu(), o_c.float())
        err = max_abs_err(o.float().cpu(), o_c.float())
        lerr = max_abs_err(lse.cpu(), lse_c)
        log(f"sageattn cuda vs cpu ({dtype}, GQA 4/2, causal, 300x517, d96): cos "
            f"{cos:.6f}, max abs {err:.3e}, lse max abs {lerr:.3e}")
        require(o.dtype == dtype and o.shape == q.shape, "sageattn output dtype/shape")
        require(cos >= 0.9999 and err <= 2e-2 and lerr <= 1e-3,
                f"sageattn on the card disagrees with the CPU path ({dtype})")

    # the op (quantizer + kernel + LSE correction) against exact attention
    b, hq, hkv, s, d = 1, 32, 8, 2048, 128
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = core.sageattn(q, k, v, tensor_layout="NHD", is_causal=True, return_lse=True)
    o_r, lse_r = reference.attention_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, return_lse=True)
    cos = cosine_similarity(o.float().cpu(), o_r.transpose(1, 2).float().cpu())
    lerr = (lse - lse_r).abs().max().item()
    log(f"sageattn vs exact fp32 (NHD, GQA 32/8, causal, 2048, d128): cos "
        f"{cos:.6f}, lse max abs {lerr:.3e}")
    require(cos > 0.999, "sageattn vs exact attention: cosine <= 0.999")
    require(lerr < 5e-2, "sageattn LSE vs exact attention")


# --------------------------------------------------------------------------
# phase 3: the CogVideoX-2B denoise server
# --------------------------------------------------------------------------

COUNTED = ("k_channel_mean", "quant_k_chunked", "sage_attn_fwd")


def counters():
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda

    return {"k_channel_mean": quant_cuda.k_channel_mean,
            "quant_k_chunked": quant_cuda.quant_k_chunked,
            "sage_attn_fwd": attention_cuda.sage_attention_fwd}


def profile_step(model, request) -> dict:
    """Device time by kernel over one denoise step (``torch.profiler``),
    and the device's idle share of the step's wall time."""
    import pathlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    from sageattention_tpu_torch import serve

    t = torch.tensor([500], device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve.denoise_step(model, *request, t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, sets), by name
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    busy, end = 0.0, None  # the union of the device spans
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += (b - a) / 1e3
            end = b
        elif b > end:
            busy += (b - end) / 1e3
            end = b
    groups = {"sage_attn_fwd": 0.0, "quant_k": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms, _ in rows:
        low = name.lower()
        if "sage_attn_fwd" in low:
            groups["sage_attn_fwd"] += ms
        elif "quant_k" in low or "channel_mean" in low:
            groups["quant_k"] += ms
        elif any(w in low for w in ("gemm", "cutlass", "nvjet", "sm90_xmma")):
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": max(0.0, 1 - busy / wall_ms), "groups_ms": groups,
           "top": [{"kernel": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:15]]}
    path = pathlib.Path("chiprun_out")
    path.mkdir(exist_ok=True)
    (path / "profile_step.json").write_text(json.dumps(out, indent=1))
    log(f"profile of one step: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
        f"idle share {out['idle_share']:.4f}, by group {json.dumps(groups)}")
    for r in out["top"][:8]:
        log(f"  {r['ms']:9.3f} ms x{r['count']:4d}  {r['kernel']}")
    return out


def run_server(results, profile: bool) -> dict:
    import torch
    from sageattention_tpu_torch import models, serve
    from sageattention_tpu_torch.utils.compare import cosine_similarity

    depth = COG_DEPTH
    cfg = models.MODEL_CONFIGS["cogvideox-2b"].scaled(depth=depth)
    log(f"server: {cfg.name} seq {cfg.seq_len} hidden {cfg.hidden} heads "
        f"{cfg.heads}x{cfg.head_dim} depth {cfg.depth} bf16")
    t0 = time.perf_counter()
    model = serve.load_model(cfg, device="cuda", seed=0)
    requests = serve.make_requests(cfg, 2, device="cuda", seed=1)
    models.set_attention_backend("sage")
    # warm-up step (allocator, cuBLAS), not counted
    serve.denoise_step(model, *requests[0], torch.tensor([999], device="cuda"))
    torch.cuda.synchronize()
    log(f"server set-up + warm-up step: {time.perf_counter() - t0:.1f} s")

    steps = 2
    for fn in counters().values():
        fn.launches = 0
    out = serve.serve(model, requests, steps)
    launches = {name: fn.launches for name, fn in counters().items()}
    n_steps = len(requests) * steps
    for lat in out["outputs"]:
        require(lat.shape == requests[0][0].shape and bool(torch.isfinite(lat).all()),
                "server output is not finite or has the wrong shape")
    ms = out["step_ms"]
    log(f"server: {len(requests)} requests x {steps} steps, ms per step "
        f"{[round(x, 3) for x in ms]}, median {statistics.median(ms):.3f}")
    log(f"server launches: {launches} (layers x steps = {depth * n_steps})")
    for name in COUNTED:
        require(launches[name] == depth * n_steps,
                f"{name} launched {launches[name]} times, want {depth * n_steps}")
        results[name]["launches"] = launches[name]
    prof = profile_step(model, requests[0]) if profile else None
    del model
    torch.cuda.empty_cache()

    # one step's eps: sage against exact attention, depth 2, full width
    cfg2 = cfg.scaled(depth=2)
    model2 = serve.load_model(cfg2, device="cuda", seed=2)
    lat, txt = serve.make_requests(cfg2, 1, device="cuda", seed=3)[0]
    t = torch.tensor([500], device="cuda")
    with torch.no_grad():
        eps_s = model2(lat, txt, t)
        models.set_attention_backend("reference")
        eps_r = model2(lat, txt, t)
        models.set_attention_backend("sage")
    cos = cosine_similarity(eps_s.float().cpu(), eps_r.float().cpu())
    log(f"server eps, sage vs exact attention (depth 2, full width): cos {cos:.6f}")
    require(cos >= 0.999, "server eps disagrees with exact attention")
    del model2
    torch.cuda.empty_cache()
    return {"depth": depth, "step_ms": ms, "median_step_ms": statistics.median(ms),
            "eps_cosine_vs_exact": cos, "profile": prof}


# --------------------------------------------------------------------------
# phase 4: times at the model shape
# --------------------------------------------------------------------------


def time_kernels(gen, results):
    import torch
    import torch.nn.functional as F
    from sageattention_tpu_torch import core
    from sageattention_tpu_torch.ops import attention_cuda, quant_cuda

    b, h, s, d = COG["b"], COG["h"], COG["s"], COG["d"]
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)
    ng = -(-s // 128)

    km = quant_cuda.k_channel_mean(k)
    r = results["k_channel_mean"]
    r["ms"] = cuda_ms(lambda: quant_cuda.k_channel_mean(k))
    r["plain_ms"] = cuda_ms(lambda: quant_cuda.k_channel_mean_plain(k))
    r["library_ms"] = cuda_ms(lambda: torch.mean(k, dim=-2, dtype=torch.float32))
    r["bound_ms"] = (k.numel() * 2 + km.numel() * 4) / PEAK_BYTES_S * 1e3
    r["bound_by"] = "bytes"

    r = results["quant_k_chunked"]
    r["ms"] = cuda_ms(lambda: quant_cuda.quant_k_chunked(k, km, group=128))
    r["plain_ms"] = cuda_ms(lambda: quant_cuda.quant_k_chunked_plain(k, km, group=128))
    r["library_ms"] = None
    r["bound_ms"] = (k.numel() * 3 + km.numel() * 4 + b * h * ng * 4) / PEAK_BYTES_S * 1e3
    r["bound_by"] = "bytes"

    k_i8, k_sc, _ = quant_cuda.quant_k_fused_mean(k, group=128)
    fold = d**-0.5 * core.LOG2E

    def kern():
        attention_cuda.sage_attention_fwd(q, k_i8, k_sc, v, is_causal=False, q_fold=fold)

    def plain():
        attention_cuda.sage_attention_plain(q, k_i8, k_sc, v, is_causal=False, q_fold=fold,
                                            return_lse=False)

    r = results["sage_attn_fwd"]
    r["ms"] = cuda_ms(kern, reps=20)
    r["plain_ms"] = cuda_ms(plain, reps=10, warmup=1)
    r["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps=20)
    pairs = b * h * s * s
    t_ops = (2 * pairs * d / PEAK_INT8_OPS_S + 2 * pairs * d / PEAK_BF16_FLOP_S) * 1e3
    t_bytes = (q.numel() * 2 + k_i8.numel() + k_sc.numel() * 4 + v.numel() * 2
               + q.numel() * 2) / PEAK_BYTES_S * 1e3
    r["bound_ms"] = max(t_ops, t_bytes)
    r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    for name, r in results.items():
        log(f"time {name} at {tuple(COG.values())}: {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms, {r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one denoise step into chiprun_out/")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run", file=sys.stderr)
        return 1
    from sageattention_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(_build.SIGNATURES)) as pool:
        list(pool.map(_build.lib, _build.SIGNATURES))
    log(f"build: {list(_build.SIGNATURES)} in {time.perf_counter() - t0:.1f} s wall, "
        f"into {_build.build_dir()}")

    src = "sageattention_tpu_torch/csrc/"
    results = {
        "k_channel_mean": {"route": "cuda", "source": src + "quant_k.cu",
                           "replaces": "sageattention_tpu/ops/quant_pallas.py:272"},
        "quant_k_chunked": {"route": "cuda", "source": src + "quant_k.cu",
                            "replaces": "sageattention_tpu/ops/quant_pallas.py:143"},
        "sage_attn_fwd": {"route": "cuda", "source": src + "attention_fwd.cu",
                          "replaces": "sageattention_tpu/ops/attention_pallas.py:1412"},
    }
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    check_quant(gen, results)
    check_attention(gen, results)
    server = run_server(results, args.profile)
    time_kernels(gen, results)

    kernels = []
    for name, r in results.items():
        r.setdefault("launches", 0)
        kernels.append({"name": name, **r, "max_err": r["max_abs_err"]})
    log(json.dumps({"server": server}))
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
