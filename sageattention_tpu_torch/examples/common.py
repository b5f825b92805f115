"""Shared example runner (reference: example/cogvideox-2b.py structure —
model load, attention backend switch, timed denoise loop, wall-clock and
peak-memory report, reference: parallel_sageattn_cogvideo.py:70-108).
The counterpart of the JAX package's ``examples/common.py``.

The reference runs real diffusers pipelines off HuggingFace weights; the
examples download nothing, so they run the port's model families
(``sageattention_tpu_torch.models``) at the real model geometry (or
``--scale`` reduced) with seeded random weights: the attention workload,
shapes and backend switching are the reference's, only the weights differ.

Everything runs on ``--device`` (``cuda`` by default; ``cpu`` runs the
kernels' plain PyTorch versions).  Step times come from CUDA events on the
card and the host clock on the CPU; peak memory from
``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import argparse
import time

import torch

from sageattention_tpu_torch import models, serve
from sageattention_tpu_torch.generate import Clock
from sageattention_tpu_torch.models.configs import MODEL_CONFIGS
from sageattention_tpu_torch.utils.compare import cosine_similarity
from sageattention_tpu_torch.utils.profiling import trace


def base_parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument(
        "--attention_type",
        default="sage",
        choices=["sage", "sage_bf16", "sage_fp8", "sdpa", "flash", "reference"],
        help="attention backend (reference: example/cogvideox-2b.py:13-23 "
        "attention_type in {sdpa, sage, fa3, fa3_fp8})",
    )
    ap.add_argument("--steps", type=int, default=4,
                    help="denoise steps to run (timed)")
    ap.add_argument("--scale", type=float, default=0.25,
                    help="geometry scale for smoke runs; 1.0 = full model")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--compare", action="store_true",
                    help="also run the sdpa backend and report output parity")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler trace of one step to this directory")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the kernels' plain versions)")
    return ap


def scaled_config(name: str, scale: float):
    cfg = MODEL_CONFIGS[name]
    if scale >= 1.0:
        return cfg
    def s(x, q=1):
        return max(q, int(x * scale) // q * q)
    pt = getattr(cfg, "patch_t", 1)
    return cfg.scaled(
        depth=max(2, int(cfg.depth * scale)),
        # frames stay a multiple of the temporal patch
        latent_frames=max(2, s(cfg.latent_frames, pt)),
        latent_height=s(cfg.latent_height, 2),
        latent_width=s(cfg.latent_width, 2),
        text_len=max(16, int(cfg.text_len * scale)),
    )


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_video_example(name: str, args, model_cls=None, *, cfg=None, state_dict=None,
                      inputs=None) -> dict:
    """Load ``name`` (``scaled_config(name, args.scale)``, or ``cfg``) as
    ``model_cls`` (default ``VideoDiT``) and run the example's loop: one
    first step at t 999 (the kernels' build and load included), one
    profiled step at t 500 with ``--profile``, ``--steps`` timed steps on
    the runner's schedule, and with ``--compare`` eps at t 500 against the
    "sdpa" backend.  ``state_dict`` (converted weights) and ``inputs``
    (latents, text embedding) replace the seeded ones; the model then
    computes in the latents' dtype.  Returns what it printed, and the
    final ``latents``."""
    cfg = cfg or scaled_config(name, args.scale)
    model_cls = model_cls or models.VideoDiT
    dev = serve.resolve_device(args.device)
    print(f"model={name} ({model_cls.__name__}) seq_len={cfg.seq_len} "
          f"heads={cfg.heads} head_dim={cfg.head_dim} depth={cfg.depth} "
          f"backend={args.attention_type} device={device_name(dev)}")
    prev = models.get_attention_backend()
    models.set_attention_backend(args.attention_type)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dtype = inputs[0].dtype if inputs is not None else torch.bfloat16
    model = serve.load_model(cfg, device=dev, dtype=dtype, seed=2, state_dict=state_dict,
                             model_cls=model_cls)
    b = args.batch
    if inputs is None:
        lat, txt = serve.make_requests(cfg, 1, device=dev, seed=0, batch=b)[0]
    else:
        lat, txt = (x.to(dev) for x in inputs)
    report = {"model": name, "class": model_cls.__name__, "seq_len": cfg.seq_len,
              "heads": cfg.heads, "head_dim": cfg.head_dim, "depth": cfg.depth,
              "backend": args.attention_type, "device": device_name(dev)}

    def at(t):
        return torch.full((b,), t, device=dev)

    t0 = time.perf_counter()
    lat = serve.denoise_step(model, lat, txt, at(999))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report["first_step_s"] = time.perf_counter() - t0
    print(f"first step (kernel build and load included): {report['first_step_s']:.2f} s")

    report["profile"] = None
    if args.profile:
        with trace(args.profile) as path:
            lat = serve.denoise_step(model, lat, txt, at(500))
        report["profile"] = path
        print(f"profile written to {path}")

    clock, step_ms = Clock(dev), []
    for t in serve.timesteps(args.steps, b, dev):
        c0 = clock.start()
        lat = serve.denoise_step(model, lat, txt, t)
        step_ms.append(clock.ms(c0))
    report["step_ms"] = step_ms
    report["avg_step_ms"] = sum(step_ms) / len(step_ms) if step_ms else None
    if step_ms:
        print(f"avg denoise step: {report['avg_step_ms']:.1f} ms "
              f"({args.steps} steps, seq {cfg.seq_len})")

    report["cosine_vs_sdpa"] = None
    if args.compare:
        with torch.no_grad():
            models.set_attention_backend("sdpa")
            eps_ref = model(lat, txt, at(500))
            models.set_attention_backend(args.attention_type)
            eps = model(lat, txt, at(500))
        report["cosine_vs_sdpa"] = cosine_similarity(eps.float().cpu(), eps_ref.float().cpu())
        print(f"output parity vs sdpa: cosine={report['cosine_vs_sdpa']:.6f}")

    report["peak_gib"] = None
    if dev.type == "cuda":
        report["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"peak device memory: {report['peak_gib']:.2f} GiB")
    models.set_attention_backend(prev)
    report["latents"] = lat
    return report
