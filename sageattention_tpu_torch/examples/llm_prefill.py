"""LLM prefill with causal sage attention — SageAttention's second headline
use case (reference: the causal bench sweeps, bench_qk_int8_pv_fp8_cuda.py
is_causal=True).

Runs a llama-7B-shaped (or GQA llama-3-8B-shaped) decoder prefill and
reports per-forward time and logit parity vs the sdpa backend.

    python -m sageattention_tpu_torch.examples.llm_prefill --model llm-8b-gqa --compare
"""

from __future__ import annotations

import argparse
import time

import torch

from sageattention_tpu_torch import generate, models
from sageattention_tpu_torch.examples.common import device_name
from sageattention_tpu_torch.models.configs import MODEL_CONFIGS
from sageattention_tpu_torch.serve import resolve_device
from sageattention_tpu_torch.utils.compare import cosine_similarity


def main(argv=None, *, cfg=None) -> dict:
    """Parse ``argv`` and run; ``cfg`` replaces the ``--model`` / ``--depth``
    configuration."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llm-7b",
                    choices=["llm-7b", "llm-8b-gqa"])
    ap.add_argument("--attention_type", default="sage",
                    choices=["sage", "sage_bf16", "sage_fp8", "sdpa"])
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--depth", type=int, default=4,
                    help="layers to run (full model: 32)")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = cfg or MODEL_CONFIGS[args.model].scaled(depth=args.depth)
    dev = resolve_device(args.device)
    prev = models.get_attention_backend()
    models.set_attention_backend(args.attention_type)
    model = generate.load_llm(cfg, device=dev, seed=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq), generator=gen, device=dev)

    def fwd():
        with torch.inference_mode():
            return model(tokens)

    t0 = time.perf_counter()
    logits = fwd()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    first_s = time.perf_counter() - t0
    print(f"first prefill (kernel build and load included): {first_s:.2f} s")

    clock, n = generate.Clock(dev), 3
    c0 = clock.start()
    for _ in range(n):
        logits = fwd()
    ms = clock.ms(c0) / n
    tok_s = args.batch * args.seq / (ms / 1e3)
    print(f"prefill: {ms:.1f} ms ({tok_s/1e3:.1f}k tok/s, seq {args.seq}, depth {cfg.depth}, "
          f"backend {args.attention_type})")
    report = {"model": cfg.name, "seq": args.seq, "batch": args.batch, "depth": cfg.depth,
              "backend": args.attention_type, "first_prefill_s": first_s, "prefill_ms": ms,
              "tokens_per_s": tok_s, "cosine_vs_sdpa": None, "device": device_name(dev)}

    if args.compare:
        models.set_attention_backend("sdpa")
        ref = fwd()
        report["cosine_vs_sdpa"] = cosine_similarity(logits.float().cpu(), ref.float().cpu())
        print(f"logit parity vs sdpa: cosine={report['cosine_vs_sdpa']:.6f}")
    models.set_attention_backend(prev)
    return report


if __name__ == "__main__":
    main()
