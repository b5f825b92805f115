"""LLM serving loop: prefill + token-at-a-time decode over the int8 KV
cache (beyond the reference, which covers prefill only).

The decode step streams the quantized cache once per token — int8 K/V
halves the bytes and the footprint vs a bf16 cache, which is the decode
bottleneck at long context.

``--paged`` switches the per-layer caches to the vLLM-style paged pool
(page-table appends + decode gather) — same loop, same tokens, pages can
live anywhere in the pool.

    python -m sageattention_tpu_torch.examples.llm_decode [--scale 0.1]
        [--prompt_len 512] [--gen 32] [--max_len 4096] [--paged]
        [--page_size 1024] [--bits 4] [--chunked_prefill N] [--speculate K]
"""

from __future__ import annotations

import argparse

import torch

from sageattention_tpu_torch import generate
from sageattention_tpu_torch.examples.common import device_name
from sageattention_tpu_torch.models.configs import MODEL_CONFIGS
from sageattention_tpu_torch.serve import resolve_device


def scaled_llm(scale: float):
    """llm-7b at ``scale``: heads, hidden and depth scaled, kv heads a
    quarter of the heads (GQA) below full size."""
    base = MODEL_CONFIGS["llm-7b"]
    heads = max(4, int(base.heads * scale) // 2 * 2)
    if scale >= 1.0:
        kv_heads = base.kv_heads  # full model: the advertised architecture
    else:
        kv_heads = max(2, heads // 4)  # keep hq a multiple of hkv (GQA)
    return base.scaled(
        depth=max(2, int(base.depth * scale)),
        hidden=max(128, int(base.hidden * scale) // 128 * 128),
        heads=heads,
        kv_heads=kv_heads,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="model size factor vs llm-7b (1.0 = full)")
    ap.add_argument("--prompt_len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max_len", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV pool (vLLM-style)")
    ap.add_argument("--page_size", type=int, default=1024)
    ap.add_argument("--bits", type=int, default=8, choices=(8, 4),
                    help="cache storage width (4 = packed int4: half "
                         "the footprint and cache-read bytes; means "
                         "auto-calibrated on the prompt)")
    ap.add_argument("--chunked_prefill", type=int, default=0,
                    metavar="N",
                    help="prefill the prompt in N-token extend blocks "
                         "through the quantized cache (the vLLM extend "
                         "phase) instead of one full-attention pass")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens (self-draft), "
                         "verify them in ONE t_q=K+1 extend step (greedy "
                         "acceptance + rollback by the lengths)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = scaled_llm(args.scale)
    print(f"model: depth={cfg.depth} hidden={cfg.hidden} heads={cfg.heads} "
          f"kv_heads={cfg.kv_heads} head_dim={cfg.head_dim}")
    dev = resolve_device(args.device)
    model = generate.load_llm(cfg, device=dev, seed=1)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=g,
                         device=dev)
    kw = dict(cache="paged" if args.paged else "dense", max_len=args.max_len,
              page_size=args.page_size, bits=args.bits, chunked_prefill=args.chunked_prefill)
    mode = (f"chunked ({args.chunked_prefill}-token extend blocks)" if args.chunked_prefill
            else "one-shot")
    kind = (f"paged int{args.bits} cache, {args.page_size}-token pages"
            if args.paged else f"int{args.bits} KV cache")
    report = {"config": {"depth": cfg.depth, "hidden": cfg.hidden, "heads": cfg.heads,
                         "kv_heads": cfg.kv_heads, "head_dim": cfg.head_dim},
              "cache": kind, "prefill_mode": mode, "device": device_name(dev)}
    if args.speculate:
        k = args.speculate
        out = generate.speculate(model, toks, args.gen, k=k, **kw)
        rounds = len(out["n_accepted"])
        # the first round loads the decode path: its time is left out, as the
        # runner leaves out the first round's compile
        ms = sum(out["draft_ms"][1:]) + sum(out["verify_ms"][1:])
        n = sum(out["n_accepted"][1:]) + rounds - 1
        context = args.prompt_len + rounds + out["accepted"]
        print(f"prefill {args.prompt_len} tokens ({mode}): {out['prefill_ms'] / 1e3:.2f}s "
              f"(kernel build and load included)")
        print(f"decode: {n} tokens (after the first round) in {ms / 1e3:.3f}s, speculative "
              f"K={k}: {out['accepted']}/{out['drafted']} drafts accepted ({kind}, "
              f"context {context})")
        report.update(speculate=k, rounds=rounds, accepted=out["accepted"],
                      drafted=out["drafted"], acceptance=out["acceptance"])
    else:
        out = generate.generate(model, toks, args.gen, **kw)
        # the first step loads the decode path: timed from the second on
        n, ms = args.gen - 1, sum(out["step_ms"][1:])
        context = args.prompt_len + args.gen
        print(f"prefill {args.prompt_len} tokens ({mode}): {out['prefill_ms'] / 1e3:.2f}s "
              f"(kernel build and load included)")
        print(f"decode: {n} tokens in {ms / 1e3:.3f}s = "
              f"{n * args.batch / max(ms / 1e3, 1e-9):.1f} tok/s ({kind}, context {context})")
    ids = out["tokens"][0].tolist()
    print("generated token ids:", ids[:16], "...")
    report.update(prefill_ms=out["prefill_ms"], decode_tokens=n, decode_ms=ms,
                  context=context, tokens=ids)
    return report


if __name__ == "__main__":
    main()
