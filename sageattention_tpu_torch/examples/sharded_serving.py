"""Sequence/tensor-parallel serving: one attention layer's KV cache
sharded TP x SP (``parallel/decode.py``).

Long-context serving exhausts one card's memory long before its FLOPs —
this demo shards the int8 (or ``--bits 4``) cache TP x SP: each shard
holds 1/(tp*sp) of the cache, decodes its part with the decode kernel,
and one exact LSE merge combines the partials.  Appends route to the
owning shard bit-exactly, so the loop produces the same numbers one
card holding the whole cache would.

Run as one process, it holds every shard and runs them in turn on one
device.  Under ``torchrun --nproc_per_node tp*sp`` (NCCL, a card a rank;
gloo with ``--device cpu``) each rank holds its own shard of a
("data", "seq", "heads") mesh.

    python -m sageattention_tpu_torch.examples.sharded_serving [--tp 2] [--sp 4]
        [--context 8192] [--gen 8] [--bits 4] [--window 1024]
        [--paged [--page_size 256]]
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from sageattention_tpu_torch import generate
from sageattention_tpu_torch.examples.common import device_name
from sageattention_tpu_torch.parallel.mesh import make_multihost_mesh
from sageattention_tpu_torch.serve import resolve_device

B, HQ, HKV, D = 1, 8, 4, 128


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tp", type=int, default=2,
                    help="tensor-parallel degree (kv-head sharding)")
    ap.add_argument("--sp", type=int, default=4,
                    help="sequence-parallel degree (cache sharding)")
    ap.add_argument("--context", type=int, default=8192)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--bits", type=int, default=8, choices=(8, 4))
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--paged", action="store_true",
                    help="shard a vLLM-style paged pool instead of the "
                         "dense cache (scrambled physical pages; each "
                         "shard owns a block of pages and reads only "
                         "those)")
    ap.add_argument("--page_size", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the kernels' plain versions)")
    args = ap.parse_args(argv)
    n = args.tp * args.sp
    dev = resolve_device(args.device)
    kw = dict(b=B, hq=HQ, hkv=HKV, d=D, context=args.context, gen=args.gen, bits=args.bits,
              paged=args.paged, page_size=args.page_size)
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        own = not dist.is_initialized()  # a group this run joins, it leaves
        mesh = make_multihost_mesh(1, args.sp, args.tp, device_type=dev.type)
        out = generate.sharded_serve(mesh, axis="seq", head_axis="heads", window=args.window,
                                     **kw)
        if own:
            dist.destroy_process_group()
        where = f"a {args.tp}x{args.sp} mesh"
    else:
        shards = [generate.local_shard_ops(head=h, seq=s, n_seq=args.sp, paged=args.paged,
                                           window=args.window)
                  for h in range(args.tp) for s in range(args.sp)]
        out = generate.serve_shards(shards, tp=args.tp, sp=args.sp, device=dev, **kw)
        where = f"{args.tp}x{args.sp} shards in turn on one device"
    kind = (f"paged int{args.bits}, {args.page_size}-token pages" if args.paged
            else f"int{args.bits}")
    # the prompt ends where the decode steps begin
    prompt = int(out["lengths"][0]) - args.gen
    per_shard = out["cache_bytes"] / len(out["caches"])
    print(f"prefilled {prompt} tokens into {where} ({per_shard / 2**20:.1f} MiB cache/shard, "
          f"{kind})")
    report = {"tp": args.tp, "sp": args.sp, "shards": n, "prompt": prompt, "cache": kind,
              "cache_mib_per_shard": per_shard / 2**20, "prefill_ms": out["prefill_ms"],
              "step_ms": out["step_ms"], "device": device_name(dev)}
    if args.gen < 1:
        print("nothing to decode (--gen 0)")
        return report
    o = out["outputs"][-1][0]
    ms = sum(out["step_ms"]) / args.gen
    w = f", window={args.window}" if args.window else ""
    norm = float(torch.linalg.norm(o.float()))
    print(f"decoded {args.gen} steps at context {int(out['lengths'][0])}{w}: {ms:.1f} ms/step")
    print("output head norm:", norm)
    report.update(context=int(out["lengths"][0]), avg_step_ms=ms, output_norm=norm,
                  output=o)
    return report


if __name__ == "__main__":
    main()
