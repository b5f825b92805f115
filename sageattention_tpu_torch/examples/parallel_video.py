"""Multi-device video DiT inference: DP/CFG x ring x Ulysses sage attention
(reference: example/parallel_sageattn_cogvideo.py + run_parallel.sh).

Where the reference launches xDiT under torchrun with --ulysses_degree /
--ring_degree / --use_cfg_parallel, here the degrees are dims of one
("data", "seq", "heads") device mesh over the torchrun world and the
model's attention runs through the "sage_parallel" backend (the KV ring,
the head all-to-all and the batch split over "data").

One process a rank: under ``torchrun --nproc_per_node N`` (NCCL, a card a
rank), or ``--device cpu`` for a gloo validation world
(``examples/run_parallel.sh``).  A process group that already exists is
reused.  The degrees must multiply to the world size.

    torchrun --nproc_per_node 4 -m sageattention_tpu_torch.examples.parallel_video \\
        --ring_degree 2 --ulysses_degree 2
"""

from __future__ import annotations

import argparse
import time

import torch.distributed as dist

from sageattention_tpu_torch import serve
from sageattention_tpu_torch.examples.common import device_name, scaled_config
from sageattention_tpu_torch.models.configs import MODEL_CONFIGS, DiTConfig
from sageattention_tpu_torch.parallel.mesh import make_multihost_mesh


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--model", default="cogvideox-2b",
        # video DiTs only (LLM configs have their own examples)
        choices=[n for n, c in MODEL_CONFIGS.items() if isinstance(c, DiTConfig)],
    )
    ap.add_argument("--ring_degree", type=int, default=2,
                    help="KV-ring (context parallel) degree "
                    "(reference: run_parallel.sh --ring_degree)")
    ap.add_argument("--ulysses_degree", type=int, default=1,
                    help="head all-to-all degree "
                    "(reference: --ulysses_degree)")
    ap.add_argument("--cfg_parallel", action="store_true",
                    help="shard the CFG pair over the data axis "
                    "(reference: --use_cfg_parallel)")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--smoke", action="store_true",
                    help="shrink hidden/heads too (a quick validation world)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default, NCCL) or 'cpu' (gloo, the kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = serve.resolve_device(args.device)
    data = 2 if args.cfg_parallel else 1
    need = data * args.ring_degree * args.ulysses_degree
    own = not dist.is_initialized()  # a group this run joins, it leaves
    mesh = make_multihost_mesh(data, args.ring_degree, args.ulysses_degree,
                               device_type=dev.type)
    rank = dist.get_rank()
    if rank == 0:
        print(f"mesh: data={data} ring={args.ring_degree} "
              f"ulysses={args.ulysses_degree} over {need} ranks")

    cfg = scaled_config(args.model, args.scale)
    if args.smoke:
        cfg = cfg.scaled(hidden=256, heads=4, head_dim=64)
    # the heads must divide by the Ulysses degree and the sequence by the
    # sequence-parallel degree (the reference validates the same,
    # reference: parallel_sageattn_cogvideo.py:32-36): the text is padded
    cfg = serve.parallel_config(cfg, mesh)
    model = serve.load_model(cfg, device=dev, seed=2)
    # CFG = 2 prompt branches in the batch (split over "data" with
    # cfg_parallel; the reference's cfg_degree=2, run_parallel.sh:40-42)
    requests = serve.make_requests(cfg, 1, device=dev, seed=0, batch=2)

    t0 = time.perf_counter()
    first = serve.serve_parallel(model, requests, 1, mesh)
    first_s = time.perf_counter() - t0
    lat = first["outputs"][0]
    out = serve.serve_parallel(model, [(lat, requests[0][1])], args.steps, mesh)
    ms = sum(out["step_ms"]) / max(args.steps, 1)
    if rank == 0:
        print(f"first step (kernel build and load included): {first_s:.2f} s "
              f"(seq {cfg.seq_len})")
        print(f"avg parallel denoise step: {ms:.1f} ms")
    report = {"model": args.model, "seq_len": cfg.seq_len, "data": data,
              "ring": args.ring_degree, "ulysses": args.ulysses_degree, "rank": rank,
              "world": dist.get_world_size(), "first_step_s": first_s,
              "step_ms": out["step_ms"], "avg_step_ms": ms, "latents": out["outputs"][0],
              "device": device_name(dev)}
    if own:
        dist.destroy_process_group()
    return report


if __name__ == "__main__":
    main()
