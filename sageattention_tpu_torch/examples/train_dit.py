"""Training loop: diffusion (flow-matching) training of the video DiT
with sage attention end-to-end — forward AND backward through the fused
quantized kernels (the fused backward, kernels 7-8).

The reference is inference-only; training is this framework's
beyond-reference axis: ``loss.backward()`` through ``sageattn`` runs the
fused backward.  This loop shows the whole story: AdamW, the train step,
loss going down, optional data parallelism (``--dp N``: under ``torchrun
--nproc_per_node N``, NCCL, a card a rank; with ``--device cpu``, gloo).

Checkpoint/resume (the reference has no persistence at all — SURVEY §5):
``--ckpt_dir`` saves the model's and AdamW's state and the step every
``--ckpt_every`` steps and after the last, and resumes from the latest
checkpoint on restart, so a preempted job continues where it stopped.

    python -m sageattention_tpu_torch.examples.train_dit [--steps 20] [--scale 0.1]
        [--attention_type sage] [--dp N] [--lr 1e-4]
        [--ckpt_dir ckpt --ckpt_every 5]
"""

from __future__ import annotations

import torch.distributed as dist

from sageattention_tpu_torch import models, serve, train
from sageattention_tpu_torch.examples.common import base_parser, device_name, scaled_config
from sageattention_tpu_torch.parallel.mesh import make_multihost_mesh


def main(argv=None, *, cfg=None) -> dict:
    """Parse ``argv`` and run; ``cfg`` replaces ``scaled_config("cogvideox-2b",
    --scale)``."""
    ap = base_parser("train a CogVideoX-shaped DiT with sage attention")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel degree (ranks of the torchrun world); "
                         "gradients averaged over them")
    ap.add_argument("--ckpt_dir", default=None,
                    help="checkpoint directory; resumes from the latest step if one exists")
    ap.add_argument("--ckpt_every", type=int, default=5,
                    help="save a checkpoint every N steps")
    args = ap.parse_args(argv)
    if args.steps < 2:
        raise SystemExit("need >= 2 steps to check the loss trend")

    dev = serve.resolve_device(args.device)
    own = args.dp > 1 and not dist.is_initialized()  # a group this run joins, it leaves
    mesh = make_multihost_mesh(data=args.dp, device_type=dev.type) if args.dp > 1 else None
    prev = models.get_attention_backend()
    models.set_attention_backend(args.attention_type)
    # small smoke geometry by default; --scale 1.0 trains the real shape
    cfg = cfg or scaled_config("cogvideox-2b", args.scale)
    trainer = train.load_trainer(cfg, device=dev, seed=2, data=mesh, lr=args.lr)
    b = max(1, args.dp)
    lat, txt = serve.make_requests(cfg, 1, device=dev, seed=0, batch=b)[0]
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"model: depth={cfg.depth} hidden={cfg.hidden} heads={cfg.heads} seq={cfg.seq_len} "
          f"params={n_params/1e6:.1f}M attention={args.attention_type}")
    report = {"depth": cfg.depth, "hidden": cfg.hidden, "seq": cfg.seq_len,
              "params": n_params, "dp": args.dp, "attention": args.attention_type,
              "device": device_name(dev), "start": 0, "losses": [], "step_ms": []}

    start = 0
    if args.ckpt_dir:
        start = train.restore_latest(trainer, args.ckpt_dir)
        if start:
            print(f"resumed from {args.ckpt_dir} at step {start - 1}")
    report["start"] = start
    if start >= args.steps:
        print(f"checkpoint already at step {start - 1}; nothing to do")
        models.set_attention_backend(prev)
        if own:
            dist.destroy_process_group()
        return report

    out = train.train(trainer, lat, txt, args.steps - start, seed=0, data=mesh, start=start,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    models.set_attention_backend(prev)
    if own:
        dist.destroy_process_group()
    losses, ms = out["losses"], out["step_ms"]
    report.update(losses=losses, step_ms=ms)
    print(f"step {start} (kernel build and load included): {ms[0] / 1e3:.1f}s "
          f"loss {losses[0]:.4f}")
    if args.ckpt_dir:
        report["checkpoint_step"] = args.steps - 1
        print(f"checkpointed through step {args.steps - 1} in {args.ckpt_dir}")
    # the first step of a run loads the kernels: the later ones are timed
    if len(ms) > 1:
        report["avg_step_ms"] = sum(ms[1:]) / len(ms[1:])
        print(f"steps {start + 1}..{args.steps - 1}: {report['avg_step_ms']:.0f} ms/step")
    print(f"steps {start}..{args.steps - 1}: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if start == 0:
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"loss did not decrease: {losses}")
        print("loss decreased OK (fused quantized fwd+bwd)")
    return report


if __name__ == "__main__":
    main()
