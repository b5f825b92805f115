"""Per-layer attention-processor injection (reference:
example/modify_model/modify_wan.py:9-40, example/mochi.py:11-50).

Instead of the global backend switch, a ``SageAttnProcessor`` is attached
to the model so only its attention layers run the quantized kernel — the
way the reference injects WanAttnProcessor2_0 into individual diffusers
attention modules.  Its ``pv_dtype="int8"`` quantizes V to int8 codes
(the single-pass or the two-pass V quantizer, by V's size).

    python -m sageattention_tpu_torch.examples.modify_model
"""

from __future__ import annotations

import argparse

import torch

from sageattention_tpu_torch import models, serve
from sageattention_tpu_torch.examples.common import device_name, scaled_config
from sageattention_tpu_torch.models.attention import SageAttnProcessor
from sageattention_tpu_torch.utils.compare import cosine_similarity


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.25,
                    help="geometry scale of the Wan2.1-shaped model; 1.0 = full")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the kernels' plain versions)")
    args = ap.parse_args(argv)
    cfg = scaled_config("wan2.1-t2v-1.3b", args.scale)
    dev = serve.resolve_device(args.device)
    # keep the global backend at the baseline; inject sage per layer
    prev = models.get_attention_backend()
    models.set_attention_backend("sdpa")
    proc = SageAttnProcessor(backend="sage", kwargs={"pv_dtype": "int8"})
    model = serve.load_model(cfg, device=dev, seed=2, processor=proc)
    # the same weights on the global (sdpa) backend
    baseline = serve.load_model(cfg, device=dev, state_dict=model.state_dict())
    lat, txt = serve.make_requests(cfg, 1, device=dev, seed=0)[0]
    t = torch.tensor([500], device=dev)
    with torch.no_grad():
        out_sage = model(lat, txt, t)
        out_base = baseline(lat, txt, t)
    models.set_attention_backend(prev)
    cos = cosine_similarity(out_sage.float().cpu(), out_base.float().cpu())
    print(f"wan-shaped DiT, injected SageAttnProcessor: parity vs sdpa cosine={cos:.6f}")
    return {"model": "wan2.1-t2v-1.3b", "seq_len": cfg.seq_len, "depth": cfg.depth,
            "processor": {"backend": proc.backend, "kwargs": proc.kwargs},
            "cosine_vs_sdpa": cos, "device": device_name(dev)}


if __name__ == "__main__":
    main()
