"""LLM decode serving: the loop of the JAX package's
``examples/llm_decode.py`` without its command line.

``load_llm`` builds a :class:`models.CausalLM` with seeded random weights (or
takes converted ones), ``prefill`` writes a prompt into the quantized
caches (one shot, or in extend blocks through the decode path),
``decode_step`` feeds one token a sequence, and ``generate`` runs greedy
generation over a dense or a paged cache, timing each phase with CUDA
events on the card (the host clock on the CPU).  Everything runs under
``torch.inference_mode()``.

Entry points that build state default to ``device="cuda"`` and raise when
no GPU is present, unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import time

import torch

from sageattention_tpu_torch.models.configs import LLMConfig
from sageattention_tpu_torch.models.llm import CausalLM
from sageattention_tpu_torch.serve import init_weights, resolve_device


def load_llm(cfg: LLMConfig, *, device="cuda", seed: int = 0, dtype=torch.bfloat16,
             state_dict: dict | None = None) -> CausalLM:
    """A CausalLM on ``device`` in eval mode, with seeded random weights
    (``serve.init_weights``: N(0, 1/fan_in) matrices and embedding, norm
    scales 1) or the given (converted) ``state_dict``."""
    dev = resolve_device(device)
    model = CausalLM(cfg, dtype=dtype, device=dev)
    if state_dict is None:
        init_weights(model, seed)
    else:
        model.load_state_dict(state_dict)
    return model.eval()


def make_caches(model: CausalLM, b: int, max_len: int, *, cache: str = "dense",
                page_size: int = 1024, page_table: torch.Tensor | None = None,
                bits: int = 8):
    if cache == "dense":
        return model.init_caches(b, max_len, bits=bits)
    if cache == "paged":
        return model.init_paged_caches(b, max_len, page_size=page_size, page_table=page_table,
                                       bits=bits)
    raise ValueError(f"cache must be 'dense' or 'paged', got {cache!r}")


@torch.inference_mode()
def prefill(model: CausalLM, tokens: torch.Tensor, caches, lengths=None,
            chunked_prefill: int = 0):
    """Write the prompt [b, s] into empty ``caches``: one full-attention
    pass, or ``chunked_prefill``-token extend blocks through the decode
    kernels.  Returns (logits of the last block, caches, lengths)."""
    b, s = tokens.shape
    if lengths is None:
        lengths = torch.zeros(b, dtype=torch.int32, device=tokens.device)
    if not chunked_prefill:
        logits, caches = model(tokens, caches=caches, lengths=lengths)
        return logits, caches, lengths + s
    n = chunked_prefill
    if s % n:
        raise ValueError(f"prompt length {s} is not a multiple of the extend block {n}")
    for i in range(0, s, n):
        logits, caches = model(tokens[:, i:i + n], caches=caches, lengths=lengths, decode=True)
        lengths = lengths + n
    return logits, caches, lengths


@torch.inference_mode()
def decode_step(model: CausalLM, cur: torch.Tensor, caches, lengths):
    """Feed ``cur`` [b, t] at ``lengths``: (logits, caches, lengths + t)."""
    logits, caches = model(cur, caches=caches, lengths=lengths, decode=True)
    return logits, caches, lengths + cur.shape[1]


class _Clock:
    """Phase times from CUDA events on the card, the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, t0) -> float:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            return t0.elapsed_time(ev)
        return (time.perf_counter() - t0) * 1e3


@torch.inference_mode()
def generate(model: CausalLM, tokens: torch.Tensor, gen: int, *, cache: str = "dense",
             max_len: int | None = None, page_size: int = 1024,
             page_table: torch.Tensor | None = None, bits: int = 8,
             chunked_prefill: int = 0) -> dict:
    """Greedy generation of ``gen`` tokens after the prompt [b, s].

    Returns {"tokens": [b, gen + 1] (the prefill's pick, then one a decode
    step), "prefill_ms", "step_ms" (each decode step), "tokens_per_s" (b *
    gen over the decode steps' time), "logits" (the last step's), "device"}.
    ``max_len`` defaults to s + gen."""
    b, s = tokens.shape
    dev = tokens.device
    max_len = max_len or s + gen
    caches = make_caches(model, b, max_len, cache=cache, page_size=page_size,
                         page_table=page_table, bits=bits)
    clock = _Clock(dev)
    t0 = clock.start()
    logits, caches, lengths = prefill(model, tokens, caches, chunked_prefill=chunked_prefill)
    cur = logits[:, -1:].argmax(dim=-1)
    prefill_ms = clock.ms(t0)
    out, step_ms = [cur], []
    for _ in range(gen):
        t0 = clock.start()
        logits, caches, lengths = decode_step(model, cur, caches, lengths)
        cur = logits[:, -1:].argmax(dim=-1)
        step_ms.append(clock.ms(t0))
        out.append(cur)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"tokens": torch.cat(out, dim=1), "prefill_ms": prefill_ms, "step_ms": step_ms,
            "tokens_per_s": b * gen / (sum(step_ms) / 1e3) if gen else 0.0,
            "logits": logits, "device": name}
