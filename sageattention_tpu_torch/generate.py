"""LLM decode serving: the loop of the JAX package's
``examples/llm_decode.py`` without its command line.

``load_llm`` builds a :class:`models.CausalLM` with seeded random weights (or
takes converted ones), ``prefill`` writes a prompt into the quantized
caches (one shot, or in extend blocks through the decode path),
``decode_step`` feeds one token a sequence, and ``generate`` runs greedy
generation over a dense or a paged cache, timing each phase with CUDA
events on the card (the host clock on the CPU).  ``speculate`` is the
speculative loop of ``examples/llm_decode.py --speculate``: greedy tokens
drafted by the model itself and verified in one extend step.
``serve_shards`` is the loop of ``examples/sharded_serving.py``: the
caches of a model's layers sharded TP x SP (``parallel.decode``), over a
mesh (``sharded_serve``) or every shard in turn in one process.  Everything runs under
``torch.inference_mode()``.

Entry points that build state default to ``device="cuda"`` and raise when
no GPU is present, unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import torch

from sageattention_tpu_torch.models.configs import LLMConfig
from sageattention_tpu_torch.models.llm import CausalLM
from sageattention_tpu_torch.serve import init_weights, resolve_device
from sageattention_tpu_torch.speculative import speculative_verify


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


@torch.inference_mode()
def speculate(model: CausalLM, tokens: torch.Tensor, gen: int, *, k: int = 4,
              cache: str = "dense", max_len: int | None = None, page_size: int = 1024,
              page_table: torch.Tensor | None = None, bits: int = 8,
              chunked_prefill: int = 0) -> dict:
    """Greedy speculative decoding of ``gen`` tokens after the prompt [1, s].

    Each round drafts ``k`` tokens with ``k`` decode steps (t_q 1), then
    verifies them with the model in one extend step of t_q = k + 1 (the
    decode kernels' causal tail), which also writes the block's K and V:
    ``speculative_verify`` keeps the matching prefix and the target's next
    token, and the rejected tail rolls back by the lengths alone
    (``lengths = base + 1 + n_accepted``; the caches are written in place
    and the next round overwrites the stale rows).  A round can write k + 1
    rows past the last token, so the caches hold ``max_len`` >= s + gen + k
    rows; the default is that, rounded up to a multiple of 128 (a dense
    cache of more than 4,096 rows needs one).  One token stream: b must be
    1.

    Returns {"tokens": [1, gen + 1] as ``generate`` gives them,
    "n_accepted": each round's, "accepted", "drafted", "acceptance",
    "prefill_ms", "draft_ms" and "verify_ms" (each round's), "tokens_per_s"
    (the tokens the rounds produced over their time), "device"}."""
    b, s = tokens.shape
    if b != 1:
        raise ValueError(f"speculative decoding keeps one token stream: b must be 1, got {b}")
    max_len = max_len or -(-(s + gen + k) // 128) * 128
    if max_len < s + gen + k:
        raise ValueError(f"max_len {max_len} leaves no room for a round's {k + 1} rows past "
                         f"{s + gen - 1} tokens: give at least {s + gen + k}")
    dev = tokens.device
    caches = make_caches(model, b, max_len, cache=cache, page_size=page_size,
                         page_table=page_table, bits=bits)
    clock = _Clock(dev)
    t0 = clock.start()
    logits, caches, lengths = prefill(model, tokens, caches, chunked_prefill=chunked_prefill)
    cur = logits[:, -1:].argmax(dim=-1)
    prefill_ms = clock.ms(t0)
    out, n_accepted, draft_ms, verify_ms = [cur], [], [], []
    while len(out) - 1 < gen:
        t0 = clock.start()
        dlen, dcur, drafts = lengths, cur, []
        for _ in range(k):
            dl, caches, dlen = decode_step(model, dcur, caches, dlen)
            dcur = dl[:, -1:].argmax(dim=-1)
            drafts.append(dcur)
        draft_ms.append(clock.ms(t0))
        t0 = clock.start()
        logits, caches, _ = decode_step(model, torch.cat([cur] + drafts, dim=1), caches,
                                        lengths)
        n_acc, nxt = speculative_verify(torch.cat(drafts, dim=1), logits)
        na = int(n_acc[0])
        verify_ms.append(clock.ms(t0))
        cur = nxt[:, None].long()
        out.extend(drafts[:na] + [cur])
        n_accepted.append(na)
        lengths = lengths + 1 + na
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    accepted, drafted = sum(n_accepted), k * len(n_accepted)
    return {"tokens": torch.cat(out, dim=1)[:, :gen + 1], "n_accepted": n_accepted,
            "accepted": accepted, "drafted": drafted,
            "acceptance": accepted / drafted if drafted else 0.0,
            "prefill_ms": prefill_ms, "draft_ms": draft_ms, "verify_ms": verify_ms,
            "tokens_per_s": (len(out) - 1) / ((sum(draft_ms) + sum(verify_ms)) / 1e3)
            if n_accepted else 0.0,
            "device": name}


def serving_draw(seed: int, layer: int, step: int, shapes, device, dtype=torch.bfloat16):
    """The seeded global tensors of :func:`sharded_serve`: one normal tensor
    of each shape in ``shapes`` for (layer, step), step -1 being the prompt.
    Every rank draws the same ones."""
    g = torch.Generator(device=device)
    g.manual_seed(seed * 1_000_003 + layer * 10_007 + step + 1)
    return [torch.randn(sh, generator=g, device=device).to(dtype) for sh in shapes]


@dataclasses.dataclass
class ShardOps:
    """One (kv-head, sequence) shard of :func:`serve_shards`' caches and the
    functions that write and read it: ``prefill`` and ``append`` are
    ``(cache, lengths, k, v) -> (cache, lengths)``, ``decode`` is ``(q,
    cache, lengths)`` -> o, or the shard's partial (o, m, l) for
    :func:`serve_shards` to merge."""

    head: int
    seq: int
    prefill: Callable
    append: Callable
    decode: Callable


def local_shard_ops(*, head: int = 0, seq: int = 0, n_seq: int = 1, paged: bool = False,
                    window: int | None = None, sharded: bool = True) -> ShardOps:
    """The ops of shard (``head``, ``seq``) of ``n_seq`` sequence shards for
    a process that runs many shards itself: ``parallel.decode``'s local
    bodies, whose partials :func:`serve_shards` merges.  ``sharded=False``:
    the unsharded cache (one shard) through the plain appends and decode
    entry points, its output fp32 as a merge gives it, a dense decode at
    the chunk of ``n_seq`` shards (the merge equals an unsharded decode
    only at the same chunk)."""
    from sageattention_tpu_torch import kvcache
    from sageattention_tpu_torch.ops.decode_cuda import dense_plan
    from sageattention_tpu_torch.parallel import decode as pd

    f32 = torch.float32
    if not sharded:
        if paged:
            return ShardOps(0, 0, lambda c, n, k, v: kvcache.paged_prefill(c, k, v),
                            kvcache.paged_append,
                            lambda q, c, n: kvcache.sageattn_paged_decode(
                                q, c, n, window=window, out_dtype=f32))

        def chunk(q, c):  # the chunk of ``n_seq`` shards': a merge equals this decode
            t_q = q.shape[2]
            rows = q.shape[1] // c.k_i8.shape[1] * t_q
            return dense_plan(c.max_len // n_seq, rows, t_q, 4096, window)[0]

        return ShardOps(0, 0, kvcache.append_kv, kvcache.append_kv,
                        lambda q, c, n: kvcache.sageattn_decode(
                            q, c, n, window=window, chunk=chunk(q, c), out_dtype=f32))
    if paged:
        def start(c):
            return seq * c.pages_k.shape[0]

        return ShardOps(head, seq,
                        lambda c, n, k, v: kvcache.paged_prefill(c, k, v, pool_start=start(c)),
                        lambda c, n, k, v: kvcache.paged_append(c, n, k, v,
                                                                pool_start=start(c)),
                        lambda q, c, n: pd.local_paged_shard_decode(q, c, n, shard=seq,
                                                                    window=window))
    write = functools.partial(pd.local_shard_append, shard=seq, n_shards=n_seq)
    return ShardOps(head, seq, write, write,
                    lambda q, c, n: pd.local_shard_decode(q, c, n, shard=seq, window=window))


def _join(shards, outs):
    """The shards' decode outputs as one tensor: partials (o, m, l) merged
    over the sequence shards, joined over the kv-head shards."""
    from sageattention_tpu_torch.ops.decode_cuda import merge_decode_partials

    cols = []
    for h in sorted({s.head for s in shards}):
        parts = [o for s, o in zip(shards, outs) if s.head == h]
        if isinstance(parts[0], tuple):
            cols.append(merge_decode_partials(*(torch.stack(x) for x in zip(*parts))))
        else:
            cols.append(parts[0])
    return torch.cat(cols, dim=1)


@torch.inference_mode()
def serve_shards(shards: list[ShardOps], *, tp: int = 1, sp: int = 1, b: int = 1,
                 hq: int = 8, hkv: int = 4, d: int = 128, context: int = 8192, gen: int = 8,
                 depth: int = 1, bits: int = 8, paged: bool = False, page_size: int = 256,
                 seed: int = 0, device="cuda") -> dict:
    """The serving loop over ``depth`` independent attention layers whose
    quantized caches are split TP ``tp`` (kv heads) x SP ``sp`` (sequence,
    or the page pool), this process holding ``shards``: one on a mesh
    (:func:`sharded_serve`), or every shard in turn on one card.  A prompt of
    ``context - gen`` tokens (whole pages when ``paged``) is written by each
    shard's ``prefill``, then each of ``gen`` steps appends one token and
    decodes one query a layer.  The inputs are :func:`serving_draw`'s, the
    same for every shard, cut to its heads; the page table is a seeded
    permutation.

    Returns {"outputs": [step][layer] decode outputs of this process's query
    heads, "caches": [shard][layer], "table" (paged), "lengths",
    "prefill_ms", "step_ms", "cache_bytes" (the shards' code bytes),
    "device"}."""
    from sageattention_tpu_torch import kvcache

    dev = resolve_device(device)
    if hkv % tp or context % sp:
        raise ValueError(f"kv heads {hkv} / context {context} must divide by tp {tp} / sp {sp}")

    def heads(n, t):
        return slice(t * n // tp, (t + 1) * n // tp)

    prompt = context - gen
    table = None
    if paged:
        prompt = prompt // page_size * page_size
        n_pg = b * (context // page_size)
        if context % page_size or n_pg % sp:
            raise ValueError(f"{n_pg} pages of {page_size} do not split {sp} ways")
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        table = torch.randperm(n_pg, generator=g, device=dev).reshape(b, -1).int()
    zeros = torch.zeros(b, dtype=torch.int32, device=dev)
    clock = _Clock(dev)
    caches, prefill_ms = [[] for _ in shards], 0.0
    for layer in range(depth):
        k, v = serving_draw(seed, layer, -1, [(b, hkv, prompt, d)] * 2, dev)
        for sh, layers in zip(shards, caches):
            ks, vs = k[:, heads(hkv, sh.head)], v[:, heads(hkv, sh.head)]
            if paged:
                cache = kvcache.init_paged_kv_cache(n_pg // sp, hkv // tp, d, table,
                                                    page_size=page_size, bits=bits, device=dev)
            else:
                cache = kvcache.init_kv_cache(b, hkv // tp, context // sp, d, bits=bits,
                                              device=dev)
            if bits == 4:
                cache = kvcache.calibrate(cache, ks, vs)
            t0 = clock.start()
            cache, lengths = sh.prefill(cache, zeros, ks, vs)
            prefill_ms += clock.ms(t0)
            layers.append(cache)
    step_ms, outputs = [], []
    for step in range(gen):
        t0 = clock.start()
        outs = []
        for layer in range(depth):
            q, k_new, v_new = serving_draw(seed, layer, step, [(b, hq, 1, d), (b, hkv, 1, d),
                                                               (b, hkv, 1, d)], dev)
            for sh, layers in zip(shards, caches):
                kh = heads(hkv, sh.head)
                layers[layer], new_len = sh.append(layers[layer], lengths, k_new[:, kh],
                                                   v_new[:, kh])
            outs.append(_join(shards, [sh.decode(q[:, heads(hq, sh.head)], layers[layer],
                                                 new_len)
                                       for sh, layers in zip(shards, caches)]))
        lengths = new_len
        step_ms.append(clock.ms(t0))
        outputs.append(outs)
    code = "pages_k" if paged else "k_i8"
    return {"outputs": outputs, "caches": caches, "table": table, "lengths": lengths,
            "prefill_ms": prefill_ms, "step_ms": step_ms,
            "cache_bytes": sum(2 * getattr(c, code).numel() for ls in caches for c in ls),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def sharded_serve(mesh, *, axis: str = "seq", head_axis: str | None = "heads",
                  window: int | None = None, paged: bool = False, **kw) -> dict:
    """:func:`serve_shards` on ``mesh``: the sequence (or the page pool)
    split over ``axis``, the kv heads over ``head_axis``; this rank holds
    its own shard, written and read through the four sharded factories
    (``parallel.make_sharded_*``), and gets the merged output of its query
    heads.  The tensors live on the mesh's device type."""
    from sageattention_tpu_torch import parallel
    from sageattention_tpu_torch.parallel.mesh import axis_info

    _, tp, ti = axis_info(mesh, head_axis)
    _, sp, si = axis_info(mesh, axis)
    axes = dict(axis=axis, head_axis=head_axis)
    if paged:
        ops = ShardOps(ti, si, parallel.make_sharded_paged_append(mesh, **axes, prefill=True),
                       parallel.make_sharded_paged_append(mesh, **axes),
                       parallel.make_sharded_paged_decode(mesh, **axes, window=window))
    else:
        append = parallel.make_sharded_append(mesh, **axes)
        ops = ShardOps(ti, si, append, append,
                       parallel.make_sharded_decode(mesh, **axes, window=window))
    device = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
              else "cpu")
    return serve_shards([ops], tp=tp, sp=sp, paged=paged, device=device, **kw)
