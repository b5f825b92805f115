"""Decoder-only LLM as ``nn.Module``s: the counterpart of the JAX package's
``models/llm.py`` (flax), with the same branches and numerics.

Llama-style: RMSNorm, RoPE, GQA, SwiGLU.  Two paths:

* prefill: full-sequence causal attention through
  :func:`models.attention.attention` (the selected backend), filling the
  quantized KV caches as it goes when they are given;
* decode: ``decode=True`` attends the cache through
  ``kvcache.sageattn_decode`` (kernels 9 and 10) or
  ``kvcache.sageattn_paged_decode`` (kernels 11 and 12); t > 1 tokens get
  the causal tail, so chunked-prefill extend blocks go this way too.

Where flax and torch differ, this follows flax: RMSNorm takes its
statistics in fp32 with eps 1e-6 and returns fp32; parameters are fp32 and
the projections compute in the model dtype (:class:`dit.Dense`, flax's
``nn.Dense(dtype=bf16)``); the ``lm_head`` computes in fp32.  The
embedding indexes the fp32 table and casts after, which gives flax's
numbers.  The caches are written in place (see ``kvcache``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sageattention_tpu_torch import kvcache
from sageattention_tpu_torch.models.attention import attention as _attention
from sageattention_tpu_torch.models.configs import LLMConfig
from sageattention_tpu_torch.models.dit import Dense

RMS_EPS = 1e-6


def rope_angles(positions: torch.Tensor, d: int, base: float = 10000.0):
    """(sin, cos) [b, 1, s, d/2] of the rotary embedding at positions [b, s]
    (the JAX package's base 10000).  The same for every layer, so the model
    computes them once a forward."""
    half = d // 2
    freqs = torch.pow(
        torch.full((), base, dtype=torch.float32, device=positions.device),
        -torch.arange(half, dtype=torch.float32, device=positions.device) / half,
    )
    ang = positions.float()[:, None, :, None] * freqs
    return torch.sin(ang), torch.cos(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0, angles=None) -> torch.Tensor:
    """Rotary embedding of x [b, h, s, d] at positions [b, s], pairs split
    in halves; ``angles`` from :func:`rope_angles` if already computed."""
    half = x.shape[-1] // 2
    sin, cos = angles if angles is not None else rope_angles(positions, x.shape[-1], base)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([(x1 * cos - x2 * sin).to(x.dtype), (x2 * cos + x1 * sin).to(x.dtype)],
                     dim=-1)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(dtype=float32)``: ``x * (rsqrt(mean(x^2) + eps) *
    scale)`` in fp32."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x = x.float()
        mul = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + RMS_EPS) * self.weight
        return x * mul


class LLMBlock(nn.Module):
    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        c = cfg
        self.cfg, self.dtype = cfg, dtype
        self.attn_norm = RMSNorm(c.hidden, device)
        self.q_proj = Dense(c.hidden, c.heads * c.head_dim, dtype, device, bias=False)
        self.k_proj = Dense(c.hidden, c.kv_heads * c.head_dim, dtype, device, bias=False)
        self.v_proj = Dense(c.hidden, c.kv_heads * c.head_dim, dtype, device, bias=False)
        self.o_proj = Dense(c.heads * c.head_dim, c.hidden, dtype, device, bias=False)
        self.mlp_norm = RMSNorm(c.hidden, device)
        mh = c.mlp_hidden or 4 * c.hidden
        self.gate = Dense(c.hidden, mh, dtype, device, bias=False)
        self.up = Dense(c.hidden, mh, dtype, device, bias=False)
        self.down = Dense(mh, c.hidden, dtype, device, bias=False)

    def forward(self, x, positions, cache=None, lengths=None, decode: bool = False, angles=None):
        c = self.cfg
        b, s, _ = x.shape
        h = self.attn_norm(x).to(self.dtype)

        def to_hnd(t, nh):
            return t.reshape(b, s, nh, c.head_dim).transpose(1, 2)

        q = rope(to_hnd(self.q_proj(h), c.heads), positions, angles=angles)
        k = rope(to_hnd(self.k_proj(h), c.kv_heads), positions, angles=angles)
        v = to_hnd(self.v_proj(h), c.kv_heads)
        W = c.window
        wkw = {} if W is None else {"window": W}
        if decode and cache is None:
            # decoding without a cache would attend only the current tokens
            raise ValueError(
                "decode=True requires caches (init_caches / init_paged_caches); got None"
            )
        new_cache = None
        if cache is not None and cache.bits == 4 and lengths is not None:
            # int4 cache: freeze the channel means on each batch's first
            # write (lengths == 0); live batches keep theirs
            cache = kvcache.calibrate(cache, k, v, lengths)
        if isinstance(cache, kvcache.PagedKVCache):
            if not decode and s % cache.page_size == 0:
                new_cache, new_len = kvcache.paged_prefill(cache, k, v)
            else:
                new_cache, new_len = kvcache.paged_append(cache, lengths, k, v)
            if decode:
                o = kvcache.sageattn_paged_decode(q, new_cache, new_len, window=W)
            else:
                o = _attention(q, k, v, is_causal=True, **wkw)
        elif cache is not None:
            new_cache, new_len = kvcache.append_kv(cache, lengths, k, v)
            if decode:
                o = kvcache.sageattn_decode(q, new_cache, new_len, window=W)
            else:
                # prefill attends the prompt directly; the cache is filled
                o = _attention(q, k, v, is_causal=True, **wkw)
        else:
            o = _attention(q, k, v, is_causal=True, **wkw)
        o = o.transpose(1, 2).reshape(b, s, c.heads * c.head_dim)
        x = x + self.o_proj(o)
        h = self.mlp_norm(x).to(self.dtype)
        down = self.down(F.silu(self.gate(h)) * self.up(h))
        return x + down, new_cache


class CausalLM(nn.Module):
    """forward(tokens [b, s], caches=None, lengths=None, decode=False).

    Prefill: ``forward(tokens)`` -> fp32 logits [b, s, vocab]; with
    ``caches`` (per-layer ``QuantKVCache`` or ``PagedKVCache``) the prompt
    is also written into them (lengths default to 0) and (logits, caches)
    is returned.  Decode or continuation: ``decode=True`` with the current
    ``lengths`` attends the cache.  The caller advances ``lengths``."""

    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        c = cfg
        self.cfg, self.dtype = cfg, dtype
        self.embed = nn.Embedding(c.vocab, c.hidden, device=device)
        self.layers = nn.ModuleList(LLMBlock(c, dtype, device) for _ in range(c.depth))
        self.final_norm = RMSNorm(c.hidden, device)
        self.lm_head = Dense(c.hidden, c.vocab, torch.float32, device, bias=False)

    def forward(self, tokens, caches=None, lengths=None, decode: bool = False):
        b, s = tokens.shape
        x = self.embed(tokens).to(self.dtype)
        steps = torch.arange(s, device=tokens.device)
        if lengths is None:
            if caches is not None:
                lengths = torch.zeros(b, dtype=torch.int32, device=tokens.device)
            positions = steps.expand(b, s)
        else:
            positions = lengths[:, None] + steps[None, :]
        angles = rope_angles(positions, self.cfg.head_dim)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            x, nc = layer(x, positions, cache=caches[i] if caches is not None else None,
                          lengths=lengths, decode=decode, angles=angles)
            if new_caches is not None:
                new_caches.append(nc)
        logits = self.lm_head(self.final_norm(x))
        return (logits, new_caches) if caches is not None else logits

    def _device(self):
        return self.embed.weight.device

    def init_caches(self, b: int, max_len: int, bits: int = 8):
        c = self.cfg
        return [kvcache.init_kv_cache(b, c.kv_heads, max_len, c.head_dim, bits=bits,
                                      device=self._device()) for _ in range(c.depth)]

    def init_paged_caches(self, b: int, max_len: int, page_size: int = 1024,
                          page_table: torch.Tensor | None = None, bits: int = 8):
        """Per-layer page pools for ``b`` sequences of ``max_len`` tokens; a
        linear page table (sequence i owns pages [i*n, (i+1)*n)) unless
        ``page_table`` [b, n] gives another assignment."""
        c = self.cfg
        n = -(-max_len // page_size)
        if page_table is None:
            page_table = torch.arange(b * n, dtype=torch.int32).reshape(b, n)
        return [kvcache.init_paged_kv_cache(b * n, c.kv_heads, c.head_dim, page_table,
                                            page_size=page_size, bits=bits,
                                            device=self._device()) for _ in range(c.depth)]
