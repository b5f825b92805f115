"""Dual-stream and cross-attention video DiTs: the counterpart of the JAX
package's ``models/mmdit.py`` (flax), on the same layouts and with the
numerics of :mod:`models.dit`.

* :class:`DualStreamVideoDiT` (HunyuanVideo's dual-stream blocks, Mochi-1's
  AsymmDiT): text and video keep their own projections and MLPs, and
  attention is joint over the concatenated [text; video] sequence, one
  softmax, split back at the text length.
* :class:`CrossAttnVideoDiT` (Wan2.1): self-attention over the video
  tokens, then cross-attention from the video to the text tokens (sq !=
  sk), which are embedded once and never updated across blocks.

Every attention goes through :func:`models.attention.attention` (or the
block's ``SageAttnProcessor``).  The qk-norms are flax's
``nn.RMSNorm(dtype=q.dtype)``: statistics in fp32, the output cast back to
the model dtype, so ``sageattn`` gets q and k in the model dtype as the JAX
model's attention does.  The modules carry the flax names, so that
``convert.params_from_jax`` maps both trees across as it maps VideoDiT's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sageattention_tpu_torch.models.attention import SageAttnProcessor
from sageattention_tpu_torch.models.attention import attention as _attention
from sageattention_tpu_torch.models.configs import DiTConfig
from sageattention_tpu_torch.models.dit import (Dense, VideoDiT, embed_video_text,
                                                finalize_video, layer_norm)
from sageattention_tpu_torch.models.llm import RMSNorm


class QKNorm(RMSNorm):
    """flax ``nn.RMSNorm(dtype=x.dtype)``: RMSNorm in fp32, output in x's dtype."""

    def forward(self, x):
        return super().forward(x).to(x.dtype)


def _split_heads(x, heads: int, head_dim: int):
    b, s, _ = x.shape
    return x.reshape(b, s, heads, head_dim).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu


class _Block(nn.Module):
    def __init__(self, processor: SageAttnProcessor | None):
        super().__init__()
        self.processor = processor

    def attend(self, q, k, v):
        if self.processor is not None:
            return self.processor(q, k, v)
        return _attention(q, k, v, is_causal=False)


class DualStreamBlock(_Block):
    """One MMDiT block: text and video weights of their own, one joint
    softmax over [text; video]."""

    def __init__(self, cfg: DiTConfig, dtype, processor=None, device=None):
        super().__init__(processor)
        c = cfg
        self.cfg = cfg
        inner, mlp = c.heads * c.head_dim, int(c.hidden * c.mlp_ratio)
        self.adaln = nn.Linear(c.hidden, 12 * c.hidden, device=device)  # fp32
        self.qkv_text = Dense(c.hidden, 3 * inner, dtype, device=device)
        self.qkv_video = Dense(c.hidden, 3 * inner, dtype, device=device)
        self.q_norm = QKNorm(c.head_dim, device)
        self.k_norm = QKNorm(c.head_dim, device)
        self.out_text = Dense(inner, c.hidden, dtype, device=device)
        self.out_video = Dense(inner, c.hidden, dtype, device=device)
        self.mlp_text_up = Dense(c.hidden, mlp, dtype, device=device)
        self.mlp_text_down = Dense(mlp, c.hidden, dtype, device=device)
        self.mlp_video_up = Dense(c.hidden, mlp, dtype, device=device)
        self.mlp_video_down = Dense(mlp, c.hidden, dtype, device=device)

    def forward(self, xt, xv, cond):
        c, dt = self.cfg, xv.dtype
        (tsh1, tsc1, tg1, tsh2, tsc2, tg2,
         vsh1, vsc1, vg1, vsh2, vsc2, vg2) = self.adaln(F.silu(cond))[:, None, :].chunk(12, -1)
        ht = (layer_norm(xt) * (1 + tsc1) + tsh1).to(dt)
        hv = (layer_norm(xv) * (1 + vsc1) + vsh1).to(dt)
        qkv_t = self.qkv_text(ht).chunk(3, dim=-1)
        qkv_v = self.qkv_video(hv).chunk(3, dim=-1)
        q, k, v = (torch.cat([_split_heads(a, c.heads, c.head_dim),
                              _split_heads(b, c.heads, c.head_dim)], dim=2)
                   for a, b in zip(qkv_t, qkv_v))
        o = _merge_heads(self.attend(self.q_norm(q), self.k_norm(k), v))
        st = xt.shape[1]
        xt = xt + tg1.to(dt) * self.out_text(o[:, :st])
        xv = xv + vg1.to(dt) * self.out_video(o[:, st:])
        ht = (layer_norm(xt) * (1 + tsc2) + tsh2).to(dt)
        hv = (layer_norm(xv) * (1 + vsc2) + vsh2).to(dt)
        xt = xt + tg2.to(dt) * self.mlp_text_down(_gelu(self.mlp_text_up(ht)))
        xv = xv + vg2.to(dt) * self.mlp_video_down(_gelu(self.mlp_video_up(hv)))
        return xt, xv


class DualStreamVideoDiT(VideoDiT):
    """HunyuanVideo / Mochi-shaped dual-stream video DiT; ``forward`` as
    :class:`models.dit.VideoDiT`'s."""

    block = DualStreamBlock

    def forward(self, latents, text_emb, t):
        xt, xv = embed_video_text(self, latents, text_emb)
        cond = self.t_embed(t)
        for blk in self.blocks:
            xt, xv = blk(xt, xv, cond)
        return finalize_video(self, xv, latents.shape)


class CrossAttnBlock(_Block):
    """Wan-style block: video self-attention, cross-attention to the text
    (its norm unmodulated, its output ungated), MLP."""

    def __init__(self, cfg: DiTConfig, dtype, processor=None, device=None):
        super().__init__(processor)
        c = cfg
        self.cfg = cfg
        inner, mlp = c.heads * c.head_dim, int(c.hidden * c.mlp_ratio)
        self.adaln = nn.Linear(c.hidden, 6 * c.hidden, device=device)  # fp32
        self.self_qkv = Dense(c.hidden, 3 * inner, dtype, device=device)
        self.q_norm = QKNorm(c.head_dim, device)
        self.k_norm = QKNorm(c.head_dim, device)
        self.self_out = Dense(inner, c.hidden, dtype, device=device)
        self.cross_q = Dense(c.hidden, inner, dtype, device=device)
        self.cross_k = Dense(c.hidden, inner, dtype, device=device)
        self.cross_v = Dense(c.hidden, inner, dtype, device=device)
        self.cross_q_norm = QKNorm(c.head_dim, device)
        self.cross_k_norm = QKNorm(c.head_dim, device)
        self.cross_out = Dense(inner, c.hidden, dtype, device=device)
        self.mlp_up = Dense(c.hidden, mlp, dtype, device=device)
        self.mlp_down = Dense(mlp, c.hidden, dtype, device=device)

    def forward(self, xv, text, cond):
        c, dt = self.cfg, xv.dtype

        def heads(x):
            return _split_heads(x, c.heads, c.head_dim)

        sh1, sc1, g1, sh2, sc2, g2 = self.adaln(F.silu(cond))[:, None, :].chunk(6, dim=-1)
        h = (layer_norm(xv) * (1 + sc1) + sh1).to(dt)
        q, k, v = (heads(x) for x in self.self_qkv(h).chunk(3, dim=-1))
        o = _merge_heads(self.attend(self.q_norm(q), self.k_norm(k), v))
        xv = xv + g1.to(dt) * self.self_out(o)
        # cross-attention: video queries, text keys and values
        h = layer_norm(xv).to(dt)
        qc = self.cross_q_norm(heads(self.cross_q(h)))
        kc = self.cross_k_norm(heads(self.cross_k(text)))
        o = _merge_heads(self.attend(qc, kc, heads(self.cross_v(text))))
        xv = xv + self.cross_out(o)
        h = (layer_norm(xv) * (1 + sc2) + sh2).to(dt)
        return xv + g2.to(dt) * self.mlp_down(_gelu(self.mlp_up(h)))


class CrossAttnVideoDiT(VideoDiT):
    """Wan2.1-shaped video DiT: video self-attention and text
    cross-attention; ``forward`` as :class:`models.dit.VideoDiT`'s."""

    block = CrossAttnBlock

    def forward(self, latents, text_emb, t):
        text, xv = embed_video_text(self, latents, text_emb)
        cond = self.t_embed(t)
        for blk in self.blocks:
            xv = blk(xv, text, cond)
        return finalize_video(self, xv, latents.shape)
