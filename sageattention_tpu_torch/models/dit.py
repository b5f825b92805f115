"""Video DiT as ``nn.Module``s: the counterpart of the JAX package's
``models/dit.py`` (flax), on the same layouts and with the same numerics.

A CogVideoX-style joint text-video diffusion transformer: 3D patch
embedding of the video latents, text tokens prepended, adaLN-zero
conditioning from a timestep embedding, joint non-causal self-attention
with qk-norm through :func:`models.attention.attention`, tanh-GELU MLP,
unpatchify head.

Where flax and torch differ, this follows flax: LayerNorm has eps 1e-6
and takes its statistics in fp32 as E[x^2] - E[x]^2; ``nn.gelu`` is the
tanh approximation; ``adaln``, ``t_embed`` and the final norm and
unpatchify run in fp32 and the rest in the model dtype.  Every parameter
is fp32, as flax's default ``param_dtype``: the layers that compute in the
model dtype cast their weights per call (:class:`Dense`), so a training
step's small updates are not lost to bf16 rounding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sageattention_tpu_torch.models.attention import SageAttnProcessor
from sageattention_tpu_torch.models.attention import attention as _attention
from sageattention_tpu_torch.models.configs import DiTConfig

LN_EPS = 1e-6


def layer_norm(x, weight=None, bias=None, eps: float = LN_EPS):
    """flax ``nn.LayerNorm`` over the last axis, returned in fp32."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight
    y = (x - mean) * mul
    return y + bias if bias is not None else y


class LayerNorm(nn.Module):
    """flax-style LayerNorm with fp32 scale/bias, output in ``dtype``
    (None: fp32)."""

    def __init__(self, dim: int, dtype=None, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.dtype = dtype

    def forward(self, x):
        y = layer_norm(x, self.weight, self.bias)
        return y if self.dtype is None else y.to(self.dtype)


def embed_video_text(mdl: "VideoDiT", latents, text_emb):
    """3D patchify + patch and positional embedding of the video, linear
    embedding of the text.  Returns (xt, xv) in the model dtype."""
    cfg, dtype = mdl.cfg, mdl.dtype
    b, Fr, H, W, C = latents.shape
    p, pt = cfg.patch, cfg.patch_t
    xv = latents.reshape(b, Fr // pt, pt, H // p, p, W // p, p, C)
    xv = xv.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        b, (Fr // pt) * (H // p) * (W // p), pt * p * p * C
    )
    xv = mdl.patch_embed(xv)
    xv = xv + mdl.pos_embed[:, : xv.shape[1]].to(dtype)
    xt = mdl.text_embed(text_emb)
    return xt, xv


def finalize_video(mdl: "VideoDiT", xv, video_shape):
    """Final norm + unpatchify back to the latent video shape, in fp32."""
    b, Fr, H, W, C = video_shape
    p, pt = mdl.cfg.patch, mdl.cfg.patch_t
    out = mdl.unpatchify(mdl.final_norm(xv))
    out = out.reshape(b, Fr // pt, H // p, W // p, pt, p, p, C)
    return out.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, Fr, H, W, C)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: fp32 parameters, and the input, weight
    and bias cast to ``compute_dtype`` for each call (``promote_dtype``)."""

    def __init__(self, d_in: int, d_out: int, compute_dtype, device=None, bias: bool = True):
        super().__init__(d_in, d_out, bias=bias, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class TimestepEmbed(nn.Module):
    """Sinusoidal timestep embedding (``dim // 8`` frequencies) and a
    two-layer SiLU MLP, in fp32."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.half = dim // 8
        self.mlp = nn.Sequential(
            nn.Linear(2 * self.half, dim, device=device),
            nn.SiLU(),
            nn.Linear(dim, dim, device=device),
        )

    def forward(self, t):
        half = self.half
        freqs = torch.exp(
            -math.log(10000.0)
            * torch.arange(half, dtype=torch.float32, device=t.device) / half
        )
        ang = t.float()[:, None] * freqs[None, :]
        return self.mlp(torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1))


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, head_dim: int, dtype,
                 processor: SageAttnProcessor | None = None, device=None):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        inner = heads * head_dim
        self.qkv = Dense(hidden, 3 * inner, dtype, device=device)
        self.q_norm = LayerNorm(head_dim, dtype, device=device)
        self.k_norm = LayerNorm(head_dim, dtype, device=device)
        self.out = Dense(inner, hidden, dtype, device=device)
        self.processor = processor

    def forward(self, x):
        b, s, _ = x.shape
        q, k, v = self.qkv(x).chunk(3, dim=-1)

        def to_hnd(t):
            return t.reshape(b, s, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = to_hnd(q), to_hnd(k), to_hnd(v)
        q, k = self.q_norm(q), self.k_norm(k)
        if self.processor is not None:
            o = self.processor(q, k, v)
        else:
            o = _attention(q, k, v, is_causal=False)
        return self.out(o.transpose(1, 2).reshape(b, s, -1))


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, dtype, processor=None, device=None):
        super().__init__()
        c = cfg
        self.adaln = nn.Linear(c.hidden, 6 * c.hidden, device=device)  # fp32
        self.attn = Attention(c.hidden, c.heads, c.head_dim, dtype, processor, device)
        mlp_hidden = int(c.hidden * c.mlp_ratio)
        self.mlp = nn.Sequential(
            Dense(c.hidden, mlp_hidden, dtype, device=device),
            nn.GELU(approximate="tanh"),
            Dense(mlp_hidden, c.hidden, dtype, device=device),
        )

    def forward(self, x, cond):
        dt = x.dtype
        mods = self.adaln(F.silu(cond))[:, None, :]
        sh1, sc1, g1, sh2, sc2, g2 = mods.chunk(6, dim=-1)
        # adaLN-zero norms carry no affine parameters
        h = (layer_norm(x) * (1 + sc1) + sh1).to(dt)
        x = x + g1.to(dt) * self.attn(h)
        h = (layer_norm(x) * (1 + sc2) + sh2).to(dt)
        return x + g2.to(dt) * self.mlp(h)


class VideoDiT(nn.Module):
    """Joint text-video diffusion transformer.

    forward(latents [b, F, H, W, C], text_emb [b, Lt, text_dim], t [b])
      -> predicted noise [b, F, H, W, C] fp32

    The trunk (patch, positional, text and timestep embeddings, final norm,
    unpatchify) is shared with ``models.mmdit``'s models, which set their
    own ``block`` class and forward.
    """

    block = DiTBlock

    def __init__(self, cfg: DiTConfig, *, latent_channels: int = 16,
                 text_dim: int = 512, dtype=torch.bfloat16,
                 processor: SageAttnProcessor | None = None, device=None):
        super().__init__()
        c = cfg
        self.cfg, self.dtype = cfg, dtype
        patch_dim = c.patch_t * c.patch * c.patch * latent_channels
        self.patch_embed = Dense(patch_dim, c.hidden, dtype, device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, c.video_tokens, c.hidden, device=device)
        )
        self.text_embed = Dense(text_dim, c.hidden, dtype, device=device)
        self.t_embed = TimestepEmbed(c.hidden, device=device)
        self.blocks = nn.ModuleList(
            self.block(c, dtype, processor, device) for _ in range(c.depth)
        )
        self.final_norm = LayerNorm(c.hidden, device=device)
        self.unpatchify = nn.Linear(c.hidden, patch_dim, device=device)

    def forward(self, latents, text_emb, t):
        xt, xv = embed_video_text(self, latents, text_emb)
        x = torch.cat([xt, xv], dim=1)
        cond = self.t_embed(t)
        for blk in self.blocks:
            x = blk(x, cond)
        # the final norm is per token: slicing before it equals after
        return finalize_video(self, x[:, xt.shape[1]:], latents.shape)
