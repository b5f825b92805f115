"""The layers the video DiTs share, in fp32, and the precision each product
is computed in.

:class:`Precision` is the reference's own (every product in fp32, TF32
off) or the control's: the products that the configuration states in
bf16 (the ``dense`` projections of every block, the patch and text
embeddings) computed one step lower, with both operands rounded to fp8
e4m3 under one scale a tensor, as a later change to fp8 GEMMs would
compute them.  The products the configuration keeps in fp32 (adaLN, the
timestep MLP, the unpatchify head) stay fp32 in both.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one scale (amax / 448), back in fp32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _straight_through(x: torch.Tensor) -> torch.Tensor:
    """fp8_round in the forward, the identity in the backward."""
    return x + (fp8_round(x) - x).detach()


def linear(x, w, b=None):
    y = x @ w.t()
    return y + b if b is not None else y


class Precision:
    """``dense`` computes the configuration's bf16 products."""

    def __init__(self, control: bool = False):
        self.control = control

    def dense(self, x, w, b=None):
        if self.control:
            x, w = _straight_through(x), _straight_through(w)
        return linear(x, w, b)


EXACT = Precision()
CONTROL = Precision(control=True)


@contextlib.contextmanager
def fp32_matmuls():
    """Full fp32 products (TF32 off) inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def layer_norm(x, w=None, b=None, eps: float = LN_EPS):
    mean = x.mean(dim=-1, keepdim=True)
    xc = x - mean
    y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    if w is not None:
        y = y * w
    return y + b if b is not None else y


def gelu(x):
    return F.gelu(x, approximate="tanh")


def timestep_embed(p, t, hidden: int):
    """Sinusoid of hidden/8 frequencies, then Linear, SiLU, Linear."""
    half = hidden // 8
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    h = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    h = F.silu(linear(h, p["t_embed.mlp.0.weight"], p["t_embed.mlp.0.bias"]))
    return linear(h, p["t_embed.mlp.2.weight"], p["t_embed.mlp.2.bias"])


def patchify(latents, m: dict):
    b, fr, h, w, c = latents.shape
    pp, pt = m["patch"], m["patch_t"]
    x = latents.reshape(b, fr // pt, pt, h // pp, pp, w // pp, pp, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, -1, pt * pp * pp * c)


def unpatchify(x, shape, m: dict):
    b, fr, h, w, c = shape
    pp, pt = m["patch"], m["patch_t"]
    x = x.reshape(b, fr // pt, h // pp, w // pp, pt, pp, pp, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, fr, h, w, c)


def embed(p, latents, text, prec: Precision, m: dict):
    """(text tokens, video tokens) [b, s, hidden]."""
    xv = prec.dense(patchify(latents.float(), m), p["patch_embed.weight"], p["patch_embed.bias"])
    xv = xv + p["pos_embed"][:, : xv.shape[1]]
    xt = prec.dense(text.float(), p["text_embed.weight"], p["text_embed.bias"])
    return xt, xv


def finalize(p, xv, shape, m: dict):
    y = layer_norm(xv, p["final_norm.weight"], p["final_norm.bias"])
    return unpatchify(linear(y, p["unpatchify.weight"], p["unpatchify.bias"]), shape, m)


def heads(x, h: int, d: int):
    b, s, _ = x.shape
    return x.reshape(b, s, h, d).transpose(1, 2)


def merge(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def trunk_shapes(m: dict) -> dict:
    """Name -> (shape, kind) of the parameters outside the blocks."""
    hid, pd = m["hidden"], m["patch_t"] * m["patch"] ** 2 * m["latent_channels"]
    half = hid // 8
    return {
        "patch_embed.weight": ((hid, pd), "weight"), "patch_embed.bias": ((hid,), "bias"),
        "pos_embed": ((1, m["video_tokens"], hid), "pos"),
        "text_embed.weight": ((hid, m["text_dim"]), "weight"),
        "text_embed.bias": ((hid,), "bias"),
        "t_embed.mlp.0.weight": ((hid, 2 * half), "weight"), "t_embed.mlp.0.bias": ((hid,), "bias"),
        "t_embed.mlp.2.weight": ((hid, hid), "weight"), "t_embed.mlp.2.bias": ((hid,), "bias"),
        "final_norm.weight": ((hid,), "norm"), "final_norm.bias": ((hid,), "bias"),
        "unpatchify.weight": ((pd, hid), "weight"), "unpatchify.bias": ((pd,), "bias"),
    }


def trunk_linears(m: dict, batch: int, text: int, video: int) -> list:
    """(tokens, in, out) of the trunk's products in one forward."""
    hid, pd = m["hidden"], m["patch_t"] * m["patch"] ** 2 * m["latent_channels"]
    return [(batch * video, pd, hid), (batch * text, m["text_dim"], hid),
            (batch, 2 * (hid // 8), hid), (batch, hid, hid), (batch * video, hid, pd)]
