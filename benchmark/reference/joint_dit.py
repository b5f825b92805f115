"""Plain reference of the joint text-video DiT (CogVideoX's layout as the
port's ``models.dit.VideoDiT`` builds it): text tokens prepended to the
patched video, one adaLN-zero modulation of the joint sequence per block,
joint self-attention with LayerNorm qk-norm, a tanh-GELU MLP, the final
norm and unpatchify over the video tokens.  fp32 throughout; parameters
by the port's state-dict names.  With gradients, each block is
recomputed in the backward, so that a deep model's fp32 activations fit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import nn
from benchmark.reference.attention import attention


def param_shapes(m: dict) -> dict:
    hid, inner, mlp = m["hidden"], m["heads"] * m["head_dim"], int(m["hidden"] * m["mlp_ratio"])
    d = m["head_dim"]
    out = nn.trunk_shapes(m)
    for i in range(m["depth"]):
        pre = f"blocks.{i}."
        out.update({
            pre + "adaln.weight": ((6 * hid, hid), "weight"),
            pre + "adaln.bias": ((6 * hid,), "bias"),
            pre + "attn.qkv.weight": ((3 * inner, hid), "weight"),
            pre + "attn.qkv.bias": ((3 * inner,), "bias"),
            pre + "attn.q_norm.weight": ((d,), "norm"), pre + "attn.q_norm.bias": ((d,), "bias"),
            pre + "attn.k_norm.weight": ((d,), "norm"), pre + "attn.k_norm.bias": ((d,), "bias"),
            pre + "attn.out.weight": ((hid, inner), "weight"),
            pre + "attn.out.bias": ((hid,), "bias"),
            pre + "mlp.0.weight": ((mlp, hid), "weight"), pre + "mlp.0.bias": ((mlp,), "bias"),
            pre + "mlp.2.weight": ((hid, mlp), "weight"), pre + "mlp.2.bias": ((hid,), "bias"),
        })
    return out


def block(p, pre: str, x, cond, m: dict, prec, grad: bool):
    h_, d = m["heads"], m["head_dim"]
    mods = nn.linear(F.silu(cond), p[pre + "adaln.weight"], p[pre + "adaln.bias"])[:, None, :]
    sh1, sc1, g1, sh2, sc2, g2 = mods.chunk(6, dim=-1)
    h = nn.layer_norm(x) * (1 + sc1) + sh1
    q, k, v = prec.dense(h, p[pre + "attn.qkv.weight"], p[pre + "attn.qkv.bias"]).chunk(3, dim=-1)
    qn, kn = pre + "attn.q_norm.", pre + "attn.k_norm."
    q = nn.layer_norm(nn.heads(q, h_, d), p[qn + "weight"], p[qn + "bias"])
    k = nn.layer_norm(nn.heads(k, h_, d), p[kn + "weight"], p[kn + "bias"])
    o = nn.merge(attention(q, k, nn.heads(v, h_, d), grad=grad))
    x = x + g1 * prec.dense(o, p[pre + "attn.out.weight"], p[pre + "attn.out.bias"])
    h = nn.layer_norm(x) * (1 + sc2) + sh2
    h = nn.gelu(prec.dense(h, p[pre + "mlp.0.weight"], p[pre + "mlp.0.bias"]))
    return x + g2 * prec.dense(h, p[pre + "mlp.2.weight"], p[pre + "mlp.2.bias"])


def forward(p, latents, text, t, m: dict, prec=nn.EXACT, grad: bool = False):
    """The predicted noise [b, F, H, W, C] fp32 for latents [b, F, H, W, C],
    text [b, Lt, text_dim] and integer timesteps t [b]."""
    xt, xv = nn.embed(p, latents, text, prec, m)
    x = torch.cat([xt, xv], dim=1)
    cond = nn.timestep_embed(p, t, m["hidden"])
    for i in range(m["depth"]):
        if grad:  # keep each block's input only; its backward recomputes the rest
            x = checkpoint(block, p, f"blocks.{i}.", x, cond, m, prec, grad,
                           use_reentrant=False)
        else:
            x = block(p, f"blocks.{i}.", x, cond, m, prec, grad)
    return nn.finalize(p, x[:, xt.shape[1]:], latents.shape, m)


def linears(m: dict, batch: int, text: int, video: int) -> list:
    """(tokens, in, out) of every product of one forward."""
    hid, inner, mlp = m["hidden"], m["heads"] * m["head_dim"], int(m["hidden"] * m["mlp_ratio"])
    tok = batch * (text + video)
    per_block = [(batch, hid, 6 * hid), (tok, hid, 3 * inner), (tok, inner, hid),
                 (tok, hid, mlp), (tok, mlp, hid)]
    return nn.trunk_linears(m, batch, text, video) + per_block * m["depth"]


def attentions(m: dict, batch: int, text: int, video: int) -> list:
    """(b, h, s_q, s_k, d) of every attention call of one forward."""
    s = text + video
    return [(batch, m["heads"], s, s, m["head_dim"])] * m["depth"]
