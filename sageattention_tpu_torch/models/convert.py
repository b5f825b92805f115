"""Carry the JAX package's video DiT and CausalLM parameters across to the port.

``params_from_jax`` takes the flax parameter tree as nested dicts of numpy
arrays (``{"params": {...}}`` or the inner dict) and returns a state dict
for :class:`models.dit.VideoDiT`, :class:`models.mmdit.DualStreamVideoDiT`
or :class:`models.mmdit.CrossAttnVideoDiT`:

* a flax ``Dense`` kernel [in, out] becomes a Linear ``weight`` [out, in];
* a flax ``LayerNorm`` ``scale`` becomes ``weight``;
* ``pos_embed`` is copied as it is.

Every leaf stays fp32, as the port's parameters are (the layers that
compute in bf16 cast their weights per call, as flax does).

The flax names, read from a real ``VideoDiT.init`` tree, and their torch
counterparts:

    patch_embed, text_embed, unpatchify, final_norm   same names
    pos_embed                                         pos_embed
    t_embed/Dense_0, t_embed/Dense_1                  t_embed.mlp.0, .2
    block_i/adaln                                     blocks.i.adaln
    block_i/attn/{qkv, q_norm, k_norm, out}           blocks.i.attn.*
    block_i/Dense_0, block_i/Dense_1                  blocks.i.mlp.0, .2

and the mmdit models' blocks, whose torch modules carry the flax names
(``block_i/<name>`` -> ``blocks.i.<name>``, a norm's ``scale`` ->
``weight``), over the same trunk:

    DualStreamBlock  adaln, qkv_text, qkv_video, q_norm, k_norm, out_text,
                     out_video, mlp_text_up, mlp_text_down, mlp_video_up,
                     mlp_video_down
    CrossAttnBlock   adaln, self_qkv, q_norm, k_norm, self_out, cross_q,
                     cross_k, cross_v, cross_q_norm, cross_k_norm, cross_out,
                     mlp_up, mlp_down

``llm_params_from_jax`` does the same for :class:`models.llm.CausalLM`,
whose flax names (from a real ``CausalLM.init`` tree) map as:

    embed/embedding                                   embed.weight
    layer_i/{attn_norm, mlp_norm}/scale               layers.i.*.weight
    layer_i/Dense_0, Dense_1, Dense_2                 layers.i.q_proj, k_proj, v_proj
    layer_i/{o_proj, gate, up, down}                  layers.i.*
    final_norm, lm_head                               same names
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_RENAME = {"Dense_0": "mlp.0", "Dense_1": "mlp.2"}
_LLM_RENAME = {"Dense_0": "q_proj", "Dense_1": "k_proj", "Dense_2": "v_proj"}


def _torch_name(path: list[str], rename=_RENAME) -> str:
    out = []
    for part in path:
        if part.startswith("block_"):
            out += ["blocks", part[len("block_"):]]
        elif part.startswith("layer_"):
            out += ["layers", part[len("layer_"):]]
        else:
            out.append(rename.get(part, part))
    return ".".join(out)


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """flax VideoDiT, DualStreamVideoDiT or CrossAttnVideoDiT parameters
    (numpy leaves) -> torch state dict (fp32)."""
    return _from_jax(tree, _RENAME)


def llm_params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """flax CausalLM parameters (numpy leaves) -> torch state dict (fp32)."""
    return _from_jax(tree, _LLM_RENAME)


def _from_jax(tree: dict, rename: dict) -> dict[str, torch.Tensor]:
    tree = tree.get("params", tree)
    sd: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + [key])
            return
        arr = np.asarray(node, dtype=np.float32)
        *mod, leaf = path
        if leaf == "kernel":
            name, arr = _torch_name(mod, rename) + ".weight", arr.T
        elif leaf in ("scale", "embedding"):
            name = _torch_name(mod, rename) + ".weight"
        else:  # bias, pos_embed
            name = _torch_name(path, rename)
        sd[name] = torch.tensor(np.ascontiguousarray(arr))

    walk(tree, [])
    return sd

