"""What the job drivers share: the port's configuration of a cell's model,
and the reference's sizes of it."""

from __future__ import annotations


def dims(cell) -> dict:
    """The model as the reference reads it: the configuration's ``run``
    block at the job's depth, with the cell's video positions."""
    return {**cell.model, "video_tokens": cell.geometry.video_tokens}


def port_model(cell):
    """(the port's ``DiTConfig`` of the cell, its model class)."""
    from sageattention_tpu_torch import models, serve
    from sageattention_tpu_torch.models.configs import DiTConfig

    m, g = cell.model, cell.geometry
    if (m["text_dim"], m["latent_channels"]) != (serve.TEXT_DIM, serve.LATENT_CHANNELS):
        raise ValueError(f"the port embeds text of width {serve.TEXT_DIM} and latents of "
                         f"{serve.LATENT_CHANNELS} channels; the configuration says "
                         f"{m['text_dim']} and {m['latent_channels']}")
    cfg = DiTConfig(cell.config["name"], m["hidden"], m["heads"], m["head_dim"], m["depth"],
                    m["text_len"], g.latent_frames, g.latent_height, g.latent_width,
                    patch=m["patch"], patch_t=m["patch_t"], mlp_ratio=m["mlp_ratio"])
    return cfg, getattr(models, m["model"])
