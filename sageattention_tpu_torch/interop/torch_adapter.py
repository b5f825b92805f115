"""``patch_torch_sdpa``: the port's ``sageattn`` installed as
``torch.nn.functional.scaled_dot_product_attention``, with the argument
handling of the JAX package's ``interop/torch_adapter.py``.

The port's own callers of SDPA (the exact-recompute backward in
``ops/autodiff.py``, ``baselines``) bind the original function when they
are imported, so the patch does not reach them: a backward under the
patch is the backward without it.  The ``"sdpa"`` model backend calls the
attribute, as any model does, and so runs ``sageattn`` under the patch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sageattention_tpu_torch import core


def _mask_4d(m: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """An SDPA mask (broadcastable to ``(*batch, L, S)``, where query is
    ``(*batch, L, E)``) as the [b, 1 or h, L or 1, S or 1] mask of the 4-D
    call."""
    nd = query.dim()
    if m.dim() > nd:
        raise ValueError(f"attn_mask {tuple(m.shape)} has more dims than the query's {nd}")
    m = m.reshape((1,) * (nd - m.dim()) + tuple(m.shape))
    if nd == 3:  # (N, L, S): the head axis that the 4-D call adds
        return m.unsqueeze(1)
    if nd > 4:  # the leading batch dims collapse into one
        m = m.expand(*query.shape[:-3], *m.shape[-3:])
        m = m.reshape(-1, *m.shape[-3:])
    return m


def patch_torch_sdpa(**default_kwargs):
    """Replace ``F.scaled_dot_product_attention`` with ``sageattn`` (HND);
    ``default_kwargs`` go to every call (``pv_dtype="fp8"``, say).  Returns
    ``undo()``, which puts the original back.

    As SDPA: any number of leading batch dims (3-D inputs too), a mask
    broadcastable to ``(*batch, L, S)``, bool (True = attend) or additive;
    a float mask holding only 0 and values <= finfo.min / 2 (the padding
    masks of Hugging Face models) is taken as the bool mask ``m == 0``, for
    the masked kernel instead of an additive bias.  GQA runs natively
    (``enable_gqa`` or not); dropout is refused."""
    orig = F.scaled_dot_product_attention

    def _sdpa(query, key, value, attn_mask=None, dropout_p: float = 0.0,
              is_causal: bool = False, scale: float | None = None, enable_gqa: bool = False):
        del enable_gqa  # sageattn groups the KV heads itself
        if dropout_p != 0.0:
            raise NotImplementedError(f"sageattn has no attention dropout; got "
                                      f"dropout_p={dropout_p}")
        if query.dim() < 3:
            raise ValueError(f"scaled_dot_product_attention needs >= 3 dims, got "
                             f"{tuple(query.shape)}")
        kw = dict(default_kwargs)
        if attn_mask is not None:
            m = attn_mask
            if m.dtype != torch.bool and bool(
                    ((m == 0) | (m <= torch.finfo(m.dtype).min / 2)).all()):
                m = m == 0
            kw["attn_mask"] = _mask_4d(m, query)
        lead = query.shape[:-2]
        q, k, v = query, key, value
        if q.dim() == 3:
            q, k, v = (x.unsqueeze(1) for x in (q, k, v))
        elif q.dim() > 4:
            q, k, v = (x.reshape(-1, *x.shape[-3:]) for x in (q, k, v))
        out = core.sageattn(q, k, v, tensor_layout="HND", is_causal=is_causal, sm_scale=scale,
                            **kw)
        return out.reshape(*lead, *out.shape[-2:])

    F.scaled_dot_product_attention = _sdpa

    def undo():
        F.scaled_dot_product_attention = orig

    return undo
