"""Baseline attention: PyTorch's SDPA behind ``sageattn``'s call signature,
the counterpart of the JAX package's ``baselines.py``.

* :func:`sdpa` -- ``F.scaled_dot_product_attention``, whichever backend
  PyTorch picks.
* :func:`flash` -- the same call pinned to the flash backend
  (``SDPBackend.FLASH_ATTENTION``), the FA2-class baseline on an H100.
* :func:`flash_int8_pertensor` -- flash attention on q, k and v quantized
  to int8 with one scale per tensor and dequantized to bf16: the accuracy
  strawman that SageAttention's per-token and per-block scales beat.

All take HND ([b, h, s, d]) or NHD layouts.  A baseline is a library call
by design, not a port of a kernel of the repo.

Deliberate difference from the JAX package: where the flash backend cannot
take the inputs (an fp32 tensor on the card, a head dim it lacks),
:func:`flash` raises instead of falling back to another backend, so that a
baseline's time always names what ran.

The SDPA function is bound when this module is imported, so that
``interop.patch_torch_sdpa`` (which replaces the module attribute with
``sageattn``) never reaches a baseline.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from sageattention_tpu_torch.quant import round_half_away

_SDPA = F.scaled_dot_product_attention


def _to_hnd(x: torch.Tensor, layout: str) -> torch.Tensor:
    if layout not in ("HND", "NHD"):
        raise ValueError(f"tensor_layout must be 'HND' or 'NHD', got {layout!r}")
    return x if layout == "HND" else x.transpose(1, 2)


def _attend(q, k, v, layout: str, is_causal: bool, sm_scale: float | None):
    q, k, v = (_to_hnd(x, layout) for x in (q, k, v))
    o = _SDPA(q, k, v, is_causal=is_causal, scale=sm_scale,
              enable_gqa=q.shape[1] != k.shape[1])
    return _to_hnd(o, layout)


def sdpa(q, k, v, tensor_layout: str = "HND", is_causal: bool = False,
         sm_scale: float | None = None) -> torch.Tensor:
    """``F.scaled_dot_product_attention`` (GQA when k and v have fewer heads)."""
    return _attend(q, k, v, tensor_layout, is_causal, sm_scale)


def flash(q, k, v, tensor_layout: str = "HND", is_causal: bool = False,
          sm_scale: float | None = None) -> torch.Tensor:
    """SDPA on the flash backend alone; raises where it cannot run."""
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return _attend(q, k, v, tensor_layout, is_causal, sm_scale)


def qdq_pertensor(x: torch.Tensor) -> torch.Tensor:
    """x quantized to int8 with one scale for the whole tensor (amax / 127,
    round half away from zero) and dequantized to bf16: the JAX
    ``baselines.py`` ``qdq``."""
    xf = x.float()
    scale = xf.abs().amax().clamp_min(1e-30) / 127.0
    codes = round_half_away(xf / scale).clamp(-127, 127).to(torch.int8)
    return (codes.float() * scale).to(torch.bfloat16)


def flash_int8_pertensor(q, k, v, tensor_layout: str = "HND", is_causal: bool = False,
                         sm_scale: float | None = None) -> torch.Tensor:
    """:func:`flash` on per-tensor int8 q, k and v (:func:`qdq_pertensor`)."""
    return flash(qdq_pertensor(q), qdq_pertensor(k), qdq_pertensor(v), tensor_layout,
                 is_causal, sm_scale)
