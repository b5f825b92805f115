"""Pluggable attention backend: the drop-in integration point.

Two ways in, as in the JAX package: :func:`set_attention_backend`
switches every model of this package, and a :class:`SageAttnProcessor`
passed to a module picks the backend for that module alone.

Backends (HND [b, h, s, d] tensors):
  "sage"       -- the default ``sageattn`` (int8 Q.K^T, bf16 P.V)
  "sage_bf16"  -- ``sageattn_qk_int8_pv_bf16``, the same kernels
  "sage_fp8"   -- ``sageattn_qk_int8_pv_fp8``: fp8 e4m3 V codes with
                  per-channel scales (the V quantizer, then the same kernel)
  "reference"  -- exact fp32 attention (``ops.reference``)

The registry is process-wide state, as in the JAX package: tests that
change the backend set it back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from sageattention_tpu_torch import core
from sageattention_tpu_torch.ops import reference as ref_mod

_BACKENDS: dict[str, Callable] = {}
_CURRENT = "sage"


def register_backend(name: str, fn: Callable) -> None:
    _BACKENDS[name] = fn


def set_attention_backend(name: str) -> None:
    """Globally select the attention implementation."""
    global _CURRENT
    if name not in _BACKENDS:
        raise ValueError(f"unknown backend {name!r}; have {sorted(_BACKENDS)}")
    _CURRENT = name


def get_attention_backend() -> str:
    return _CURRENT


def attention(q, k, v, *, is_causal=False, sm_scale=None, backend=None, **kw):
    """Scaled-dot-product attention on HND tensors through the selected
    backend."""
    name = backend or _CURRENT
    if name not in _BACKENDS:
        raise ValueError(f"unknown backend {name!r}; have {sorted(_BACKENDS)}")
    return _BACKENDS[name](q, k, v, is_causal=is_causal, sm_scale=sm_scale, **kw)


register_backend(
    "sage",
    lambda q, k, v, *, is_causal, sm_scale, **kw: core.sageattn(
        q, k, v, is_causal=is_causal, sm_scale=sm_scale, **kw
    ),
)
register_backend(
    "sage_bf16",
    lambda q, k, v, *, is_causal, sm_scale, **kw: core.sageattn_qk_int8_pv_bf16(
        q, k, v, is_causal=is_causal, sm_scale=sm_scale, **kw
    ),
)
register_backend(
    "sage_fp8",
    lambda q, k, v, *, is_causal, sm_scale, **kw: core.sageattn_qk_int8_pv_fp8(
        q, k, v, is_causal=is_causal, sm_scale=sm_scale, **kw
    ),
)
register_backend(
    "reference",
    lambda q, k, v, *, is_causal, sm_scale, **kw: ref_mod.attention_reference(
        q, k, v, is_causal=is_causal, sm_scale=sm_scale, **kw
    ),
)


@dataclasses.dataclass
class SageAttnProcessor:
    """Per-layer attention processor: calls :func:`attention` with its own
    backend and options."""

    backend: str = "sage"
    is_causal: bool = False
    kwargs: dict = dataclasses.field(default_factory=dict)

    def __call__(self, q, k, v, sm_scale=None):
        return attention(q, k, v, is_causal=self.is_causal, sm_scale=sm_scale,
                         backend=self.backend, **self.kwargs)
