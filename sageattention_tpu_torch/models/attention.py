"""Pluggable attention backend: the drop-in integration point.

Two ways in, as in the JAX package: :func:`set_attention_backend`
switches every model of this package, and a :class:`SageAttnProcessor`
passed to a module picks the backend for that module alone.

Backends (HND [b, h, s, d] tensors):
  "sage"       -- the default ``sageattn`` (int8 Q.K^T, bf16 P.V)
  "sage_bf16"  -- ``sageattn_qk_int8_pv_bf16``, the same kernels
  "sage_fp8"   -- ``sageattn_qk_int8_pv_fp8``: fp8 e4m3 V codes with
                  per-channel scales (the V quantizer, then the same kernel)
  "sage_parallel" -- ``parallel.make_parallel_sageattn`` over the mesh
                  :func:`set_mesh` bound: data x ring x Ulysses, differentiable
                  (every rank runs the replicated model on the global view, so
                  its parameter gradients come out the same on every rank)
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


# --- the mesh-aware parallel backend -----------------------------------------
_MESH = None
_MESH_AXES = ("data", "seq", "heads")
_PARALLEL_CACHE: dict = {}


def set_mesh(mesh, data_axis="data", ring_axis="seq", ulysses_axis="heads") -> None:
    """Bind a device mesh (``parallel.make_mesh``, or None to unbind): the
    "sage_parallel" backend then runs every attention as data x ring x
    Ulysses over it, each rank passing and getting the global tensors."""
    global _MESH, _MESH_AXES
    _MESH = mesh
    _MESH_AXES = (data_axis, ring_axis, ulysses_axis)
    _PARALLEL_CACHE.clear()


def _sage_parallel(q, k, v, *, is_causal, sm_scale, **kw):
    if _MESH is None:
        raise RuntimeError("call models.set_mesh(mesh) before using the 'sage_parallel' backend")
    from sageattention_tpu_torch.parallel.api import make_parallel_sageattn

    key = (is_causal, sm_scale, tuple(sorted(kw.items())))
    if key not in _PARALLEL_CACHE:
        data_axis, ring_axis, ulysses_axis = _MESH_AXES
        _PARALLEL_CACHE[key] = make_parallel_sageattn(
            _MESH, data_axis=data_axis, ring_axis=ring_axis, ulysses_axis=ulysses_axis,
            is_causal=is_causal, sm_scale=sm_scale, **kw)
    return _PARALLEL_CACHE[key](q, k, v)


register_backend("sage_parallel", _sage_parallel)


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
