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
  "sdpa"       -- ``F.scaled_dot_product_attention`` as this module finds it
                  when called, as any PyTorch model calls it: under
                  ``interop.patch_torch_sdpa`` that is ``sageattn``.  A
                  ``window`` goes in as a bool band mask (each query sees its
                  last ``window`` keys, itself included); GQA natively
  "flash"      -- ``baselines.flash``: SDPA pinned to the flash backend (which
                  raises where it cannot run), KV heads repeated for GQA
  "reference"  -- exact fp32 attention (``ops.reference``)

The registry is process-wide state, as in the JAX package: tests that
change the backend set it back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from sageattention_tpu_torch import baselines, core
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


def _window_band(sq: int, sk: int, window: int, device) -> torch.Tensor:
    """[sq, sk] bool: query i sees keys i - window + 1 .. i (the JAX
    ``local_window_size=(window - 1, 0)`` with ``is_causal``)."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    return (j <= i) & (j > i - window)


def _sdpa(q, k, v, *, is_causal, sm_scale, window=None, **kw):
    if kw:
        # dropping a kwarg (a mask, say) would answer with other attention
        raise TypeError(f"sdpa backend does not support {sorted(kw)}")
    mask = None
    if window is not None:
        if not is_causal:
            raise ValueError("window requires is_causal=True")
        mask, is_causal = _window_band(q.shape[2], k.shape[2], window, q.device), False
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=is_causal,
                                          scale=sm_scale, enable_gqa=q.shape[1] != k.shape[1])


def _flash(q, k, v, *, is_causal, sm_scale, **kw):
    if kw:
        raise TypeError(f"flash backend does not support {sorted(kw)}")
    rep = q.shape[1] // k.shape[1]
    if rep != 1:
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    return baselines.flash(q, k, v, is_causal=is_causal, sm_scale=sm_scale)


register_backend("sdpa", _sdpa)
register_backend("flash", _flash)


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


# sageattn's options, and the JAX package's TPU launch options, which
# sageattn refuses as it does everywhere
_SAGE_OPTS = frozenset({"pv_dtype", "qk_quant_gran", "qk_bits", "smooth_k", "smooth_q",
                        "smooth_v", "window", "block_q", "block_k", "impl"})


def sage_attention_fn(query, key, value, bias=None, mask=None, *, dropout_rate: float = 0.0,
                      deterministic: bool = True, is_causal: bool = False,
                      sm_scale: float | None = None, dtype=None, **sage_kwargs):
    """flax ``attention_fn`` convention on torch tensors: q, k, v
    ``[batch..., s, heads, head_dim]``, a ``mask`` (nonzero = attend, a
    float 0/1 mask too) and an additive ``bias``, each broadcastable to
    ``[batch..., heads, sq, sk]``.  Runs ``sageattn`` in NHD; kwargs that
    are not ``sageattn`` options are dropped, attention dropout is
    refused."""
    sage_kwargs = {k_: v_ for k_, v_ in sage_kwargs.items() if k_ in _SAGE_OPTS}
    if dropout_rate != 0.0 and not deterministic:
        raise NotImplementedError("sage attention has no attention-weight dropout")
    *batch, sq, _, _ = query.shape
    sk = key.shape[-3]
    lead = len(batch)

    def flat(x):  # [batch..., s, h, d] -> NHD [b, s, h, d]
        return x.reshape((-1,) + tuple(x.shape[lead:]))

    def flat_mask(m):  # -> [b, 1 or h, sq, sk]
        while m.dim() < lead + 3:
            m = m[None]
        m = m.expand(*batch, m.shape[-3], sq, sk)
        return m.reshape((-1,) + tuple(m.shape[lead:]))

    kw = dict(sage_kwargs)
    if mask is not None:
        # flax masks are boolean whatever their dtype (make_attention_mask
        # gives float 0/1); a float attn_mask would be an additive bias here
        kw["attn_mask"] = flat_mask(mask) != 0
    if bias is not None:
        kw["attn_bias"] = flat_mask(bias)
    out = core.sageattn(flat(query), flat(key), flat(value), tensor_layout="NHD",
                        is_causal=is_causal, sm_scale=sm_scale, **kw)
    out = out.reshape(tuple(batch) + tuple(out.shape[1:]))
    return out.to(dtype) if dtype is not None else out
