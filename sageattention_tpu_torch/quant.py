"""Numerical spec of the quantizers, in PyTorch.

A copy of the JAX package's ``quant.py`` for the functions the port's
``sageattn`` needs, quantized V among them.  The CUDA kernels (``ops/quant_cuda.py``,
``ops/attention_cuda.py``) compute exactly this chain, so the CPU tests
check the same numbers the card produces:

* ``inv_scale``: ``scale = max(amax, 1e-30) * (1/qmax)``, then ``1/scale``,
  in that order, in fp32;
* codes: ``round_half_away(x * (1/scale))``, clipped to ``[-qmax, qmax]``.

``sm_scale * log2(e)`` is folded into the Q scales so the attention
softmax runs in base 2.
"""

from __future__ import annotations

import numpy as np
import torch

LOG2E = 1.4426950408889634
INT8_QMAX = 127.0
INT4_QMAX = 7.0


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero.

    ``torch.round`` rounds exact .5 ties to even; those ties are moved to
    ``trunc(x) + sign(x)``.  ``floor(|x| + 0.5)`` is not used: the add
    rounds 0.49999997 up to 1.0 in fp32."""
    r = torch.round(x)
    tie = (x - torch.trunc(x)).abs() == 0.5
    return torch.where(tie, torch.trunc(x) + torch.sign(x), r)


def f32_scalar(value: float, device) -> torch.Tensor:
    """``value`` rounded to fp32, as a 0-d tensor on ``device``.  Filled on
    the device: ``torch.tensor(value, device=cuda)`` would copy from the
    host and wait for the stream."""
    return torch.full((), value, dtype=torch.float32, device=device)


def inv_scale(amax: torch.Tensor, qmax: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, 1/scale) from an fp32 amax, in the spec's order."""
    scale = torch.clamp_min(amax, 1e-30) * f32_scalar(1.0 / qmax, amax.device)
    return scale, 1.0 / scale


def fold_multiplier(scale_fold: float, qmax: float = INT8_QMAX) -> float:
    """The fp32 product ``f32(1/qmax) * f32(scale_fold)``.

    The spec writes the folded scale as ``(max(amax,1e-30) * (1/qmax)) *
    scale_fold``; XLA compiles that constant chain as ``max(amax,1e-30) *
    ((1/qmax) * scale_fold)``, which can differ in the last bit.  The port
    computes the compiled form, on the CPU and in the kernel, so that its
    scales equal the JAX function's bit for bit."""
    return float(np.float32(1.0 / qmax) * np.float32(scale_fold))


def qk_qmax(bits: int) -> float:
    """The largest Q / K code: 127, or 7 for ``bits=4`` (int4 values kept
    in int8, ``quant.py:50`` of the JAX package)."""
    if bits not in (4, 8):
        raise ValueError(f"qk_bits must be 8 or 4, got {bits!r}")
    return INT4_QMAX if bits == 4 else INT8_QMAX


def _group_amax(x: torch.Tensor, group: int) -> torch.Tensor:
    """amax over groups of ``group`` rows x head dim, expanded per row to
    [.., s]; a ragged last group takes its amax over its live rows."""
    if group <= 1:
        return x.abs().amax(dim=-1)
    b, h, s, d = x.shape
    pad = (-s) % group
    g = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(b, h, -1, group, d)
    return g.abs().amax(dim=(-1, -2)).repeat_interleave(group, dim=-1)[..., :s]


GRANULARITIES = ("per_token", "per_subtile", "per_block")


def group_rows(granularity: str, block_size: int = 32) -> int:
    """The rows that share a scale at ``granularity``: one (``per_token``),
    ``block_size`` (``per_subtile``) or ``max(block_size, 128)``
    (``per_block``)."""
    if granularity not in GRANULARITIES:
        raise ValueError(f"unknown granularity {granularity!r}")
    return {"per_token": 1, "per_subtile": block_size,
            "per_block": max(block_size, 128)}[granularity]


def quant_int8(x: torch.Tensor, *, granularity: str = "per_token", block_size: int = 32,
               scale_fold: float = 1.0, bits: int = 8):
    """[b,h,s,d] -> (int8 [b,h,s,d], f32 per-row scales [b,h,s] with
    ``scale_fold`` multiplied in).  ``granularity``: one scale a row
    (``per_token``), a group of ``block_size`` rows (``per_subtile``) or of
    ``max(block_size, 128)`` rows (``per_block``), expanded per row;
    ``bits=4`` codes to +-7."""
    group = group_rows(granularity, block_size)
    qmax = qk_qmax(bits)
    x = x.float()
    amax = _group_amax(x, group)
    scale, r = inv_scale(amax, qmax)
    q = round_half_away(x * r[..., None])
    q = q.clamp(-qmax, qmax).to(torch.int8)
    folded = torch.clamp_min(amax, 1e-30) * f32_scalar(fold_multiplier(scale_fold, qmax),
                                                      x.device)
    return q, folded


def quant_int8_block_scales(x: torch.Tensor, *, group: int, bits: int = 8):
    """One scale per ``group`` rows: [b,h,s,d] -> (int8 [b,h,s,d], f32
    scales [b,h,ceil(s/group)]).  A ragged last group takes its amax over
    its live rows only (the spec zero-pads, and zeros never raise amax)."""
    qmax = qk_qmax(bits)
    x = x.float()
    b, h, s, d = x.shape
    pad = (-s) % group
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    g = xp.reshape(b, h, -1, group, d)
    amax = g.abs().amax(dim=(-1, -2))
    scale, r = inv_scale(amax, qmax)
    q = round_half_away(g * r[..., None, None])
    q = q.clamp(-qmax, qmax).to(torch.int8)
    return q.reshape(b, h, s + pad, d)[:, :, :s], scale


def sub_mean(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Subtract the per-(b,h,d) mean over the sequence axis, in fp32."""
    x = x.float()
    mean = x.mean(dim=-2)
    return x - mean[..., None, :], mean


# pv_dtype -> V code type
V_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}
# the largest magnitude of each V code type; its position here is the
# kernels' code for it (csrc/quant_v.cu; csrc/attention_fwd.cu counts bf16
# V as 0 and these from 1)
QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}
V_CODE_TYPES = tuple(QMAX)


def v_codes(scaled: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """V codes from ``x * (1/scale)``: int8 ``round_half_away``, clipped to
    +-127; fp8 the cast, which rounds to nearest even."""
    if dtype == torch.int8:
        return round_half_away(scaled).clamp(-INT8_QMAX, INT8_QMAX).to(torch.int8)
    return scaled.to(dtype)


def per_channel_quant(v: torch.Tensor, *, dtype=torch.int8, smooth: bool = False):
    """Per-(b,h,d)-channel quantization of V [b,h,s,d]: (codes in
    ``dtype``, scales [b,h,d] fp32, the smooth-v mean [b,h,d] or None).
    ``dtype`` is int8, ``float8_e4m3fn`` or ``float8_e5m2``."""
    v = v.float()
    v_mean = None
    if smooth:
        v, v_mean = sub_mean(v)
    amax = v.abs().amax(dim=-2)
    scale, r = inv_scale(amax, QMAX[dtype])
    return v_codes(v * r[..., None, :], dtype), scale, v_mean


def quantize_qk(q: torch.Tensor, k: torch.Tensor, *, sm_scale: float,
                granularity: str = "per_token", block_size: int = 32, smooth_k: bool = True,
                bits: int = 8):
    """Q and K quantized outside the kernel (``quant.py:264-296`` of the JAX
    package): K smoothed by its mean, Q with ``sm_scale * log2(e)`` folded
    into its scales.  Returns (q_i8, q_scale [b,hq,sq], k_i8, k_scale
    [b,hkv,sk], km [b,hkv,d] or None), the scales per row."""
    k_s, km = sub_mean(k) if smooth_k else (k, None)
    kw = dict(granularity=granularity, block_size=block_size, bits=bits)
    q_i8, q_scale = quant_int8(q, scale_fold=sm_scale * LOG2E, **kw)
    k_i8, k_scale = quant_int8(k_s, **kw)
    return q_i8, q_scale, k_i8, k_scale, km
