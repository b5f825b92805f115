"""Public API: ``sageattn`` and ``sageattn_qk_int8_pv_{bf16,int8,fp8}``.

The ``sageattn`` of the JAX package (int8 Q.K^T with per-row Q scales and
per-group K scales, K mean-smoothing, P.V in bf16 with V stored as bf16
or as per-channel int8 / fp8 codes, optional V mean-smoothing), on
``torch.Tensor``s, forward and backward.  It runs where its inputs live:
CUDA tensors go through the hand-written kernels (``ops/quant_cuda.py``,
``ops/attention_cuda.py``, ``ops/attention_bwd_cuda.py``), CPU tensors
through their plain versions, which compute the same numbers.

Differentiable: when grad is enabled and an input requires it, the call
goes through ``ops.autodiff.SageAttnFunction``, whose backward is the
straight-through gradient of the quantized forward (the JAX package's
fused backward), for q, k and v, and through the LSE with ``return_lse``.

Layouts HND ([b, h, s, d]) and NHD ([b, s, h, d]); GQA (hq a multiple of
hkv); top-left causal masking; any sq / sk; ``return_lse`` gives the
natural-log LSE with the smooth-k correction; ``pv_dtype`` bf16 / int8 /
fp8 / fp8_e5m2 and ``smooth_v``.  V is quantized from the caller's V,
before any head-dim padding, as in the JAX package.  Head dims below 64,
or between 64 and 128, are zero-padded to 64 or 128; above 128 they
raise.  Every other option of the JAX ``sageattn`` raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from sageattention_tpu_torch import quant
from sageattention_tpu_torch.ops import attention_cuda, autodiff, quant_cuda

LOG2E = 1.4426950408889634
K_GROUP = attention_cuda.K_GROUP

# option -> ROADMAP item that lifts the restriction
_LATER = {
    "smooth_q": "kernel row 1 slice (h), smooth_q",
    "q_segment_ids": "kernel row 1 slice (c), segment ids / varlen",
    "kv_segment_ids": "kernel row 1 slice (c), segment ids / varlen",
    "q_positions": "kernel row 1 slice (g), positions",
    "kv_positions": "kernel row 1 slice (g), positions",
    "attn_mask": "kernel row 1 slice (d), bool masks",
    "attn_bias": "kernel row 1 slice (e), additive bias",
    "window": "kernel row 1 slice (f), sliding window",
}


def _to_hnd(x: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "HND":
        return x
    if layout == "NHD":
        return x.transpose(1, 2)
    raise ValueError(f"tensor_layout must be 'HND' or 'NHD', got {layout!r}")


def _pad_head_dim(d: int) -> int:
    """The kernel's head dim for d <= 128: 64 or 128."""
    return 64 if d <= 64 else 128


def _pad_d(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    return F.pad(x, (0, d_pad - x.shape[-1])).contiguous()


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The kernels read bf16 or fp32; fp16 widens to fp32 exactly."""
    return dtype if dtype in (torch.bfloat16, torch.float32) else torch.float32


class Forward(NamedTuple):
    """The forward's output and what its backward reuses."""

    o: torch.Tensor               # [b,hq,sq,d] in q's dtype
    lse2: torch.Tensor | None     # base-2 LSE [b,hq,sq] fp32, as the kernel gives it
    k_i8: torch.Tensor            # int8 K codes [b,hkv,sk,d_pad]
    k_scale: torch.Tensor         # fp32 [b,hkv,ceil(sk/K_GROUP)]
    km: torch.Tensor | None       # fp32 [b,hkv,d_pad] smooth-k mean, or None
    v_q: torch.Tensor             # the V the kernel read [b,hkv,sk,d_pad]: bf16, or codes
    v_scale: torch.Tensor | None  # fp32 [b,hkv,d_pad] per-channel V scales (codes only)
    v_mean: torch.Tensor | None   # fp32 [b,hkv,d_pad] smooth-v mean, or None
    sm_scale: float


def _quant_v(v, *, pv_dtype: str, smooth_v: bool, d_pad: int):
    """V for the kernel, from the caller's V before any head-dim padding
    (``core.py:359-384`` of the JAX package): (v_q, v_scale, v_mean)."""
    if pv_dtype in quant.V_DTYPES:
        return quant_cuda.quant_v_per_channel(v, dtype=quant.V_DTYPES[pv_dtype],
                                              smooth=smooth_v, d_pad=d_pad)
    if pv_dtype != "bf16":
        raise ValueError(f"unknown pv_dtype {pv_dtype!r}")
    if not smooth_v:
        return _pad_d(v.to(torch.bfloat16), d_pad), None, None
    # bf16 P.V with smooth-v: V - mean in bf16, the mean back in the epilogue
    v_c, v_mean = quant.sub_mean(v)
    return _pad_d(v_c.to(torch.bfloat16), d_pad), None, _pad_d(v_mean, d_pad)


def _forward(q, k, v, *, is_causal: bool, sm_scale: float | None, smooth_k: bool,
             return_lse: bool, pv_dtype: str = "bf16", smooth_v: bool = False) -> Forward:
    """Quantize K and V, then one fused attention call, on HND tensors."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q, k, v must be [b,h,s,d] with v shaped like k; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, sq, d_og = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d_og or hq % hkv:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k {tuple(k.shape)}")
    if sm_scale is None:
        sm_scale = d_og**-0.5
    if d_og > 128:
        raise NotImplementedError(
            f"head_dim {d_og} > 128 is not ported (ROADMAP: kernel row 1, "
            f"head dims above 128)"
        )
    work = _work_dtype(q.dtype)
    d_pad = _pad_head_dim(d_og)
    qp = _pad_d(q.to(work), d_pad)
    kp = _pad_d(k.to(work), d_pad)
    v_q, v_scale, v_mean = _quant_v(v, pv_dtype=pv_dtype, smooth_v=smooth_v, d_pad=d_pad)
    k_i8, k_scale, km = quant_cuda.quant_k_fused_mean(kp, group=K_GROUP, smooth=smooth_k)
    out = attention_cuda.sage_attention_fwd(
        qp, k_i8, k_scale, v_q, v_scale, v_mean, is_causal=is_causal,
        q_fold=sm_scale * LOG2E, return_lse=return_lse,
    )
    o, lse2 = out if return_lse else (out, None)
    return Forward(o[..., :d_og].to(q.dtype), lse2, k_i8, k_scale, km, v_q, v_scale, v_mean,
                   sm_scale)


def _lse_nat(lse2, q, km, sm_scale: float):
    """The public natural-log LSE from the kernel's base-2 one."""
    lse = lse2 / LOG2E
    if km is not None:
        # smoothing shifted every logit of row i by q_i . km
        hq, d_og = q.shape[1], q.shape[-1]
        km_q = km[..., :d_og].repeat_interleave(hq // km.shape[1], dim=1)
        lse = lse + torch.einsum("bhqd,bhd->bhq", q.float(), km_q) * sm_scale
    return lse


def _sageattn_hnd(q, k, v, *, is_causal: bool, sm_scale: float | None,
                  smooth_k: bool, return_lse: bool, pv_dtype: str, smooth_v: bool):
    """The forward alone on HND tensors: o, or (o, lse)."""
    f = _forward(q, k, v, is_causal=is_causal, sm_scale=sm_scale, smooth_k=smooth_k,
                 return_lse=return_lse, pv_dtype=pv_dtype, smooth_v=smooth_v)
    if not return_lse:
        return f.o
    return f.o, _lse_nat(f.lse2, q, f.km, f.sm_scale)


def _refuse(kwargs: dict, qk_quant_gran: str, qk_bits: int) -> None:
    if qk_quant_gran != "auto":
        raise NotImplementedError(
            f"qk_quant_gran={qk_quant_gran!r}: only 'auto' is ported (ROADMAP: "
            f"module 1, qk_quant_gran per_token/per_subtile/per_block)"
        )
    if qk_bits != 8:
        raise NotImplementedError(
            "qk_bits=4 is not ported (ROADMAP: kernel row 1 slice (i))"
        )
    for name, value in kwargs.items():
        if name in _LATER:
            if value is None or value is False:
                continue
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP: {_LATER[name]})"
            )
        if name in ("block_q", "block_k", "impl"):
            raise NotImplementedError(
                f"{name}: the port picks its own H100 launch configuration"
            )
        raise TypeError(f"unexpected keyword argument {name!r}")


def sageattn_qk_int8_pv_bf16(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    tensor_layout: str = "HND",
    is_causal: bool = False,
    sm_scale: float | None = None,
    return_lse: bool = False,
    *,
    smooth_k: bool = True,
    smooth_v: bool = False,
    pv_dtype: str = "bf16",
    qk_quant_gran: str = "auto",
    qk_bits: int = 8,
    **kwargs,
):
    """int8 Q.K^T + bf16 P.V (fp32 accumulate).

    ``pv_dtype`` names how V is stored: "bf16", or per-channel "int8",
    "fp8" (e4m3) or "fp8_e5m2" codes, which the kernel widens to bf16;
    ``smooth_v`` subtracts V's channel mean first and adds it back in the
    epilogue.  Returns o in q's layout and dtype and, with ``return_lse``,
    the natural-log LSE [b, hq, sq] fp32.  Differentiable in q, k and v
    (and through the LSE): with grad enabled and an input that requires
    it, the call runs through ``autodiff.SageAttnFunction``, whose backward
    is the fused quantized backward (kernels ``quant_q_per_token``,
    ``sage_attn_bwd_dq``, ``sage_attn_bwd_dkv`` on the card)."""
    _refuse(kwargs, qk_quant_gran, qk_bits)
    qh, kh, vh = (_to_hnd(x, tensor_layout) for x in (q, k, v))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out = autodiff.SageAttnFunction.apply(qh, kh, vh, is_causal, sm_scale,
                                              smooth_k, return_lse, pv_dtype, smooth_v)
    else:
        out = _sageattn_hnd(qh, kh, vh, is_causal=is_causal, sm_scale=sm_scale,
                            smooth_k=smooth_k, return_lse=return_lse, pv_dtype=pv_dtype,
                            smooth_v=smooth_v)
    if return_lse:
        return _to_hnd(out[0], tensor_layout), out[1]
    return _to_hnd(out, tensor_layout)


def sageattn_qk_int8_pv_int8(q, k, v, tensor_layout: str = "HND", is_causal: bool = False,
                             sm_scale: float | None = None, return_lse: bool = False,
                             **kwargs):
    """int8 Q.K^T + int8 V codes with per-channel scales (``pv_dtype``
    defaults to "int8").  See :func:`sageattn_qk_int8_pv_bf16`."""
    kwargs.setdefault("pv_dtype", "int8")
    return sageattn_qk_int8_pv_bf16(
        q, k, v, tensor_layout, is_causal, sm_scale, return_lse, **kwargs
    )


def sageattn_qk_int8_pv_fp8(q, k, v, tensor_layout: str = "HND", is_causal: bool = False,
                            sm_scale: float | None = None, return_lse: bool = False,
                            **kwargs):
    """int8 Q.K^T + fp8 e4m3 V codes with per-channel scales (``pv_dtype``
    defaults to "fp8"; "fp8_e5m2" for the e5m2 coding).  See
    :func:`sageattn_qk_int8_pv_bf16`."""
    kwargs.setdefault("pv_dtype", "fp8")
    return sageattn_qk_int8_pv_bf16(
        q, k, v, tensor_layout, is_causal, sm_scale, return_lse, **kwargs
    )


def sageattn(q, k, v, tensor_layout: str = "HND", is_causal: bool = False,
             sm_scale: float | None = None, return_lse: bool = False, **kwargs):
    """Drop-in attention: the default SageAttention (int8 Q.K^T, smoothed
    K, bf16 P.V), differentiable.  See :func:`sageattn_qk_int8_pv_bf16`."""
    return sageattn_qk_int8_pv_bf16(
        q, k, v, tensor_layout, is_causal, sm_scale, return_lse, **kwargs
    )
