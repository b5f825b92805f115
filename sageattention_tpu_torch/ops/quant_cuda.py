"""int8 quantizers: CUDA wrappers and plain versions.

Replaces the TPU kernels ``sageattention_tpu/ops/quant_pallas.py``:
``quant_k_fused_mean`` (``_quant_k_fused_kernel``) and
``quant_k_chunked`` (``_quant_k_kernel``), in ``csrc/quant_k.cu``, which
says what bounds them (bytes) and why K is read twice on this card; and
``quant_q_per_token`` (``_quant_rows_kernel``), in ``csrc/quant_q.cu``,
which the backward uses to quantize Q again exactly as the forward kernel
did inside itself.

On a CPU tensor every function here runs its plain PyTorch version; on a
CUDA tensor it launches its kernel or raises.  Each wrapper counts its
launches in ``<function>.launches``.
"""

from __future__ import annotations

import torch

from sageattention_tpu_torch import quant
from sageattention_tpu_torch.ops import _build

_KDTYPES = (torch.bfloat16, torch.float32)


def _check_input(x: torch.Tensor, what: str = "K quantizer") -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {x.device}, want cpu or cuda")
    if x.dtype not in _KDTYPES:
        raise TypeError(f"{what} takes bf16 or fp32 input, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] not in (64, 128) or not x.is_contiguous():
        raise ValueError(
            f"{what} takes contiguous [b,h,s,d] with d in (64, 128), "
            f"got {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


def quant_q_per_token_plain(q: torch.Tensor, *, scale_fold: float):
    """The spec: ``quant.quant_int8(q, scale_fold=scale_fold)``."""
    return quant.quant_int8(q, scale_fold=scale_fold)


def quant_q_per_token(q: torch.Tensor, *, scale_fold: float):
    """[b,h,s,d] -> (int8 [b,h,s,d], f32 scales [b,h,s] with ``scale_fold``
    folded in), bit for bit the forward kernel's in-kernel Q quantization."""
    if q.device.type == "cpu":
        return quant_q_per_token_plain(q, scale_fold=scale_fold)
    _check_input(q, "Q quantizer")
    b, h, s, d = q.shape
    out = torch.empty(b, h, s, d, dtype=torch.int8, device=q.device)
    scales = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):  # the launch goes to the current device
        err = _build.lib("quant_q").quant_q_per_token(
            q.data_ptr(), out.data_ptr(), scales.data_ptr(), b * h * s, d,
            int(q.dtype == torch.float32), quant.fold_multiplier(scale_fold),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "quant_q_per_token")
    quant_q_per_token.launches += 1
    return out, scales


quant_q_per_token.launches = 0


def k_channel_mean_plain(k: torch.Tensor) -> torch.Tensor:
    """km [b,h,d]: the fp32 mean of K over the sequence."""
    return k.float().mean(dim=-2)


def k_channel_mean(k: torch.Tensor) -> torch.Tensor:
    """km [b,h,d] fp32 (the smooth-k channel mean)."""
    if k.device.type == "cpu":
        return k_channel_mean_plain(k)
    _check_input(k)
    b, h, s, d = k.shape
    km = torch.empty(b, h, d, dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):  # the launch goes to the current device
        err = _build.lib("quant_k").k_channel_mean(
            k.data_ptr(), km.data_ptr(), b * h, s, d, int(k.dtype == torch.bfloat16),
            torch.cuda.current_stream(k.device).cuda_stream,
        )
    _build.check(err, "k_channel_mean")
    k_channel_mean.launches += 1
    return km


k_channel_mean.launches = 0


def quant_k_chunked_plain(k, km, *, group: int):
    """The spec: ``quant_int8_block_scales(k - km, group)``."""
    ks = k.float() - km[..., None, :] if km is not None else k.float()
    return quant.quant_int8_block_scales(ks, group=group)


def quant_k_chunked(k: torch.Tensor, km: torch.Tensor | None, *, group: int):
    """[b,h,s,d] -> (int8 [b,h,s,d], f32 scales [b,h,ceil(s/group)]),
    subtracting ``km`` [b,h,d] first when it is given."""
    if k.device.type == "cpu":
        return quant_k_chunked_plain(k, km, group=group)
    _check_input(k)
    b, h, s, d = k.shape
    if km is not None and (
        km.dtype != torch.float32 or km.shape != (b, h, d)
        or not km.is_contiguous() or km.device != k.device
    ):
        raise ValueError(f"km must be contiguous fp32 {(b, h, d)} on {k.device}")
    out = torch.empty(b, h, s, d, dtype=torch.int8, device=k.device)
    scales = torch.empty(b, h, -(-s // group), dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):  # the launch goes to the current device
        err = _build.lib("quant_k").quant_k_chunked(
            k.data_ptr(), km.data_ptr() if km is not None else None,
            out.data_ptr(), scales.data_ptr(), b * h, s, d, group,
            int(k.dtype == torch.bfloat16),
            torch.cuda.current_stream(k.device).cuda_stream,
        )
    _build.check(err, "quant_k_chunked")
    quant_k_chunked.launches += 1
    return out, scales


quant_k_chunked.launches = 0


def quant_k_fused_mean(k: torch.Tensor, *, group: int, smooth: bool = True):
    """The K prologue of the default forward: (int8 K, per-group scales,
    km or None).  On the card: ``k_channel_mean`` then ``quant_k_chunked``."""
    km = k_channel_mean(k) if smooth else None
    k_i8, scales = quant_k_chunked(k, km, group=group)
    return k_i8, scales, km
