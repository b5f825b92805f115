"""Fused int8-QK^T / bf16-PV attention forward: CUDA wrapper and plain version.

Replaces the TPU kernel ``sageattention_tpu/ops/attention_pallas.py``:
``sage_attention_fused`` (``_kernel`` / ``_kernel_single``) for bf16 V and
for int8 / fp8 V codes with per-channel scales and the smooth-v mean
(its default ``pv_compute="bf16"``: codes widened to bf16, P.V in bf16).
The kernel is ``csrc/attention_fwd.cu``; its header says what bounds it
(tensor-core operations) and what this first version leaves for later.

The H100 launch configuration is fixed: 64 Q rows per CTA, KV tiles of
``K_GROUP`` = 128 columns, which is also the K-scale group, so the kernel
reads one K scale per tile.  It replaces the TPU's ``default_config`` and
tuned table, which hold TPU block sizes only.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  ``sage_attention_fwd.launches`` counts
the launches.
"""

from __future__ import annotations

import torch

from sageattention_tpu_torch import quant
from sageattention_tpu_torch.ops import _build, reference

# the K-scale group, shared by the CPU and CUDA paths: the kernel's KV tile
K_GROUP = 128
# the V storage types the kernel reads; the position of each is its code
V_TYPES = (torch.bfloat16, *quant.V_CODE_TYPES)


def _check_v_scale(v, v_scale) -> None:
    """V codes come with their per-channel scales, bf16 V without."""
    if (v_scale is None) != (v.dtype == torch.bfloat16):
        raise ValueError(
            f"v_scale must be given exactly when V holds codes: V is {v.dtype}, "
            f"v_scale is {'None' if v_scale is None else 'given'}"
        )


def sage_attention_plain(q, k_i8, k_scale, v, v_scale=None, v_mean=None, *,
                         is_causal: bool, q_fold: float, return_lse: bool):
    """The kernel's function in plain PyTorch: per-row int8 Q with
    ``q_fold`` in its scales, per-group K scales expanded per row, then
    :func:`reference.quantized_attention_reference`."""
    _check_v_scale(v, v_scale)
    sk = k_i8.shape[2]
    q_i8, q_scale = quant.quant_int8(q, scale_fold=q_fold)
    k_rows = k_scale.repeat_interleave(K_GROUP, dim=-1)[..., :sk]
    return reference.quantized_attention_reference(
        q_i8, q_scale, k_i8, k_rows, v, v_scale, v_mean, is_causal=is_causal,
        return_lse=return_lse, out_dtype=q.dtype,
    )


def _check(q, k_i8, k_scale, v, v_scale, v_mean):
    b, hq, sq, d = q.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    want = {
        "q": (q, (torch.bfloat16, torch.float32), (b, hq, sq, d)),
        "k_i8": (k_i8, (torch.int8,), (b, hkv, sk, d)),
        "k_scale": (k_scale, (torch.float32,), (b, hkv, -(-sk // K_GROUP))),
        "v": (v, V_TYPES, (b, hkv, sk, d)),
        "v_scale": (v_scale, (torch.float32,), (b, hkv, d)),
        "v_mean": (v_mean, (torch.float32,), (b, hkv, d)),
    }
    for name, (x, dtypes, shape) in want.items():
        if x is None and name in ("v_scale", "v_mean"):
            continue
        if x.device != q.device or x.dtype not in dtypes or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: want {shape} {dtypes} on {q.device}, got "
                f"{tuple(x.shape)} {x.dtype} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_v_scale(v, v_scale)
    if d not in (64, 128):
        raise ValueError(f"head dim {d}: the kernel takes 64 or 128 (pad first)")
    if hq % hkv:
        raise ValueError(f"hq={hq} is not a multiple of hkv={hkv}")


def sage_attention_fwd(q, k_i8, k_scale, v, v_scale=None, v_mean=None, *,
                       is_causal: bool, q_fold: float, return_lse: bool = False):
    """Fused forward on HND tensors.

    q [b,hq,sq,d] bf16/fp32 (unquantized); k_i8 [b,hkv,sk,d] int8;
    k_scale [b,hkv,ceil(sk/K_GROUP)] fp32; v [b,hkv,sk,d] bf16, or int8 /
    fp8 (e4m3, e5m2) codes with ``v_scale`` [b,hkv,d] fp32; ``v_mean``
    [b,hkv,d] fp32 or None (smooth-v).  Returns o [b,hq,sq,d] in q's
    dtype, ``(acc / l) * v_scale + v_mean``, and, with ``return_lse``, the
    base-2 LSE [b,hq,sq] fp32."""
    if q.device.type == "cpu":
        return sage_attention_plain(q, k_i8, k_scale, v, v_scale, v_mean, is_causal=is_causal,
                                    q_fold=q_fold, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"sage_attention_fwd: tensor on {q.device}")
    _check(q, k_i8, k_scale, v, v_scale, v_mean)
    b, hq, sq, d = q.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    o = torch.empty_like(q)
    lse2 = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device) if return_lse else None
    # the launch goes to the current device: make it the tensors' own
    with torch.cuda.device(q.device):
        err = _build.lib("attention_fwd").sage_attn_fwd(
            q.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
            v_scale.data_ptr() if v_scale is not None else None,
            v_mean.data_ptr() if v_mean is not None else None,
            o.data_ptr(), lse2.data_ptr() if return_lse else None,
            b, hq, hkv, sq, sk, d, int(is_causal), int(q.dtype == torch.float32),
            V_TYPES.index(v.dtype), int(return_lse), K_GROUP, quant.fold_multiplier(q_fold),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "sage_attn_fwd")
    sage_attention_fwd.launches += 1
    return (o, lse2) if return_lse else o


sage_attention_fwd.launches = 0
