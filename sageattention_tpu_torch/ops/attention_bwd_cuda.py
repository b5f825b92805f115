"""Fused attention backward: CUDA wrappers and plain versions.

Replaces the TPU kernels ``sageattention_tpu/ops/attention_bwd_pallas.py``:
``sage_attention_bwd`` -> ``_dq_kernel`` and ``_dkv_kernel``.  The kernels
are ``csrc/attention_bwd.cu``; its header gives their layout (a CTA loops
over KV tiles for dQ, over the GQA group's Q tiles for dK/dV) and their
bound (tensor-core operations).

Both take the forward's quantized operands and its base-2 LSE: ``q_i8`` /
``q_scale`` from :func:`quant_cuda.quant_q_per_token` (bit for bit the
forward's in-kernel Q quantization), ``k_i8`` / ``k_scale`` with one scale
per ``K_GROUP`` rows, and ``dvec`` = rowsum(dO * O) minus any LSE
cotangent.  The TPU launcher's fold grid, transposed (vt) accumulation and
block heuristics are layout tricks that change no number and are not
ported; every length is taken, the ragged edge masked inside the kernels.
A sliding ``window`` (with causal) is applied as the forward applies it:
``col > row - window``, and each kernel's loop covers only the tiles the
band reaches (the TPU's band grids, ``attention_bwd_pallas.py:756-816``).

On a CPU tensor a wrapper runs its plain version
(:func:`reference.quantized_attention_bwd_reference`); on a CUDA tensor it
launches its kernel or raises.  ``<function>.launches`` counts launches.
"""

from __future__ import annotations

import torch

from sageattention_tpu_torch.ops import _build, reference
from sageattention_tpu_torch.ops.attention_cuda import K_GROUP, window_arg


def _k_rows(k_scale, sk: int):
    """Per-group K scales [b,h,ceil(sk/K_GROUP)] -> per-row [b,h,sk]."""
    return k_scale.repeat_interleave(K_GROUP, dim=-1)[..., :sk]


def sage_attention_bwd_dq_plain(q_i8, q_scale, k_i8, k_scale, k_sm, v, do, lse2, dvec, *,
                                is_causal: bool, sm_scale: float, window: int | None = None):
    """dQ [b,hq,sq,d] fp32 in plain PyTorch."""
    return reference.quantized_attention_bwd_reference(
        q_i8, q_scale, k_i8, _k_rows(k_scale, k_i8.shape[2]), k_sm, None, v, do, lse2,
        dvec, is_causal=is_causal, sm_scale=sm_scale, window=window,
    )[0]


def sage_attention_bwd_dkv_plain(q_i8, q_scale, q_bf, k_i8, k_scale, v, do, lse2, dvec, *,
                                 is_causal: bool, sm_scale: float, window: int | None = None):
    """(dK, dV) [b,hkv,sk,d] fp32 in plain PyTorch."""
    _, dk, dv = reference.quantized_attention_bwd_reference(
        q_i8, q_scale, k_i8, _k_rows(k_scale, k_i8.shape[2]), None, q_bf, v, do, lse2,
        dvec, is_causal=is_causal, sm_scale=sm_scale, window=window,
    )
    return dk, dv


def _check(q_i8, q_scale, k_i8, k_scale, lse2, dvec, **bf16):
    b, hq, sq, d = q_i8.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    want = {
        "q_i8": (q_i8, torch.int8, (b, hq, sq, d)),
        "q_scale": (q_scale, torch.float32, (b, hq, sq)),
        "k_i8": (k_i8, torch.int8, (b, hkv, sk, d)),
        "k_scale": (k_scale, torch.float32, (b, hkv, -(-sk // K_GROUP))),
        "lse2": (lse2, torch.float32, (b, hq, sq)),
        "dvec": (dvec, torch.float32, (b, hq, sq)),
    }
    for name, x in bf16.items():
        want[name] = (x, torch.bfloat16, (b, hq, sq, d) if name in ("q_bf", "do")
                      else (b, hkv, sk, d))
    for name, (x, dtype, shape) in want.items():
        if x.device != q_i8.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: want {shape} {dtype} on {q_i8.device}, got "
                f"{tuple(x.shape)} {x.dtype} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d not in (64, 128):
        raise ValueError(f"head dim {d}: the kernels take 64 or 128 (pad first)")
    if hq % hkv:
        raise ValueError(f"hq={hq} is not a multiple of hkv={hkv}")


def sage_attention_bwd_dq(q_i8, q_scale, k_i8, k_scale, k_sm, v, do, lse2, dvec, *,
                          is_causal: bool, sm_scale: float, window: int | None = None):
    """dQ [b,hq,sq,d] fp32 (``sm_scale`` applied) on HND tensors."""
    win = window_arg(window, is_causal)
    if q_i8.device.type == "cpu":
        return sage_attention_bwd_dq_plain(q_i8, q_scale, k_i8, k_scale, k_sm, v, do, lse2,
                                           dvec, is_causal=is_causal, sm_scale=sm_scale,
                                           window=window)
    if q_i8.device.type != "cuda":
        raise ValueError(f"sage_attention_bwd_dq: tensor on {q_i8.device}")
    _check(q_i8, q_scale, k_i8, k_scale, lse2, dvec, k_sm=k_sm, v=v, do=do)
    b, hq, sq, d = q_i8.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    dq = torch.empty(b, hq, sq, d, dtype=torch.float32, device=q_i8.device)
    with torch.cuda.device(q_i8.device):  # the launch goes to the current device
        err = _build.lib("attention_bwd").sage_attn_bwd_dq(
            q_i8.data_ptr(), q_scale.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(),
            k_sm.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(), dvec.data_ptr(),
            dq.data_ptr(), b, hq, hkv, sq, sk, d, int(is_causal), win, K_GROUP, sm_scale,
            torch.cuda.current_stream(q_i8.device).cuda_stream,
        )
    _build.check(err, "sage_attn_bwd_dq")
    sage_attention_bwd_dq.launches += 1
    return dq


sage_attention_bwd_dq.launches = 0


def sage_attention_bwd_dkv(q_i8, q_scale, q_bf, k_i8, k_scale, v, do, lse2, dvec, *,
                           is_causal: bool, sm_scale: float, window: int | None = None):
    """(dK, dV) [b,hkv,sk,d] fp32, summed over the GQA group, on HND
    tensors."""
    win = window_arg(window, is_causal)
    if q_i8.device.type == "cpu":
        return sage_attention_bwd_dkv_plain(q_i8, q_scale, q_bf, k_i8, k_scale, v, do, lse2,
                                            dvec, is_causal=is_causal, sm_scale=sm_scale,
                                            window=window)
    if q_i8.device.type != "cuda":
        raise ValueError(f"sage_attention_bwd_dkv: tensor on {q_i8.device}")
    _check(q_i8, q_scale, k_i8, k_scale, lse2, dvec, q_bf=q_bf, v=v, do=do)
    b, hq, sq, d = q_i8.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    dk = torch.empty(b, hkv, sk, d, dtype=torch.float32, device=q_i8.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q_i8.device):  # the launch goes to the current device
        err = _build.lib("attention_bwd").sage_attn_bwd_dkv(
            q_i8.data_ptr(), q_scale.data_ptr(), q_bf.data_ptr(), k_i8.data_ptr(),
            k_scale.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
            dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, sk, d,
            int(is_causal), win, K_GROUP, sm_scale,
            torch.cuda.current_stream(q_i8.device).cuda_stream,
        )
    _build.check(err, "sage_attn_bwd_dkv")
    sage_attention_bwd_dkv.launches += 1
    return dk, dv


sage_attention_bwd_dkv.launches = 0
