"""Fused attention backward: CUDA wrappers and plain versions.

Replaces the TPU kernels ``sageattention_tpu/ops/attention_bwd_pallas.py``:
``sage_attention_bwd`` -> ``_dq_kernel`` and ``_dkv_kernel``.  The kernels
are ``csrc/attention_bwd.cu``; its header gives their layout (a CTA loops
over KV tiles for dQ, over the GQA group's Q tiles for dK/dV) and their
bound (tensor-core operations; bytes with a bias).  Every instance is a
Hopper kernel (TMA loads through a pipeline of shared-memory stages,
``wgmma``; ``csrc/wgmma_sm90.cuh``), with a bias or without (:func:`route`).

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
An additive ``bias`` [b, hq, sq, sk] (fp32 or bf16, contiguous; not with
a window, as in the JAX package) joins the recomputed logits in both
kernels, and dQ writes dBias (= dS in fp32, cast to the bias's dtype) when
asked (``has_bias`` / ``emit_dbias``, ``attention_bwd_pallas.py:82-204,
238-316``), into a tensor it allocates uninitialised: the kernel writes
every element, the zeros right of the causal diagonal included.  The
kernels read the bias by TMA where a row of it is a multiple of 16 bytes,
else each thread loads its own (:func:`bias_reads`).

Head dims 64, 128 and 256, with a bias or without; at D = 256 dK/dV is one
launch (one warpgroup keeps dV, another dK).

On a CPU tensor a wrapper runs its plain version
(:func:`reference.quantized_attention_bwd_reference`); on a CUDA tensor it
launches its kernel or raises.  ``<function>.launches`` counts the
launches without a bias at head dims 64 and 128,
``<function>.hd256_launches`` those at 256,
``<function>.bias_launches`` those of the bias
instances (``sage_attn_bwd_dq_bias``, ``sage_attn_bwd_dkv_bias``) at 64
and 128, ``<function>.bias_hd256_launches`` theirs at 256 (one a call
each).
"""

from __future__ import annotations

import torch

from sageattention_tpu_torch.ops import _build, reference
from sageattention_tpu_torch.ops.attention_cuda import K_GROUP, window_arg


def route(d: int, bias_dtype=None) -> tuple[str, str, str, str]:
    """(library, dQ entry point, dK/dV entry point, kernel) of a backward
    call at head dim ``d`` (64, 128 or 256) with a bias of ``bias_dtype``
    (None, ``torch.float32`` or ``torch.bfloat16``): the ``BIAS`` instances
    of the same TMA-fed ``wgmma`` kernels for a bias, else the instances
    without one."""
    if d not in (64, 128, 256):
        raise ValueError(f"head dim {d}: the kernels take 64, 128 or 256 (pad first)")
    if bias_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"bias dtype {bias_dtype}: fp32 or bf16")
    sfx = "" if bias_dtype is None else "_bias"
    return "attention_bwd", "sage_attn_bwd_dq" + sfx, "sage_attn_bwd_dkv" + sfx, "wgmma"


def bias_reads(sk: int, dtype, data_ptr: int = 0) -> str:
    """How the kernels read a bias of ``sk`` columns at address
    ``data_ptr``: ``"tma"`` (the producer stages its tiles by TMA in a ring
    of their own) where a row is a multiple of 16 bytes and the base 16-byte
    aligned, as a TMA map needs, else ``"loads"`` (each thread loads its
    fragment's values).  dK/dV at head dim 256 always loads it: no bias
    tile fits beside its ring."""
    size = torch.empty((), dtype=dtype).element_size()
    return "tma" if (sk * size) % 16 == 0 and data_ptr % 16 == 0 else "loads"


def _bias_kind(bias) -> int:
    """The entry points' ``bias_kind``: bit 0 a bf16 bias, bit 1 the loads
    (:func:`bias_reads`)."""
    loads = bias_reads(bias.shape[-1], bias.dtype, bias.data_ptr()) == "loads"
    return int(bias.dtype == torch.bfloat16) | (2 if loads else 0)


def _k_rows(k_scale, sk: int):
    """Per-group K scales [b,h,ceil(sk/K_GROUP)] -> per-row [b,h,sk]."""
    return k_scale.repeat_interleave(K_GROUP, dim=-1)[..., :sk]


def sage_attention_bwd_dq_plain(q_i8, q_scale, k_i8, k_scale, k_sm, v, do, lse2, dvec, *,
                                is_causal: bool, sm_scale: float, window: int | None = None,
                                bias=None, need_dbias: bool = False):
    """dQ [b,hq,sq,d] fp32 in plain PyTorch, and with ``need_dbias`` (dQ,
    dBias)."""
    out = reference.quantized_attention_bwd_reference(
        q_i8, q_scale, k_i8, _k_rows(k_scale, k_i8.shape[2]), k_sm, None, v, do, lse2,
        dvec, is_causal=is_causal, sm_scale=sm_scale, window=window, bias=bias,
        need_dbias=need_dbias,
    )
    return (out[0], out[3]) if need_dbias else out[0]


def sage_attention_bwd_dkv_plain(q_i8, q_scale, q_bf, k_i8, k_scale, v, do, lse2, dvec, *,
                                 is_causal: bool, sm_scale: float, window: int | None = None,
                                 bias=None):
    """(dK, dV) [b,hkv,sk,d] fp32 in plain PyTorch."""
    _, dk, dv = reference.quantized_attention_bwd_reference(
        q_i8, q_scale, k_i8, _k_rows(k_scale, k_i8.shape[2]), None, q_bf, v, do, lse2,
        dvec, is_causal=is_causal, sm_scale=sm_scale, window=window, bias=bias,
    )
    return dk, dv


def _check(q_i8, q_scale, k_i8, k_scale, lse2, dvec, bias, **bf16):
    b, hq, sq, d = q_i8.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    want = {
        "q_i8": (q_i8, (torch.int8,), (b, hq, sq, d)),
        "q_scale": (q_scale, (torch.float32,), (b, hq, sq)),
        "k_i8": (k_i8, (torch.int8,), (b, hkv, sk, d)),
        "k_scale": (k_scale, (torch.float32,), (b, hkv, -(-sk // K_GROUP))),
        "lse2": (lse2, (torch.float32,), (b, hq, sq)),
        "dvec": (dvec, (torch.float32,), (b, hq, sq)),
    }
    for name, x in bf16.items():
        want[name] = (x, (torch.bfloat16,), (b, hq, sq, d) if name in ("q_bf", "do")
                      else (b, hkv, sk, d))
    if bias is not None:
        want["bias"] = (bias, (torch.float32, torch.bfloat16), (b, hq, sq, sk))
    for name, (x, dtypes, shape) in want.items():
        if x.device != q_i8.device or x.dtype not in dtypes or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: want {shape} {' or '.join(map(str, dtypes))} on {q_i8.device}, got "
                f"{tuple(x.shape)} {x.dtype} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d not in (64, 128, 256):
        raise ValueError(f"head dim {d}: the kernels take 64, 128 or 256 (pad first)")
    if hq % hkv:
        raise ValueError(f"hq={hq} is not a multiple of hkv={hkv}")


def _check_bias(bias, window, need_dbias: bool = False) -> None:
    """A bias comes without a window (the exact backward takes that), and
    dBias only with a bias."""
    if bias is not None and window is not None:
        raise ValueError("a bias with a window has no kernel (the exact backward takes it)")
    if need_dbias and bias is None:
        raise ValueError("need_dbias needs the bias")


def sage_attention_bwd_dq(q_i8, q_scale, k_i8, k_scale, k_sm, v, do, lse2, dvec, *,
                          is_causal: bool, sm_scale: float, window: int | None = None,
                          bias=None, need_dbias: bool = False):
    """dQ [b,hq,sq,d] fp32 (``sm_scale`` applied) on HND tensors; with
    ``bias`` [b,hq,sq,sk] the bias instance, and with ``need_dbias`` (dQ,
    dBias), dBias in the bias's dtype."""
    win = window_arg(window, is_causal)
    _check_bias(bias, window, need_dbias)
    if q_i8.device.type == "cpu":
        return sage_attention_bwd_dq_plain(q_i8, q_scale, k_i8, k_scale, k_sm, v, do, lse2,
                                           dvec, is_causal=is_causal, sm_scale=sm_scale,
                                           window=window, bias=bias, need_dbias=need_dbias)
    if q_i8.device.type != "cuda":
        raise ValueError(f"sage_attention_bwd_dq: tensor on {q_i8.device}")
    _check(q_i8, q_scale, k_i8, k_scale, lse2, dvec, bias, k_sm=k_sm, v=v, do=do)
    b, hq, sq, d = q_i8.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    dq = torch.empty(b, hq, sq, d, dtype=torch.float32, device=q_i8.device)
    # every element is written by the kernel, the causal zeros included
    dbias = torch.empty_like(bias) if need_dbias else None
    ops = (q_i8.data_ptr(), q_scale.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(),
           k_sm.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(), dvec.data_ptr(),
           dq.data_ptr())
    stream = torch.cuda.current_stream(q_i8.device).cuda_stream
    lib, entry, _, _ = route(d, None if bias is None else bias.dtype)
    with torch.cuda.device(q_i8.device):  # the launch goes to the current device
        fn = getattr(_build.lib(lib), entry)
        if bias is None:
            err = fn(*ops, b, hq, hkv, sq, sk, d, int(is_causal), win, K_GROUP, sm_scale, stream)
        else:
            err = fn(*ops, bias.data_ptr(), dbias.data_ptr() if need_dbias else None, b, hq, hkv,
                     sq, sk, d, int(is_causal), _bias_kind(bias), K_GROUP, sm_scale, stream)
    _build.check(err, entry)
    if bias is None:
        if d == 256:
            sage_attention_bwd_dq.hd256_launches += 1
        else:
            sage_attention_bwd_dq.launches += 1
    else:
        if d == 256:
            sage_attention_bwd_dq.bias_hd256_launches += 1
        else:
            sage_attention_bwd_dq.bias_launches += 1
    return (dq, dbias) if need_dbias else dq


sage_attention_bwd_dq.launches = 0
sage_attention_bwd_dq.hd256_launches = 0
sage_attention_bwd_dq.bias_launches = 0
sage_attention_bwd_dq.bias_hd256_launches = 0


def sage_attention_bwd_dkv(q_i8, q_scale, q_bf, k_i8, k_scale, v, do, lse2, dvec, *,
                           is_causal: bool, sm_scale: float, window: int | None = None,
                           bias=None):
    """(dK, dV) [b,hkv,sk,d] fp32, summed over the GQA group, on HND
    tensors; with ``bias`` [b,hq,sq,sk] the bias instance, each q head
    reading its own."""
    win = window_arg(window, is_causal)
    _check_bias(bias, window)
    if q_i8.device.type == "cpu":
        return sage_attention_bwd_dkv_plain(q_i8, q_scale, q_bf, k_i8, k_scale, v, do, lse2,
                                            dvec, is_causal=is_causal, sm_scale=sm_scale,
                                            window=window, bias=bias)
    if q_i8.device.type != "cuda":
        raise ValueError(f"sage_attention_bwd_dkv: tensor on {q_i8.device}")
    _check(q_i8, q_scale, k_i8, k_scale, lse2, dvec, bias, q_bf=q_bf, v=v, do=do)
    b, hq, sq, d = q_i8.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    dk = torch.empty(b, hkv, sk, d, dtype=torch.float32, device=q_i8.device)
    dv = torch.empty_like(dk)
    ops = (q_i8.data_ptr(), q_scale.data_ptr(), q_bf.data_ptr(), k_i8.data_ptr(),
           k_scale.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(), dvec.data_ptr(),
           dk.data_ptr(), dv.data_ptr())
    stream = torch.cuda.current_stream(q_i8.device).cuda_stream
    lib, _, entry, _ = route(d, None if bias is None else bias.dtype)
    with torch.cuda.device(q_i8.device):  # the launch goes to the current device
        fn = getattr(_build.lib(lib), entry)
        if bias is None:
            err = fn(*ops, b, hq, hkv, sq, sk, d, int(is_causal), win, K_GROUP, sm_scale, stream)
        else:
            err = fn(*ops, bias.data_ptr(), b, hq, hkv, sq, sk, d, int(is_causal),
                     _bias_kind(bias), K_GROUP, sm_scale, stream)
    _build.check(err, entry)
    if bias is None:
        if d == 256:
            sage_attention_bwd_dkv.hd256_launches += 1
        else:
            sage_attention_bwd_dkv.launches += 1
    else:
        if d == 256:
            sage_attention_bwd_dkv.bias_hd256_launches += 1
        else:
            sage_attention_bwd_dkv.bias_launches += 1
    return dk, dv


sage_attention_bwd_dkv.launches = 0
sage_attention_bwd_dkv.hd256_launches = 0
sage_attention_bwd_dkv.bias_launches = 0
sage_attention_bwd_dkv.bias_hd256_launches = 0
