"""Quantizers: CUDA wrappers and plain versions.

Replaces the TPU kernels ``sageattention_tpu/ops/quant_pallas.py``:
``quant_k_fused_mean`` (``_quant_k_fused_kernel``) and
``quant_k_chunked`` (``_quant_k_kernel``), in ``csrc/quant_k.cu``, which
says what bounds them (bytes) and why K is read twice on this card;
``quant_q_per_token`` (``_quant_rows_kernel``), in ``csrc/quant_q.cu``,
which the backward uses to quantize Q again exactly as the forward kernel
did inside itself; and the per-channel V quantizers ``quant_v_per_channel``
(``_quant_v_kernel``) and ``_quant_v_blocked`` (``_v_stats_kernel``,
``_v_apply_kernel``), in ``csrc/quant_v.cu``.  The Q and K quantizers take
``bits``: 8, or 4 for the +-7 codes of ``sageattn(qk_bits=4)``, as the TPU
kernels do.

On a CPU tensor every function here runs its plain PyTorch version; on a
CUDA tensor it launches its kernel or raises.  Each wrapper counts its
launches in ``<function>.launches``, and those at head dims 256, 384 and
512 apart, in ``<function>.hd256_launches``, ``.hd384_launches`` and
``.hd512_launches`` (the Q quantizer has instances of its own there; the
K and V kernels take the width as an argument).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sageattention_tpu_torch import quant
from sageattention_tpu_torch.ops import _build

_KDTYPES = (torch.bfloat16, torch.float32)
# the single-pass V kernel takes a (b,h) slab of at most this many bytes,
# counted on the caller's V (s * d * itemsize); larger slabs take the
# two-pass kernels, by the JAX package's rule (quant_pallas._V_VMEM_BYTES)
V_SINGLE_PASS_BYTES = 4 * 2**20
# rows of one CTA of the two-pass V kernels
V_BLOCK_ROWS = 512
# the K mean's plan: CTAs of 512 threads, four resident an SM, each summing
# a chunk of a multiple of 64 rows
MEAN_CTAS_PER_SM = 4
MEAN_ROW_STEP = 64
HEAD_DIMS = _build.HEAD_DIMS


def _check_input(x: torch.Tensor, what: str = "K quantizer") -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {x.device}, want cpu or cuda")
    if x.dtype not in _KDTYPES:
        raise TypeError(f"{what} takes bf16 or fp32 input, got {x.dtype}")
    if x.dim() != 4 or x.shape[-1] not in HEAD_DIMS or not x.is_contiguous():
        raise ValueError(
            f"{what} takes contiguous [b,h,s,d] with d in {HEAD_DIMS}, "
            f"got {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


def _qmax_args(bits: int) -> tuple[float, float]:
    """(qmax, f32(1/qmax)) of the Q / K kernels."""
    qmax = quant.qk_qmax(bits)
    return qmax, float(np.float32(1.0 / qmax))


def quant_q_per_token_plain(q: torch.Tensor, *, scale_fold: float, bits: int = 8):
    """The spec: ``quant.quant_int8(q, scale_fold=scale_fold, bits=bits)``."""
    return quant.quant_int8(q, scale_fold=scale_fold, bits=bits)


def quant_q_per_token(q: torch.Tensor, *, scale_fold: float, bits: int = 8):
    """[b,h,s,d] -> (int8 [b,h,s,d], f32 scales [b,h,s] with ``scale_fold``
    folded in), bit for bit the forward kernel's in-kernel Q quantization
    (and at ``bits=4`` the TPU kernel's at qmax 7)."""
    if q.device.type == "cpu":
        return quant_q_per_token_plain(q, scale_fold=scale_fold, bits=bits)
    _check_input(q, "Q quantizer")
    qmax, inv_qmax = _qmax_args(bits)
    b, h, s, d = q.shape
    out = torch.empty(b, h, s, d, dtype=torch.int8, device=q.device)
    scales = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):  # the launch goes to the current device
        err = _build.lib("quant_q").quant_q_per_token(
            q.data_ptr(), out.data_ptr(), scales.data_ptr(), b * h * s, d,
            int(q.dtype == torch.float32), quant.fold_multiplier(scale_fold, qmax), qmax,
            inv_qmax, torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, "quant_q_per_token")
    _build.count_launch(quant_q_per_token, q.shape[-1])
    return out, scales



def k_channel_mean_plain(k: torch.Tensor) -> torch.Tensor:
    """km [b,h,d]: the fp32 mean of K over the sequence."""
    return k.float().mean(dim=-2)


def mean_chunk_rows(s: int, bh: int, sms: int) -> int:
    """Rows a CTA of the K mean sums: a multiple of ``MEAN_ROW_STEP``, as
    few as give each of the ``bh`` (b, h) slabs enough chunks that
    ``MEAN_CTAS_PER_SM`` CTAs fill each of the card's ``sms`` SMs."""
    want = max(1, min(-(-MEAN_CTAS_PER_SM * sms // bh), -(-s // MEAN_ROW_STEP)))
    return -(-(-(-s // want)) // MEAN_ROW_STEP) * MEAN_ROW_STEP


def mean_chunks(s: int, rows: int) -> list[range]:
    """The row ranges of a slab's chunks, in the order the kernel adds their
    sums."""
    return [range(r, min(s, r + rows)) for r in range(0, s, rows)]


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# the K mean's per-(b,h) arrival counters, one zeroed int32 buffer a stream
# (the kernel's last CTA of each (b,h) zeroes its counter again), grown as
# launches need
_COUNTERS: dict[tuple, torch.Tensor] = {}


def _mean_counters(stream: torch.cuda.Stream, n: int) -> torch.Tensor:
    key = (stream.device, stream.cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        with torch.cuda.stream(stream):
            buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                               device=stream.device)
    return buf


def k_channel_mean(k: torch.Tensor) -> torch.Tensor:
    """km [b,h,d] fp32 (the smooth-k channel mean): one launch, a CTA per
    (chunk of :func:`mean_chunk_rows` rows, b h), the chunks' sums added in
    chunk order."""
    if k.device.type == "cpu":
        return k_channel_mean_plain(k)
    _check_input(k)
    b, h, s, d = k.shape
    stream = torch.cuda.current_stream(k.device)
    rows = mean_chunk_rows(s, b * h, _sm_count(k.device))
    km = torch.empty(b, h, d, dtype=torch.float32, device=k.device)
    part = torch.empty(b * h, -(-s // rows), d, dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):  # the launch goes to the current device
        err = _build.lib("quant_k").k_channel_mean(
            k.data_ptr(), part.data_ptr(), _mean_counters(stream, b * h).data_ptr(),
            km.data_ptr(), b * h, s, d, rows, int(k.dtype == torch.bfloat16),
            stream.cuda_stream,
        )
    _build.check(err, "k_channel_mean")
    _build.count_launch(k_channel_mean, k.shape[-1])
    return km



def quant_k_chunked_plain(k, km, *, group: int, bits: int = 8):
    """The spec: ``quant_int8_block_scales(k - km, group, bits)``."""
    ks = k.float() - km[..., None, :] if km is not None else k.float()
    return quant.quant_int8_block_scales(ks, group=group, bits=bits)


def quant_k_chunked(k: torch.Tensor, km: torch.Tensor | None, *, group: int, bits: int = 8):
    """[b,h,s,d] -> (int8 [b,h,s,d], f32 scales [b,h,ceil(s/group)]),
    subtracting ``km`` [b,h,d] first when it is given."""
    if k.device.type == "cpu":
        return quant_k_chunked_plain(k, km, group=group, bits=bits)
    _check_input(k)
    qmax, inv_qmax = _qmax_args(bits)
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
            int(k.dtype == torch.bfloat16), qmax, inv_qmax,
            torch.cuda.current_stream(k.device).cuda_stream,
        )
    _build.check(err, "quant_k_chunked")
    _build.count_launch(quant_k_chunked, k.shape[-1])
    return out, scales



def quant_k_fused_mean(k: torch.Tensor, *, group: int, smooth: bool = True, bits: int = 8):
    """The K prologue of the default forward: (int8 K, per-group scales,
    km or None).  On the card: ``k_channel_mean`` then ``quant_k_chunked``."""
    km = k_channel_mean(k) if smooth else None
    k_i8, scales = quant_k_chunked(k, km, group=group, bits=bits)
    return k_i8, scales, km


# --------------------------------------------------------------------------
# V: per-channel scales (+ the smooth-v mean); codes int8, e4m3 or e5m2
# --------------------------------------------------------------------------


def quant_v_per_channel_plain(v: torch.Tensor, *, dtype: torch.dtype, smooth: bool):
    """The spec: ``quant.per_channel_quant``."""
    return quant.per_channel_quant(v, dtype=dtype, smooth=smooth)


def quant_v_per_channel(v: torch.Tensor, *, dtype: torch.dtype, smooth: bool = False,
                        d_pad: int | None = None):
    """Per-channel V quantization: (codes [b,h,s,d_pad] in ``dtype``,
    scales [b,h,d_pad] fp32, the smooth-v mean [b,h,d_pad] fp32 or None).
    V is zero-padded to ``d_pad`` channels (default its own d; the kernels
    take 64, 128, 256, 384 or 512), and pad channels get code 0 and mean 0.

    ``v`` is the caller's [b,h,s,d].  A (b,h) slab of more than
    ``V_SINGLE_PASS_BYTES`` (s * d * its itemsize) goes to the two-pass
    :func:`quant_v_blocked`; a smaller one to the single-pass kernel,
    whose launches this function counts."""
    blocked = v.shape[-2] * v.shape[-1] * v.element_size() > V_SINGLE_PASS_BYTES
    # bf16 or fp32, as the kernels read it (fp16 widens exactly)
    x = v if v.dtype in _KDTYPES else v.float()
    x = F.pad(x, (0, (d_pad or v.shape[-1]) - v.shape[-1])).contiguous()
    if blocked:
        return quant_v_blocked(x, dtype=dtype, smooth=smooth)
    if x.device.type == "cpu":
        return quant_v_per_channel_plain(x, dtype=dtype, smooth=smooth)
    _check_input(x, "V quantizer")
    b, h, s, d = x.shape
    out = torch.empty(b, h, s, d, dtype=dtype, device=x.device)
    scale = torch.empty(b, h, d, dtype=torch.float32, device=x.device)
    mean = torch.empty_like(scale) if smooth else None
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _build.lib("quant_v").quant_v_per_channel(
            x.data_ptr(), out.data_ptr(), scale.data_ptr(),
            mean.data_ptr() if smooth else None, b * h, s, d,
            int(x.dtype == torch.bfloat16), quant.V_CODE_TYPES.index(dtype), int(smooth),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "quant_v_per_channel")
    _build.count_launch(quant_v_per_channel, x.shape[-1])
    return out, scale, mean



def v_channel_stats_plain(v: torch.Tensor, *, smooth: bool):
    """(max, min, mean or None) of each channel over the sequence, [b,h,d]
    fp32 each."""
    x = v.float()
    return x.amax(dim=-2), x.amin(dim=-2), x.mean(dim=-2) if smooth else None


def v_channel_stats(v: torch.Tensor, *, smooth: bool):
    """Pass 1 of the two-pass V quantizer: the kernel takes each block of
    ``V_BLOCK_ROWS`` rows' max, min and sum; the blocks are combined here,
    mean = sum / s (``quant_pallas.py:475-476``)."""
    if v.device.type == "cpu":
        return v_channel_stats_plain(v, smooth=smooth)
    _check_input(v, "V statistics")
    b, h, s, d = v.shape
    parts = torch.empty(3, b * h, -(-s // V_BLOCK_ROWS), d, dtype=torch.float32,
                        device=v.device)
    with torch.cuda.device(v.device):  # the launch goes to the current device
        err = _build.lib("quant_v").quant_v_stats(
            v.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), parts[2].data_ptr(),
            b * h, s, d, V_BLOCK_ROWS, int(v.dtype == torch.bfloat16),
            torch.cuda.current_stream(v.device).cuda_stream,
        )
    _build.check(err, "quant_v_stats")
    _build.count_launch(v_channel_stats, v.shape[-1])
    gmax, gmin, gsum = (x.reshape(b, h, -1, d) for x in parts)
    return gmax.amax(dim=2), gmin.amin(dim=2), gsum.sum(dim=2) / s if smooth else None



def v_scale_from_stats(gmax: torch.Tensor, gmin: torch.Tensor, mean: torch.Tensor | None,
            dtype: torch.dtype):
    """(scale, 1/scale) from the channel statistics: amax = max(gmax -
    mean, mean - gmin), which equals max|x - mean| exactly (a rounded
    subtraction is monotone), or max(gmax, -gmin) without the mean."""
    if mean is None:
        amax = torch.maximum(gmax, -gmin)
    else:
        amax = torch.maximum(gmax - mean, mean - gmin)
    return quant.inv_scale(amax, quant.QMAX[dtype])


def quant_v_apply_plain(v: torch.Tensor, r: torch.Tensor, mean: torch.Tensor | None, *,
                        dtype: torch.dtype) -> torch.Tensor:
    """Codes of ``(v - mean) * r`` (``_v_apply_kernel``): fp8 values are
    clamped to +-qmax before the cast, int8 after rounding."""
    x = v.float()
    if mean is not None:
        x = x - mean[..., None, :]
    scaled = x * r[..., None, :]
    if dtype != torch.int8:
        scaled = scaled.clamp(-quant.QMAX[dtype], quant.QMAX[dtype])
    return quant.v_codes(scaled, dtype)


def quant_v_apply(v: torch.Tensor, r: torch.Tensor, mean: torch.Tensor | None, *,
                  dtype: torch.dtype) -> torch.Tensor:
    """Pass 2 of the two-pass V quantizer: codes [b,h,s,d] in ``dtype``
    from ``r`` = 1/scale and the mean (or None), both [b,h,d] fp32."""
    if v.device.type == "cpu":
        return quant_v_apply_plain(v, r, mean, dtype=dtype)
    _check_input(v, "V quantizer")
    b, h, s, d = v.shape
    for name, x in (("r", r), ("mean", mean)):
        if x is not None and (x.dtype != torch.float32 or x.shape != (b, h, d)
                              or not x.is_contiguous() or x.device != v.device):
            raise ValueError(f"{name} must be contiguous fp32 {(b, h, d)} on {v.device}")
    out = torch.empty(b, h, s, d, dtype=dtype, device=v.device)
    with torch.cuda.device(v.device):  # the launch goes to the current device
        err = _build.lib("quant_v").quant_v_apply(
            v.data_ptr(), r.data_ptr(), mean.data_ptr() if mean is not None else None,
            out.data_ptr(), b * h, s, d, V_BLOCK_ROWS, int(v.dtype == torch.bfloat16),
            quant.V_CODE_TYPES.index(dtype), torch.cuda.current_stream(v.device).cuda_stream,
        )
    _build.check(err, "quant_v_apply")
    _build.count_launch(quant_v_apply, v.shape[-1])
    return out



def quant_v_blocked_plain(v: torch.Tensor, *, dtype: torch.dtype, smooth: bool):
    """The two-pass quantizer in plain PyTorch: statistics, scales, codes."""
    gmax, gmin, mean = v_channel_stats_plain(v, smooth=smooth)
    scale, r = v_scale_from_stats(gmax, gmin, mean, dtype)
    return quant_v_apply_plain(v, r, mean, dtype=dtype), scale, mean


def quant_v_blocked(v: torch.Tensor, *, dtype: torch.dtype, smooth: bool):
    """The two-pass V quantizer (``_quant_v_blocked``) on [b,h,s,d], d in
    ``HEAD_DIMS``: ``v_channel_stats``, the scales in PyTorch (the JAX
    package's XLA combine), ``quant_v_apply``.  Returns (codes, scales,
    mean or None)."""
    gmax, gmin, mean = v_channel_stats(v, smooth=smooth)
    scale, r = v_scale_from_stats(gmax, gmin, mean, dtype)
    return quant_v_apply(v, r, mean, dtype=dtype), scale, mean


_build.zero_counters(quant_q_per_token, k_channel_mean, quant_k_chunked, quant_v_per_channel,
                    v_channel_stats, quant_v_apply)
