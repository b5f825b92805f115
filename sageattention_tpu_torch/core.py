"""Public API: ``sageattn``, ``sageattn_qk_int8_pv_{bf16,int8,fp8}`` and
``sageattn_varlen``.

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
fused backward), for q, k and v, and through the LSE with ``return_lse``;
and for a lone additive ``attn_bias``, for the bias too (dBias), the
JAX package's ``differentiable_sageattn_bias``: the fused backward's bias
instances for a per-head [b, hq, sq, sk] bias without a window or a Q/K
option, exact recompute (``autodiff.RecomputeFunction``) for the rest.

The Q/K quantization options of the JAX ``sageattn``: ``smooth_q`` (Q
centred by its mean, the mean's product with the smoothed K added back as
a column bias), ``qk_bits=4`` (+-7 Q and K codes) and ``qk_quant_gran`` =
"per_token" / "per_subtile" / "per_block" (Q and K quantized by kernel 4
with per-row scales).  These run the forward on pre-quantized operands
(``attention_cuda.sage_attention_fwd_preq``) and are differentiated by
exact recompute (``autodiff.RecomputeFunction``), as the JAX package
differentiates every option outside its fused backward.

Layouts HND ([b, h, s, d]) and NHD ([b, s, h, d]); GQA (hq a multiple of
hkv); top-left causal masking; any sq / sk; ``return_lse`` gives the
natural-log LSE with the smooth-k correction; ``pv_dtype`` bf16 / int8 /
fp8 / fp8_e5m2 and ``smooth_v``.  V is quantized from the caller's V,
before any head-dim padding, as in the JAX package.  Head dims are
zero-padded to 64, 128, 256, 384 or 512, as the JAX package pads them
(``core.py:70-75``: 64, or the next multiple of 128); above 512 they raise.

Masks, normalised as the JAX package does (:func:`_masks`), run in the
masked kernel: ``q_segment_ids``/``kv_segment_ids`` [b, s] (equal ids
attend), ``q_positions``/``kv_positions`` [b, s] (``kv_pos <= q_pos``), a
bool ``attn_mask`` (True = attend), an additive ``attn_bias`` (a non-bool
``attn_mask`` is one too, with torch's semantics) and a sliding ``window``
(with ``is_causal``).  A row with no live key gives o = 0 and LSE -inf.
Under grad ``window`` and a lone ``attn_bias`` are differentiable; ids,
positions, a bool mask (with a bias or without) and a float
``attn_mask`` raise ``NotImplementedError``, as the JAX package has no
gradient for them.  Head dims above 512 raise ``NotImplementedError``
naming their ROADMAP limits row; every option runs at every head dim up
to 512.  Above 256 the gradient is exact recompute, as the JAX fused
backward declines d > 256 (``attention_bwd_pallas.py:486``).
``block_q`` / ``block_k`` / ``impl`` raise too: the port picks its own
launch configuration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from sageattention_tpu_torch import quant
from sageattention_tpu_torch.ops import attention_cuda, autodiff, quant_cuda
from sageattention_tpu_torch.ops._build import MAX_HEAD_DIM, pad_head_dim
from sageattention_tpu_torch.ops.attention_cuda import Masks

LOG2E = 1.4426950408889634
K_GROUP = attention_cuda.K_GROUP

# qk_quant_gran values: "auto" quantizes K per 128-row tile on the card
_GRANULARITIES = ("auto", *quant.GRANULARITIES)


def _to_hnd(x: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "HND":
        return x
    if layout == "NHD":
        return x.transpose(1, 2)
    raise ValueError(f"tensor_layout must be 'HND' or 'NHD', got {layout!r}")


# the largest padded head dim the fused backward (kernels 7-8) takes
MAX_FUSED_BWD_HEAD_DIM = 256


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
    k_scale: torch.Tensor         # fp32 [b,hkv,ceil(sk/K_GROUP)], or [b,hkv,sk] per row
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


def _mask4(x: torch.Tensor, name: str, b: int, hq: int, sq: int, sk: int) -> torch.Tensor:
    """A mask or bias as a [b, 1 or hq, sq, sk] view (``core.py:177-236`` of
    the JAX package): 2-D is [1, 1, sq, sk], 3-D [b, 1, sq, sk]; batch
    broadcasts from 1, trailing dims of 1 broadcast to (sq, sk).  The view
    is expanded, not copied."""
    if x.dim() == 2:
        x = x[None, None]
    elif x.dim() == 3:
        x = x[:, None]
    elif x.dim() != 4:
        raise ValueError(f"{name} must have 2, 3 or 4 dims, got {tuple(x.shape)}")
    if x.shape[0] not in (1, b):
        raise ValueError(f"{name} batch dim {x.shape[0]} must be 1 or {b}")
    if x.shape[1] not in (1, hq):
        raise ValueError(f"{name} head dim {x.shape[1]} must be 1 or {hq}")
    if not all(ms in (1, full) for ms, full in zip(x.shape[-2:], (sq, sk))):
        raise ValueError(f"{name} trailing dims {tuple(x.shape[-2:])} must be ({sq}, {sk}) "
                         f"or broadcastable (size 1)")
    return x.expand(b, x.shape[1], sq, sk)


def _masks(q, k, *, is_causal: bool, q_segment_ids=None, kv_segment_ids=None, q_positions=None,
           kv_positions=None, attn_mask=None, attn_bias=None, window=None) -> Masks | None:
    """The masked kernel's operands from ``sageattn``'s options on HND q, k,
    normalised as ``core.py:161-243, 396-398`` of the JAX package does: ids
    and positions in pairs, a non-bool ``attn_mask`` added to ``attn_bias``,
    masks and biases as [b, 1 or hq, sq, sk] views, a window only with
    ``is_causal`` and >= 1.  None when no option is given."""
    if attn_mask is not None and attn_mask.dtype != torch.bool:
        # a float mask is an additive bias (torch's semantics)
        attn_bias = attn_mask if attn_bias is None else attn_bias + attn_mask
        attn_mask = None
    if all(x is None for x in (q_segment_ids, kv_segment_ids, q_positions, kv_positions,
                               attn_mask, attn_bias, window)):
        return None
    b, hq, sq = q.shape[:3]
    sk = k.shape[2]
    dev = q.device

    def rows(x, s):  # int32 [b, s] on q's device, batch broadcast from 1
        return None if x is None else x.to(dev, torch.int32).expand(b, s).contiguous()

    if attn_mask is not None:
        attn_mask = _mask4(attn_mask.to(dev), "attn_mask", b, hq, sq, sk)
    if attn_bias is not None:
        if attn_bias.dtype not in (torch.float32, torch.bfloat16):
            attn_bias = attn_bias.float()
        attn_bias = _mask4(attn_bias.to(dev), "attn_bias", b, hq, sq, sk)
    masks = Masks(q_seg=rows(q_segment_ids, sq), kv_seg=rows(kv_segment_ids, sk),
                  q_pos=rows(q_positions, sq), kv_pos=rows(kv_positions, sk),
                  mask=attn_mask, bias=attn_bias, window=window)
    attention_cuda.check_masks(masks, b, hq, sq, sk, dev, is_causal)
    return masks


class QKOptions(NamedTuple):
    """The Q/K quantization options of ``sageattn``; the defaults take the
    default kernels."""

    smooth_q: bool = False
    qk_bits: int = 8
    qk_quant_gran: str = "auto"

    @property
    def default(self) -> bool:
        return not self.smooth_q and self.qk_bits == 8 and self.qk_quant_gran == "auto"


def _smooth_q(q: torch.Tensor):
    """smooth_q's (qm, q - qm): the Q mean over the sequence in fp32 [b,hq,d]
    and the centred Q cast back to q's dtype (``core.py:276-277`` of the
    JAX package), which is what is quantized.  The spec of what
    :func:`_quant_qk` computes with kernels 2 and 4."""
    qm = q.float().mean(dim=-2)
    return qm, (q.float() - qm[..., None, :]).to(q.dtype)


def _score_col_bias(qm, k, km, sm_scale: float) -> torch.Tensor:
    """smooth_q's column bias qm . (k - km) * sm_scale * log2(e), fp32
    [b,hq,sk] (``core.py:279-292`` of the JAX package): a grouped einsum
    under GQA, so that K is not repeated per query head."""
    b, hq, d = qm.shape
    hkv = k.shape[1]
    k_c = k.float() if km is None else k.float() - km[..., None, :]
    qm_g = qm.reshape(b, hkv, hq // hkv, d)
    return torch.einsum("bhgd,bhsd->bhgs", qm_g, k_c).reshape(b, hq, -1) * sm_scale * LOG2E


def _quant_qk(q, k, opts: QKOptions, *, work, d_pad: int, sm_scale: float, smooth_k: bool):
    """The pre-quantized forward's Q and K operands (``core.py:270-347`` of
    the JAX package): (q_i8, q_scale, k_i8, k_scale, km, col_bias), codes
    at the padded head dim, km padded too.  Every option through the
    kernels (``quant.quantize_qk`` and :func:`_smooth_q` are their spec):
    ``smooth_q``'s qm is kernel 2's mean of Q, and kernel 4 quantizes ``q -
    qm`` cast back to q's dtype, qm's column term added back; Q by kernel 4
    at the option's group; K per 128-row tile by kernels 2-3 under "auto",
    else by kernel 4 at the option's group with kernel 2's km, per-row
    scales."""
    bits, d_og = opts.qk_bits, q.shape[-1]
    gran = opts.qk_quant_gran
    group = 1 if gran == "auto" else quant.group_rows(gran)
    qp, kp = _pad_d(q.to(work), d_pad), _pad_d(k.to(work), d_pad)
    qm = quant_cuda.k_channel_mean(qp) if opts.smooth_q else None
    # smooth_q's centred Q is rounded back to the caller's 16-bit type
    cast = q.dtype if qm is not None and q.dtype in (torch.bfloat16, torch.float16) else None
    q_i8, q_scale = quant_cuda.quant_q_per_token(qp, qm, scale_fold=sm_scale * LOG2E, bits=bits,
                                                 group=group, cast=cast)
    if gran == "auto":
        k_i8, k_scale, km = quant_cuda.quant_k_fused_mean(kp, group=K_GROUP, smooth=smooth_k,
                                                          bits=bits)
    else:
        km = quant_cuda.k_channel_mean(kp) if smooth_k else None
        k_i8, k_scale = quant_cuda.quant_q_per_token(kp, km, scale_fold=1.0, bits=bits,
                                                     group=group)
    col_bias = None
    if qm is not None:
        col_bias = _score_col_bias(qm[..., :d_og], k, km[..., :d_og] if km is not None else None,
                                   sm_scale)
    return q_i8, q_scale, k_i8, k_scale, km, col_bias


def _forward(q, k, v, *, is_causal: bool, sm_scale: float | None, smooth_k: bool,
             return_lse: bool, pv_dtype: str = "bf16", smooth_v: bool = False,
             masks: Masks | None = None, opts: QKOptions = QKOptions()) -> Forward:
    """Quantize K and V, then one fused attention call (the masked kernel
    when ``masks`` is given), on HND tensors; with a Q/K option of
    ``opts``, Q and K quantized first and the pre-quantized kernel."""
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
    if d_og > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"head_dim {d_og} > {MAX_HEAD_DIM} is not ported (ROADMAP: limits, head dims "
            f"above 512; the JAX package pads every head dim above 64 to the next multiple "
            f"of 128)"
        )
    work = _work_dtype(q.dtype)
    d_pad = pad_head_dim(d_og)
    v_q, v_scale, v_mean = _quant_v(v, pv_dtype=pv_dtype, smooth_v=smooth_v, d_pad=d_pad)
    if not opts.default:
        q_i8, q_scale, k_i8, k_scale, km, col_bias = _quant_qk(
            q, k, opts, work=work, d_pad=d_pad, sm_scale=sm_scale, smooth_k=smooth_k)
        out = attention_cuda.sage_attention_fwd_preq(
            q_i8, q_scale, k_i8, k_scale, v_q, v_scale, v_mean, is_causal=is_causal,
            return_lse=return_lse, out_dtype=work, col_bias=col_bias, masks=masks)
        o, lse2 = out if return_lse else (out, None)
        return Forward(o[..., :d_og].to(q.dtype), lse2, k_i8, k_scale, km, v_q, v_scale,
                       v_mean, sm_scale)
    qp = _pad_d(q.to(work), d_pad)
    kp = _pad_d(k.to(work), d_pad)
    k_i8, k_scale, km = quant_cuda.quant_k_fused_mean(kp, group=K_GROUP, smooth=smooth_k)
    kw = dict(is_causal=is_causal, q_fold=sm_scale * LOG2E, return_lse=return_lse)
    if masks is None:
        out = attention_cuda.sage_attention_fwd(qp, k_i8, k_scale, v_q, v_scale, v_mean, **kw)
    else:
        out = attention_cuda.sage_attention_fwd_masked(qp, k_i8, k_scale, v_q, v_scale, v_mean,
                                                       masks=masks, **kw)
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
                  smooth_k: bool, return_lse: bool, pv_dtype: str, smooth_v: bool,
                  masks: Masks | None = None, opts: QKOptions = QKOptions()):
    """The forward alone on HND tensors: o, or (o, lse).  The LSE's
    smooth-k term is taken with the caller's q, also under smooth_q
    (``core.py:348-357`` of the JAX package)."""
    f = _forward(q, k, v, is_causal=is_causal, sm_scale=sm_scale, smooth_k=smooth_k,
                 return_lse=return_lse, pv_dtype=pv_dtype, smooth_v=smooth_v, masks=masks,
                 opts=opts)
    if not return_lse:
        return f.o
    return f.o, _lse_nat(f.lse2, q, f.km, f.sm_scale)


def _qk_options(kwargs: dict, smooth_q: bool, qk_quant_gran: str, qk_bits: int) -> QKOptions:
    """The Q/K options, checked; what is left in ``kwargs`` raises: the JAX
    package's TPU launch options, anything else ``TypeError``."""
    if qk_quant_gran not in _GRANULARITIES:
        raise ValueError(f"unknown qk_quant_gran {qk_quant_gran!r}; have {_GRANULARITIES}")
    quant.qk_qmax(qk_bits)  # 8 or 4
    for name in kwargs:
        if name in ("block_q", "block_k", "impl"):
            raise NotImplementedError(
                f"{name}: the port picks its own H100 launch configuration"
            )
        raise TypeError(f"unexpected keyword argument {name!r}")
    return QKOptions(bool(smooth_q), qk_bits, qk_quant_gran)


def _refuse_grad(masks: Masks | None, attn_mask) -> None:
    """The masks that have no gradient under grad: all but the window and a
    lone additive ``attn_bias``.  As in the JAX package (``core.py:802-831``),
    any tensor argument beside the bias keeps a call off its differentiable
    routes, and a float ``attn_mask`` has none."""
    if attn_mask is not None and attn_mask.dtype != torch.bool:
        raise NotImplementedError(
            "a float attn_mask has no gradient (nor in the JAX package, core.py:803-805): pass "
            "the additive bias as attn_bias, whose gradient (dBias) is taken")
    if masks is not None and any(x is not None for x in (masks.q_seg, masks.kv_lo,
                                                         masks.q_pos, masks.mask)):
        raise NotImplementedError(
            "segment ids, positions and bool masks have no gradient (nor in the JAX package, "
            "core.py:798-800), and a bias beside them none either: call sageattn under "
            "torch.no_grad() with them")


def _fused_bias(bias, q: torch.Tensor, k: torch.Tensor, window, opts: QKOptions) -> bool:
    """Whether the fused backward takes the call: a head dim padded to 256
    or less, no bias or a per-head [b, hq, sq, sk] one without a window,
    and no Q/K option (``attention_bwd_pallas.py:418-427, 486``,
    ``autodiff.py:106-114`` of the JAX package).  The rest is
    differentiated by exact recompute; above 256 the JAX fused backward
    declines the call too, and kernels 7-8 have no instance."""
    if not opts.default or pad_head_dim(q.shape[-1]) > MAX_FUSED_BWD_HEAD_DIM:
        return False
    return bias is None or (window is None
                            and tuple(bias.shape) == (*q.shape[:3], k.shape[2]))


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
    smooth_q: bool = False,
    smooth_v: bool = False,
    pv_dtype: str = "bf16",
    qk_quant_gran: str = "auto",
    qk_bits: int = 8,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    attn_mask: torch.Tensor | None = None,
    attn_bias: torch.Tensor | None = None,
    window: int | None = None,
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
    ``sage_attn_bwd_dq``, ``sage_attn_bwd_dkv`` on the card), with the
    ``window`` band, and differentiable in a lone ``attn_bias``: a per-head
    [b, hq, sq, sk] bias without a window takes the kernels' bias instances
    (dQ writes dBias when the bias requires grad), any other shape exact
    recompute.  The masks are those of the module docstring; they are [b,
    s] (ids, positions) or [.., .., sq, sk] whatever the layout.

    ``smooth_q``, ``qk_bits=4`` and ``qk_quant_gran`` = "per_token" /
    "per_subtile" / "per_block" (``block_size`` 32 rows, 128 for
    per_block) run the pre-quantized forward; under grad their gradient is
    exact attention's, recomputed (``autodiff.RecomputeFunction``)."""
    opts = _qk_options(kwargs, smooth_q, qk_quant_gran, qk_bits)
    qh, kh, vh = (_to_hnd(x, tensor_layout) for x in (q, k, v))
    masks = _masks(qh, kh, is_causal=is_causal, q_segment_ids=q_segment_ids,
                   kv_segment_ids=kv_segment_ids, q_positions=q_positions,
                   kv_positions=kv_positions, attn_mask=attn_mask, attn_bias=attn_bias,
                   window=window)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (q, k, v, attn_mask, attn_bias)):
        _refuse_grad(masks, attn_mask)
        args = (qh, kh, vh, attn_bias, is_causal, sm_scale, smooth_k, return_lse, pv_dtype,
                smooth_v, window)
        if _fused_bias(attn_bias, qh, kh, window, opts):
            out = autodiff.SageAttnFunction.apply(*args)
        else:
            out = autodiff.RecomputeFunction.apply(*args, opts)
    else:
        out = _sageattn_hnd(qh, kh, vh, is_causal=is_causal, sm_scale=sm_scale,
                            smooth_k=smooth_k, return_lse=return_lse, pv_dtype=pv_dtype,
                            smooth_v=smooth_v, masks=masks, opts=opts)
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


def varlen_rows(cu_q, cu_k, total_q: int, total_k: int):
    """The packing of ``sageattn_varlen``: the segment of each packed query
    and key token (1 for the first sequence) and each query row's key range
    [kv_lo, kv_hi) (int32), from the int64 cumulative starts."""
    dev = cu_q.device
    seg_q = torch.searchsorted(cu_q, torch.arange(total_q, device=dev), right=True)
    seg_k = torch.searchsorted(cu_k, torch.arange(total_k, device=dev), right=True)
    last = cu_k.shape[0] - 1  # gathers clamp as the JAX package's do
    kv_lo = cu_k[(seg_q - 1).clamp(0, last)].to(torch.int32)
    kv_hi = cu_k[seg_q.clamp(0, last)].to(torch.int32)
    return seg_q, seg_k, kv_lo, kv_hi


def sageattn_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, max_seqlen_q: int | None = None,
                    max_seqlen_k: int | None = None, is_causal: bool = False,
                    sm_scale: float | None = None, return_lse: bool = False, *,
                    smooth_k_mode: str = "global", **kwargs):
    """Attention over FlashAttention-style packed sequences (``core.py:904-1060``
    of the JAX package).

    q, k, v: [total_tokens, heads, head_dim]; ``cu_seqlens_q/k``: [batch+1]
    int32 cumulative sequence starts.  Each query row attends the keys of
    its own sequence, which the masked kernel takes as a per-row range
    [kv_lo, kv_hi) and uses to skip every KV tile outside its Q tile's
    rows' ranges.  Causal needs the same packing of q and k.  Returns o
    [total_q, heads, head_dim] and, with ``return_lse``, the natural-log
    LSE [heads, total_q].

    ``smooth_k_mode``: "global", one K mean over all packed tokens (the
    reference's); "per_segment", each sequence centred by its own K mean,
    exact because no row attends across sequences (the LSE gets each
    row's own correction).  ``pv_dtype`` defaults to "int8" here, as in
    the JAX package; ``smooth_v``, ``smooth_q``, ``qk_bits`` and
    ``qk_quant_gran`` are taken as :func:`sageattn` takes them (smooth_q's
    Q mean over all packed tokens, as in the JAX package).
    ``max_seqlen_q/k`` are the JAX package's TPU block hints and are not
    used.  ``block_q``/``block_k``/``impl`` raise ``NotImplementedError``
    (the port picks its own launch configuration), anything else
    ``TypeError``.  Forward only, as in the JAX package."""
    smooth_k = kwargs.pop("smooth_k", True)
    pv_dtype = kwargs.pop("pv_dtype", "int8")
    smooth_v = kwargs.pop("smooth_v", False)
    opts = _qk_options(kwargs, kwargs.pop("smooth_q", False), kwargs.pop("qk_quant_gran", "auto"),
                       kwargs.pop("qk_bits", 8))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "sageattn_varlen has no gradient (nor in the JAX package): call it under "
            "torch.no_grad()")
    dev = q.device
    cu_q = torch.as_tensor(cu_seqlens_q, device=dev).long()
    cu_k = torch.as_tensor(cu_seqlens_k, device=dev).long()
    if is_causal:
        # causal masking orders rows by their packed position: the same
        # packing of q and k, or a silently wrong mask
        if q.shape[0] != k.shape[0]:
            raise ValueError("causal varlen requires matching q/k packing")
        if cu_q.shape != cu_k.shape:
            raise ValueError(f"causal varlen requires cu_seqlens_q and cu_seqlens_k of the "
                             f"same shape, got {tuple(cu_q.shape)} vs {tuple(cu_k.shape)}")
        if not torch.equal(cu_q, cu_k):
            raise ValueError("causal varlen requires cu_seqlens_q == cu_seqlens_k "
                             "(mismatched packings would silently compute wrong causal masks)")
    if smooth_k_mode not in ("global", "per_segment"):
        raise ValueError(f"unknown smooth_k_mode {smooth_k_mode!r}")
    total_q, hq, d = q.shape
    total_k, hkv = k.shape[0], k.shape[1]
    seg_q, seg_k, kv_lo, kv_hi = varlen_rows(cu_q, cu_k, total_q, total_k)
    qh, kh, vh = (x.transpose(0, 1)[None] for x in (q, k, v))
    lse_corr = None
    if smooth_k and smooth_k_mode == "per_segment":
        # centre each sequence's K by its own mean, then no global smoothing
        n_seg = cu_k.shape[0] + 1
        kf = k.float()
        seg_sum = kf.new_zeros(n_seg, hkv, d).index_add_(0, seg_k, kf)
        counts = kf.new_zeros(n_seg).index_add_(0, seg_k, kf.new_ones(total_k))
        km_seg = seg_sum / counts.clamp_min(1.0)[:, None, None]
        kh = (kf - km_seg[seg_k]).transpose(0, 1)[None].to(k.dtype)
        smooth_k = False
        if return_lse:
            # each row's LSE correction q_i . km(segment of i) * sm_scale
            sm = sm_scale if sm_scale is not None else d**-0.5
            km_rows = km_seg[seg_q.clamp(max=n_seg - 1)].repeat_interleave(hq // hkv, dim=1)
            lse_corr = torch.einsum("thd,thd->th", q.float(), km_rows).T[None] * sm
    out = _sageattn_hnd(qh, kh, vh, is_causal=is_causal, sm_scale=sm_scale, smooth_k=smooth_k,
                        return_lse=return_lse, pv_dtype=pv_dtype, smooth_v=smooth_v,
                        masks=Masks(kv_lo=kv_lo[None], kv_hi=kv_hi[None]), opts=opts)
    if not return_lse:
        return out[0].transpose(0, 1)
    o, lse = out
    if lse_corr is not None:
        lse = lse + lse_corr
    return o[0].transpose(0, 1), lse[0]
