"""Autograd for ``sageattn``: the quantized forward and its fused backward.

The counterpart of the JAX package's ``ops/autodiff.py`` (``_cached``'s
custom VJP) and ``attention_bwd_pallas.quantized_attention_vjp``.  The
gradient is the straight-through gradient of the quantized forward (the
quantizers' scales are constants): P is recomputed from the forward's own
int8 codes and base-2 LSE, so it is the gradient of what the forward
computed, not of a different kernel.

* Forward: the forward of ``core`` with its LSE.  It saves q, k, v, o, the
  base-2 LSE, the forward's K codes, K scales and smooth-k mean and, with
  quantized V, the V codes, scales and smooth-v mean, so the backward
  quantizes nothing but Q.
* Backward: Q quantized again by ``quant_q_per_token`` (bit for bit the
  forward kernel's in-kernel quantization, which the saved LSE was built
  from), ``K_sm = bf16(K - km)``, the V the forward multiplied
  (``bf16(v_q * v_scale + v_mean)`` from the saved codes, or ``bf16(V)``;
  ``attention_bwd_pallas.py:506-532``), ``dvec = rowsum(dO * O) - dlse``
  in plain PyTorch, then the dQ and dK/dV kernels and the smooth-k LSE
  term ``dQ += dlse * km * sm_scale``.  dV is Pt.dO, straight through the
  V quantizer.

A sliding ``window`` (with causal) and an additive ``attn_bias`` are the
masks with a gradient.  The forward runs the masked kernel with them; the
backward kernels apply the same band (``attention_bwd_pallas.py:117-143,
274-287``) or add the same bias to the recomputed logits, and dQ writes
dBias = dS blockwise when the bias needs a gradient (the JAX package's
``differentiable_sageattn_bias``, ``autodiff.py:203-271``).  As there, the
kernels take a per-head ``[b, hq, sq, sk]`` bias without a window; every
other bias form, a bias with a window and a bias with a Q/K option take
:class:`RecomputeFunction`, whose backward differentiates exact attention
with the bias (:func:`exact_attention_vjp`), [b, hq, sq, sk] scores.

Every length is taken: the kernels mask the ragged edge.  (The JAX fused
backward takes only multiples of 128 and falls back to an exact,
unquantized recompute elsewhere; ROADMAP records the difference.)  The
callers pass HND tensors: ``core`` normalises NHD first.

The Q/K options (``smooth_q``, ``qk_bits=4``, ``qk_quant_gran`` other than
"auto") are outside what the fused backward models (the JAX package's
``_FUSED_BWD_KWARGS``, ``autodiff.py:106-114``): :class:`RecomputeFunction`
runs their quantized forward and differentiates exact attention,
recomputed from the saved q, k and v (:func:`exact_attention_vjp`), as the
JAX package does (``autodiff.py:173-196``).  So are head dims above 256
(``core._fused_bias`` routes them), which the JAX fused backward declines.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from sageattention_tpu_torch import core
from sageattention_tpu_torch.ops import attention_bwd_cuda, quant_cuda, reference

LOG2E = 1.4426950408889634
# SDPA as PyTorch defines it, bound at import: ``interop.patch_torch_sdpa``
# replaces the module attribute with ``sageattn``, whose exact-recompute
# backward must not run through itself
_SDPA = F.scaled_dot_product_attention


def effective_v(v, v_q, v_scale, v_mean, d_pad: int) -> torch.Tensor:
    """The V the forward multiplied, bf16 at the padded head dim: from the
    saved codes ``bf16(v_q * v_scale + v_mean)``, or ``bf16(V)`` when V was
    not quantized."""
    if v_scale is None:
        return core._pad_d(v.to(torch.bfloat16), d_pad)
    v_eff = v_q.float() * v_scale[..., None, :]
    if v_mean is not None:
        v_eff = v_eff + v_mean[..., None, :]
    return v_eff.to(torch.bfloat16)


def backward_operands(q, k, v, do, *, o, k_i8, km, dlse, sm_scale: float, v_q=None,
                      v_scale=None, v_mean=None) -> dict:
    """The backward kernels' operands besides the forward's K codes, K
    scales and LSE: the Q codes and scales (``quant_q_per_token``), bf16
    Q, K - km, the effective V (:func:`effective_v`) and dO at the
    forward's padded head dim, and ``dvec`` = rowsum(dO * O) - dlse in
    fp32."""
    d_pad = k_i8.shape[-1]
    qp = core._pad_d(q.to(core._work_dtype(q.dtype)), d_pad)
    q_i8, q_scale = quant_cuda.quant_q_per_token(qp, scale_fold=sm_scale * LOG2E)
    k_sm = core._pad_d(k.to(core._work_dtype(k.dtype)), d_pad).float()
    if km is not None:
        k_sm = k_sm - km[..., None, :]
    q_bf, do_bf = (core._pad_d(x.to(torch.bfloat16), d_pad) for x in (q, do))
    v_bf = effective_v(v, v_q, v_scale, v_mean, d_pad)
    dvec = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        dvec = dvec - dlse.float()
    return dict(q_i8=q_i8, q_scale=q_scale, q_bf=q_bf, k_sm=k_sm.to(torch.bfloat16),
                v=v_bf, do=do_bf, dvec=dvec.contiguous())


def quantized_attention_vjp(q, k, v, do, *, o, lse2, k_i8, k_scale, km, dlse, is_causal: bool,
                            sm_scale: float, v_q=None, v_scale=None, v_mean=None,
                            window: int | None = None, bias=None, need_dbias: bool = False):
    """(dq, dk, dv) in the dtypes of q, k, v, from the forward's residuals:
    ``o`` (q's dtype), ``lse2`` (base 2), ``k_i8``/``k_scale``/``km`` (the
    forward's K quantization, head dim padded) and, with quantized V,
    ``v_q``/``v_scale``/``v_mean`` (its V quantization, head dim padded).
    ``dlse`` is the cotangent of the natural-log LSE, or None; ``window``
    the forward's sliding window (with ``is_causal``), or None; ``bias``
    the forward's additive bias, contiguous [b, hq, sq, sk] fp32 or bf16,
    or None.  With ``need_dbias`` the result is (dq, dk, dv, dbias),
    dbias in the bias's dtype."""
    d_og = q.shape[-1]
    ops = backward_operands(q, k, v, do, o=o, k_i8=k_i8, km=km, dlse=dlse, sm_scale=sm_scale,
                            v_q=v_q, v_scale=v_scale, v_mean=v_mean)
    common = dict(q_i8=ops["q_i8"], q_scale=ops["q_scale"], k_i8=k_i8, k_scale=k_scale,
                  v=ops["v"], do=ops["do"], lse2=lse2, dvec=ops["dvec"],
                  is_causal=is_causal, sm_scale=sm_scale, window=window, bias=bias)
    dq = attention_bwd_cuda.sage_attention_bwd_dq(k_sm=ops["k_sm"], need_dbias=need_dbias,
                                                  **common)
    if need_dbias:
        dq, dbias = dq
    dk, dv = attention_bwd_cuda.sage_attention_bwd_dkv(q_bf=ops["q_bf"], **common)
    if dlse is not None and km is not None:
        # the smooth-k LSE correction q . km * sm_scale; its km pathway
        # through K cancels in the LSE identity
        km_q = km.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
        dq = dq + dlse[..., None].float() * (km_q[:, :, None, :] * sm_scale)
    grads = (dq[..., :d_og].to(q.dtype), dk[..., :d_og].to(k.dtype),
             dv[..., :d_og].to(v.dtype))
    return grads + (dbias,) if need_dbias else grads


class SageAttnFunction(torch.autograd.Function):
    """``sageattn`` on HND tensors with the fused quantized backward.

    ``apply(q, k, v, bias, is_causal, sm_scale, smooth_k, return_lse,
    pv_dtype, smooth_v, window)`` returns o, or (o, lse) with
    ``return_lse``; both are differentiable.  ``window`` (None or >= 1,
    with ``is_causal``) runs the masked forward kernel and the backward
    kernels' band.  ``bias`` is None or a per-head [b, hq, sq, sk] additive
    bias (any float dtype, not with a window): the masked forward and the
    backward kernels' bias instances, with dBias written only when the
    bias needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, is_causal, sm_scale, smooth_k, return_lse, pv_dtype,
                smooth_v, window=None):
        masks = core._masks(q, k, is_causal=is_causal, attn_bias=bias, window=window)
        f = core._forward(q, k, v, is_causal=is_causal, sm_scale=sm_scale, smooth_k=smooth_k,
                          return_lse=True, pv_dtype=pv_dtype, smooth_v=smooth_v, masks=masks)
        # the V codes only when quantized: bf16 V is rebuilt from v
        v_q = f.v_q if f.v_scale is not None else None
        # the kernels' bias: fp32 or bf16, contiguous; dBias goes back in the
        # caller's dtype and device
        kernel_bias = masks.bias.contiguous() if bias is not None else None
        ctx.save_for_backward(q, k, v, f.o, f.lse2, f.k_i8, f.k_scale, f.km, v_q, f.v_scale,
                              f.v_mean if v_q is not None else None, kernel_bias)
        ctx.is_causal, ctx.sm_scale, ctx.return_lse = is_causal, f.sm_scale, return_lse
        ctx.window = window
        ctx.bias_to = None if bias is None else dict(dtype=bias.dtype, device=bias.device)
        if return_lse:
            return f.o, core._lse_nat(f.lse2, q, f.km, f.sm_scale)
        return f.o

    @staticmethod
    def backward(ctx, do, dlse=None):
        (q, k, v, o, lse2, k_i8, k_scale, km, v_q, v_scale, v_mean,
         kernel_bias) = ctx.saved_tensors
        need_dbias = ctx.needs_input_grad[3]
        grads = quantized_attention_vjp(
            q, k, v, do, o=o, lse2=lse2, k_i8=k_i8, k_scale=k_scale, km=km,
            dlse=dlse if ctx.return_lse else None, is_causal=ctx.is_causal,
            sm_scale=ctx.sm_scale, v_q=v_q, v_scale=v_scale, v_mean=v_mean, window=ctx.window,
            bias=kernel_bias, need_dbias=need_dbias)
        dbias = grads[3].to(**ctx.bias_to) if need_dbias else None
        return (*grads[:3], dbias, None, None, None, None, None, None, None)


def _exact_attention(q, k, v, bias, *, is_causal: bool, sm_scale: float | None,
                     window: int | None, return_lse: bool):
    """Exact fp32 attention with an additive bias (None, or any shape that
    broadcasts to [b, hq, sq, sk], in the user's dtype and device) and the
    causal window band, by the fused kernel's rule for a row whose every
    score is -inf (an all -inf bias on its live keys): o = 0 and LSE -inf,
    where a softmax would give NaN.  Masked scores are -inf too, so such a
    row takes no weight from them.  It materializes [b, hq, sq, sk]."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d**-0.5
    kr, vr = (x.float().repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * sm_scale
    if bias is not None:
        s = s + reference._as_4d(bias).to(q.device, torch.float32)
    mask = reference._build_mask(sq, sk, is_causal=is_causal, device=q.device, window=window)
    if mask is not None:
        s = s.masked_fill(~mask, -torch.inf)
    m = s.amax(dim=-1, keepdim=True).detach()
    live = m > -torch.inf
    m = torch.where(live, m, 0.0)
    p = torch.exp(s - m)  # 0 across a dead row
    l = torch.where(live, p.sum(dim=-1, keepdim=True), 1.0)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l, vr).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.where(live, m + torch.log(l), -torch.inf)[..., 0]


def _sdpa_route(q: torch.Tensor) -> bool:
    """Whether the exact recompute takes PyTorch's SDPA (on the card)."""
    return q.device.type == "cuda"


def exact_attention_vjp(q, k, v, do, dlse, *, is_causal: bool, sm_scale: float | None,
                        window: int | None = None, bias=None, need_dbias: bool = False):
    """(dq, dk, dv) of exact attention at the saved q, k, v (HND; GQA when k
    and v have fewer heads), for the cotangents ``do`` of o and ``dlse`` of
    the natural-log LSE (either may be None); with ``need_dbias``, (dq,
    dk, dv, dbias), dbias in the shape, dtype and device of ``bias``.

    On the card without a bias, an LSE cotangent or a ``window``: exact
    attention recomputed under autograd by ``F.scaled_dot_product_attention``
    (bound at import, so that ``patch_torch_sdpa`` does not reach it),
    K and V repeated over the GQA group inside the graph so that their
    gradients sum over it, where the JAX package takes jax's library flash
    attention on a TPU.  Otherwise autograd through :func:`_exact_attention`,
    the JAX package's exact VJP of ``reference.attention_reference`` with
    the bias and the window band (``autodiff.py:173-188, 255-268``), a row
    with no live key given 0."""
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    if bias is not None:
        bias = bias.detach().requires_grad_(need_dbias)
        if need_dbias:
            xs.append(bias)
    lse = dlse is not None
    with torch.enable_grad():
        if bias is None and not lse and window is None and _sdpa_route(q):
            rep_ = q.shape[1] // k.shape[1]
            kr, vr = (x.repeat_interleave(rep_, dim=1) for x in xs[1:])
            out = _SDPA(xs[0], kr, vr, is_causal=is_causal, scale=sm_scale)
        else:
            out = _exact_attention(*xs[:3], bias, is_causal=is_causal, sm_scale=sm_scale,
                                   window=window, return_lse=lse)
    outs = out if lse else (out,)
    if do is None:  # only the LSE is used
        do = torch.zeros_like(outs[0])
    cts = (do,) if dlse is None else (do, dlse)
    return torch.autograd.grad(outs, xs, cts)


class RecomputeFunction(torch.autograd.Function):
    """``sageattn`` on HND tensors whose backward is exact recompute: a Q/K
    option (``core.QKOptions``), a bias the fused backward does not take
    (broadcast forms, a bias with a window or an option), or a head dim
    padded above 256 (384, 512), which the JAX fused backward declines
    (``attention_bwd_pallas.py:486``) and kernels 7-8 have no instance of.

    ``apply(q, k, v, bias, is_causal, sm_scale, smooth_k, return_lse,
    pv_dtype, smooth_v, window, opts)``: the quantized forward (with the
    bias and the window; the pre-quantized kernel with an option), saving
    q, k, v and the bias; the backward is :func:`exact_attention_vjp`,
    dBias only when the bias needs a gradient.  It launches none of the
    backward's kernels.  An output that is not used gets no cotangent (not
    a zero one), so an unused LSE keeps the recompute off the
    materialized-scores path."""

    @staticmethod
    def forward(ctx, q, k, v, bias, is_causal, sm_scale, smooth_k, return_lse, pv_dtype,
                smooth_v, window, opts):
        ctx.set_materialize_grads(False)
        out = core._sageattn_hnd(q, k, v, is_causal=is_causal, sm_scale=sm_scale,
                                 smooth_k=smooth_k, return_lse=return_lse, pv_dtype=pv_dtype,
                                 smooth_v=smooth_v,
                                 masks=core._masks(q, k, is_causal=is_causal, attn_bias=bias,
                                                   window=window),
                                 opts=opts)
        ctx.save_for_backward(q, k, v, bias)
        ctx.is_causal, ctx.sm_scale, ctx.window = is_causal, sm_scale, window
        return out

    @staticmethod
    def backward(ctx, do, dlse=None):
        q, k, v, bias = ctx.saved_tensors
        need_dbias = ctx.needs_input_grad[3]
        grads = exact_attention_vjp(q, k, v, do, dlse, is_causal=ctx.is_causal,
                                    sm_scale=ctx.sm_scale, window=ctx.window, bias=bias,
                                    need_dbias=need_dbias)
        dbias = grads[3] if need_dbias else None
        return (*grads[:3], dbias, None, None, None, None, None, None, None, None)
