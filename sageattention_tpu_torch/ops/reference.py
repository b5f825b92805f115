"""Reference attention in plain PyTorch: the CPU path and the oracle.

* :func:`attention_reference`: exact fp32 attention, the accuracy target.
* :func:`quantized_attention_reference`: the arithmetic of the fused
  kernel written out unfused (int8 QK^T dequantized by per-row scales,
  base-2 softmax, P.V), the correctness target.
* :func:`quantized_attention_bwd_reference`: the arithmetic of the two
  backward kernels, the straight-through gradient of the quantized forward.
* :func:`decode_reference`: exact fp32 decode of a few query tokens
  against unquantized K/V, the accuracy target of the decode kernels.
* :func:`merge_attention_partials`: the LSE merge of partial attentions
  over disjoint KV shards (the ring's merge).

Both loop over (batch, head) slabs so that one slab's [sq, sk] score
matrix is the largest temporary: at CogVideoX-2B's 17,776 tokens that is
1.26 GB in fp32, where all 30 heads at once would not fit on the card.
Causal masking is top-left aligned (``col <= row``); a sliding ``window``
keeps the keys ``col > row - window`` (:func:`window_band_mask`).  The
other masks (:func:`_build_mask`): segment ids (equal ids attend), their
contiguous range form ``q_kv_lo``/``q_kv_hi`` (varlen), positions
(``kv_pos <= q_pos``) and a bool mask, each broadcastable to [b, h, sq,
sk] with a head dim of 1 or hq.
"""

from __future__ import annotations

import torch

LOG2E = 1.4426950408889634
# finite mask value: exp(MASK_VALUE - m) is 0 without an inf - inf
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# the backward's floor of biased base-2 logits (the TPU kernels' clamp)
LOGIT_FLOOR = -1e30


def window_band_mask(sq: int, sk: int, window: int, device=None) -> torch.Tensor:
    """[sq, sk] bool: key col within the last ``window`` positions of query
    row (top-left aligned; the upper edge comes from ``is_causal``), the
    JAX package's band convention."""
    row = torch.arange(sq, device=device)[:, None]
    return torch.arange(sk, device=device)[None, :] > row - window


def _build_mask(sq: int, sk: int, *, is_causal: bool, device, window: int | None = None,
                q_segment_ids=None, kv_segment_ids=None, q_positions=None, kv_positions=None,
                attn_mask=None, q_kv_lo=None, q_kv_hi=None) -> torch.Tensor | None:
    """One bool mask (True = attend) broadcastable against [b, h, sq, sk]
    scores, or None: causal and the sliding window [sq, sk]; positions,
    segment ids and their range form [b, 1, sq, sk]; a bool ``attn_mask``
    of 2, 3 or 4 dims.  As in the JAX package, every [b, sq, sk] part gets
    its own head axis before the parts are combined."""
    if window is not None and not is_causal:
        raise ValueError("window requires is_causal=True")
    parts = []
    if is_causal:
        row = torch.arange(sq, device=device)[:, None]
        col = torch.arange(sk, device=device)[None, :]
        causal = col <= row
        if window is not None:
            causal = causal & window_band_mask(sq, sk, window, device)
        parts.append(causal)
    if q_positions is not None:
        parts.append((kv_positions[:, None, :] <= q_positions[:, :, None])[:, None])
    if q_segment_ids is not None:
        parts.append((q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])[:, None])
    if q_kv_lo is not None:
        col = torch.arange(sk, device=device)
        parts.append(((col >= q_kv_lo[..., None]) & (col < q_kv_hi[..., None]))[:, None])
    if attn_mask is not None:
        if attn_mask.dtype != torch.bool:
            raise TypeError("a float attn_mask is an additive bias: pass it as attn_bias")
        parts.append(attn_mask[:, None] if attn_mask.dim() == 3 else attn_mask)
    mask = None
    for m in parts:
        mask = m if mask is None else mask & m
    return mask


def _slab(x: torch.Tensor | None, bi: int, h: int) -> torch.Tensor | None:
    """The [sq, sk] slab of (batch bi, query head h) of a mask or bias of 2
    dims or 4 (batch and head dims of 1 broadcast)."""
    if x is None or x.dim() == 2:
        return x
    return x[bi if x.shape[0] > 1 else 0, h if x.shape[1] > 1 else 0]


def _as_4d(x: torch.Tensor | None) -> torch.Tensor | None:
    """A 2-D [sq, sk] or 3-D [b, sq, sk] mask or bias as [.., .., sq, sk]."""
    if x is None or x.dim() == 4:
        return x
    return x[None, None] if x.dim() == 2 else x[:, None]


def _kv_head(h: int, hq: int, hkv: int) -> int:
    """GQA: query head h reads kv head h // (hq // hkv) (``jnp.repeat``)."""
    return h // (hq // hkv)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    is_causal: bool = False,
    sm_scale: float | None = None,
    return_lse: bool = False,
    window: int | None = None,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    attn_bias: torch.Tensor | None = None,
    attn_mask: torch.Tensor | None = None,
):
    """Exact fp32 attention on HND [b, h, s, d] tensors; GQA when k/v have
    fewer heads; ``window`` (with ``is_causal``) keeps each query's last
    ``window`` keys; the masks of :func:`_build_mask`; ``attn_bias`` is
    added to the scaled scores before the masks.  A row with no live key
    averages V uniformly, as the JAX reference does.  Returns o in q's
    dtype and, if asked, the natural-log LSE [b, hq, sq] in fp32."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d**-0.5
    mask = _build_mask(sq, sk, is_causal=is_causal, device=q.device, window=window,
                       q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                       q_positions=q_positions, kv_positions=kv_positions,
                       attn_mask=attn_mask)
    bias = _as_4d(attn_bias)
    o = torch.empty(b, hq, sq, v.shape[-1], dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    for bi in range(b):
        for h in range(hq):
            hk = _kv_head(h, hq, hkv)
            s = (q[bi, h].float() @ k[bi, hk].float().T) * sm_scale
            if bias is not None:
                s = s + _slab(bias, bi, h).float()
            if mask is not None:
                s = torch.where(_slab(mask, bi, h), s, MASK_VALUE)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(dim=-1, keepdim=True)
            o[bi, h] = ((p / l) @ v[bi, hk].float()).to(q.dtype)
            lse[bi, h] = (m + torch.log(l))[:, 0]
    return (o, lse) if return_lse else o


def quantized_attention_reference(
    q_i8: torch.Tensor,
    q_scale: torch.Tensor,
    k_i8: torch.Tensor,
    k_scale: torch.Tensor,
    v: torch.Tensor,
    v_scale: torch.Tensor | None = None,
    v_mean: torch.Tensor | None = None,
    *,
    is_causal: bool = False,
    return_lse: bool = False,
    out_dtype=torch.bfloat16,
    window: int | None = None,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    attn_mask: torch.Tensor | None = None,
    attn_bias: torch.Tensor | None = None,
    q_kv_lo: torch.Tensor | None = None,
    q_kv_hi: torch.Tensor | None = None,
    score_col_bias: torch.Tensor | None = None,
):
    """Unfused spec of the fused kernel's arithmetic.

    ``q_scale`` [b,hq,sq] and ``k_scale`` [b,hkv,sk] are per-row fp32
    scales, with ``sm_scale * log2(e)`` folded into ``q_scale``; ``v`` is
    the bf16 (or fp32) V, or its int8 / fp8 codes with the per-channel
    ``v_scale`` [b,hkv,d]; ``v_mean`` [b,hkv,d], if given, is added back
    (smooth-v).  ``score_col_bias`` [b,hq,sk] fp32, if given, is added to
    the dequantized base-2 scores (smooth-q's ``qm . (k - km)`` column
    term, ``reference.py:214-216`` of the JAX package).  The epilogue runs
    in the JAX order ``(pv * v_scale) / l + v_mean``.  Returns o and, if asked, the base-2 LSE ``log2(l) + m`` as
    the kernel stores it.

    The int8 product runs as an fp32 matmul of the codes, which is exact:
    |sum| <= 127^2 * d < 2^24 for d <= 1024.  P stays fp32 here, where the
    kernel rounds it to bf16 before P.V.

    The masks are those of :func:`_build_mask`, with ``window`` and the
    range form ``q_kv_lo``/``q_kv_hi`` [b, sq] (row attends [lo, hi)).
    ``attn_bias`` follows the fused kernel (``attention_pallas.py:689-705``):
    ``bias * log2(e)`` joins the dequantized base-2 scores, clamped below
    at ``MASK_VALUE``.  (The JAX ``quantized_attention_reference`` takes no
    bias: its XLA path runs a bias through exact attention.)  A row with no
    live key, masked out or all ``-inf`` bias, gives o = 0 (no v_mean) and
    lse2 = -inf, as the fused kernel does (``:750-777, 1187-1204``)."""
    b, hq, sq, d = q_i8.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    mask = _build_mask(sq, sk, is_causal=is_causal, device=q_i8.device, window=window,
                       q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                       q_positions=q_positions, kv_positions=kv_positions,
                       attn_mask=attn_mask, q_kv_lo=q_kv_lo, q_kv_hi=q_kv_hi)
    bias = _as_4d(attn_bias)
    o = torch.empty(b, hq, sq, v.shape[-1], dtype=out_dtype, device=q_i8.device)
    lse2 = torch.empty(b, hq, sq, dtype=torch.float32, device=q_i8.device)
    for bi in range(b):
        for h in range(hq):
            hk = _kv_head(h, hq, hkv)
            s_i = q_i8[bi, h].float() @ k_i8[bi, hk].float().T
            s = s_i * q_scale[bi, h, :, None] * k_scale[bi, hk, None, :]
            if score_col_bias is not None:
                s = s + score_col_bias[bi, h, None, :].float()
            if bias is not None:
                s = torch.clamp(s + _slab(bias, bi, h).float() * LOG2E, min=MASK_VALUE)
            mk = _slab(mask, bi, h)
            if mk is not None:
                s = torch.where(mk, s, MASK_VALUE)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp2(s - m)
            if mk is not None:
                p = torch.where(mk, p, 0.0)
            if mk is not None or bias is not None:
                p = torch.where(m > MASK_VALUE, p, 0.0)  # rows with no live key
            l = p.sum(dim=-1, keepdim=True)
            pv = p @ v[bi, hk].float()
            if v_scale is not None:
                pv = pv * v_scale[bi, hk]
            oh = torch.where(l > 0, pv / l, 0.0)
            if v_mean is not None:
                oh = oh + torch.where(l > 0, v_mean[bi, hk], 0.0)
            o[bi, h] = oh.to(out_dtype)
            lse2[bi, h] = torch.where(l > 0, torch.log2(l) + m, -torch.inf)[:, 0]
    return (o, lse2) if return_lse else o


def quantized_attention_bwd_reference(
    q_i8: torch.Tensor,
    q_scale: torch.Tensor,
    k_i8: torch.Tensor,
    k_scale: torch.Tensor,
    k_sm: torch.Tensor | None,
    q_bf: torch.Tensor | None,
    v: torch.Tensor,
    do: torch.Tensor,
    lse2: torch.Tensor,
    dvec: torch.Tensor,
    *,
    is_causal: bool,
    sm_scale: float,
    window: int | None = None,
    bias: torch.Tensor | None = None,
    need_dbias: bool = False,
):
    """Unfused spec of the backward kernels: returns (dq, dk, dv) in fp32,
    and dBias with ``need_dbias``.

    ``q_i8``/``q_scale`` and ``k_i8``/``k_scale`` (per-row scales [b,h,s],
    ``sm_scale * log2(e)`` in ``q_scale``) are the forward's quantized
    operands, ``lse2`` its base-2 LSE [b,hq,sq], ``dvec`` = rowsum(dO * O)
    minus any LSE cotangent [b,hq,sq].  ``k_sm`` is bf16(K - km), ``q_bf``
    bf16(Q), ``v`` and ``do`` bf16.  Per (b, q head):

        P = exp2(l2 - lse2),  l2 = s_i32 * (q_scale * k_scale)
        dV += bf16(P)^T . dO        dP = dO . V^T
        dS = bf16(P * (dP - dvec))
        dQ = dS . K_sm * sm_scale   dK += dS^T . Q * sm_scale

    dK and dV sum over the GQA group.  The bf16 roundings sit where the
    TPU kernels put them (``attention_bwd_pallas.py`` ``ds.astype`` and
    ``pt.astype``); products of bf16 values are exact in fp32 and every sum
    is fp32.  ``k_sm=None`` skips dQ and ``q_bf=None`` skips dK (returned
    as None).  ``window`` (with ``is_causal``) masks as the forward does.

    ``bias`` [b, hq, sq, sk] (fp32 or bf16), the forward's additive bias
    (``attention_bwd_pallas.py:160-204``): ``bias * log2(e)`` joins l2,
    clamped below at ``LOGIT_FLOOR``, and a row whose lse2 is -inf (no
    live key: its o was 0) takes 0 in its place, so its P is 0.  With
    ``need_dbias``, dBias = P * (dP - dvec) in fp32, before the bf16
    rounding, in the bias's dtype (0 wherever P is masked)."""
    b, hq, sq, _ = q_i8.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    mask = _build_mask(sq, sk, is_causal=is_causal, device=q_i8.device, window=window)
    f32 = dict(dtype=torch.float32, device=q_i8.device)
    dq = torch.zeros(q_i8.shape, **f32) if k_sm is not None else None
    dk = torch.zeros(k_i8.shape, **f32) if q_bf is not None else None
    dv = torch.zeros(k_i8.shape, **f32)
    dbias = torch.empty_like(bias) if need_dbias else None
    for bi in range(b):
        for h in range(hq):
            hk = _kv_head(h, hq, hkv)
            s_i = q_i8[bi, h].float() @ k_i8[bi, hk].float().T
            # the kernels' operand order: s * (q_scale * k_scale)
            l2 = s_i * (q_scale[bi, h, :, None] * k_scale[bi, hk, None, :])
            lse = lse2[bi, h, :, None]
            if bias is not None:
                l2 = torch.clamp(l2 + bias[bi, h].float() * LOG2E, min=LOGIT_FLOOR)
                lse = torch.where(torch.isneginf(lse), 0.0, lse)
            p = torch.exp2(l2 - lse)
            if mask is not None:
                p = torch.where(mask, p, 0.0)
            do_h = do[bi, h].float()
            dv[bi, hk] += p.to(torch.bfloat16).float().T @ do_h
            dp = do_h @ v[bi, hk].float().T
            ds = p * (dp - dvec[bi, h, :, None])
            if dbias is not None:
                dbias[bi, h] = ds.to(dbias.dtype)
            ds = ds.to(torch.bfloat16).float()
            if dq is not None:
                dq[bi, h] = (ds @ k_sm[bi, hk].float()) * sm_scale
            if dk is not None:
                dk[bi, hk] += ds.T @ q_bf[bi, h].float()
    if dk is not None:
        dk *= sm_scale
    return (dq, dk, dv, dbias) if need_dbias else (dq, dk, dv)


def decode_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths, *, sm_scale: float | None = None,
                     window: int | None = None) -> torch.Tensor:
    """Exact fp32 decode of t_q query tokens against unquantized K/V.

    q [b, hq, t_q, d]; k, v [b, hkv, S, d]; ``lengths`` [b] counts the live
    keys including the t_q new ones.  Query token t sits at position
    ``length - t_q + t`` and attends keys up to it (and, with ``window``,
    after ``position - window``).  Returns fp32 [b, hq, t_q, d]."""
    b, hq, t_q, d = q.shape
    if sm_scale is None:
        sm_scale = d**-0.5
    out = torch.zeros(b, hq, t_q, v.shape[-1], dtype=torch.float32, device=q.device)
    for bi, length in enumerate(torch.as_tensor(lengths).tolist()):
        length = int(length)
        pos = length - t_q + torch.arange(t_q, device=q.device)[:, None]
        col = torch.arange(length, device=q.device)[None, :]
        mask = col <= pos
        if window is not None:
            mask = mask & (col > pos - window)
        kb = k[bi, :, :length].float().repeat_interleave(hq // k.shape[1], dim=0)
        vb = v[bi, :, :length].float().repeat_interleave(hq // v.shape[1], dim=0)
        s = torch.einsum("hqd,hkd->hqk", q[bi].float(), kb) * sm_scale
        s = torch.where(mask, s, MASK_VALUE)
        out[bi] = torch.einsum("hqk,hkd->hqd", torch.softmax(s, dim=-1), vb)
    return out


def merge_attention_partials(o_parts, lse_parts):
    """Merge partial attention outputs over disjoint KV shards through their
    natural-log LSEs [b, h, sq]: the ring's merge, all shards at once.
    Returns (o in the first part's dtype, the merged LSE)."""
    lse = torch.stack(list(lse_parts), dim=0)  # [n, b, h, sq]
    m = lse.amax(dim=0)
    w = torch.exp(lse - m[None])
    denom = w.sum(dim=0)
    o = torch.stack([x.float() for x in o_parts], dim=0)
    o_merged = (o * w[..., None]).sum(dim=0) / denom[..., None]
    return o_merged.to(o_parts[0].dtype), m + torch.log(denom)
