"""Fused int8-QK^T / bf16-PV attention forward: CUDA wrappers and plain version.

Replaces the TPU kernel ``sageattention_tpu/ops/attention_pallas.py``:
``sage_attention_fused`` (``_kernel`` / ``_kernel_single``) for bf16 V and
for int8 / fp8 V codes with per-channel scales and the smooth-v mean
(its default ``pv_compute="bf16"``: codes widened to bf16, P.V in bf16),
and with its masks (:class:`Masks`: segment ids and varlen's range form,
positions, a bool mask, an additive bias, a sliding window), and on
pre-quantized operands (int8 or +-7 Q codes with per-row scales, K scales
per tile or per row, smooth-q's column bias).  Three wrappers over
libraries of TMA-fed ``wgmma`` kernels, with masks and without
(``csrc/attention_fwd_sm90.cuh`` at head dims 64, 128 and 256: a producer
warpgroup and two consumer warpgroups of 64 Q rows each;
``csrc/attention_fwd_sm90_wide.cuh`` at 384 and 512: one 64-row Q tile a
CTA, O's columns split between the two consumer warpgroups; the masks'
pieces in ``csrc/attention_fwd_kernel.cuh``; :func:`route` names a call's
library; each source says what bounds it).  Before every launch, V codes
are widened to bf16 by :func:`widen_v_codes` (``csrc/widen_v.cu``), which
counts its own launches:
:func:`sage_attention_fwd` (``csrc/attention_fwd.cu``, no masks),
:func:`sage_attention_fwd_masked` (``csrc/attention_fwd_masked.cu``) and
:func:`sage_attention_fwd_preq` (``csrc/attention_fwd_preq.cu``, with
masks or without), at head dims 64 and 128.  At 256 they launch the
instances of ``csrc/attention_fwd_hd256.cu``,
``csrc/attention_fwd_masked_hd256.cu`` and
``csrc/attention_fwd_preq_hd256.cu``, and at 384 and 512 those of
``csrc/attention_fwd_wide.cu``, ``csrc/attention_fwd_masked_wide.cu`` and
``csrc/attention_fwd_preq_wide.cu``, and count them apart, in ``<wrapper>.hd256_launches``, ``.hd384_launches`` and
``.hd512_launches``.  A masked row with no live key gives o = 0 and
lse2 = -inf, as the TPU kernel does.

The H100 launch configuration is fixed: 128 Q rows per CTA (64 a
consumer warpgroup) up to head dim 256, 64 above it, KV tiles of
``K_GROUP`` = 128 columns (64 from head dim 256 on, two to a group; 32 in
the pre-quantized kernel at 512, four to a group), and ``K_GROUP`` is also
the K-scale group, so a tile reads one K scale.  :func:`cta_tiles` gives
the KV tiles a masked CTA visits.  It replaces the TPU's
``default_config`` and tuned table, which hold TPU block sizes only.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches its kernel or raises.  ``<wrapper>.launches`` counts the
launches at head dims 64 and 128.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sageattention_tpu_torch import quant
from sageattention_tpu_torch.ops import _build, reference

# the K-scale group, shared by the CPU and CUDA paths: the kernel's KV tile
K_GROUP = 128
# the kernel's Q tile: rows of one CTA, and of one row of the liveness table
Q_TILE = 64
# the V storage types the kernel reads; the position of each is its code
V_TYPES = (torch.bfloat16, *quant.V_CODE_TYPES)
# the kernels' head dims; 256, and 384 with 512, have sources of their own
HEAD_DIMS = _build.HEAD_DIMS


def instances(d: int) -> str:
    """The suffix of the library and entry point that hold the instances at
    head dim ``d`` (``attention_fwd`` + it, ``sage_attn_fwd`` + it)."""
    return "_hd256" if d == 256 else "_wide" if d > 256 else ""


def route(d: int, *, masked: bool, preq: bool) -> tuple[str, str, str]:
    """(library, entry point, kernel) of a forward call at head dim ``d``:
    the library ``attention_fwd[_masked|_preq]`` + :func:`instances`, its
    entry ``sage_attn_fwd[_masked|_preq]`` + the same, and the kernel it
    launches, ``"wgmma"`` for every call (``csrc/attention_fwd_sm90.cuh``
    at 64, 128 and 256, ``csrc/attention_fwd_sm90_wide.cuh`` at 384 and
    512, with masks or without).  The pre-quantized library holds both ways
    of ``masked``."""
    kind = "_preq" if preq else "_masked" if masked else ""
    return "attention_fwd" + kind + instances(d), "sage_attn_fwd" + kind + instances(d), "wgmma"


def _check_v_scale(v, v_scale) -> None:
    """V codes come with their per-channel scales, bf16 V without."""
    if (v_scale is None) != (v.dtype == torch.bfloat16):
        raise ValueError(
            f"v_scale must be given exactly when V holds codes: V is {v.dtype}, "
            f"v_scale is {'None' if v_scale is None else 'given'}"
        )


class Masks(NamedTuple):
    """The masked kernel's operands, each optional.  Segment ids, the
    varlen range form (row attends [kv_lo, kv_hi)) and positions are int32,
    [b, sq] on the q side and [b, sk] on the kv side.  ``mask`` (bool, True
    = attend) and ``bias`` (fp32 or bf16, added to the scores) have 4 dims
    [b, 1 or hq, sq, sk] and may be broadcast views: the kernel reads them
    through their strides.  ``window`` (with causal) keeps col > row -
    window."""

    q_seg: torch.Tensor | None = None
    kv_seg: torch.Tensor | None = None
    kv_lo: torch.Tensor | None = None
    kv_hi: torch.Tensor | None = None
    q_pos: torch.Tensor | None = None
    kv_pos: torch.Tensor | None = None
    mask: torch.Tensor | None = None
    bias: torch.Tensor | None = None
    window: int | None = None

    def reference_kwargs(self) -> dict:
        """The same masks as :func:`reference.quantized_attention_reference`
        takes them."""
        return dict(window=self.window, q_segment_ids=self.q_seg, kv_segment_ids=self.kv_seg,
                    q_kv_lo=self.kv_lo, q_kv_hi=self.kv_hi, q_positions=self.q_pos,
                    kv_positions=self.kv_pos, attn_mask=self.mask, attn_bias=self.bias)


def sage_attention_plain(q, k_i8, k_scale, v, v_scale=None, v_mean=None, *,
                         is_causal: bool, q_fold: float, return_lse: bool,
                         masks: Masks | None = None):
    """The kernels' function in plain PyTorch: per-row int8 Q with
    ``q_fold`` in its scales, per-group K scales expanded per row, then
    :func:`reference.quantized_attention_reference` with the ``masks``."""
    _check_v_scale(v, v_scale)
    sk = k_i8.shape[2]
    q_i8, q_scale = quant.quant_int8(q, scale_fold=q_fold)
    k_rows = k_scale.repeat_interleave(K_GROUP, dim=-1)[..., :sk]
    return reference.quantized_attention_reference(
        q_i8, q_scale, k_i8, k_rows, v, v_scale, v_mean, is_causal=is_causal,
        return_lse=return_lse, out_dtype=q.dtype,
        **(masks.reference_kwargs() if masks is not None else {}),
    )


def tile_liveness(masks: Masks, sq: int, sk: int) -> torch.Tensor | None:
    """uint8 [b, 1 or hq, ceil(sq/Q_TILE), ceil(sk/K_GROUP)] for the masked
    kernel, from the segment ids and the bool mask: 0 where no element of
    a (Q tile, KV tile) can be live, which the kernel skips; 2 where every
    element in bounds is, which it computes without the element rule; 1
    otherwise.  None without ids or a mask.  The counterpart of the TPU
    kernel's ``msum`` liveness summary (``attention_pallas.py:1867-1923``),
    computed outside the kernel as there: two tiles whose id ranges are
    disjoint cannot attend (exact for sorted ids, conservative for others),
    and two tiles of one id attend wholly."""
    nq, nk = -(-sq // Q_TILE), -(-sk // K_GROUP)
    any_ = all_ = None
    if masks.q_seg is not None:
        big = torch.iinfo(torch.int32).max

        def span(ids, n, tile):  # per-tile (min, max) of the ids, pads ignored
            pad = n * tile - ids.shape[1]
            lo = torch.nn.functional.pad(ids, (0, pad), value=big)
            hi = torch.nn.functional.pad(ids, (0, pad), value=-big)
            return lo.view(-1, n, tile).amin(-1), hi.view(-1, n, tile).amax(-1)

        qlo, qhi = span(masks.q_seg, nq, Q_TILE)
        klo, khi = span(masks.kv_seg, nk, K_GROUP)
        any_ = ((qlo[:, :, None] <= khi[:, None, :]) & (qhi[:, :, None] >= klo[:, None, :]))[:, None]
        all_ = ((qlo == qhi)[:, :, None] & (klo == khi)[:, None, :]
                & (qlo[:, :, None] == klo[:, None, :]))[:, None]
    if masks.mask is not None:
        m = masks.mask
        tiles = (*m.shape[:2], nq, Q_TILE, nk, K_GROUP)
        if (sq, sk) == (nq * Q_TILE, nk * K_GROUP):  # whole tiles: views of the mask
            m_any = m.view(tiles).any(dim=5).any(dim=3)
            m_all = m.view(tiles).all(dim=5).all(dim=3)
        else:  # a padded copy: out of bounds is dead for "any", live for "all"
            pad = m.new_zeros(*m.shape[:2], nq * Q_TILE, nk * K_GROUP)
            pad[..., :sq, :sk] = m
            m_any = pad.view(tiles).any(dim=5).any(dim=3)
            pad[..., :sq, :sk] = ~m
            m_all = ~pad.view(tiles).any(dim=5).any(dim=3)
        any_ = m_any if any_ is None else any_ & m_any
        all_ = m_all if all_ is None else all_ & m_all
    if any_ is None:
        return None
    return (any_.to(torch.uint8) + (any_ & all_).to(torch.uint8)).contiguous()


def cta_tiles(masks: Masks, live: torch.Tensor | None, bi: int, h: int, q0: int, rows: int,
              sq: int, sk: int, kt: int, is_causal: bool) -> list[int]:
    """The KV tiles of ``kt`` columns that the masked kernel's CTA of
    ``rows`` Q rows from ``q0`` (batch ``bi``, query head ``h``) visits, in
    its order; ``live`` is :func:`tile_liveness`'s table or None.  A CTA is
    128 rows up to head dim 256 and 64 above; a tile is 128 columns up to
    128 (64 for the masked pre-quantized instances at 128), 64 above (32
    for the masked instances at 512).  The kernel's formulas
    (``csrc/attention_fwd_kernel.cuh:193-220`` ``mask_range`` for the span,
    ``:226-259`` ``TileWalk`` for the listing): causal ends at the tile of
    the CTA's last row, a window starts at the tile of ``q0 - window + 1``,
    the range form keeps [min kv_lo, max kv_hi) over the CTA's rows below
    ``sq`` (nothing where no row has a key), and a tile is listed unless
    each table row of the CTA (one a 64 rows below ``sq``) marks its
    128-column group dead."""
    first, end = 0, -(-sk // kt)
    if is_causal:
        end = min(end, (q0 + rows - 1) // kt + 1)
    if masks.window:
        first = max(0, q0 - masks.window + 1) // kt
    if masks.kv_lo is not None:
        span = slice(q0, min(q0 + rows, sq))
        lo, hi = int(masks.kv_lo[bi, span].min()), int(masks.kv_hi[bi, span].max())
        if hi > lo:
            first, end = max(first, lo // kt), min(end, -(-hi // kt))
        else:
            end = first
    if live is None:
        return list(range(first, end))
    table = live[bi, h if live.shape[1] > 1 else 0]
    trows = [table[(q0 + r) // Q_TILE] for r in range(0, rows, Q_TILE) if q0 + r < sq]
    return [j for j in range(first, end) if any(int(t[j * kt // K_GROUP]) for t in trows)]


def _check_operands(device, want: dict, optional: tuple) -> None:
    """Each operand of ``want`` (name -> (tensor, dtypes, shape)) on
    ``device``, of one of its dtypes and its shape, contiguous; those named
    in ``optional`` may be None."""
    for name, (x, dtypes, shape) in want.items():
        if x is None and name in optional:
            continue
        if x.device != device or x.dtype not in dtypes or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: want {shape} {dtypes} on {device}, got "
                f"{tuple(x.shape)} {x.dtype} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kv(device, q_shape, k_i8, k_scale, v, v_scale, v_mean, ks_cols=None):
    """The K and V operands of a forward kernel for a Q of ``q_shape``:
    K scales per tile, or ``ks_cols`` of them a head."""
    b, hq, sq, d = q_shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    f32 = (torch.float32,)
    _check_operands(device, {
        "k_i8": (k_i8, (torch.int8,), (b, hkv, sk, d)),
        "k_scale": (k_scale, f32, (b, hkv, ks_cols or -(-sk // K_GROUP))),
        "v": (v, V_TYPES, (b, hkv, sk, d)),
        "v_scale": (v_scale, f32, (b, hkv, d)),
        "v_mean": (v_mean, f32, (b, hkv, d)),
    }, ("v_scale", "v_mean"))
    _check_v_scale(v, v_scale)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS} (pad first)")
    if hq % hkv:
        raise ValueError(f"hq={hq} is not a multiple of hkv={hkv}")


def _check(q, k_i8, k_scale, v, v_scale, v_mean):
    _check_operands(q.device, {"q": (q, (torch.bfloat16, torch.float32), tuple(q.shape))}, ())
    _check_kv(q.device, q.shape, k_i8, k_scale, v, v_scale, v_mean)


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
    lib, entry, _ = route(d, masked=False, preq=False)
    if v.dtype != torch.bfloat16:
        v = widen_v_codes(v)
    # the launch goes to the current device: make it the tensors' own
    with torch.cuda.device(q.device):
        err = getattr(_build.lib(lib), entry)(
            q.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
            v_scale.data_ptr() if v_scale is not None else None,
            v_mean.data_ptr() if v_mean is not None else None,
            o.data_ptr(), lse2.data_ptr() if return_lse else None,
            b, hq, hkv, sq, sk, d, int(is_causal), int(q.dtype == torch.float32),
            V_TYPES.index(v.dtype), int(return_lse), K_GROUP, quant.fold_multiplier(q_fold),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(err, entry)
    _build.count_launch(sage_attention_fwd, d)
    return (o, lse2) if return_lse else o


def widen_v_codes_plain(v: torch.Tensor) -> torch.Tensor:
    """V codes as bf16 values (exact: bf16 holds every int8, e4m3 and e5m2
    value)."""
    return v.to(torch.bfloat16)


def widen_v_codes(v: torch.Tensor) -> torch.Tensor:
    """V codes (int8, fp8 e4m3 or e5m2; contiguous) widened to bf16, the
    step of kernel 1's P.V that the ``wgmma`` forwards take before their
    launch (``csrc/widen_v.cu``; TMA cannot widen)."""
    if v.device.type == "cpu":
        return widen_v_codes_plain(v)
    if v.device.type != "cuda":
        raise ValueError(f"widen_v_codes: tensor on {v.device}")
    if v.dtype not in quant.V_CODE_TYPES or not v.is_contiguous() or v.numel() % 16:
        raise ValueError(f"widen_v_codes takes contiguous codes of {quant.V_CODE_TYPES} in "
                         f"a multiple of 16, got {v.dtype} {tuple(v.shape)}")
    out = torch.empty(v.shape, dtype=torch.bfloat16, device=v.device)
    with torch.cuda.device(v.device):
        err = _build.lib("widen_v").widen_v_codes(
            v.data_ptr(), out.data_ptr(), v.numel(), V_TYPES.index(v.dtype),
            torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(err, "widen_v_codes")
    _build.count_launch(widen_v_codes, v.shape[-1])
    return out


def broadcast_strides(x: torch.Tensor | None) -> list[int]:
    """The element strides (b, h, row, col) the masked kernel reads a mask
    or bias through: 0 along every dim of size 1, which the kernel indexes
    with the batch, query head, row or column it computes (a dim that
    ``expand`` did not touch keeps a nonzero stride)."""
    if x is None:
        return [0, 0, 0, 0]
    return [st if n > 1 else 0 for st, n in zip(x.stride(), x.shape)]


def window_arg(window: int | None, is_causal: bool) -> int:
    """The kernels' window argument, 0 for none: a window needs causal and
    window >= 1."""
    if window is not None and (not is_causal or window < 1):
        raise ValueError(f"window={window} needs is_causal=True and window >= 1")
    return window or 0


def check_masks(masks: Masks, b: int, hq: int, sq: int, sk: int, device, is_causal: bool):
    """The rules the masked kernel holds its operands to: a window with
    causal and >= 1, ids, ranges and positions in pairs, their dtypes,
    shapes and device.  ``core`` checks a user's masks with it too."""
    window_arg(masks.window, is_causal)
    for pair in (("q_seg", "kv_seg"), ("kv_lo", "kv_hi"), ("q_pos", "kv_pos")):
        if (getattr(masks, pair[0]) is None) != (getattr(masks, pair[1]) is None):
            raise ValueError(f"{pair[0]} and {pair[1]} come together")
    for name in ("q_seg", "kv_seg", "kv_lo", "kv_hi", "q_pos", "kv_pos"):
        x = getattr(masks, name)
        want = (b, sk) if name in ("kv_seg", "kv_pos") else (b, sq)
        if x is not None and (x.dtype != torch.int32 or tuple(x.shape) != want
                              or x.device != device or not x.is_contiguous()):
            raise ValueError(f"{name}: want contiguous int32 {want} on {device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    for name, dtypes in (("mask", (torch.bool,)), ("bias", (torch.float32, torch.bfloat16))):
        x = getattr(masks, name)
        if x is not None and (x.dtype not in dtypes or x.dim() != 4 or x.shape[0] != b
                              or x.shape[1] not in (1, hq) or tuple(x.shape[2:]) != (sq, sk)
                              or x.device != device):
            raise ValueError(f"{name}: want {dtypes} [{b}, 1 or {hq}, {sq}, {sk}] on {device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def sage_attention_fwd_masked(q, k_i8, k_scale, v, v_scale=None, v_mean=None, *,
                              masks: Masks, is_causal: bool, q_fold: float,
                              return_lse: bool = False):
    """:func:`sage_attention_fwd` with the ``masks`` (:class:`Masks`) on HND
    tensors: the masked instances (``csrc/attention_fwd_masked.cu``).  A row
    with no live key gives o = 0 and, with ``return_lse``, lse2 = -inf."""
    b, hq, sq, _ = q.shape
    sk = k_i8.shape[2]
    check_masks(masks, b, hq, sq, sk, q.device, is_causal)
    if q.device.type == "cpu":
        return sage_attention_plain(q, k_i8, k_scale, v, v_scale, v_mean, is_causal=is_causal,
                                    q_fold=q_fold, return_lse=return_lse, masks=masks)
    if q.device.type != "cuda":
        raise ValueError(f"sage_attention_fwd_masked: tensor on {q.device}")
    _check(q, k_i8, k_scale, v, v_scale, v_mean)
    d, hkv = q.shape[3], k_i8.shape[1]
    live = tile_liveness(masks, sq, sk)
    o = torch.empty_like(q)
    lse2 = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device) if return_lse else None

    def ptr(x):
        return x.data_ptr() if x is not None else None

    live_st = [0, 0] if live is None else broadcast_strides(live)[:2]
    lib, entry, _ = route(d, masked=True, preq=False)
    if v.dtype != torch.bfloat16:
        v = widen_v_codes(v)
    with torch.cuda.device(q.device):
        err = getattr(_build.lib(lib), entry)(
            q.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(), v.data_ptr(), ptr(v_scale),
            ptr(v_mean), o.data_ptr(), ptr(lse2), b, hq, hkv, sq, sk, d, int(is_causal),
            int(q.dtype == torch.float32), V_TYPES.index(v.dtype), int(return_lse), K_GROUP,
            quant.fold_multiplier(q_fold), torch.cuda.current_stream(q.device).cuda_stream,
            ptr(masks.q_seg), ptr(masks.kv_seg), ptr(masks.kv_lo), ptr(masks.kv_hi),
            ptr(masks.q_pos), ptr(masks.kv_pos), ptr(masks.mask), ptr(masks.bias), ptr(live),
            *broadcast_strides(masks.mask), *broadcast_strides(masks.bias), *live_st,
            window_arg(masks.window, is_causal),
            int(masks.bias is not None and masks.bias.dtype == torch.bfloat16),
        )
    _build.check(err, entry)
    _build.count_launch(sage_attention_fwd_masked, d)
    return (o, lse2) if return_lse else o


def sage_attention_preq_plain(q_i8, q_scale, k_i8, k_scale, v, v_scale=None, v_mean=None, *,
                              is_causal: bool, return_lse: bool, out_dtype=torch.bfloat16,
                              col_bias=None, masks: Masks | None = None):
    """The pre-quantized kernel's function in plain PyTorch: per-tile K
    scales expanded per row (per-row ones as they are), then
    :func:`reference.quantized_attention_reference` with the column bias
    and the ``masks``."""
    _check_v_scale(v, v_scale)
    sk = k_i8.shape[2]
    if k_scale.shape[-1] != sk:
        k_scale = k_scale.repeat_interleave(K_GROUP, dim=-1)[..., :sk]
    return reference.quantized_attention_reference(
        q_i8, q_scale, k_i8, k_scale, v, v_scale, v_mean, is_causal=is_causal,
        return_lse=return_lse, out_dtype=out_dtype, score_col_bias=col_bias,
        **(masks.reference_kwargs() if masks is not None else {}),
    )


def _check_preq(q_i8, q_scale, k_i8, k_scale, v, v_scale, v_mean, col_bias, out_dtype):
    """The pre-quantized kernel's operands: the codes, per-row Q scales and
    the column bias, then K (per-tile or per-row scales) and V."""
    b, hq, sq, d = q_i8.shape
    sk = k_i8.shape[2]
    f32 = (torch.float32,)
    _check_operands(q_i8.device, {
        "q_i8": (q_i8, (torch.int8,), (b, hq, sq, d)),
        "q_scale": (q_scale, f32, (b, hq, sq)),
        "col_bias": (col_bias, f32, (b, hq, sk)),
    }, ("col_bias",))
    _check_kv(q_i8.device, q_i8.shape, k_i8, k_scale, v, v_scale, v_mean,
              ks_cols=sk if k_scale.shape[-1] == sk else None)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bf16 or fp32, got {out_dtype}")


def sage_attention_fwd_preq(q_i8, q_scale, k_i8, k_scale, v, v_scale=None, v_mean=None, *,
                            is_causal: bool, return_lse: bool = False,
                            out_dtype=torch.bfloat16, col_bias=None,
                            masks: Masks | None = None):
    """The forward on pre-quantized operands (``csrc/attention_fwd_preq.cu``;
    at head dim 256 ``csrc/attention_fwd_preq_hd256.cu``, at 384 and 512
    ``csrc/attention_fwd_preq_wide.cu``), HND: q_i8 [b,hq,sq,d] int8 codes
    (+-127, or +-7 at 4 bits) with q_scale [b,hq,sq] fp32 holding ``sm_scale * log2(e)``; k_i8 with
    k_scale [b,hkv,ceil(sk/K_GROUP)] per tile or [b,hkv,sk] per row; V as
    :func:`sage_attention_fwd` takes it; ``col_bias`` [b,hq,sk] fp32 in the
    base-2 domain (smooth-q) or None; ``masks`` (:class:`Masks`) or None.
    Returns o [b,hq,sq,d] in ``out_dtype`` (bf16 or fp32) and, with
    ``return_lse``, the base-2 LSE."""
    b, hq, sq, d = q_i8.shape
    hkv, sk = k_i8.shape[1], k_i8.shape[2]
    if masks is not None:
        check_masks(masks, b, hq, sq, sk, q_i8.device, is_causal)
    if q_i8.device.type == "cpu":
        return sage_attention_preq_plain(q_i8, q_scale, k_i8, k_scale, v, v_scale, v_mean,
                                         is_causal=is_causal, return_lse=return_lse,
                                         out_dtype=out_dtype, col_bias=col_bias, masks=masks)
    if q_i8.device.type != "cuda":
        raise ValueError(f"sage_attention_fwd_preq: tensor on {q_i8.device}")
    _check_preq(q_i8, q_scale, k_i8, k_scale, v, v_scale, v_mean, col_bias, out_dtype)
    o = torch.empty(b, hq, sq, d, dtype=out_dtype, device=q_i8.device)
    lse2 = torch.empty(b, hq, sq, dtype=torch.float32, device=q_i8.device) if return_lse else None
    m = masks if masks is not None else Masks()
    live = tile_liveness(m, sq, sk) if masks is not None else None
    live_st = [0, 0] if live is None else broadcast_strides(live)[:2]

    def ptr(x):
        return x.data_ptr() if x is not None else None

    lib, entry, _ = route(d, masked=masks is not None, preq=True)
    if v.dtype != torch.bfloat16:
        v = widen_v_codes(v)
    with torch.cuda.device(q_i8.device):
        err = getattr(_build.lib(lib), entry)(
            q_i8.data_ptr(), k_i8.data_ptr(), k_scale.data_ptr(), v.data_ptr(), ptr(v_scale),
            ptr(v_mean), o.data_ptr(), ptr(lse2), b, hq, hkv, sq, sk, d, int(is_causal),
            V_TYPES.index(v.dtype), int(return_lse), K_GROUP, int(k_scale.shape[-1] == sk),
            int(out_dtype == torch.float32), q_scale.data_ptr(), ptr(col_bias),
            torch.cuda.current_stream(q_i8.device).cuda_stream, int(masks is not None),
            ptr(m.q_seg), ptr(m.kv_seg), ptr(m.kv_lo), ptr(m.kv_hi), ptr(m.q_pos),
            ptr(m.kv_pos), ptr(m.mask), ptr(m.bias), ptr(live), *broadcast_strides(m.mask),
            *broadcast_strides(m.bias), *live_st, window_arg(m.window, is_causal),
            int(m.bias is not None and m.bias.dtype == torch.bfloat16),
        )
    _build.check(err, entry)
    _build.count_launch(sage_attention_fwd_preq, d)
    return (o, lse2) if return_lse else o


_build.zero_counters(sage_attention_fwd, sage_attention_fwd_masked, sage_attention_fwd_preq,
                     widen_v_codes)
