"""Quantizers: CUDA wrappers and plain versions.

Replaces the TPU kernels ``sageattention_tpu/ops/quant_pallas.py``:
``quant_k_fused_mean`` (``_quant_k_fused_kernel``) and
``quant_k_chunked`` (``_quant_k_kernel``), in ``csrc/quant_k.cu``;
``quant_q_per_token`` (``_quant_rows_kernel``), in ``csrc/quant_q.cu``,
the row-group quantizer of every Q/K option (one row, 32 or 128 a scale, a
mean taken off first, smooth_q's cast back), whose per-token form the
backward uses to quantize Q again exactly as the forward kernel did inside
itself; and the per-channel V quantizers ``quant_v_per_channel``
(``_quant_v_kernel``) and ``_quant_v_blocked`` (``_v_stats_kernel``,
``_v_apply_kernel``), in ``csrc/quant_v.cu``.  Each source says what
bounds its kernels (bytes) and how they meet it.  The Q and K quantizers
take ``bits``: 8, or 4 for the +-7 codes of ``sageattn(qk_bits=4)``, as
the TPU kernels do.

Kernels 3-5 read K, Q and V from device memory once by plans made here,
on the host, and passed to the kernel: ``quant_q_plan`` (rows held in
registers, several a thread, a group too large for a CTA split over a
cluster), ``quant_k_plan`` (at head dims up
to 128 a tile a CTA, held in its threads' registers; above, a persistent
grid over the (b h, group) tiles, each tile staged in a shared-memory ring
by each thread's ``cp.async`` of the chunks it reads) and ``quant_v_plan``
(of the column split and thread-block clusters of 1-16 CTAs a (b h) slab,
their CTAs splitting the rows, the one of least predicted time;
``v_partition_sum`` computes the smooth-v sum in the kernel's order).
Each wrapper's ``*_args`` function gives its C entry
point's arguments for outputs the caller allocated, with which
``chip_smoke.py`` and the A/B tools time the entry point alone.

On a CPU tensor every function here runs its plain PyTorch version; on a
CUDA tensor it launches its kernel or raises.  Each wrapper counts its
launches in ``<function>.launches``, and those at head dims 256, 384 and
512 apart, in ``<function>.hd256_launches``, ``.hd384_launches`` and
``.hd512_launches`` (the Q/K quantizer has instances of its own there; the
K and V kernels take the width as an argument).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
# kernel 3's plan (csrc/quant_k.cu): 256-thread CTAs; a tile in registers
# where a thread holds at most K_REG_ROWS of its rows (d <= 128), else a ring
# of at most K_RING_BYTES of units of at most K_UNIT_BYTES, at most
# K_MAX_STAGES units, up to K_CTAS_PER_SM CTAs an SM of SM_SHARED_BYTES
K_THREADS = 256
K_REG_ROWS = 8
K_RING_BYTES = 216 * 2**10
K_UNIT_BYTES = 64 * 2**10
K_MAX_STAGES = 16
K_CTAS_PER_SM = 4
SM_SHARED_BYTES = 228 * 2**10
# kernel 5's plan (csrc/quant_v.cu): 256-thread CTAs, each staging at most
# V_STAGE_BYTES of its rows.  Its candidates, V_PLAN_SIZES: cl 0, the column
# split (a CTA per (b h, 8 channels) over all the rows, which it reads twice;
# no cluster), or clusters of cl CTAs a slab (16 is a non-portable size, taken
# only where the card places it).  The plan is the candidate of least
# predicted time, v_plan_us, whose coefficients V_COLUMN_US and V_CLUSTER_US
# were fitted to an H100's times of every candidate at 280 shapes
# (tools/sweep_quant_v.py, PERF.md), a cluster plan's time weighted by
# V_CLUSTER_MARGIN: taken only where predicted 10 % faster than the column
# split, about twice the model's median error.  V_L2_BYTES: all of V beyond it, the
# column split's second read comes from device memory; V_REREAD_L2_BYTES:
# rows read twice by all clusters at once beyond it, their second read does.
V_THREADS = 256
V_STAGE_BYTES = 192 * 2**10
V_PLAN_SIZES = (0, 1, 2, 4, 8, 16)
V_L2_BYTES = 40 * 10**6
V_REREAD_L2_BYTES = 24 * 2**20
V_CLUSTER_MARGIN = 1.1
# the column split: fixed; a wave of CTAs over the SMs; a CTA's thousand
# elements; their rise with the share of the SMs busy; a MB of V's 32-byte
# sectors read again from device memory
V_COLUMN_US = (3.422, 0.295, 0.2664, 0.721, 1.283)
# a round of clusters: fixed; the exchange, a CTA and 256 channels; a CTA's
# thousand elements; a KB it reads twice; its rise where those come from
# device memory; a MB of the round's traffic (V, rows read twice, codes)
V_CLUSTER_US = (11.55, 0.1456, 0.1289, 0.008585, 3.883, 0.4741)
H100_SMS = 132
# kernel 4's plan (csrc/quant_q.cu, whose slots_of mirrors it): groups of
# Q_GROUPS rows, 256-thread CTAs, each thread holding Q_SLOTS rows' chunks
# at once, at most Q_HELD_BYTES of x (64 registers): Q_TOKEN_ELEMS of x a
# thread at one row a group, at least Q_GROUP_SLOTS rows at more (the
# fastest of every slot count on an H100, PERF.md); a group no CTA holds is
# split over a cluster of at most Q_MAX_CLUSTER CTAs
Q_GROUPS = (1, 32, 128)
Q_THREADS = 256
Q_SLOTS = (1, 2, 4, 8, 16)
Q_TOKEN_ELEMS = 16
Q_GROUP_SLOTS = 4
Q_HELD_BYTES = 256
Q_MAX_CLUSTER = 8


class KPlan(NamedTuple):
    """Kernel 3's plan: units of ``unit_rows`` rows, a ring of ``stages``
    units a CTA, the first ``staged_rows`` rows of each tile staged (the
    rest read from device memory twice), ``grid`` CTAs."""
    unit_rows: int
    stages: int
    staged_rows: int
    grid: int


def quant_k_plan(bh: int, s: int, d: int, itemsize: int, group: int,
                 sms: int = H100_SMS) -> KPlan:
    """Kernel 3's plan for K [bh, s, d] of ``itemsize`` bytes.  At d <= 128,
    where a thread holds at most ``K_REG_ROWS`` rows of a tile: each tile in
    the registers of a CTA of its own (``stages`` 0).  Else the largest
    unit (the group, or a half, quarter or eighth of it) of at most
    ``K_UNIT_BYTES`` whose ring holds a whole tile and one unit more (up
    to two); where none does (fp32 at d 512), the ring of the largest such
    unit stages all but one unit's worth of each tile.  As many CTAs as
    tiles, at most ``K_CTAS_PER_SM`` an SM as their rings allow."""
    n_tiles = bh * -(-s // group)
    if d <= 128 and -(-group // (K_THREADS // (d // 8))) <= K_REG_ROWS:
        return KPlan(group, 0, group, n_tiles)
    row = d * itemsize
    units = [group >> i for i in range(4) if group % (1 << i) == 0 and group >> i >= 8] or [group]
    fitting = [u for u in units if u * row <= K_UNIT_BYTES] or units[-1:]
    for u in fitting:
        upt = group // u
        stages = min(upt + 2, K_RING_BYTES // (u * row), K_MAX_STAGES)
        if stages >= upt + 1:
            staged = group
            break
    else:
        u = fitting[0]
        stages = min(K_RING_BYTES // (u * row), K_MAX_STAGES)
        staged = (stages - 1 if stages > 1 else stages) * u
    ring = stages * u * row
    per_sm = max(1, min(K_CTAS_PER_SM, SM_SHARED_BYTES // (ring + 2 * 2**10)))
    return KPlan(u, stages, staged, max(1, min(n_tiles, sms * per_sm)))


class VPlan(NamedTuple):
    """Kernel 5's plan: clusters of ``cl`` CTAs a slab, each taking
    ``rows_per_cta`` rows and staging at most ``stage_rows`` of them;
    ``clusters`` clusters walk the slabs.  ``cl`` 0: the column split, a
    CTA per (slab, 8 channels) over all the rows, read twice."""
    cl: int
    rows_per_cta: int
    stage_rows: int
    clusters: int


def v_smem_bytes(stage_rows: int, d: int, itemsize: int) -> int:
    """The shared memory of a CTA of kernel 5 (``v_smem_bytes`` of
    ``csrc/quant_v.cu``): the staged rows, the row groups' statistics, the
    CTA's partials, mean and r."""
    return -(-stage_rows * d * itemsize // 16) * 16 + 4 * 3 * V_THREADS * 8 + 4 * 5 * d


def v_plan_us(plan: VPlan, bh: int, s: int, d: int, itemsize: int, sms: int = H100_SMS,
              room1: int | None = None, coef: tuple | None = None) -> float:
    """Kernel 5's predicted time under ``plan``, microseconds, for V [bh, s,
    d] of ``itemsize`` bytes on a card of ``sms`` SMs, with ``coef`` =
    (column, cluster) coefficients (default ``V_COLUMN_US``,
    ``V_CLUSTER_US``).  The column split: its waves of bh d/8 CTAs over the
    SMs, each CTA's 8 s elements dearer the more SMs are busy; at least the
    time to read V's 32-byte sectors again from device memory where all of V
    exceeds ``V_L2_BYTES``.  A cluster plan: its rounds ceil(bh /
    clusters), each the larger of a CTA's time (the exchange over cl CTAs,
    its elements, its rows read twice, dearer where all clusters' exceed
    ``V_REREAD_L2_BYTES``) times the CTAs an SM takes in the round (the
    clusters over ``room1``, those the card holds with one CTA an SM;
    default sms / cl), and the round's traffic."""
    col, clu = coef or (V_COLUMN_US, V_CLUSTER_US)
    if plan.cl == 0:
        fixed, wave, el_us, fill_us, again_us = col
        ctas = bh * d // 8
        busy = min(ctas, sms) / sms
        lat = fixed + -(-ctas // sms) * (wave + el_us * 8 * s / 1e3 * (1 + fill_us * busy))
        again = bh * s * d * itemsize > V_L2_BYTES
        return max(lat, again_us * bh * s * d * 4 / 1e6 * again)
    fixed, xchg_us, el_us, twice_us, far, mb_us = clu
    cl, rows = plan.cl, plan.rows_per_cta
    at_once = min(bh, plan.clusters)
    per_sm = -(-at_once // (room1 or max(1, sms // cl)))
    twice = (rows - plan.stage_rows) * d * itemsize
    dear = 1 + far * (at_once * cl * twice > V_REREAD_L2_BYTES)
    lat = fixed + xchg_us * cl * d / 256 + per_sm * (el_us * rows * d / 1e3
                                                      + twice_us * twice / 1e3 * dear)
    traffic = mb_us * at_once * cl * (rows * d * (itemsize + 1) + twice) / 1e6
    return -(-bh // plan.clusters) * max(lat, traffic)


def quant_v_plan(bh: int, s: int, d: int, itemsize: int, room=None, cls=V_PLAN_SIZES,
                 sms: int = H100_SMS) -> VPlan:
    """Kernel 5's plan for V [bh, s, d] of ``itemsize`` bytes: of the
    candidates ``cls`` (the wrapper weighs all of ``V_PLAN_SIZES``; the
    tools narrow them to time one size, a plan the wrapper may not pick),
    the one of least ``v_plan_us``, a cluster plan's weighted by
    ``V_CLUSTER_MARGIN`` (the smaller cl on a tie).  The column
    split is ``VPlan(0, s, 0, bh)``.  Clusters of cl CTAs take ceil(s / cl)
    rows a CTA, at most ``V_STAGE_BYTES`` of them staged, and as many
    clusters as slabs, at most ``room(cl, shared memory a CTA)``, the
    clusters the card holds at once (every slab at once where ``room`` is
    None), walk the slabs; a size the card cannot place is not weighed."""
    row = d * itemsize
    cap = V_STAGE_BYTES // row
    best = None
    for cl in cls:
        room1 = None
        if cl == 0:
            plan = VPlan(0, s, 0, bh)
        else:
            rows = -(-s // cl)
            stage = min(cap, rows)
            at_once = bh
            if room is not None:
                at_once = room(cl, v_smem_bytes(stage, d, itemsize))
                room1 = room(cl, v_smem_bytes(cap, d, itemsize))
            if at_once < 1:  # the card cannot place such a cluster
                continue
            plan = VPlan(cl, rows, stage, min(bh, at_once))
        key = (v_plan_us(plan, bh, s, d, itemsize, sms, room1) * (V_CLUSTER_MARGIN if cl else 1),
               cl)
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f"kernel 5: no plan of the sizes {cls} fits the card")
    return best[1]


def v_partition_sum(v: torch.Tensor, plan: VPlan) -> torch.Tensor:
    """The per-channel sum over the sequence of V [..., s, d] in fp32,
    added in kernel 5's order: CTA c of the cluster sums rows [c rpc,
    (c + 1) rpc); in it, the row group g of each channel (its rows g, g +
    n, g + 2n, ..., n = V_THREADS // (d // 8)) is summed in row order from
    0, the groups are added in group order and the CTAs in rank order.
    The column split (``cl`` 0): thread t sums rows t, t + V_THREADS, ... in
    row order from 0, the 32 lanes of a warp add theirs by a butterfly over
    xor 1, 2, ..., 16, and the warps' sums are added in warp order."""
    *lead, s, d = v.shape
    if plan.cl == 0:
        k = -(-s // V_THREADS)
        x = F.pad(v.float().reshape(-1, s, d), (0, 0, 0, k * V_THREADS - s))
        x = x.reshape(-1, k, V_THREADS, d)
        acc = torch.zeros_like(x[:, 0])
        for i in range(k):
            acc = acc + x[:, i]
        acc = acc.reshape(-1, V_THREADS // 32, 32, d)
        lanes = torch.arange(32)
        for o in (1, 2, 4, 8, 16):
            acc = acc + acc[:, :, lanes ^ o]
        out = acc[:, 0, 0]
        for w in range(1, V_THREADS // 32):
            out = out + acc[:, w, 0]
        return out.reshape(*lead, d)
    n = V_THREADS // (d // 8)
    cl, rpc = plan.cl, plan.rows_per_cta
    k = -(-rpc // n)
    x = F.pad(v.float().reshape(-1, s, d), (0, 0, 0, cl * rpc - s))  # rows past s: +0
    x = F.pad(x.reshape(-1, cl, rpc, d), (0, 0, 0, k * n - rpc)).reshape(-1, cl, k, n, d)
    acc = torch.zeros_like(x[:, :, 0])
    for i in range(k):
        acc = acc + x[:, :, i]
    tot = acc[:, :, 0]
    for g in range(1, n):
        tot = tot + acc[:, :, g]
    out = tot[:, 0]
    for c in range(1, cl):
        out = out + tot[:, c]
    return out.reshape(*lead, d)


def v_partition_mean(v: torch.Tensor, plan: VPlan) -> torch.Tensor:
    """Kernel 5's smooth-v mean: ``v_partition_sum`` over s, divided
    element by element (PyTorch multiplies a CUDA tensor by the reciprocal
    of a Python scalar divisor, which can round otherwise)."""
    total = v_partition_sum(v, plan)
    return total / torch.full_like(total, float(v.shape[-2]))


@functools.cache
def v_cluster_room(device: torch.device, cl: int, smem: int, bf16: bool) -> int:
    """How many clusters of ``cl`` CTAs of kernel 5 with ``smem`` bytes of
    shared memory each ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _build.lib("quant_v").quant_v_cluster_room(cl, smem, int(bf16), ctypes.byref(n))
    _build.check(err, "quant_v_cluster_room")
    return n.value


def quant_v_device_plan(v: torch.Tensor, cls: tuple = V_PLAN_SIZES) -> VPlan:
    """Kernel 5's plan for the bf16 or fp32 CUDA tensor V [b,h,s,d] on its
    card (of the candidates ``cls``, as ``quant_v_plan``), made once a
    shape."""
    b, h, s, d = v.shape
    return _device_plan(v.device, b * h, s, d, v.dtype == torch.bfloat16, tuple(cls))


@functools.cache
def _device_plan(device: torch.device, bh: int, s: int, d: int, bf16: bool, cls) -> VPlan:
    return quant_v_plan(bh, s, d, 2 if bf16 else 4, cls=cls, sms=_sm_count(device),
                        room=lambda cl, smem: v_cluster_room(device, cl, smem, bf16))


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


class QPlan(NamedTuple):
    """Kernel 4's plan: each thread holds ``slots`` rows at once, clusters
    of ``cl`` CTAs share a group's amax, each (b, h) slab is ``tiles``
    clusters' rows, ``grid`` CTAs."""
    slots: int
    cl: int
    tiles: int
    grid: int


def q_row_lanes(d: int) -> tuple[int, int, int]:
    """Kernel 4's row layout at head dim ``d``: (lanes a row, rows a warp
    holds side by side, 8-column chunks a lane).  A row takes as many of a
    warp's lanes as divide its d / 8 chunks, at most 32."""
    nv = d // 8
    lanes = min(32, nv & -nv)
    return lanes, 32 // lanes, nv // lanes


def quant_q_plan(bh: int, s: int, d: int, itemsize: int, group: int,
                 mean: bool = False) -> QPlan:
    """Kernel 4's plan for x [bh, s, d] of ``itemsize`` bytes in groups of
    ``group`` rows (one of ``Q_GROUPS``; ``mean``: a mean is taken off).
    Each thread holds at most ``Q_HELD_BYTES`` of x.  One row a group:
    ``Q_TOKEN_ELEMS`` of a row's elements a thread, twice as many with a
    mean (two slots at d <= 256, one above; four and two with a mean).
    Else the fewest slots of ``Q_SLOTS``, at least ``Q_GROUP_SLOTS``, with
    which a CTA holds a group; where none does, ``Q_GROUP_SLOTS`` (or fewer,
    as many as a thread holds), and the group split over a cluster of
    CTAs."""
    if group not in Q_GROUPS:
        raise ValueError(f"kernel 4 takes groups of {Q_GROUPS} rows, got {group}")
    _, w, c = q_row_lanes(d)
    held = [r for r in Q_SLOTS if r * c * 8 * itemsize <= Q_HELD_BYTES]
    rows = Q_THREADS // 32 * w  # a CTA's rows a slot
    if group == 1:
        slots = max(1, Q_TOKEN_ELEMS * (2 if mean else 1) // (c * 8))
    else:
        fits = [r for r in held if r >= Q_GROUP_SLOTS and rows * r >= group]
        slots = fits[0] if fits else min(Q_GROUP_SLOTS, held[-1])
    cl = 1 if group <= rows * slots else group // (rows * slots)
    if cl > Q_MAX_CLUSTER:
        raise ValueError(f"kernel 4: a group of {group} rows at d {d} needs {cl} CTAs")
    tiles = -(-s // (rows * slots * cl))
    return QPlan(slots, cl, tiles, bh * tiles * cl)


def quant_q_per_token_plain(x: torch.Tensor, mean: torch.Tensor | None = None, *,
                            scale_fold: float, bits: int = 8, group: int = 1,
                            cast: torch.dtype | None = None):
    """The spec: ``quant.quant_int8`` of x' at groups of ``group`` rows, x'
    x itself, ``f32(x) - mean`` or ``(f32(x) - mean).to(cast)``."""
    xs = x.float() if mean is None else x.float() - mean[..., None, :]
    if cast is not None:
        xs = xs.to(cast)
    gran = "per_token" if group == 1 else "per_subtile"
    return quant.quant_int8(xs, granularity=gran, block_size=group, scale_fold=scale_fold,
                            bits=bits)


def _cast_code(x: torch.Tensor, mean, cast: torch.dtype | None) -> int:
    """The C entry's ``cast``: 0, or 1 to round x - mean to bf16 (bf16 x)
    or fp16 (fp32 x, an fp16 caller's, widened exactly)."""
    if cast is None:
        return 0
    if mean is None:
        raise ValueError("kernel 4 casts x - mean back, and no mean was given")
    if (x.dtype, cast) not in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float16)):
        raise ValueError(f"kernel 4 casts bf16 x to bf16 and fp32 x to fp16, not {x.dtype} "
                         f"to {cast}")
    return 1


def quant_q_args(x, out, scales, *, scale_fold: float, bits: int = 8, mean=None, group: int = 1,
                 cast=None, plan: QPlan | None = None) -> tuple:
    """The arguments of the C entry point ``quant_rows`` (with kernel 4's
    plan, or ``plan``) writing into ``out`` and ``scales``; each wrapper
    here has such a function, with which ``chip_smoke.py`` and the A/B tools
    time the entry point without the wrapper."""
    qmax, inv_qmax = _qmax_args(bits)
    b, h, s, d = x.shape
    plan = plan or quant_q_plan(b * h, s, d, x.element_size(), group, mean=mean is not None)
    return (
        x.data_ptr(), mean.data_ptr() if mean is not None else None, out.data_ptr(),
        scales.data_ptr(), b * h, s, d, int(x.dtype == torch.float32), group,
        _cast_code(x, mean, cast), quant.fold_multiplier(scale_fold, qmax), qmax, inv_qmax,
        *plan[:3], torch.cuda.current_stream(x.device).cuda_stream)


def quant_q_per_token(x: torch.Tensor, mean: torch.Tensor | None = None, *, scale_fold: float,
                      bits: int = 8, group: int = 1, cast: torch.dtype | None = None):
    """Kernel 4, the row-group quantizer of Q and K: x [b,h,s,d] (bf16 or
    fp32; d in ``HEAD_DIMS``) -> (int8 [b,h,s,d], f32 scales [b,h,s] with
    ``scale_fold`` folded in), the codes of x', which is x, ``f32(x) -
    mean`` (``mean`` [b,h,d] fp32) or that rounded to ``cast`` (bf16 for
    bf16 x, fp16 for fp32 x: smooth_q's centred Q), at one scale a group of
    ``group`` rows (1, 32 or 128), ``quant_q_per_token_plain`` bit for bit.
    Its default, Q at one row a scale, is the TPU kernel's function, bit
    for bit the forward kernel's in-kernel Q quantization (and at ``bits=4``
    the TPU kernel's at qmax 7).  Its launches count on its own counters,
    whatever it quantizes."""
    if x.device.type == "cpu":
        return quant_q_per_token_plain(x, mean, scale_fold=scale_fold, bits=bits, group=group,
                                       cast=cast)
    _check_input(x, "Q/K quantizer")
    b, h, s, d = x.shape
    if mean is not None and (
        mean.dtype != torch.float32 or mean.shape != (b, h, d)
        or not mean.is_contiguous() or mean.device != x.device
    ):
        raise ValueError(f"mean must be contiguous fp32 {(b, h, d)} on {x.device}")
    out = torch.empty(b, h, s, d, dtype=torch.int8, device=x.device)
    scales = torch.empty(b, h, s, dtype=torch.float32, device=x.device)
    args = quant_q_args(x, out, scales, scale_fold=scale_fold, bits=bits, mean=mean, group=group,
                        cast=cast)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _build.lib("quant_q").quant_rows(*args)
    _build.check(err, "quant_rows")
    _build.count_launch(quant_q_per_token, d)
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


def k_mean_args(k, km) -> tuple[tuple, torch.Tensor]:
    """(the arguments of the C entry point ``k_channel_mean`` writing into
    ``km``, the chunks' scratch they point to, which must live as long as
    they are used)."""
    b, h, s, d = k.shape
    stream = torch.cuda.current_stream(k.device)
    rows = mean_chunk_rows(s, b * h, _sm_count(k.device))
    part = torch.empty(b * h, -(-s // rows), d, dtype=torch.float32, device=k.device)
    return (
        k.data_ptr(), part.data_ptr(), _mean_counters(stream, b * h).data_ptr(), km.data_ptr(),
        b * h, s, d, rows, int(k.dtype == torch.bfloat16), stream.cuda_stream), part


def k_channel_mean(k: torch.Tensor) -> torch.Tensor:
    """km [b,h,d] fp32 (the smooth-k channel mean): one launch, a CTA per
    (chunk of :func:`mean_chunk_rows` rows, b h), the chunks' sums added in
    chunk order."""
    if k.device.type == "cpu":
        return k_channel_mean_plain(k)
    _check_input(k)
    b, h, s, d = k.shape
    km = torch.empty(b, h, d, dtype=torch.float32, device=k.device)
    args, part = k_mean_args(k, km)
    with torch.cuda.device(k.device):  # the launch goes to the current device
        err = _build.lib("quant_k").k_channel_mean(*args)
    _build.check(err, "k_channel_mean")
    _build.count_launch(k_channel_mean, k.shape[-1])
    return km



def quant_k_chunked_plain(k, km, *, group: int, bits: int = 8):
    """The spec: ``quant_int8_block_scales(k - km, group, bits)``."""
    ks = k.float() - km[..., None, :] if km is not None else k.float()
    return quant.quant_int8_block_scales(ks, group=group, bits=bits)


def quant_k_args(k, km, out, scales, *, group: int, bits: int = 8) -> tuple:
    """The arguments of the C entry point ``quant_k_chunked`` (with kernel
    3's plan) writing into ``out`` and ``scales``."""
    qmax, inv_qmax = _qmax_args(bits)
    b, h, s, d = k.shape
    plan = quant_k_plan(b * h, s, d, k.element_size(), group, _sm_count(k.device))
    return (
        k.data_ptr(), km.data_ptr() if km is not None else None, out.data_ptr(),
        scales.data_ptr(), b * h, s, d, group, int(k.dtype == torch.bfloat16), qmax, inv_qmax,
        *plan, torch.cuda.current_stream(k.device).cuda_stream)


def quant_k_chunked(k: torch.Tensor, km: torch.Tensor | None, *, group: int, bits: int = 8):
    """[b,h,s,d] -> (int8 [b,h,s,d], f32 scales [b,h,ceil(s/group)]),
    subtracting ``km`` [b,h,d] first when it is given."""
    if k.device.type == "cpu":
        return quant_k_chunked_plain(k, km, group=group, bits=bits)
    _check_input(k)
    b, h, s, d = k.shape
    if km is not None and (
        km.dtype != torch.float32 or km.shape != (b, h, d)
        or not km.is_contiguous() or km.device != k.device
    ):
        raise ValueError(f"km must be contiguous fp32 {(b, h, d)} on {k.device}")
    out = torch.empty(b, h, s, d, dtype=torch.int8, device=k.device)
    scales = torch.empty(b, h, -(-s // group), dtype=torch.float32, device=k.device)
    args = quant_k_args(k, km, out, scales, group=group, bits=bits)
    with torch.cuda.device(k.device):  # the launch goes to the current device
        err = _build.lib("quant_k").quant_k_chunked(*args)
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


def quant_v_args(v, out, scale, mean) -> tuple:
    """The arguments of the C entry point ``quant_v_per_channel`` (with
    kernel 5's plan) on the bf16 or fp32 [b,h,s,d] ``v``, writing the codes
    of ``out``'s type into ``out``, the scales into ``scale`` and, where
    ``mean`` is given (smooth-v), the mean into ``mean``."""
    b, h, s, d = v.shape
    bf16 = v.dtype == torch.bfloat16
    plan = quant_v_device_plan(v)
    return (
        v.data_ptr(), out.data_ptr(), scale.data_ptr(),
        mean.data_ptr() if mean is not None else None, b * h, s, d, int(bf16),
        quant.V_CODE_TYPES.index(out.dtype), int(mean is not None), *plan,
        torch.cuda.current_stream(v.device).cuda_stream)


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
    args = quant_v_args(x, out, scale, mean)
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = _build.lib("quant_v").quant_v_per_channel(*args)
    _build.check(err, "quant_v_per_channel")
    _build.count_launch(quant_v_per_channel, x.shape[-1])
    return out, scale, mean



def v_channel_stats_plain(v: torch.Tensor, *, smooth: bool):
    """(max, min, mean or None) of each channel over the sequence, [b,h,d]
    fp32 each."""
    x = v.float()
    return x.amax(dim=-2), x.amin(dim=-2), x.mean(dim=-2) if smooth else None


def v_stats_args(v, parts) -> tuple:
    """The arguments of the C entry point ``quant_v_stats`` (kernel 6's
    first pass) writing each block's max, min and sum into ``parts`` [3,
    bh, blocks, d] fp32."""
    b, h, s, d = v.shape
    return (
        v.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), parts[2].data_ptr(), b * h, s,
        d, V_BLOCK_ROWS, int(v.dtype == torch.bfloat16),
        torch.cuda.current_stream(v.device).cuda_stream)


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
    args = v_stats_args(v, parts)
    with torch.cuda.device(v.device):  # the launch goes to the current device
        err = _build.lib("quant_v").quant_v_stats(*args)
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


def v_apply_args(v, r, mean, out) -> tuple:
    """The arguments of the C entry point ``quant_v_apply`` (kernel 6's
    second pass) writing the codes of ``out``'s type into ``out``."""
    b, h, s, d = v.shape
    return (
        v.data_ptr(), r.data_ptr(), mean.data_ptr() if mean is not None else None,
        out.data_ptr(), b * h, s, d, V_BLOCK_ROWS, int(v.dtype == torch.bfloat16),
        quant.V_CODE_TYPES.index(out.dtype), torch.cuda.current_stream(v.device).cuda_stream)


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
    args = v_apply_args(v, r, mean, out)
    with torch.cuda.device(v.device):  # the launch goes to the current device
        err = _build.lib("quant_v").quant_v_apply(*args)
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
