"""The host-side plans of kernels 3 and 5 (``ops/quant_cuda.py``) and
kernel 5's summation order, on the CPU.

* Kernel 3 (``quant_k_plan``; ``k_tiles`` and ``k_rows`` list what the
  kernel's CTAs walk and stage under it): the CTAs walk contiguous runs of
  the (b h, group) tiles that together take every tile once, in order;
  each tile's staged (in registers at d <= 128, else in the ring) and
  re-read rows take each live row of the slab once; the ring fits its
  limits and holds the whole tile with a unit to spare except for fp32 K
  at head dim 512.
* Kernel 5 (``quant_v_plan``; ``v_rows`` lists each CTA's staged and
  re-read rows): the cluster's CTAs split the slab's rows, each row staged
  or re-read exactly once, for sequence lengths from 1 to the 4 MB limit of
  the single-pass kernel (``V_SINGLE_PASS_BYTES``) at every head dim and V
  dtype, or the column split reads every row; the plan is the candidate of
  least predicted time; the plans at the CogVideoX-2B layer and at the
  checked shapes from an H100's room for clusters.
* ``v_partition_sum``, the per-channel sum in kernel 5's partition and
  rank order (each CTA's row groups summed in row order, the groups in
  group order, the CTAs in rank order; by columns, each thread's rows,
  a butterfly a warp, the warps in order): equal to a plain loop that adds
  the rows in that order; ``v_partition_mean``, that sum over s, within
  1e-6 relative of the JAX ``per_channel_quant`` mean (XLA sums in another order); the codes
  from that mean equal the JAX spec's codes from it, for int8, e4m3 and
  e5m2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import quant as jq
from sageattention_tpu_torch import quant as tq
from sageattention_tpu_torch.ops import quant_cuda as qc

DIMS = (64, 128, 256, 384, 512)
DTYPES = {"bf16": 2, "fp32": 4}
GROUP = 128


def k_tiles(plan, bh: int, s: int, group: int) -> list[range]:
    """The (b h, group) tiles each CTA of kernel 3 walks, in its order
    (``quant_k_kernel``: tile t is group t % ceil(s / group) of
    slab t // ceil(s / group))."""
    n = bh * -(-s // group)
    return [range(c * n // plan.grid, (c + 1) * n // plan.grid) for c in range(plan.grid)]


def k_rows(plan, s: int, group: int, gi: int) -> tuple[range, range]:
    """(staged, re-read) rows of a slab's group ``gi`` under kernel 3's
    plan: the first are staged and read from device memory once, the rest
    read twice (amax, then codes)."""
    row0 = gi * group
    live = min(group, s - row0)
    st = min(plan.staged_rows, live)
    return range(row0, row0 + st), range(row0 + st, row0 + live)


def v_rows(plan, s: int) -> list[tuple[range, range]]:
    """(staged, re-read) rows of each CTA of a slab's cluster under kernel
    5's plan, by rank (``quant_v_kernel``: CTA ``rank`` takes rows [rank
    rpc, (rank + 1) rpc), the first ``stage_rows`` of them staged); the
    column split reads every row twice."""
    if plan.cl == 0:
        return [(range(0), range(s))]
    out = []
    for rank in range(plan.cl):
        r0 = min(s, rank * plan.rows_per_cta)
        r1 = min(s, r0 + plan.rows_per_cta)
        st = min(r1 - r0, plan.stage_rows)
        out.append((range(r0, r0 + st), range(r0 + st, r1)))
    return out


def _lengths(d: int, itemsize: int) -> list[int]:
    """Sequence lengths from 1 to the single-pass limit at (d, itemsize):
    the edges of a group, of the ring and of a cluster's split, and the
    limit itself."""
    top = qc.V_SINGLE_PASS_BYTES // (d * itemsize)
    picks = {1, 2, 7, 63, 64, 65, 127, 128, 129, 1000, 1111, 3001, 4001, top - 1, top}
    picks |= {top // k for k in (2, 3, 5, 7, 16, 17)}
    return sorted(x for x in picks if 1 <= x <= top)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", DIMS)
def test_k_plan_covers_every_row_once(d, dtype):
    isz = DTYPES[dtype]
    for bh in (1, 3, 30):
        for s in _lengths(d, isz)[::2] + [17776]:
            plan = qc.quant_k_plan(bh, s, d, isz, GROUP)
            ng = -(-s // GROUP)
            tiles = k_tiles(plan, bh, s, GROUP)
            assert len(tiles) == plan.grid
            if plan.stages:  # a persistent grid, as many CTAs as the SMs hold
                assert plan.grid <= min(bh * ng, qc.H100_SMS * qc.K_CTAS_PER_SM)
            else:  # a tile a CTA
                assert plan.grid == bh * ng
            walked = [t for r in tiles for t in r]
            assert walked == list(range(bh * ng))  # every tile once, each CTA a contiguous run
            assert all(len(r) >= 1 for r in tiles)
            assert max(map(len, tiles)) - min(map(len, tiles)) <= 1
            seen = np.zeros(s, dtype=np.int64)
            for gi in range(ng):  # one slab's groups; every slab walks the same
                staged, reread = k_rows(plan, s, GROUP, gi)
                assert len(staged) <= plan.staged_rows
                seen[list(staged)] += 1
                seen[list(reread)] += 1
            np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", DIMS)
def test_k_plan_limits(d, dtype):
    isz = DTYPES[dtype]
    plan = qc.quant_k_plan(30, 17776, d, isz, GROUP)
    if d <= 128:  # each tile in the registers of a CTA of its own
        assert plan == qc.KPlan(GROUP, 0, GROUP, 30 * -(-17776 // GROUP))
        assert -(-GROUP // (qc.K_THREADS // (d // 8))) <= qc.K_REG_ROWS
        return
    unit = plan.unit_rows * d * isz
    assert GROUP % plan.unit_rows == 0
    assert plan.staged_rows % plan.unit_rows == 0
    assert plan.staged_rows // plan.unit_rows <= plan.stages <= qc.K_MAX_STAGES
    assert plan.stages * unit <= qc.K_RING_BYTES and unit <= qc.K_UNIT_BYTES
    if d == 512 and dtype == "fp32":  # a 256 KB tile: part of it is re-read
        assert 0 < plan.staged_rows < GROUP
    else:  # the whole tile staged, with a unit of the next in flight
        assert plan.staged_rows == GROUP
        assert plan.stages >= GROUP // plan.unit_rows + 1


def test_k_plan_at_the_cogvideox_layer():
    """The main path's call holds each of the 4,170 16 KB tiles in the
    registers of a CTA of its own (4 rows a thread); at d 256 whole 64 KB
    tiles go through a ring of three, one CTA an SM walking 15 or 16 of the
    2,048 tiles of (4, 16, 4096)."""
    plan = qc.quant_k_plan(30, 17776, 64, 2, GROUP)
    assert plan == qc.KPlan(unit_rows=128, stages=0, staged_rows=128, grid=4170)
    assert [len(r) for r in k_tiles(plan, 30, 17776, GROUP)] == [1] * 4170
    plan = qc.quant_k_plan(64, 4096, 256, 2, GROUP)
    assert plan == qc.KPlan(unit_rows=128, stages=3, staged_rows=128, grid=132)
    assert {len(r) for r in k_tiles(plan, 64, 4096, GROUP)} == {15, 16}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", DIMS)
def test_v_plan_covers_every_row_once(d, dtype):
    isz = DTYPES[dtype]
    room = qc.V_STAGE_BYTES // (d * isz)
    for bh in (1, 16, 30):
        for cls in (qc.V_PLAN_SIZES, (8,), (16,)):
            for s in _lengths(d, isz):
                plan = qc.quant_v_plan(bh, s, d, isz, room=h100_room, cls=cls)
                assert plan.cl in cls
                seen = np.zeros(s, dtype=np.int64)
                if plan.cl == 0:  # the column split reads every row, twice
                    assert plan == qc.VPlan(0, s, 0, bh)
                    assert v_rows(plan, s) == [(range(0), range(s))]
                    continue
                assert 1 <= plan.clusters <= bh
                assert qc.v_smem_bytes(plan.stage_rows, d, isz) <= 232448
                assert plan.rows_per_cta == -(-s // plan.cl)
                assert plan.stage_rows * d * isz <= qc.V_STAGE_BYTES
                assert plan.stage_rows == min(room, plan.rows_per_cta)
                for staged, reread in v_rows(plan, s):
                    assert len(staged) <= plan.stage_rows
                    assert not reread or len(staged) == plan.stage_rows
                    seen[list(staged)] += 1
                    seen[list(reread)] += 1
                np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", DIMS)
def test_v_plan_is_the_least_predicted(d, dtype):
    """Of the column split and the cluster sizes the card places, the plan
    is the one of least predicted time, a cluster plan's weighted by
    ``V_CLUSTER_MARGIN``, every prediction finite and positive."""
    isz = DTYPES[dtype]
    full = qc.v_smem_bytes(qc.V_STAGE_BYTES // (d * isz), d, isz)
    for bh in (1, 16, 30, 64):
        for s in _lengths(d, isz)[::3]:
            plan = qc.quant_v_plan(bh, s, d, isz, room=h100_room)
            us = {}
            for c in qc.V_PLAN_SIZES:
                p = qc.quant_v_plan(bh, s, d, isz, room=h100_room, cls=(c,))
                us[p] = qc.v_plan_us(p, bh, s, d, isz, room1=h100_room(c, full) if c else None)
                assert 0 < us[p] < float("inf")
                us[p] *= qc.V_CLUSTER_MARGIN if c else 1
            assert qc.VPlan(0, s, 0, bh) in us
            assert plan in us and us[plan] == min(us.values())


def h100_room(cl: int, smem: int) -> int:
    """The clusters of ``cl`` CTAs an H100 80GB HBM3 held at once by
    ``cudaOccupancyMaxActiveClusters`` with one CTA an SM (16: 7, 8: 15, 4:
    30), the smaller ones taken as the SMs over cl, twice that where two
    CTAs fit an SM."""
    return ({16: 7, 8: 15, 4: 30}.get(cl, qc.H100_SMS // cl)
            * (2 if 2 * (smem + 2**10) <= qc.SM_SHARED_BYTES else 1))


def test_v_plan_at_the_cogvideox_layer():
    """The main path's slab (17,776 x 64 bf16, 2.28 MB).  On an H100, 8
    CTAs of 2,222 rows, 1,536 staged and 686 read twice, 15 clusters at
    once, two rounds for the 30 slabs, predicted faster than 16 CTAs of
    1,111 rows (all staged) in five rounds, as seven clusters fit at once,
    than 4 CTAs of 4,444 rows in one and than the column split.  With
    every slab at once, 16 CTAs a slab.  8 MB of V in all (16 slabs of
    4096 x 64 bf16): the column split."""
    plan = qc.quant_v_plan(30, 17776, 64, 2, room=h100_room)
    assert plan == qc.VPlan(cl=8, rows_per_cta=2222, stage_rows=1536, clusters=15)
    assert [len(r) for _, r in v_rows(plan, 17776)] == [686] * 8
    cl16 = qc.quant_v_plan(30, 17776, 64, 2, room=h100_room, cls=(16,))
    assert cl16 == qc.VPlan(cl=16, rows_per_cta=1111, stage_rows=1111, clusters=7)
    full = qc.v_smem_bytes(qc.V_STAGE_BYTES // 128, 64, 2)
    us = {c: qc.v_plan_us(qc.quant_v_plan(30, 17776, 64, 2, room=h100_room, cls=(c,)),
                          30, 17776, 64, 2, room1=h100_room(c, full) if c else None)
          for c in (0, 4, 8, 16)}
    assert us[8] * qc.V_CLUSTER_MARGIN < us[0] and us[8] < min(us[4], us[16])
    assert qc.v_smem_bytes(1111, 64, 2) == 168064  # one CTA an SM
    assert qc.quant_v_plan(30, 17776, 64, 2) == qc.VPlan(16, 1111, 1111, 30)
    assert qc.quant_v_plan(16, 4096, 64, 2, room=h100_room) == qc.VPlan(0, 4096, 0, 16)


def _v(shape, seed, dtype=np.float32):
    """V with a per-channel offset, as the smooth-v tests draw it."""
    rng = np.random.default_rng(seed)
    b, h, s, d = shape
    v = rng.standard_normal(shape) + 3 * rng.standard_normal((b, h, 1, d))
    return v.astype(np.float32).astype(dtype)


def _loop_sum(x: np.ndarray, plan) -> np.ndarray:
    """The sum of x [s, d] in kernel 5's order, one fp32 addition at a time."""
    s, d = x.shape
    if plan.cl == 0:  # the column split: threads, a butterfly a warp, warps
        lane = [np.zeros(d, np.float32) for _ in range(qc.V_THREADS)]
        for r in range(s):
            lane[r % qc.V_THREADS] = (lane[r % qc.V_THREADS] + x[r]).astype(np.float32)
        for o in (1, 2, 4, 8, 16):
            lane = [(lane[i] + lane[(i // 32) * 32 + (i % 32 ^ o)]).astype(np.float32)
                    for i in range(qc.V_THREADS)]
        total = lane[0]
        for w in range(1, qc.V_THREADS // 32):
            total = (total + lane[32 * w]).astype(np.float32)
        return total
    n = qc.V_THREADS // (d // 8)
    total = None
    for rank in range(plan.cl):
        r0 = min(s, rank * plan.rows_per_cta)
        r1 = min(s, r0 + plan.rows_per_cta)
        cta = None
        for g in range(n):
            acc = np.zeros(d, np.float32)
            for r in range(r0 + g, r1, n):
                acc = (acc + x[r]).astype(np.float32)
            cta = acc if cta is None else (cta + acc).astype(np.float32)
        total = cta if total is None else (total + cta).astype(np.float32)
    return total


@pytest.mark.parametrize("s,d,plan", [(37, 64, qc.VPlan(4, 10, 10, 1)),
                                      (203, 384, qc.VPlan(2, 102, 40, 1)),
                                      (100, 512, qc.VPlan(16, 7, 7, 1)),
                                      (700, 128, qc.VPlan(0, 700, 0, 1))])
def test_v_partition_sum_is_the_kernels_order(s, d, plan):
    x = _v((1, 1, s, d), seed=s)[0, 0]
    got = qc.v_partition_sum(torch.from_numpy(x), plan).numpy()
    np.testing.assert_array_equal(got, _loop_sum(x, plan))


MEAN_SHAPES = [((1, 2, 17776, 64), "fp32"), ((2, 3, 1111, 128), "fp32"),
               ((1, 2, 4001, 256), "fp32"), ((1, 2, 2731, 384), "fp32"),
               ((1, 1, 2051, 512), "fp32"), ((1, 4, 3001, 64), "bf16")]


@pytest.mark.parametrize("shape,dtype", MEAN_SHAPES)
def test_v_partition_mean_matches_jax(shape, dtype):
    b, h, s, d = shape
    x = _v(shape, seed=d + s)
    if dtype == "bf16":  # bf16 V as the kernel reads it, widened exactly
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    itemsize = 2 if dtype == "bf16" else 4
    for cls in (qc.V_PLAN_SIZES, (16,), (4,), (0,)):
        plan = qc.quant_v_plan(b * h, s, d, itemsize, cls=cls)
        mean = qc.v_partition_mean(torch.from_numpy(x), plan).numpy()
        _, _, m_j = jq.per_channel_quant(jnp.asarray(x), dtype=jnp.int8, smooth=True)
        np.testing.assert_allclose(mean, np.asarray(m_j), rtol=1e-6, atol=1e-7)


CODES = {"int8": (torch.int8, jnp.int8), "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
         "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}


@pytest.mark.parametrize("code", sorted(CODES))
def test_codes_from_the_partition_mean_match_jax_spec(code):
    tdt, jdt = CODES[code]
    shape = (1, 3, 2222, 128)
    x = _v(shape, seed=5)
    plan = qc.quant_v_plan(3, 2222, 128, 4)
    mean = qc.v_partition_mean(torch.from_numpy(x), plan).numpy()
    centred = x - mean[..., None, :]
    q_t, s_t, _ = tq.per_channel_quant(torch.from_numpy(centred), dtype=tdt, smooth=False)
    q_j, s_j, _ = jq.per_channel_quant(jnp.asarray(centred), dtype=jdt, smooth=False)
    np.testing.assert_array_equal(q_t.view(torch.uint8).numpy(), np.asarray(q_j).view(np.uint8))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    # and the plain version of kernel 5 given that mean gives the same codes
    q_p, s_p, _ = qc.quant_v_per_channel_plain(torch.from_numpy(centred), dtype=tdt,
                                               smooth=False)
    np.testing.assert_array_equal(q_p.view(torch.uint8).numpy(), np.asarray(q_j).view(np.uint8))
