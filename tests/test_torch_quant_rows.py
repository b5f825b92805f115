"""Kernel 4, the row-group Q/K quantizer
(``quant_cuda.quant_q_per_token``, ``csrc/quant_q.cu``), and the route of
every Q/K option through kernels 2 and 4, on the CPU, from numpy inputs
made from a seed.

* Its plain version (``quant_q_per_token_plain``, what the kernel computes
  bit for bit on the card) against the JAX package, bit-exact:
  - ``quant.quant_int8`` at every granularity, 8 and 4 bits, bf16 and fp32
    input, head dims 64, 128 and 256, a ragged length (200: a ragged last
    group of 32 and of 128 rows) and an all-zero group; a few cases at 384
    and 512 and at 333 rows;
  - with a mean, the JAX chain of smooth_q (``core.py:274-275``:
    ``(q.astype(f32) - qm).astype(q.dtype)``, then ``quant_int8``) for bf16,
    fp16 and fp32 q, and the smoothed K of ``quantize_qk``
    (``quant_int8(k.astype(f32) - km)``), each given the JAX mean;
  - at head dim 80 zero-padded to 128 (x and mean), the JAX codes at 80
    padded with zeros and the same scales.
* The launch plan (``quant_q_plan``), emulated as ``quant_rows_kernel``
  walks it: every live row of every slab taken by exactly one team of
  lanes, each lane's chunks the row's every column once, each group's rows
  inside one unit that shares its amax (a team, a set of warps, a CTA or a
  cluster) and no unit holding two groups; what a thread holds within
  ``Q_HELD_BYTES``; the C entry's checks (``entry_accepts``, its
  conditions written out) accept it; the kernel's constants and its
  ``slots_of`` (compiled for the host) pick the plan's slots, the one
  instance built for each (head dim, type, group, mean).
* The route: every option calls kernels 2 and 4 (the wrappers, which run
  their plain versions here and their kernels on a CUDA tensor; ``core``
  does not branch on the device) and never ``quant.quantize_qk`` or
  ``core._smooth_q``; at head dim 64, where no padding moves a mean's
  summation, its codes and scales equal those of that spec chain.
"""

import itertools
import pathlib
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import quant as jq
from sageattention_tpu_torch import core, quant, sageattn
from sageattention_tpu_torch.ops import quant_cuda as qc

LOG2E = quant.LOG2E
GRANS = ("per_token", "per_subtile", "per_block")
JDT = {"bf16": jnp.bfloat16, "fp16": jnp.float16, "fp32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _x(shape, seed, dtype):
    """x with a per-channel offset (what a mean takes off) as a JAX array
    of ``dtype`` and the same values as a torch tensor of the kernel's
    input type (fp16 widened to fp32, exactly)."""
    b, h, s, d = shape
    x = _rand(shape, seed, 3.0) + _rand((1, h, 1, d), seed + 1, 2.0)
    x[0, 0, 32:64] = 0.0  # an all-zero group of 32 rows: the 1e-30 floor
    jx = jnp.asarray(x).astype(JDT[dtype])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    return jx, tx.to(torch.bfloat16) if dtype == "bf16" else tx


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# --------------------------------------------------------------------------
# the plain version against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_plain_matches_jax_quant_int8(d, gran, bits, dtype):
    jx, tx = _x((2, 2, 200, d), d + bits, dtype)
    fold = d**-0.5 * LOG2E
    q_t, s_t = qc.quant_q_per_token_plain(tx, group=quant.group_rows(gran), scale_fold=fold,
                                          bits=bits)
    q_j, s_j = jq.quant_int8(jx, granularity=gran, scale_fold=fold, bits=bits)
    _eq(q_t, q_j)
    _eq(s_t, s_j)
    assert int(q_t.abs().max()) == (7 if bits == 4 else 127)
    assert bool((q_t[0, 0, 32:64] == 0).all())


@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("d", [384, 512])
def test_plain_matches_jax_quant_int8_wide(d, gran):
    jx, tx = _x((1, 2, 333, d), d, "bf16")
    q_t, s_t = qc.quant_q_per_token_plain(tx, group=quant.group_rows(gran), scale_fold=1.0)
    q_j, s_j = jq.quant_int8(jx, granularity=gran)
    _eq(q_t, q_j)
    _eq(s_t, s_j)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("dtype", ["bf16", "fp16", "fp32"])
def test_plain_with_mean_matches_jax_smooth_q(dtype, gran, bits):
    """smooth_q's Q: (f32(q) - qm) rounded back to q's dtype, then
    quantized, given the JAX qm."""
    jx, tx = _x((1, 3, 333, 64), 11 + bits, dtype)
    qm = jnp.mean(jx.astype(jnp.float32), axis=-2)
    q_in = (jx.astype(jnp.float32) - qm[..., None, :]).astype(jx.dtype)
    fold = 64**-0.5 * LOG2E
    q_j, s_j = jq.quant_int8(q_in, granularity=gran, scale_fold=fold, bits=bits)
    cast = TDT[dtype] if dtype != "fp32" else None
    q_t, s_t = qc.quant_q_per_token_plain(tx, torch.from_numpy(np.array(qm)),
                                          group=quant.group_rows(gran), cast=cast,
                                          scale_fold=fold, bits=bits)
    _eq(q_t, q_j)
    _eq(s_t, s_j)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_plain_with_mean_matches_jax_smoothed_k(dtype, gran, bits):
    """quantize_qk's K: quant_int8(f32(k) - km), given the JAX km."""
    jx, tx = _x((2, 2, 300, 128), 21 + bits, dtype)
    km = jnp.mean(jx.astype(jnp.float32), axis=-2)
    k_j, s_j = jq.quant_int8(jx.astype(jnp.float32) - km[..., None, :], granularity=gran,
                             bits=bits)
    k_t, s_t = qc.quant_q_per_token_plain(tx, torch.from_numpy(np.array(km)),
                                          group=quant.group_rows(gran), scale_fold=1.0,
                                          bits=bits)
    _eq(k_t, k_j)
    _eq(s_t, s_j)


@pytest.mark.parametrize("mean", [False, True], ids=["x", "x-mean"])
@pytest.mark.parametrize("gran", GRANS)
def test_padded_head_dim_equals_quantize_then_pad(gran, mean):
    """d 80 zero-padded to 128 (the kernels' width): the codes of the JAX
    function at 80, padded with zeros, and its scales."""
    jx, tx = _x((1, 2, 200, 80), 31, "bf16")
    m = jnp.mean(jx.astype(jnp.float32), axis=-2) if mean else None
    xj = jx if m is None else jx.astype(jnp.float32) - m[..., None, :]
    q_j, s_j = jq.quant_int8(xj, granularity=gran, bits=8)
    tp = torch.nn.functional.pad(tx, (0, 48))
    mp = torch.nn.functional.pad(torch.from_numpy(np.array(m)), (0, 48)) if mean else None
    q_t, s_t = qc.quant_q_per_token_plain(tp, mp, group=quant.group_rows(gran), scale_fold=1.0)
    _eq(q_t[..., :80], q_j)
    assert not q_t[..., 80:].any()
    _eq(s_t, s_j)


# --------------------------------------------------------------------------
# the launch plan
# --------------------------------------------------------------------------


def entry_accepts(plan, s: int, d: int, group: int) -> bool:
    """The C entry's checks on the plan (``quant_rows`` in
    ``csrc/quant_q.cu``)."""
    _, w, _ = qc.q_row_lanes(d)
    rw = w * plan.slots
    rc = qc.Q_THREADS // 32 * rw
    span = rc * plan.cl
    if group not in qc.Q_GROUPS or not 1 <= plan.cl <= qc.Q_MAX_CLUSTER:
        return False
    if not (plan.tiles * span >= s > (plan.tiles - 1) * span):
        return False
    if group == 1:
        return plan.cl == 1
    if group % rw:
        return False
    if group <= rc:
        return plan.cl == 1 and rc % group == 0
    return group == span


def kernel_walk(plan, bh: int, s: int, d: int, group: int):
    """The rows ``quant_rows_kernel`` loads under ``plan``: for every (CTA,
    warp, team of lanes, slot) the (slab, row) it takes (rows below s only)
    and the unit whose amax it shares: (CTA, warp, team, slot) at one row a
    group, (CTA, warp // warps a group) for a group within a CTA, the
    cluster otherwise.  A team's lanes take the row's chunks
    (``lane_chunks``)."""
    _, w, _ = qc.q_row_lanes(d)
    rw = w * plan.slots
    warps = qc.Q_THREADS // 32
    rc = warps * rw
    cta, warp, team, i = np.meshgrid(np.arange(plan.grid), np.arange(warps), np.arange(w),
                                     np.arange(plan.slots), indexing="ij")
    rank, tile = cta % plan.cl, cta // plan.cl
    slab = tile // plan.tiles
    row = ((tile % plan.tiles) * plan.cl + rank) * rc + warp * rw + i * w + team
    if group == 1:
        unit = ((cta * warps + warp) * w + team) * plan.slots + i
    elif group <= rc:
        unit = cta * warps + warp // min(warps, group // rw)
    else:
        unit = cta // plan.cl
    live = row < s
    return slab[live], row[live], unit[live]


def lane_chunks(d: int) -> np.ndarray:
    """The 8-column chunks of a row each lane of its team loads, over the
    lanes and their chunks (``lane % L + c L`` below d / 8)."""
    lanes, _, c = qc.q_row_lanes(d)
    col = np.arange(lanes)[:, None] + np.arange(c)[None, :] * lanes
    return col[col < d // 8]


def one_to_one(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether equal ``a`` go with equal ``b`` and the other way round."""
    for x, y in ((a, b), (b, a)):
        first = np.full(x.max() + 1, -1)
        first[x] = y
        if not np.array_equal(first[x], y):
            return False
    return True


@pytest.mark.parametrize("mean", [False, True], ids=["x", "mean"])
@pytest.mark.parametrize("group", qc.Q_GROUPS)
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", qc.HEAD_DIMS)
def test_plan_covers_every_row_once(d, itemsize, group, mean):
    _, _, c = qc.q_row_lanes(d)
    for bh, s in ((2, 1), (3, 333), (2, 4001), (1, 17776)):
        plan = qc.quant_q_plan(bh, s, d, itemsize, group, mean=mean)
        assert entry_accepts(plan, s, d, group), plan
        assert plan.slots in qc.Q_SLOTS
        assert plan.slots * c * 8 * itemsize <= qc.Q_HELD_BYTES
        slab, row, unit = kernel_walk(plan, bh, s, d, group)
        # each (slab, row) taken by exactly one team, every one of them
        assert np.array_equal(np.sort(slab * s + row), np.arange(bh * s))
        # each group's rows in one unit, each unit one group's
        assert one_to_one(slab * -(-s // group) + row // group, unit)
    # a team's lanes load each chunk of the row once
    assert np.array_equal(np.sort(lane_chunks(d)), np.arange(d // 8))


@pytest.mark.parametrize("gran", GRANS)
def test_plan_at_the_model_layers(gran):
    """At the CogVideoX-2B layer (bf16, d 64) a CTA holds a group: no
    cluster, two rows a thread at one row a scale (four with a mean), four
    at more; fp32 K of 128 rows at d 512 takes a cluster of 4."""
    group = quant.group_rows(gran)
    for mean in (False, True):
        plan = qc.quant_q_plan(30, 17776, 64, 2, group, mean=mean)
        slots = 2 if group == 1 and not mean else 4  # 64 or 128 rows a CTA
        assert plan.cl == 1 and plan.slots == slots
        assert plan.grid == 30 * -(-17776 // (32 * slots))
    if group == 128:
        assert qc.quant_q_plan(16, 4096, 512, 4, group).cl == 4


def test_plan_refuses_groups_it_cannot_take():
    for group in (3, 48, 0, 64, 256):
        with pytest.raises(ValueError):
            qc.quant_q_plan(1, 100, 64, 2, group)


QUANT_Q_CU = pathlib.Path(qc.__file__).resolve().parent.parent / "csrc" / "quant_q.cu"


def test_kernel_constants_are_the_plans():
    """The constants of ``csrc/quant_q.cu`` that its ``slots_of`` and checks
    read are the plan's."""
    src = QUANT_Q_CU.read_text()
    want = {"kThreads": qc.Q_THREADS, "kHeldBytes": qc.Q_HELD_BYTES,
            "kMaxCluster": qc.Q_MAX_CLUSTER, "kTokenElems": qc.Q_TOKEN_ELEMS,
            "kGroupSlots": qc.Q_GROUP_SLOTS}
    for name, value in want.items():
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert found == [str(value)], (name, found)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no host C++ compiler")
def test_kernel_builds_the_plans_slots(tmp_path):
    """``slots_of`` of ``csrc/quant_q.cu``, compiled for the host, gives
    every (head dim, type, group, mean) the plan's slots: the one instance
    the kernel builds for it is the one the plan launches."""
    src = QUANT_Q_CU.read_text()
    body = src[src.index("constexpr int kThreads"):src.index("// the rounding of smooth_q")]
    prog = "\n".join([
        "#include <cstdio>", "#include <cstdint>", "struct __nv_bfloat16 { uint16_t x; };",
        body.replace("__host__ __device__ ", ""),
        "template <int D> void row() {",
        "  const int groups[3] = {1, 32, 128};",
        "  for (int g : groups) for (int m = 0; m < 2; ++m)",
        '    printf("%d 2 %d %d %d\\n%d 4 %d %d %d\\n", D, g, m, slots_of<D, __nv_bfloat16>(g, m),'
        " D, g, m, slots_of<D, float>(g, m));",
        "}",
        "int main() { " + " ".join(f"row<{d}>();" for d in qc.HEAD_DIMS) + " }",
    ])
    (tmp_path / "slots.cpp").write_text(prog)
    exe = tmp_path / "slots"
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(tmp_path / "slots.cpp")],
                   check=True, capture_output=True, timeout=120)
    rows = subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                          timeout=60).stdout.split("\n")
    got = [tuple(map(int, r.split())) for r in rows if r]
    assert len(got) == len(qc.HEAD_DIMS) * 2 * len(qc.Q_GROUPS) * 2
    for d, itemsize, group, mean, slots in got:
        assert qc.quant_q_plan(1, 100, d, itemsize, group, mean=bool(mean)).slots == slots, \
            (d, itemsize, group, mean)


# --------------------------------------------------------------------------
# the route of every option
# --------------------------------------------------------------------------

OPTIONS = {
    "smooth_q": dict(smooth_q=True),
    "int4": dict(qk_bits=4),
    "int4_smooth_q": dict(qk_bits=4, smooth_q=True),
    "per_token": dict(qk_quant_gran="per_token"),
    "per_subtile": dict(qk_quant_gran="per_subtile"),
    "per_block": dict(qk_quant_gran="per_block"),
    "per_block_int4_smooth_q": dict(qk_quant_gran="per_block", qk_bits=4, smooth_q=True),
}


def _qkv(dtype, seed=41, b=1, hq=4, hkv=2, s=200, d=64):
    xs = [_rand((b, h, s, d), seed + i) + _rand((1, h, 1, d), seed + 9 + i, 1.5)
          for i, h in enumerate((hq, hkv, hkv))]
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("smooth_k", [True, False])
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_every_option_quantizes_through_kernels_2_and_4(monkeypatch, opt, smooth_k):
    calls = []
    for name in ("k_channel_mean", "quant_q_per_token", "quant_k_chunked"):
        fn = getattr(qc, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            calls.append((_name, kwargs.get("group"), kwargs.get("cast")))
            return _fn(*args, **kwargs)

        monkeypatch.setattr(qc, name, spy)

    def refuse(*args, **kwargs):
        raise AssertionError("the spec chain was called on the op's route")

    monkeypatch.setattr(quant, "quantize_qk", refuse)
    monkeypatch.setattr(core, "_smooth_q", refuse)
    o = sageattn(*_qkv(torch.bfloat16), smooth_k=smooth_k, **OPTIONS[opt])
    assert bool(torch.isfinite(o).all())
    opts = core.QKOptions(**{"qk_quant_gran": "auto", **OPTIONS[opt]})
    auto = opts.qk_quant_gran == "auto"
    group = 1 if auto else quant.group_rows(opts.qk_quant_gran)
    want = [("k_channel_mean", None, None)] if opts.smooth_q else []
    want.append(("quant_q_per_token", group, torch.bfloat16 if opts.smooth_q else None))
    if auto:
        want += [("k_channel_mean", None, None)] * smooth_k + [("quant_k_chunked", 128, None)]
    else:
        want += [("k_channel_mean", None, None)] * smooth_k + [("quant_q_per_token", group, None)]
    assert calls == want


@pytest.mark.parametrize("dtype", ["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_route_equals_the_spec_chain(opt, dtype):
    """At head dim 64 (no padding) the route's Q/K operands equal those of
    ``core._smooth_q`` and ``quant.quantize_qk`` (K per row) or
    ``quant_k_fused_mean``'s plain version ("auto") bit for bit."""
    q, k, _ = _qkv(TDT[dtype], seed=51)
    opts = core.QKOptions(**{"qk_quant_gran": "auto", **OPTIONS[opt]})
    sm = 64**-0.5
    work = core._work_dtype(q.dtype)
    q_i8, q_sc, k_i8, k_sc, km, cb = core._quant_qk(q, k, opts, work=work, d_pad=64,
                                                    sm_scale=sm, smooth_k=True)
    qm, q_in = core._smooth_q(q) if opts.smooth_q else (None, q)
    if opts.qk_quant_gran == "auto":
        want_q = quant.quant_int8(q_in, scale_fold=sm * LOG2E, bits=opts.qk_bits)
        want_k = qc.quant_k_chunked_plain(k.to(work), k.to(work).float().mean(dim=-2),
                                          group=128, bits=opts.qk_bits)
        km_want = k.float().mean(dim=-2)
    else:
        sq, ssc, sk, ssk, km_want = quant.quantize_qk(
            q_in, k, sm_scale=sm, granularity=opts.qk_quant_gran, bits=opts.qk_bits)
        want_q, want_k = (sq, ssc), (sk, ssk)
    for a, b in itertools.chain(zip((q_i8, q_sc), want_q), zip((k_i8, k_sc), want_k)):
        assert torch.equal(a, b)
    assert torch.equal(km, km_want)
    if opts.smooth_q:
        assert torch.equal(cb, core._score_col_bias(qm, k, km_want, sm))
