"""The port's ``utils`` (``compare``, ``dump``, ``profiling``) against the
JAX package's, on the CPU.

* ``compare``: ``rel_err_rate`` and the non-cosine fields of
  ``compare_report`` equal the JAX results exactly (the same fp32
  arithmetic); the cosines (``per_axis_cosine``, ``cosine`` and
  ``worst_row_cosine``) within 1e-6, because the port sums them in fp64.
* ``StageDumper``: saves once per key; bf16 stages load with plain
  ``np.load`` as fp32; a JAX dump directory and a port one of the same
  attention stages (the K codes as int8, ``o`` as fp32) compare in both
  directions at cosine >= 0.9999.  The two K means are summed in other
  orders, which can move a K code one step, so the codes are held to that
  cosine and not to equality.
* ``StageTimer``: the same ``times`` give the JAX ``report()`` string
  character for character; a run accumulates per name.
* ``trace``: writes a Chrome trace file on the CPU.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu import quant as jquant
from sageattention_tpu.utils import compare as jcompare
from sageattention_tpu.utils import dump as jdump
from sageattention_tpu.utils import profiling as jprofiling
from sageattention_tpu_torch import sageattn
from sageattention_tpu_torch.core import K_GROUP
from sageattention_tpu_torch.ops import quant_cuda
from sageattention_tpu_torch.utils import compare, dump, profiling

COS_TOL = 1e-6  # fp64 against fp32 sums of the same products


def _pair(shape, seed, noise=1e-3):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    return a, (a + noise * rng.standard_normal(shape)).astype(np.float32)


SHAPES = [(7,), (4, 33), (2, 3, 64, 16)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("threshold", [0.002, 0.05])
def test_rel_err_rate_matches_jax(shape, threshold):
    a, b = _pair(shape, seed=len(shape), noise=1e-2)
    assert compare.rel_err_rate(a, b, threshold) == jcompare.rel_err_rate(a, b, threshold)


@pytest.mark.parametrize("shape", SHAPES[1:], ids=str)
@pytest.mark.parametrize("axis", [0, -1])
def test_per_axis_cosine_matches_jax(shape, axis):
    a, b = _pair(shape, seed=3)
    got, want = compare.per_axis_cosine(a, b, axis), jcompare.per_axis_cosine(a, b, axis)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=COS_TOL)


@pytest.mark.filterwarnings("ignore::RuntimeWarning")  # the mean of an empty tensor
@pytest.mark.parametrize("shape", SHAPES + [(0, 4)], ids=str)
def test_compare_report_matches_jax(shape):
    a, b = _pair(shape, seed=5)
    got = compare.compare_report(a, torch.from_numpy(b), name="o", threshold=0.01)
    want = jcompare.compare_report(a, b, name="o", threshold=0.01)
    assert list(got) == list(want)
    for key in ("name", "shape", "max_abs_err", "mean_abs_err", "rel_err_rate"):
        np.testing.assert_equal(got[key], want[key], err_msg=key)  # NaN == NaN when empty
    for key in ("cosine", "worst_row_cosine"):
        assert abs(got[key] - want[key]) <= COS_TOL, key


# --------------------------------------------------------------------------
# StageDumper
# --------------------------------------------------------------------------


def test_dumper_saves_once_per_key(tmp_path):
    d = dump.StageDumper(str(tmp_path / "run"))
    d("x", np.arange(4, dtype=np.int8))
    d("x", np.zeros(4, np.int8))  # the first value stays
    again = dump.StageDumper(str(tmp_path / "run"))
    again("x", np.ones(4, np.int8))  # another run: the file is there already
    np.testing.assert_array_equal(dump.load_dump(str(tmp_path / "run"), "x"),
                                  np.arange(4, dtype=np.int8))
    assert d.keys() == ["x"]
    assert not [f for f in os.listdir(tmp_path / "run") if f.endswith(".tmp")]
    off = dump.StageDumper(str(tmp_path / "off"), enabled=False)
    off("y", np.ones(2))
    assert not (tmp_path / "off").exists()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float8_e4m3fn])
def test_low_precision_stages_load_as_fp32(tmp_path, dtype):
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(dtype)
    d = dump.StageDumper(str(tmp_path))
    d("o", x)
    y = np.load(tmp_path / "o.npy")
    assert y.dtype == np.float32
    np.testing.assert_array_equal(y, x.float().numpy())


def _attention_stages(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 2, 256, 64)).astype(np.float32)
    k = (rng.standard_normal((1, 2, 256, 64)) + 0.5).astype(np.float32)
    v = rng.standard_normal((1, 2, 256, 64)).astype(np.float32)
    return q, k, v


def test_jax_and_port_dumps_compare_both_ways(tmp_path):
    q, k, v = _attention_stages()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jd = jdump.StageDumper(jdir)
    kc, _ = jquant.sub_mean(jnp.asarray(k))
    jd("k_int8", jquant.quant_int8_block_scales(kc, group=K_GROUP)[0])
    jd("o", jcore._sageattn_hnd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None, None, None, None,
        impl="xla", chunk_k=K_GROUP, qk_quant_gran="auto", pv_dtype="bf16", smooth_k=True,
        smooth_v=False, return_lse=False, is_causal=False, sm_scale=None, block_q=128,
        block_k=128))
    td = dump.StageDumper(tdir)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    td("k_int8", quant_cuda.quant_k_fused_mean(kt, group=K_GROUP)[0])
    td("o", sageattn(qt, kt, vt))
    assert np.load(os.path.join(tdir, "k_int8.npy")).dtype == np.int8
    assert np.load(os.path.join(tdir, "o.npy")).dtype == np.float32
    for reports in (td.compare_against(jdir), jd.compare_against(tdir)):
        assert [r["name"] for r in reports] == ["k_int8", "o"]
        for r in reports:
            assert r["cosine"] >= 0.9999, r
    dump.write_report(td.compare_against(jdir), str(tmp_path / "report.json"))
    back = json.loads((tmp_path / "report.json").read_text())
    assert [r["name"] for r in back] == ["k_int8", "o"]


# --------------------------------------------------------------------------
# StageTimer and trace
# --------------------------------------------------------------------------


def test_stage_timer_report_matches_jax():
    times = {"quant": 0.0123, "attention": 0.25, "merge": 1e-5}
    t, jt = profiling.StageTimer(), jprofiling.StageTimer()
    t.times, jt.times = dict(times), dict(times)
    assert t.report() == jt.report()


def test_stage_timer_accumulates_per_name():
    t = profiling.StageTimer()
    for _ in range(3):
        with t("matmul") as hold:
            hold.append(torch.randn(64, 64) @ torch.randn(64, 64))
    with t("empty"):
        pass
    assert set(t.times) == {"matmul", "empty"}
    assert t.times["matmul"] > 0.0 and t.times["empty"] >= 0.0
    assert "matmul" in t.report()


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as path:
        torch.randn(128, 128) @ torch.randn(128, 128)
    assert os.path.dirname(path) == str(tmp_path / "prof") and os.path.getsize(path) > 0
    events = json.loads(open(path).read())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_refuses_a_perfetto_link(tmp_path):
    with pytest.raises(ValueError, match="network"):
        with profiling.trace(str(tmp_path), create_perfetto_link=True):
            pass
