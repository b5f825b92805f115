"""The H100 rate probe (``sageattention_tpu_torch/utils/probe_mma.py``, the
port of ``tools/probe_mxu.py``) on the CPU: its plain chains against the
same chains written in jnp from ``probe_mxu``'s step rule
(``_probe_kernel``'s ``step``, ``probe_mxu.py:43-56``) with a zeroed
accumulator, from the same numpy inputs, on the JAX probe's own bodies
(``dot_nt`` for Q.K^T, ``dot_nn`` for P.V, the VPU passes): int8 products
to int32 bit-exact, the float chains within 1e-5 of the largest entry
(both fp32 on the CPU, summed in other orders).  e4m3 has no JAX probe
row, and its step rule would cast the accumulator to e4m3 (NaN past 448)
to multiply it by 1e-30 (0 in e4m3): its chain is held to the jnp chain
without the perturbation, which is what the rule adds there.  Then the
operation count a rep (``probe()``'s ``2 * M * N * d``), the 105 % guard,
the SASS parser, and the entry point's refusal without a card.  The
kernels themselves run only on the card (``chip_smoke.py`` phase 9, or
``python -m sageattention_tpu_torch.utils.probe_mma``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu_torch.utils import probe_mma

M = 64


def _jnp_chain(body, x, y, reps, acc_dtype, out_shape, perturb=True):
    """probe_mxu's step rule with a zeroed accumulator, in jnp."""
    acc = jnp.zeros(out_shape, acc_dtype)
    for _ in range(reps):
        s = acc[0:x.shape[0], 0:1]
        if not perturb:
            xr = x
        elif x.dtype == jnp.int8:
            xr = (x.astype(jnp.int32) + (s.astype(jnp.int32) & 1)).astype(jnp.int8)
        else:
            xr = x + s.astype(x.dtype) * 1e-30
        acc = acc + body(xr, y).astype(acc_dtype)
    return acc


def _dot(dims):
    def dot(a, b):
        return jax.lax.dot_general(
            a, b, (dims, ((), ())),
            preferred_element_type=jnp.int32 if a.dtype == jnp.int8 else jnp.float32)
    return dot


DOT_NT, DOT_NN = _dot(((1,), (1,))), _dot(((1,), (0,)))


def _codes(rng, shape):
    return rng.integers(-7, 7, shape).astype(np.int8)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("d", [64, 128, 256])
def test_qk_int8_chain_matches_jax_step_rule(d):
    rng = np.random.default_rng(d)
    x, y = _codes(rng, (M, d)), _codes(rng, (M, d))
    want = _jnp_chain(DOT_NT, jnp.asarray(x), jnp.asarray(y), 6, jnp.int32, (M, M))
    got = probe_mma.plain_chain(torch.from_numpy(x), torch.from_numpy(y), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) % 2).any()  # the parity perturbation took part


@pytest.mark.parametrize("dv", [64, 128, 256])
@pytest.mark.parametrize("op", ["s8", "bf16", "e4m3"])
def test_pv_chain_matches_jax_step_rule(op, dv):
    """P [M, 64] . V [64, dv]: the port takes V as its transpose [dv, 64]."""
    rng = np.random.default_rng(dv + len(op))
    if op == "s8":
        p, v = _codes(rng, (M, 64)), _codes(rng, (64, dv))
        pt, vt = torch.from_numpy(p), torch.from_numpy(np.ascontiguousarray(v.T))
        jp, jv = jnp.asarray(p), jnp.asarray(v)
        acc = jnp.int32
    else:
        p = rng.standard_normal((M, 64)).astype(np.float32)
        v = rng.standard_normal((64, dv)).astype(np.float32)
        dt = probe_mma.DTYPES[op]
        pt, vt = torch.from_numpy(p).to(dt), torch.from_numpy(np.ascontiguousarray(v.T)).to(dt)
        jt = jnp.bfloat16 if op == "bf16" else jnp.float8_e4m3fn
        # the same rounded values on both sides
        jp = jnp.asarray(pt.float().numpy()).astype(jt)
        jv = jnp.asarray(vt.float().numpy().T).astype(jt)
        acc = jnp.float32
    want = _jnp_chain(DOT_NN, jp, jv, 5, acc, (M, dv), perturb=op != "e4m3")
    got = probe_mma.plain_chain(pt, vt, 5)
    if op == "s8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert _rel(got.numpy(), want) <= 1e-5


JAX_BODIES = {
    "ex2": lambda a, b: jnp.exp2(a),
    "exp2f": lambda a, b: jnp.exp2(a),
    "rowmax": lambda a, b: jnp.broadcast_to(jnp.max(a, axis=1)[:, None], a.shape) + a * 1e-30,
    "rowsum": lambda a, b: jnp.broadcast_to(jnp.sum(a, axis=1)[:, None], a.shape) + a * 1e-30,
    "cast_bf16": lambda a, b: a.astype(jnp.bfloat16).astype(jnp.float32),
    "quant_int8": lambda a, b: (a * 127.0 + 0.5).astype(jnp.int8).astype(jnp.float32),
}


@pytest.mark.parametrize("body", probe_mma.BODIES)
def test_pass_chains_match_jax_step_rule(body):
    rng = np.random.default_rng(len(body))
    if body == "quant_int8":
        x = rng.random((M, probe_mma.EW)).astype(np.float32)
    else:
        x = rng.standard_normal((M, probe_mma.EW)).astype(np.float32)
    want = _jnp_chain(JAX_BODIES[body], jnp.asarray(x), None, 7, jnp.float32, x.shape)
    got = probe_mma.plain_elem_chain(body, torch.from_numpy(x), 7)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("row", [r for r in probe_mma.ROWS if r.kind != "hbm"],
                         ids=lambda r: r.name)
def test_chain_on_cpu_is_the_plain_chain(row):
    gen = torch.Generator().manual_seed(3)
    x, y = probe_mma.inputs(row, M, gen, device="cpu")
    got = probe_mma.chain(row, x, y, reps=2)
    want = (probe_mma.plain_elem_chain(row.op, x, 2) if row.kind == "elem"
            else probe_mma.plain_chain(x, y, 2))
    assert torch.equal(got, want)
    assert got.shape == ((M, row.n) if row.kind != "elem" else x.shape)


def test_memory_rows_on_cpu():
    x = torch.arange(-8, 8, dtype=torch.int32)
    read, copy = (r for r in probe_mma.ROWS if r.kind == "hbm")
    assert probe_mma.chain(read, x, reps=3).item() == int(x.sum()) * 3
    assert torch.equal(probe_mma.chain(copy, x), x)


def test_operation_counts_are_the_jax_probes():
    """A product rep is probe()'s 2 * M * N * d; a pass rep M x 128 elements."""
    for row in probe_mma.ROWS:
        if row.kind in ("sync", "wgmma"):
            d = row.k
            assert probe_mma.ops_per_rep(row, 4096) == 2 * 4096 * row.n * d, row.name
            assert row.k == (row.ks * 16 if row.op == "bf16" else row.ks * 32)
        elif row.kind == "elem":
            assert probe_mma.ops_per_rep(row, 4096) == 4096 * probe_mma.EW
    qk = [r for r in probe_mma.ROWS if r.name.startswith("qk")]
    assert sorted({r.k for r in qk}) == [64, 128, 256]
    pv = [r for r in probe_mma.ROWS if r.name.startswith("pv")]
    assert sorted({r.n for r in pv}) == [64, 128, 256] and {r.k for r in pv} == {16, 32, 64}


@pytest.mark.parametrize("share,ok", [(0.5, True), (1.049, True), (1.051, False), (33.0, False)])
def test_the_105_percent_guard(share, ok):
    if ok:
        assert probe_mma.check_rate("r", share * 2e12, 2e12) == pytest.approx(share)
    else:
        with pytest.raises(RuntimeError, match="folded"):
            probe_mma.check_rate("r", share * 2e12, 2e12)


@pytest.mark.parametrize("kind", ["sync", "wgmma", "elem", "hbm"])
def test_peaks_scale_with_the_sm_clock(kind):
    """A unit's peak is its width a clock and an SM times the SMs and the
    clock; at the data sheet's 132 SMs and 1,830 MHz the tensor cores'
    give its 1,979 and 989 T/s to 0.1 %, and memory keeps its 3.35 TB/s."""
    rows = [r for r in probe_mma.ROWS if r.kind == kind]
    assert rows
    for row in rows:
        sheet = probe_mma.datasheet_peak(row, 132, 1.83e9)
        at_boost = probe_mma.peak_of(row, 132, 1.83e9)
        assert at_boost == pytest.approx(sheet, rel=1e-3), row.name
        faster = probe_mma.peak_of(row, 132, 1.98e9)
        if kind == "hbm":
            assert faster == sheet == probe_mma.PEAK["hbm"]
        else:
            assert faster == pytest.approx(at_boost * 1.98 / 1.83), row.name
        if kind in ("sync", "wgmma"):
            assert sheet == probe_mma.PEAK[row.op]
            assert probe_mma.datasheet_peak(row, 132, 1.98e9) == sheet


def test_sass_parser_counts_each_kernels_instructions():
    text = """
        Function : _ZN12_GLOBAL__N_117probe_sync_kernelILi0ELi8ELi2EEEvPKhS2_Pvi
        /*0100*/   IMMA.16832.S8.S8 R4, R8.ROW, R12.COL, R4 ;
        /*0110*/   IMMA.16832.S8.S8 R4, R9.ROW, R13.COL, R4 ;
        /*0120*/   IADD3 R1, R1, 0x1, RZ ;
        Function : _ZN12_GLOBAL__N_118probe_wgmma_kernelILi1ELi128ELi4EEEvPKhS2_Pvi
        /*0200*/   HGMMA.64x128x16.F32.BF16 R24, R4, gdesc[UR4], R24 ;
        Function : _ZN12_GLOBAL__N_117probe_elem_kernelILi0EEEvPKfPfi
        /*0300*/   MUFU.EX2 R0, R1 ;
    """
    got = probe_mma.parse_sass(text)
    assert got == {("sync", "s8", 64, 2): {"IMMA": 2}, ("wgmma", "bf16", 128, 4): {"HGMMA": 1}}
    row = next(r for r in probe_mma.ROWS if r.name == "qk s8 d64 mma.sync")
    assert probe_mma.expected_mma(row) == 16
    row = next(r for r in probe_mma.ROWS if r.name == "pv e4m3 dv128 mma.sync")
    assert probe_mma.expected_mma(row) == 32  # two f16 HMMA a fp8 mma.sync on sm_90
    row = next(r for r in probe_mma.ROWS if r.name == "qk s8 d256 wgmma")
    assert probe_mma.expected_mma(row) == 8


def test_entry_point_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no"):
        probe_mma.run()
    with pytest.raises(RuntimeError, match="no"):
        probe_mma.main([])
    assert probe_mma.main(["--bad"]) == 2
    with pytest.raises(ValueError, match="meta"):
        probe_mma.chain(probe_mma.ROWS[0], torch.empty(64, 64, dtype=torch.int8, device="meta"),
                        torch.empty(64, 64, dtype=torch.int8, device="meta"))
