"""benchmark/profile.py's grouping and reduction, and the per-layer
readers, on synthetic event lists."""

from types import SimpleNamespace

import pytest

from benchmark import cells, profile, roofline
from benchmark.profile import Event


@pytest.mark.parametrize("name,group", [
    ("void sage_attn_fwd_sm90_kernel<64, 128, true>(Params)", "sage_attn_fwd"),
    ("sage_attn_bwd_dq_tma_kernel", "sage_attn_bwd"),
    ("sage_attn_bwd_dkv_tma_kernel", "sage_attn_bwd"),
    ("void quant_k_regs_kernel<64>(...)", "quant"),
    ("channel_mean_kernel", "quant"),
    ("quant_rows_kernel", "quant"),
    ("void widen_v_kernel<1>(...)", "quant"),   # the V-code widening: a quantizer
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "gemm"),
    ("cutlass_80_tensorop_s16816gemm", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
    ("Memcpy DtoD (Device -> Device)", "other"),
])
def test_group_of(name, group):
    assert profile.group_of(name) == group


def _events():
    return [
        Event(profile.WINDOW, False, 100.0, 1100.0),
        Event("aten::linear", False, 90.0, 400.0),
        Event("cudaEventSynchronize", False, 700.0, 1000.0),
        Event("before the window", True, 0.0, 150.0),        # clipped to 100..150
        Event("sage_attn_fwd_sm90_kernel", True, 150.0, 450.0),
        Event("widen_v_kernel", True, 400.0, 500.0),         # overlaps the one before
        Event("nvjet_gemm", True, 600.0, 700.0),
        Event("elementwise", True, 1050.0, 1200.0),          # clipped to 1050..1100
    ]


def test_reduce_clips_to_the_window_and_unions_the_spans():
    tr = profile.reduce(_events())
    assert tr.window_s == pytest.approx(1000e-6)
    # busy: 100..500, 600..700, 1050..1100
    assert tr.busy_s == pytest.approx(550e-6)
    assert tr.idle_share == pytest.approx(0.45)
    assert tr.group_s["sage_attn_fwd"] == pytest.approx(300e-6)
    assert tr.group_s["quant"] == pytest.approx(100e-6)
    assert tr.group_s["gemm"] == pytest.approx(100e-6)
    assert tr.group_s["other"] == pytest.approx(50e-6 + 50e-6)
    assert tr.device_ops()[0] == ["sage_attn_fwd_sm90_kernel", pytest.approx(300e-6)]


def test_idle_gaps_are_named_by_the_host_op_around_them():
    tr = profile.reduce(_events())
    gaps = dict(tr.idle_gaps)
    # 500..600 under no op, 700..1050 inside cudaEventSynchronize (mid 875)
    assert gaps["cudaEventSynchronize"] == pytest.approx(350e-6)
    assert gaps["host: no op open"] == pytest.approx(100e-6)


def test_reduce_wants_one_window():
    with pytest.raises(ValueError):
        profile.reduce(_events()[1:])


def _ctx(workload, group_s, window_s=1.0, steps=2, busy_s=0.9):
    cell = cells.load_cell(workload)
    m, g, ref = cell.model, cell.geometry, cell.reference()
    tr = profile.Trace(window_s, busy_s, dict(dict.fromkeys(profile.GROUPS, 0.0), **group_s),
                       {}, [])
    return SimpleNamespace(trace=tr, steps=steps, training=cell.job == "finetune",
                           pv=roofline.pv_type(cell.traffic["attention"]),
                           linears=ref.linears(m, g.batch, g.text_tokens, g.video_tokens),
                           attentions=ref.attentions(m, g.batch, g.text_tokens, g.video_tokens))


def test_attention_rooflines():
    ctx = _ctx("cogvideox-2b.t2v-cfg", {"sage_attn_fwd": 2 * 30 * 0.0109})
    share = cells.metric_reader("attn_fwd_roofline.denoise")(ctx)
    want = roofline.attention_forward(2, 30, 17776, 17776, 64).ms
    assert want == pytest.approx(2 * 1.840, abs=1e-3)
    assert share == pytest.approx(100 * want / 10.9, rel=1e-9)
    depth = cells.load_cell("cogvideox-2b.finetune").model["depth"]
    ctx = _ctx("cogvideox-2b.finetune", {"sage_attn_bwd": 2 * depth * 0.0221})
    share = cells.metric_reader("attn_bwd_roofline.train")(ctx)
    assert share == pytest.approx(100 * 5.52066 / 22.1, rel=1e-5)


def test_readers_find_nothing_where_nothing_ran():
    ctx = _ctx("cogvideox-2b.t2v-cfg", {})
    for name in ("attn_fwd_roofline.denoise", "quant_ms.denoise", "gemm_ms.denoise",
                 "other_ms.denoise"):
        assert cells.metric_reader(name)(ctx) is None


def test_time_and_share_readers():
    ctx = _ctx("cogvideox-2b.t2v-cfg", {"quant": 0.01, "gemm": 0.2, "other": 0.6},
               window_s=1.5, steps=2, busy_s=1.47)
    assert cells.metric_reader("quant_ms.denoise")(ctx) == pytest.approx(5.0)
    assert cells.metric_reader("gemm_ms.denoise")(ctx) == pytest.approx(100.0)
    assert cells.metric_reader("other_ms.denoise")(ctx) == pytest.approx(300.0)
    assert cells.metric_reader("device_idle.denoise")(ctx) == pytest.approx(2.0)
    want = roofline.step_matrix_ms(ctx.linears, ctx.attentions, "bf16", False) * 2 / 1500
    assert cells.metric_reader("mfu.denoise")(ctx) == pytest.approx(100 * want)
