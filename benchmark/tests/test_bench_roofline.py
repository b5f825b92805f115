"""The counting rules of benchmark/roofline.py on their check values, and
the step counts mfu reads for each cell."""

import pytest

from benchmark import cells, roofline


@pytest.mark.parametrize("shape,pv,want", [
    ((1, 30, 17776, 17776, 64), "bf16", 1.840),     # the CogVideoX-2B layer
    ((1, 24, 119056, 119056, 128), "bf16", 132.06),  # HunyuanVideo's joint layer
    ((1, 24, 119056, 119056, 128), "e4m3", 88.01),
])
def test_forward_bound(shape, pv, want):
    b = roofline.attention_forward(*shape, pv=pv)
    assert b.by == "operations" and b.ms == pytest.approx(want, abs=5e-3)


def test_forward_bytes_count_each_operand_once():
    b, h, s, d = 1, 30, 17776, 64
    nbytes = b * h * s * d * (2 + 1 + 2 + 2)  # q bf16, K codes, V bf16, o bf16
    assert roofline.attention_forward(b, h, s, s, d).bytes_ms == pytest.approx(
        nbytes / 3.35e12 * 1e3)


def test_backward_bound_is_five_products():
    b = roofline.attention_backward(1, 30, 17776, 17776, 64)
    assert b.ms == pytest.approx(0.613 + 4 * 1.227, abs=2e-3)
    assert b.ms == pytest.approx(5.521, abs=1e-3)


def _step(workload):
    cell = cells.load_cell(workload)
    m, g, ref = cell.model, cell.geometry, cell.reference()
    lin = ref.linears(m, g.batch, g.text_tokens, g.video_tokens)
    att = ref.attentions(m, g.batch, g.text_tokens, g.video_tokens)
    return cell, lin, att


def test_cogvideox_counts_by_hand():
    cell, lin, att = _step("cogvideox-2b.t2v-cfg")
    tok, hid, ff = 2 * 17776, 1920, 7680
    block = 2 * tok * (hid * 3 * hid + hid * hid + 2 * hid * ff) + 2 * 2 * hid * 6 * hid
    trunk = 2 * (2 * 17550 * 64 * hid + 2 * 226 * 512 * hid + 2 * 480 * hid + 2 * hid * hid
                 + 2 * 17550 * hid * 64)
    assert sum(2 * t * i * o for t, i, o in lin) == 30 * block + trunk
    assert att == [(2, 30, 17776, 17776, 64)] * 30
    ms = roofline.step_matrix_ms(lin, att, "bf16", training=False)
    assert ms == pytest.approx((30 * block + trunk) / 989e12 * 1e3 + 60 * 1.840, rel=1e-3)


@pytest.mark.parametrize("workload,training,want_ms", [
    ("cogvideox-2b.t2v-cfg", False, 205.83),
    ("cogvideox-2b.finetune", True, 230.52),  # depth 19
])
def test_step_matrix_time(workload, training, want_ms):
    cell, lin, att = _step(workload)
    assert cell.job == ("finetune" if training else "denoise")
    ms = roofline.step_matrix_ms(lin, att, roofline.pv_type(cell.traffic["attention"]),
                                 training=training)
    assert ms == pytest.approx(want_ms, abs=0.01)


@pytest.mark.parametrize("backend,pv", [("sage", "bf16"), ("sage_fp8", "e4m3")])
def test_pv_type_follows_the_backend(backend, pv):
    assert roofline.pv_type(backend) == pv


def test_an_unknown_backend_has_no_pv_type():
    with pytest.raises(ValueError, match="sage_int4"):
        roofline.pv_type("sage_int4")


def test_training_counts_the_backward():
    _, lin, att = _step("cogvideox-2b.finetune")
    fwd = roofline.step_matrix_ms(lin, att, "bf16", training=False)
    lin_ms = sum(roofline.linear_ms(*x) for x in lin)
    bwd = sum(roofline.attention_backward(*a).ops_ms for a in att)
    assert roofline.step_matrix_ms(lin, att, "bf16", training=True) == pytest.approx(
        fwd + 2 * lin_ms + bwd)
