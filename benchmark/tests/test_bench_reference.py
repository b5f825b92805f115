"""The plain reference against the port at a tiny size on the CPU, and
the harness driven end to end there (the look for a card skipped) with the
timed path sound and then broken underneath: each fault a cell can have
turns ``correct`` false."""

import pytest
import torch

from bench_tiny import tiny_cell
from benchmark import cells, run, weights
from benchmark.jobs.common import dims, port_model
from benchmark.reference import nn as ref_nn

SEED = 2**31 + 977


@pytest.mark.parametrize("workload", ["cogvideox-2b.t2v-cfg", "cogvideox-2b.finetune"])
def test_reference_forward_is_the_ports_model(workload):
    """The port in fp32 with exact attention computes the reference's
    equations: same weights, same inputs, agreement to fp32 round-off."""
    from sageattention_tpu_torch import models, serve

    cell = tiny_cell(workload)
    m, ref = dims(cell), cell.reference()
    cfg, cls = port_model(cell)
    sd = weights.make(ref.param_shapes(m), SEED, "cpu")
    model = serve.load_model(cfg, device="cpu", dtype=torch.float32, state_dict=sd,
                             model_cls=cls, processor=models.SageAttnProcessor("reference"))
    gen = torch.Generator().manual_seed(5)
    g = cell.geometry
    lat = torch.randn(g.batch, g.latent_frames, g.latent_height, g.latent_width, 16, generator=gen)
    txt = torch.randn(g.batch, g.text_tokens, 512, generator=gen)
    t = torch.full((g.batch,), 633)
    with torch.no_grad():
        want = ref.forward(sd, lat, txt, t, m)
        got = model(lat, txt, t)
    assert ((got - want).norm() / want.norm()).item() < 1e-5


def test_reference_backward_matches_autograd_of_exact_attention():
    from benchmark.reference.attention import attention

    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 3, 40, 16, generator=gen, dtype=torch.float64) for _ in range(3))
    do = torch.randn(2, 3, 40, 16, generator=gen, dtype=torch.float64)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.backward(attention(*leaves, grad=True), do)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    s = plain[0] @ plain[1].transpose(-1, -2) / 4.0
    torch.autograd.backward(torch.softmax(s, -1) @ plain[2], do)
    for a, b in zip(leaves, plain):
        assert torch.allclose(a.grad, b.grad, atol=1e-10)


def _run(workload):
    return run.execute(tiny_cell(workload), SEED, steps=3, device="cpu")


@pytest.mark.parametrize("workload", [w["name"] for w in cells.load_benchmark()["workloads"]])
def test_a_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 3 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def _step_unchanged(model, lat, txt, t):
    return lat.clone()


def _half_batch(model, lat, txt, t):
    eps = model(lat[:1], txt[:1], t[:1])
    return torch.cat([lat[:1] - 0.02 * eps, lat[1:]])


def _altered(model, lat, txt, t):
    out = lat - 0.02 * model(lat, txt, t)
    out.view(-1)[7] += 1.0
    return out


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch, _altered],
                         ids=lambda f: f.__name__)
def test_denoise_faults_are_not_correct(fault, monkeypatch):
    from sageattention_tpu_torch import serve

    monkeypatch.setattr(serve, "denoise_step", torch.no_grad()(fault))
    assert _run("cogvideox-2b.t2v-cfg")["correct"] is False


def _no_update(trainer, x0, txt, t, eps, data=None):
    from sageattention_tpu_torch import train

    loss = train.flow_loss(trainer.model, x0, txt, t, eps)
    loss.backward()
    return loss.detach()


def _half_loss(model, x0, txt, t, eps):
    tb = t.float()[:, None, None, None, None]
    x_t = ((1 - tb) * x0.float() + tb * eps).to(x0.dtype)
    pred = model(x_t, txt, (t * 1000).to(torch.int32))
    err = (pred.float() - (eps - x0.float())) ** 2
    return err[:, : err.shape[1] // 2].mean()


def test_training_state_left_unchanged_is_not_correct(monkeypatch):
    from sageattention_tpu_torch import train

    monkeypatch.setattr(train, "train_step", _no_update)
    assert _run("cogvideox-2b.finetune")["correct"] is False


def test_training_on_half_the_clip_is_not_correct(monkeypatch):
    from sageattention_tpu_torch import train

    monkeypatch.setattr(train, "flow_loss", _half_loss)
    assert _run("cogvideox-2b.finetune")["correct"] is False


def test_a_fault_only_in_timed_steps_is_not_correct(monkeypatch):
    """The compared change covers the window's first steps: a step that
    goes wrong only after set-up's warm step is caught."""
    from sageattention_tpu_torch import train

    step, calls = train.train_step, []

    def after_warm_up(trainer, *args, **kw):
        calls.append(1)
        return step(trainer, *args, **kw) if len(calls) == 1 else _no_update(trainer, *args)

    monkeypatch.setattr(train, "train_step", after_warm_up)
    assert _run("cogvideox-2b.finetune")["correct"] is False


def test_reference_blocks_recomputed_give_the_same_gradients():
    cell = tiny_cell("cogvideox-2b.finetune")
    m, ref = dims(cell), cell.reference()
    p = {k: v.requires_grad_() for k, v in weights.make(ref.param_shapes(m), SEED, "cpu").items()}
    gen = torch.Generator().manual_seed(9)
    g = cell.geometry
    lat = torch.randn(1, g.latent_frames, g.latent_height, g.latent_width, 16, generator=gen)
    txt = torch.randn(1, g.text_tokens, 512, generator=gen)
    t = torch.full((1,), 411)
    grads = []
    for grad in (True, False):
        loss = ref.forward(p, lat, txt, t, m, grad=grad).square().mean()
        grads.append(torch.autograd.grad(loss, list(p.values())))
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)


def test_one_leafs_update_altered_is_not_correct(monkeypatch):
    from sageattention_tpu_torch import train

    step = train.train_step

    def altered(trainer, *args, **kw):
        loss = step(trainer, *args, **kw)
        with torch.no_grad():
            trainer.model.final_norm.weight.add_(1e-2)  # a hundred steps of lr in one
        return loss

    monkeypatch.setattr(train, "train_step", altered)
    assert _run("cogvideox-2b.finetune")["correct"] is False


def test_the_control_is_not_correct_at_a_tiny_size():
    """The control (the reference in fp8 in the program's place) reads
    several times the program's gap here too."""
    cell = tiny_cell("cogvideox-2b.t2v-cfg")
    job = cell.job_module().Job(cell, SEED, "cpu")
    job.setup()
    job.window(steps=3)
    job.release()
    got = job.check(control=True)
    assert got["control"]["start_rel_l2"] > 3 * got["program"]["start_rel_l2"]
    with ref_nn.fp32_matmuls():
        assert not torch.backends.cuda.matmul.allow_tf32
