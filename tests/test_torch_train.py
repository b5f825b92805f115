"""The training slice as a whole: the port's rectified-flow loss, gradients
and AdamW step against the JAX package's, on the CPU, with the same weights.

The JAX side is the flax VideoDiT of ``examples/train_dit.py`` with a
test-side attention backend: a ``jax.custom_vjp`` whose forward is
``core._sageattn_hnd(impl="xla", chunk_k=128)`` and whose backward is the
fused ``quantized_attention_vjp(interpret=True)`` fed that forward's o,
LSE and K codes (``core._entry`` and the JAX ``sageattn`` raise at this
revision).  The model is tiny (depth 2, hidden 256, 4 x 64 heads) with a
sequence of 64 text + 2 x 8 x 12 video tokens = 256, a multiple of 128, so
the JAX fused backward takes it.  The weights are carried across with
``params_from_jax``, and (t, eps) are numpy draws fed to both.

Tolerances: the loss within 1e-5 relative in fp32 and 1e-2 in bf16
compute; every parameter gradient cosine >= 0.999 (the frameworks round
bf16 activations at different places and sum in other orders), except the
key norm's bias, whose exact gradient is 0.  AdamW is
held to optax ``adamw`` on the same parameters and the same numpy
gradients, so that Adam's first step, close to lr * sign(g), does not turn
gradient round-off into differences of 2 lr: within 1e-6.

Checkpoint and resume (``train.save_checkpoint`` / ``restore_latest``,
``examples/train_dit.py``'s ``--ckpt_dir`` / ``--ckpt_every``) on the
port alone: a resumed run's losses and parameters equal an uninterrupted
one's bit for bit; only the two newest checkpoints stay.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu import models as jmodels
from sageattention_tpu import quant as jquant
from sageattention_tpu.models.attention import register_backend as j_register
from sageattention_tpu.models.configs import MODEL_CONFIGS as J_CONFIGS
from sageattention_tpu.ops import attention_bwd_pallas
from sageattention_tpu_torch import models, train
from sageattention_tpu_torch.core import K_GROUP
from sageattention_tpu_torch.models.convert import params_from_jax
from sageattention_tpu_torch.utils.compare import cosine_similarity


@functools.lru_cache(maxsize=None)
def _jax_sage_vjp(is_causal, sm_scale):
    @jax.custom_vjp
    def f(q, k, v):
        return fwd(q, k, v)[0]

    def fwd(q, k, v):
        o, lse = jcore._sageattn_hnd(
            q, k, v, None, None, None, None, None, None,
            impl="xla", chunk_k=K_GROUP, qk_quant_gran="auto", pv_dtype="bf16",
            smooth_k=True, smooth_v=False, return_lse=True, is_causal=is_causal,
            sm_scale=sm_scale, block_q=128, block_k=128,
        )
        kf = k.astype(jnp.float32)
        km = jnp.mean(kf, axis=-2)
        k_i8, k_scale = jquant.quant_int8_block_scales(kf - km[..., None, :], group=K_GROUP)
        return o, (q, k, v, o, lse, k_i8, k_scale, km)

    def bwd(res, do):
        q, k, v, o, lse, k_i8, k_scale, km = res
        return attention_bwd_pallas.quantized_attention_vjp(
            q, k, v, do, is_causal=is_causal, sm_scale=sm_scale, o=o, lse_nat=lse,
            fwd_res={"k_i8": k_i8, "k_scale": k_scale, "km": km}, interpret=True,
        )

    f.defvjp(fwd, bwd)
    return f


def _xla_sage_trainable(q, k, v, *, is_causal, sm_scale, **kw):
    return _jax_sage_vjp(is_causal, sm_scale)(q, k, v)


def _tiny(cfgs):
    return cfgs["cogvideox-2b"].scaled(
        depth=2, latent_frames=2, latent_height=16, latent_width=24,
        text_len=64, hidden=256, heads=4, head_dim=64,
    )


@pytest.fixture(scope="module")
def jax_backend():
    j_register("torch_port_xla_sage_trainable", _xla_sage_trainable)
    prev = jmodels.get_attention_backend()
    jmodels.set_attention_backend("torch_port_xla_sage_trainable")
    yield
    jmodels.set_attention_backend(prev)


def _batch():
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((1, 2, 16, 24, 16)).astype(np.float32)
    txt = rng.standard_normal((1, 64, 512)).astype(np.float32)
    t = rng.uniform(size=(1,)).astype(np.float32)
    eps = rng.standard_normal(x0.shape).astype(np.float32)
    return x0, txt, t, eps


def _jax_loss_fn(model, jdt):
    """``train_dit.py`` ``loss_fn`` with t and eps passed in."""

    def loss_fn(params, x0, txt, t, eps):
        x0 = x0.astype(jdt)
        tb = t[:, None, None, None, None]
        x_t = ((1 - tb) * x0.astype(jnp.float32) + tb * eps).astype(x0.dtype)
        pred = model.apply(params, x_t, txt.astype(jdt), (t * 1000).astype(jnp.int32))
        target = eps - x0.astype(jnp.float32)
        return jnp.mean((pred.astype(jnp.float32) - target) ** 2)

    return loss_fn


def _jax_params(jdt):
    cfg = _tiny(J_CONFIGS)
    assert cfg.seq_len == 256
    jm = jmodels.VideoDiT(cfg, dtype=jdt)
    x0, txt, t, _ = _batch()
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x0, jdt), jnp.asarray(txt, jdt),
                     (t * 1000).astype(np.int32))
    return jm, params


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(jax_backend, dtype_name):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    jm, params = _jax_params(jdt)
    x0, txt, t, eps = _batch()
    loss_j, grads_j = jax.value_and_grad(_jax_loss_fn(jm, jdt))(
        params, jnp.asarray(x0), jnp.asarray(txt), jnp.asarray(t), jnp.asarray(eps))

    tr = train.load_trainer(_tiny(models.MODEL_CONFIGS), device="cpu", dtype=tdt,
                            state_dict=params_from_jax(jax.tree.map(np.asarray, params)))
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    models.set_attention_backend("sage")
    loss_t = train.flow_loss(tr.model, torch.from_numpy(x0).to(tdt),
                             torch.from_numpy(txt).to(tdt), torch.from_numpy(t),
                             torch.from_numpy(eps))
    loss_t.backward()

    rel = 1e-5 if dtype_name == "float32" else 1e-2
    assert abs(loss_t.item() - float(loss_j)) <= rel * abs(float(loss_j))
    want = params_from_jax(jax.tree.map(lambda g: np.asarray(g, np.float32), grads_j))
    got = dict(tr.model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        assert got[name].grad is not None, name
        if name.endswith("k_norm.bias"):
            # exactly 0 in exact arithmetic: a bias on every key shifts each
            # row of logits by a constant, which softmax ignores; both sides
            # give round-off, held to be negligible beside the scale's gradient
            ref = np.linalg.norm(want[name.replace("bias", "weight")])
            assert max(np.linalg.norm(g), got[name].grad.norm().item()) <= 1e-2 * ref, name
            continue
        cos = cosine_similarity(got[name].grad, g)
        assert cos >= 0.999, (name, cos)


def test_adamw_matches_optax():
    _, params = _jax_params(jnp.float32)
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32)
                          * rng.choice([1e-3, 1.0]), params) for _ in range(2)]
    tx = optax.adamw(1e-4, weight_decay=0.01)
    p_j, state = params, tx.init(params)
    for g in grads:
        upd, state = tx.update(g, state, p_j)
        p_j = optax.apply_updates(p_j, upd)

    tr = train.load_trainer(_tiny(models.MODEL_CONFIGS), device="cpu", dtype=torch.float32,
                            state_dict=params_from_jax(jax.tree.map(np.asarray, params)))
    named = dict(tr.model.named_parameters())
    for g in grads:
        for name, gt in params_from_jax(g).items():
            named[name].grad = gt
        tr.opt.step()
    want = params_from_jax(jax.tree.map(np.asarray, p_j))
    start = params_from_jax(jax.tree.map(np.asarray, params))
    for name, p in want.items():
        moved = np.abs(p.numpy() - start[name].numpy()).max()
        assert moved > 1e-5, name  # two steps of about lr each
        np.testing.assert_allclose(named[name].detach().numpy(), p.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_train_steps_on_cpu():
    cfg = _tiny(models.MODEL_CONFIGS)
    x0, txt, _, _ = _batch()
    x0, txt = torch.from_numpy(x0), torch.from_numpy(txt)
    models.set_attention_backend("sage")
    runs = {}
    for fixed in (True, False):
        tr = train.load_trainer(cfg, device="cpu", dtype=torch.float32, seed=0)
        out = train.train(tr, x0, txt, steps=3, seed=1, fixed_noise=fixed)
        assert out["device"] == "cpu" and len(out["step_ms"]) == 3
        assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
        runs[fixed] = out["losses"]
    # one (t, eps) for all steps: the loss on the fixed batch falls
    assert runs[True][2] < runs[True][1] < runs[True][0]
    # a new draw every step after the first, from the same generator
    assert runs[False][0] == runs[True][0] and runs[False][1:] != runs[True][1:]


def _trainer(seed: int = 0):
    return train.load_trainer(_tiny(models.MODEL_CONFIGS), device="cpu", dtype=torch.float32,
                              seed=seed)


def test_resume_from_checkpoint_is_bit_exact(tmp_path):
    """4 uninterrupted steps equal 2 steps, ``save_checkpoint``, a new
    trainer (other weights), ``restore_latest`` and 2 more: the same losses
    and parameters bit for bit (each step draws its (t, eps) from the seed
    and the step, so the resumed run draws what the whole one did)."""
    x0, txt, _, _ = (torch.from_numpy(a) for a in _batch())
    models.set_attention_backend("sage")
    whole = _trainer()
    full = train.train(whole, x0, txt, 4, seed=1)
    first = _trainer()
    head = train.train(first, x0, txt, 2, seed=1)
    train.save_checkpoint(first, tmp_path, 1)
    resumed = _trainer(seed=9)
    start = train.restore_latest(resumed, tmp_path)
    assert start == 2
    tail = train.train(resumed, x0, txt, 2, seed=1, start=start)
    assert head["losses"] + tail["losses"] == full["losses"]
    for (name, p), (_, p_r) in zip(whole.model.named_parameters(),
                                   resumed.model.named_parameters()):
        assert torch.equal(p, p_r), name
    for st, st_r in zip(whole.opt.state.values(), resumed.opt.state.values()):
        assert all(torch.equal(st[k], st_r[k]) for k in st)


def test_checkpoints_keep_the_two_newest(tmp_path):
    """``train(ckpt_dir=, ckpt_every=)`` saves after every ``ckpt_every``-th
    step and the last, and only the two newest stay (orbax's
    ``max_to_keep=2``); ``restore_latest`` goes on after the newest."""
    x0, txt, _, _ = (torch.from_numpy(a) for a in _batch())
    models.set_attention_backend("sage")
    tr = _trainer()
    train.train(tr, x0, txt, 5, seed=1, ckpt_dir=tmp_path, ckpt_every=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003.pt", "step_00000004.pt"]
    assert train.restore_latest(_trainer(), tmp_path) == 5


def test_restore_from_an_empty_directory_starts_at_zero(tmp_path):
    tr = _trainer()
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    assert train.restore_latest(tr, tmp_path) == 0
    assert train.restore_latest(tr, tmp_path / "missing") == 0
    assert all(torch.equal(p, before[n]) for n, p in tr.model.named_parameters())


def test_load_trainer_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: load_trainer() builds on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.load_trainer(_tiny(models.MODEL_CONFIGS))
