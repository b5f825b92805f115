"""The slice as a whole: the port's VideoDiT and denoise step against the
JAX package's, on the CPU, with the same weights.

The JAX model runs at the tiny config of ``tests/test_models.py`` with
``PRNGKey(2)`` init; its attention goes through a test-side backend that
calls ``core._sageattn_hnd(impl="xla", chunk_k=G)`` (``core._entry``
raises at this revision).  The weights are carried across with
``params_from_jax`` and the port runs its own ``"sage"`` backend.

Tolerances: fp32 eps cosine >= 0.9999 and max-abs <= 1e-3 (the two
quantize the same activations, so the difference is fp32 round-off
carried through 2 blocks); bf16 eps cosine >= 0.999 (the frameworks
round bf16 activations at different places).  The "sage_fp8" backend is
held to the JAX model with fp8 V (``pv_dtype="fp8"``), and a
Wan2.1-shaped model runs the two-pass V quantizer on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu import models as jmodels
from sageattention_tpu.models.attention import register_backend as j_register
from sageattention_tpu.models.configs import MODEL_CONFIGS as J_CONFIGS
from sageattention_tpu_torch import models, serve
from sageattention_tpu_torch.core import K_GROUP
from sageattention_tpu_torch.models.convert import params_from_jax
from sageattention_tpu_torch.ops import quant_cuda
from sageattention_tpu_torch.utils.compare import cosine_similarity


def _xla_sage(q, k, v, *, is_causal, sm_scale, pv_dtype="bf16", **kw):
    return jcore._sageattn_hnd(
        q, k, v, None, None, None, None, None, None,
        impl="xla", chunk_k=K_GROUP, qk_quant_gran="auto", pv_dtype=pv_dtype,
        smooth_k=True, smooth_v=False, return_lse=False, is_causal=is_causal,
        sm_scale=sm_scale, block_q=128, block_k=128,
    )


def _xla_sage_fp8(q, k, v, *, is_causal, sm_scale, **kw):
    return _xla_sage(q, k, v, is_causal=is_causal, sm_scale=sm_scale, pv_dtype="fp8")


def _tiny(cfgs):
    return cfgs["cogvideox-2b"].scaled(
        depth=2, latent_frames=2, latent_height=16, latent_width=16,
        text_len=16, hidden=256, heads=4, head_dim=64,
    )


@pytest.fixture(scope="module")
def jax_backend():
    j_register("torch_port_xla_sage", _xla_sage)
    j_register("torch_port_xla_sage_fp8", _xla_sage_fp8)
    prev = jmodels.get_attention_backend()
    jmodels.set_attention_backend("torch_port_xla_sage")
    yield
    jmodels.set_attention_backend(prev)


def _inputs():
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 2, 16, 16, 16)).astype(np.float32)
    txt = rng.standard_normal((1, 16, 512)).astype(np.float32)
    return lat, txt, np.array([500], np.int32)


def _models(dtype_name):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    jm = jmodels.VideoDiT(_tiny(J_CONFIGS), dtype=jdt)
    lat, txt, t = _inputs()
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(lat, jdt), jnp.asarray(txt), t)
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    tm = serve.load_model(_tiny(models.MODEL_CONFIGS), device="cpu", dtype=tdt,
                          state_dict=sd)
    return jm, params, tm, jdt, tdt


def test_converted_state_dict_covers_every_parameter(jax_backend):
    jm = jmodels.VideoDiT(_tiny(J_CONFIGS), dtype=jnp.float32)
    lat, txt, t = _inputs()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(2), lat, txt, t)
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = params_from_jax(params)
    tm = models.VideoDiT(_tiny(models.MODEL_CONFIGS), dtype=torch.float32)
    want = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert len(sd) == 41


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_videodit_matches_jax(jax_backend, dtype_name):
    jm, params, tm, jdt, tdt = _models(dtype_name)
    lat, txt, t = _inputs()
    eps_j = np.asarray(jm.apply(params, jnp.asarray(lat, jdt), jnp.asarray(txt), t)
                       .astype(jnp.float32))
    models.set_attention_backend("sage")
    with torch.no_grad():
        eps_t = tm(torch.from_numpy(lat).to(tdt), torch.from_numpy(txt),
                   torch.from_numpy(t))
    assert eps_t.shape == eps_j.shape and eps_t.dtype == torch.float32
    if dtype_name == "float32":
        assert cosine_similarity(eps_t, eps_j) >= 0.9999
        np.testing.assert_allclose(eps_t.numpy(), eps_j, atol=1e-3)
    else:
        assert cosine_similarity(eps_t, eps_j) >= 0.999


def test_videodit_fp8_backend_matches_jax(jax_backend):
    """The "sage_fp8" backend (fp8 e4m3 V codes) against the JAX VideoDiT
    whose attention quantizes V the same way, fp32: both quantize the same
    activations to the same codes, so the tolerances of the bf16-V fp32
    comparison hold (cosine >= 0.9999, max-abs <= 1e-3)."""
    jm, params, tm, jdt, tdt = _models("float32")
    lat, txt, t = _inputs()
    jmodels.set_attention_backend("torch_port_xla_sage_fp8")
    try:
        eps_j = np.asarray(jm.apply(params, jnp.asarray(lat), jnp.asarray(txt), t))
    finally:
        jmodels.set_attention_backend("torch_port_xla_sage")
    models.set_attention_backend("sage_fp8")
    try:
        with torch.no_grad():
            eps_t = tm(torch.from_numpy(lat), torch.from_numpy(txt), torch.from_numpy(t))
    finally:
        models.set_attention_backend("sage")
    assert cosine_similarity(eps_t, eps_j) >= 0.9999
    np.testing.assert_allclose(eps_t.numpy(), eps_j, atol=1e-3)


def _wan_cut(cfgs):
    """Wan2.1-T2V-1.3B at its width (hidden 1536, 12 heads x 128), cut to
    one layer, one latent frame of 8 x 8 and 16 text tokens."""
    return cfgs["wan2.1-t2v-1.3b"].scaled(depth=1, latent_frames=1, latent_height=8,
                                          latent_width=8, text_len=16)


def test_wan_shaped_model_runs_the_two_pass_v_quantizer(monkeypatch):
    """The Wan2.1 width through the port on the CPU with "sage_fp8"; the
    single-pass limit is lowered below this model's V slab, so that V
    takes the two-pass quantizer as the full-size Wan2.1 server does.  eps
    against exact attention: cosine >= 0.999."""
    cfg = _wan_cut(models.MODEL_CONFIGS)
    assert (cfg.hidden, cfg.heads, cfg.head_dim) == (1536, 12, 128)
    slab = cfg.seq_len * cfg.head_dim * 4  # fp32
    monkeypatch.setattr(quant_cuda, "V_SINGLE_PASS_BYTES", slab - 1)
    calls = []
    blocked = quant_cuda.quant_v_blocked

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return blocked(*args, **kwargs)

    monkeypatch.setattr(quant_cuda, "quant_v_blocked", counted)
    model = serve.load_model(cfg, device="cpu", dtype=torch.float32, seed=5)
    lat, txt = serve.make_requests(cfg, 1, device="cpu", seed=6, dtype=torch.float32)[0]
    t = torch.tensor([500])
    try:
        with torch.no_grad():
            models.set_attention_backend("sage_fp8")
            eps = model(lat, txt, t)
            models.set_attention_backend("reference")
            eps_r = model(lat, txt, t)
    finally:
        models.set_attention_backend("sage")
    assert calls == [(1, 12, cfg.seq_len, 128)]
    assert eps.shape == lat.shape and torch.isfinite(eps).all()
    assert cosine_similarity(eps, eps_r) >= 0.999


def test_denoise_step_matches_jax(jax_backend):
    jm, params, tm, jdt, tdt = _models("float32")
    lat, txt, t = _inputs()
    eps_j = jm.apply(params, jnp.asarray(lat), jnp.asarray(txt), t)
    lat_j = np.asarray(jnp.asarray(lat) - (1.0 / 50) * eps_j.astype(jnp.float32))
    lat_t = serve.denoise_step(tm, torch.from_numpy(lat), torch.from_numpy(txt),
                               torch.from_numpy(t))
    assert cosine_similarity(lat_t, lat_j) >= 0.9999
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=1e-3)


def test_serve_answers_every_request_on_cpu():
    cfg = _tiny(models.MODEL_CONFIGS)
    model = serve.load_model(cfg, device="cpu", dtype=torch.float32, seed=0)
    reqs = serve.make_requests(cfg, 2, device="cpu", seed=1, dtype=torch.float32)
    out = serve.serve(model, reqs, steps=2)
    assert len(out["outputs"]) == 2 and len(out["step_ms"]) == 4
    assert out["device"] == "cpu"
    for (lat, _), res in zip(reqs, out["outputs"]):
        assert res.shape == lat.shape and torch.isfinite(res).all()
        assert not torch.equal(res, lat)


def test_load_model_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: load_model() builds on it")
    cfg = _tiny(models.MODEL_CONFIGS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.load_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.make_requests(cfg, 1)


def test_backend_registry_and_processor():
    cfg = _tiny(models.MODEL_CONFIGS)
    with pytest.raises(ValueError):
        models.set_attention_backend("no_such_backend")
    torch.manual_seed(0)
    q, k, v = (torch.randn(1, 2, 100, 64) for _ in range(3))
    ref = models.attention(q, k, v, backend="reference")
    for name in ("sage", "sage_bf16"):
        assert cosine_similarity(models.attention(q, k, v, backend=name), ref) > 0.999
    # a per-layer processor overrides the global backend
    proc = models.SageAttnProcessor(backend="reference")
    m_proc = serve.load_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    for blk in m_proc.blocks:
        blk.attn.processor = proc
    m_glob = serve.load_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    lat, txt = serve.make_requests(cfg, 1, device="cpu", seed=4, dtype=torch.float32)[0]
    t = torch.tensor([250])
    models.set_attention_backend("reference")
    try:
        with torch.no_grad():
            want = m_glob(lat, txt, t)
        models.set_attention_backend("sage")
        with torch.no_grad():
            got = m_proc(lat, txt, t)
    finally:
        models.set_attention_backend("sage")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
