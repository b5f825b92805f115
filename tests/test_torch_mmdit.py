"""The dual-stream and cross-attention video DiTs of the port against the JAX
package's flax models, on the CPU, with the same weights.

Tiny HunyuanVideo- and Wan2.1-shaped configs (depth 2, hidden 128, 2 heads
of 64, 16 text tokens, a 2 x 8 x 8 latent) are initialised in flax and
carried across with ``params_from_jax``.  The JAX models' attention goes
through a test-side backend on ``core._sageattn_hnd(impl="xla",
chunk_k=K_GROUP)`` (``core._entry`` raises at this revision), with
``pv_dtype="fp8"`` for the port's ``"sage_fp8"``, or through the JAX
``"reference"`` backend for the port's.

Tolerances on eps: fp32 cosine >= 0.9999 and max-abs <= 1e-3 (both sides
quantize the same activations: fp32 round-off through 2 blocks); bf16
cosine >= 0.999 (the frameworks round bf16 activations at different
places).
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
from sageattention_tpu_torch.utils.compare import cosine_similarity

KINDS = {"dual": ("hunyuanvideo", "DualStreamVideoDiT"),
         "cross": ("wan2.1-t2v-1.3b", "CrossAttnVideoDiT")}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _xla_sage(q, k, v, *, is_causal, sm_scale, pv_dtype="bf16", **kw):
    return jcore._sageattn_hnd(
        q, k, v, None, None, None, None, None, None,
        impl="xla", chunk_k=K_GROUP, qk_quant_gran="auto", pv_dtype=pv_dtype,
        smooth_k=True, smooth_v=False, return_lse=False, is_causal=is_causal,
        sm_scale=sm_scale, block_q=128, block_k=128,
    )


def _xla_sage_fp8(q, k, v, *, is_causal, sm_scale, **kw):
    return _xla_sage(q, k, v, is_causal=is_causal, sm_scale=sm_scale, pv_dtype="fp8")


# the port's backend -> the JAX backend that computes the same attention
JAX_BACKEND = {"sage": "torch_port_mmdit_sage", "sage_fp8": "torch_port_mmdit_sage_fp8",
               "reference": "reference"}


@pytest.fixture(scope="module", autouse=True)
def backends():
    j_register("torch_port_mmdit_sage", _xla_sage)
    j_register("torch_port_mmdit_sage_fp8", _xla_sage_fp8)
    prev_j, prev_t = jmodels.get_attention_backend(), models.get_attention_backend()
    yield
    jmodels.set_attention_backend(prev_j)
    models.set_attention_backend(prev_t)


def _tiny(cfgs, kind):
    return cfgs[KINDS[kind][0]].scaled(depth=2, latent_frames=2, latent_height=8,
                                       latent_width=8, text_len=16, hidden=128, heads=2,
                                       head_dim=64)


def _inputs():
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((1, 2, 8, 8, 16)).astype(np.float32)
    txt = rng.standard_normal((1, 16, 512)).astype(np.float32)
    return lat, txt, np.array([500], np.int32)


def _jax_model(kind, jdt):
    return getattr(jmodels, KINDS[kind][1])(_tiny(J_CONFIGS, kind), dtype=jdt)


def _pair(kind, dtype):
    jdt, tdt = DTYPES[dtype]
    jm = _jax_model(kind, jdt)
    lat, txt, t = _inputs()
    jmodels.set_attention_backend("reference")
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(lat, jdt), jnp.asarray(txt, jdt), t)
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    tm = serve.load_model(_tiny(models.MODEL_CONFIGS, kind), device="cpu", dtype=tdt,
                          state_dict=sd, model_cls=getattr(models, KINDS[kind][1]))
    return jm, params, tm


@pytest.mark.parametrize("kind", list(KINDS))
def test_converted_state_dict_covers_every_parameter(kind):
    """Every flax leaf lands on a port parameter of its shape, and every port
    parameter comes from a flax leaf."""
    jm = _jax_model(kind, jnp.float32)
    lat, txt, t = _inputs()
    jmodels.set_attention_backend("reference")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(2), lat, txt, t)
    leaves = jax.tree.leaves(shapes)
    sd = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    tm = getattr(models, KINDS[kind][1])(_tiny(models.MODEL_CONFIGS, kind),
                                        dtype=torch.float32)
    want = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert len(sd) == len(leaves) == len(list(tm.parameters()))
    per_block = {"dual": 20, "cross": 22}[kind]  # adaln, projections, norms, MLPs
    assert len(sd) == 13 + 2 * per_block


CASES = [(kind, dtype, backend) for kind in KINDS for dtype in DTYPES
         for backend in ("sage", "reference")] + [("cross", "fp32", "sage_fp8"),
                                                  ("cross", "bf16", "sage_fp8"),
                                                  ("dual", "fp32", "sage_fp8")]


@pytest.mark.parametrize("kind,dtype,backend", CASES)
def test_eps_matches_flax(kind, dtype, backend):
    jm, params, tm = _pair(kind, dtype)
    jdt, tdt = DTYPES[dtype]
    lat, txt, t = _inputs()
    jmodels.set_attention_backend(JAX_BACKEND[backend])
    eps_j = np.asarray(jm.apply(params, jnp.asarray(lat, jdt), jnp.asarray(txt, jdt), t)
                       .astype(jnp.float32))
    models.set_attention_backend(backend)
    with torch.no_grad():
        eps_t = tm(torch.from_numpy(lat).to(tdt), torch.from_numpy(txt).to(tdt),
                   torch.from_numpy(t))
    models.set_attention_backend("sage")
    assert eps_t.shape == eps_j.shape == lat.shape and eps_t.dtype == torch.float32
    cos = cosine_similarity(eps_t, eps_j)
    if dtype == "fp32":
        assert cos >= 0.9999, cos
        np.testing.assert_allclose(eps_t.numpy(), eps_j, atol=1e-3)
    else:
        assert cos >= 0.999, cos


def test_qk_norm_keeps_the_model_dtype():
    """The qk-norm hands ``sageattn`` q and k in the model dtype (bf16), as
    flax's ``nn.RMSNorm(dtype=q.dtype)`` does, with fp32 statistics."""
    seen = []

    def spy(q, k, v, sm_scale=None):
        seen.append((q.dtype, k.dtype, v.dtype, tuple(q.shape), tuple(k.shape)))
        return models.attention(q, k, v, backend="reference")

    for kind in KINDS:
        cfg = _tiny(models.MODEL_CONFIGS, kind)
        tm = serve.load_model(cfg, device="cpu", seed=3,
                              model_cls=getattr(models, KINDS[kind][1]))
        for blk in tm.blocks:
            blk.processor = spy
        lat, txt = serve.make_requests(cfg, 1, device="cpu", seed=4)[0]
        with torch.no_grad():
            tm(lat, txt, torch.tensor([500]))
    bf = torch.bfloat16
    assert all(s[:3] == (bf, bf, bf) for s in seen)
    # dual: 2 joint calls over text + video; cross: self then cross a block
    joint, vid = (1, 2, 16 + 32, 64), (1, 2, 32, 64)
    assert [s[3:] for s in seen] == [(joint, joint)] * 2 + [(vid, vid), (vid, (1, 2, 16, 64))] * 2
    norm = models.mmdit.QKNorm(64)
    x = torch.randn(2, 3, 64).to(bf)
    want = (x.float() * torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + 1e-6)).to(bf)
    assert norm(x).dtype == bf and torch.equal(norm(x), want)


@pytest.mark.parametrize("kind", list(KINDS))
def test_sage_matches_sdpa_backend(kind):
    """The JAX package's own check, on the port: the model's eps with
    "sage" against the same weights with "sdpa" (bf16), cosine > 0.999."""
    cfg = _tiny(models.MODEL_CONFIGS, kind)
    tm = serve.load_model(cfg, device="cpu", seed=5, model_cls=getattr(models, KINDS[kind][1]))
    lat, txt = serve.make_requests(cfg, 1, device="cpu", seed=6)[0]
    t = torch.tensor([500])
    with torch.no_grad():
        models.set_attention_backend("sage")
        out = tm(lat, txt, t)
        models.set_attention_backend("sdpa")
        ref = tm(lat, txt, t)
    models.set_attention_backend("sage")
    assert out.shape == lat.shape and torch.isfinite(out).all()
    assert cosine_similarity(out, ref) > 0.999


@pytest.mark.parametrize("kind", list(KINDS))
def test_serve_answers_with_either_model(kind):
    cfg = _tiny(models.MODEL_CONFIGS, kind)
    cls = getattr(models, KINDS[kind][1])
    model = serve.load_model(cfg, device="cpu", dtype=torch.float32, seed=0, model_cls=cls)
    assert type(model) is cls
    reqs = serve.make_requests(cfg, 2, device="cpu", seed=1, dtype=torch.float32)
    out = serve.serve(model, reqs, steps=2)
    assert len(out["outputs"]) == 2 and len(out["step_ms"]) == 4
    for (lat, _), res in zip(reqs, out["outputs"]):
        assert res.shape == lat.shape and torch.isfinite(res).all()
        assert not torch.equal(res, lat)
