"""``interop.patch_torch_sdpa``: ``F.scaled_dot_product_attention`` replaced by
the port's ``sageattn``, with the argument handling of the JAX package's
``interop/torch_adapter.py``, on the CPU.

* Under the patch every SDPA call equals ``sageattn`` on the same operands
  bit for bit: 3-D, 4-D and 5-D inputs, masks broadcast from fewer dims, a
  Hugging Face float padding mask (0 / finfo.min, taken as a bool mask), an
  additive float mask, GQA, default kwargs.  Dropout is refused and
  ``undo()`` puts the original back.
* The port's own callers of SDPA bound the original at import: the exact
  recompute of ``ops/autodiff.py`` (forced onto its SDPA route here, which
  otherwise runs on the card only) gives a Q/K-option backward under the
  patch equal to the one without it and never enters the patched
  function; the baselines do not either.
* The ``"sdpa"`` model backend calls the attribute, so a VideoDiT on it
  under the patch gives the ``"sage"`` backend's eps bit for bit (what
  ``chip_smoke.py``'s ``patched_sdpa`` phase checks on the card).
"""

import pytest
import torch
import torch.nn.functional as F

from sageattention_tpu_torch import baselines, models, sageattn, serve
from sageattention_tpu_torch.interop import patch_torch_sdpa
from sageattention_tpu_torch.ops import autodiff

ORIG = F.scaled_dot_product_attention


@pytest.fixture
def patched():
    """The patch on for the test, with a count of the calls it took."""
    calls = []
    undo = patch_torch_sdpa()
    inner = F.scaled_dot_product_attention

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return inner(*args, **kwargs)

    F.scaled_dot_product_attention = counted
    yield calls
    undo()
    assert F.scaled_dot_product_attention is ORIG


def _rand(*shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def test_patch_and_undo():
    assert autodiff._SDPA is ORIG and baselines._SDPA is ORIG
    undo = patch_torch_sdpa()
    assert F.scaled_dot_product_attention is not ORIG
    undo()
    assert F.scaled_dot_product_attention is ORIG


@pytest.mark.parametrize("causal", [False, True])
def test_4d_equals_sageattn(patched, causal):
    q, k, v = (_rand(2, 3, 96, 64, seed=s) for s in (1, 2, 3))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=0.1)
    assert torch.equal(out, sageattn(q, k, v, is_causal=causal, sm_scale=0.1))
    assert len(patched) == 1


def test_3d_and_5d_inputs_and_masks(patched):
    q, k, v = (_rand(4, 80, 32, seed=s) for s in (4, 5, 6))
    out = F.scaled_dot_product_attention(q, k, v)
    assert out.shape == (4, 80, 32)
    assert torch.equal(out, sageattn(q[:, None], k[:, None], v[:, None])[:, 0])
    # a 3-D call's mask is (N, L, S): its batch stays the batch
    m3 = _rand(4, 80, 80, seed=7) > -0.5
    m3[..., 0] = True
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=m3)
    assert torch.equal(out, sageattn(q[:, None], k[:, None], v[:, None],
                                     attn_mask=m3[:, None])[:, 0])
    q5, k5, v5 = (_rand(2, 3, 2, 64, 32, seed=s) for s in (8, 9, 10))
    out = F.scaled_dot_product_attention(q5, k5, v5, is_causal=True)
    want = sageattn(*(x.reshape(6, 2, 64, 32) for x in (q5, k5, v5)), is_causal=True)
    assert out.shape == (2, 3, 2, 64, 32) and torch.equal(out, want.reshape(2, 3, 2, 64, 32))
    # a 5-D call's mask broadcast from (3, 1, 64, 64): per middle batch index
    m5 = _rand(3, 1, 64, 64, seed=11) > -0.5
    m5[..., 0] = True
    out = F.scaled_dot_product_attention(q5, k5, v5, attn_mask=m5)
    want = sageattn(*(x.reshape(6, 2, 64, 32) for x in (q5, k5, v5)),
                    attn_mask=m5.expand(2, 3, 1, 64, 64).reshape(6, 1, 64, 64))
    assert torch.equal(out, want.reshape(2, 3, 2, 64, 32))
    with pytest.raises(ValueError, match=">= 3 dims"):
        F.scaled_dot_product_attention(q[0], k[0], v[0])


def test_broadcast_and_float_masks(patched):
    q, k, v = (_rand(2, 4, 64, 64, seed=s) for s in (12, 13, 14))
    # the key-padding mask (B, 1, 1, S) and a 2-D (L, S) mask
    pad = torch.ones(2, 1, 1, 64, dtype=torch.bool)
    pad[0, ..., 48:] = False
    assert torch.equal(F.scaled_dot_product_attention(q, k, v, attn_mask=pad),
                       sageattn(q, k, v, attn_mask=pad))
    band = torch.ones(64, 64, dtype=torch.bool).tril()
    assert torch.equal(F.scaled_dot_product_attention(q, k, v, attn_mask=band),
                       sageattn(q, k, v, attn_mask=band[None, None]))
    # Hugging Face's float padding mask: 0 or finfo.min, a bool mask in disguise
    hf = torch.zeros(2, 1, 1, 64).masked_fill(~pad, torch.finfo(torch.float32).min)
    assert torch.equal(F.scaled_dot_product_attention(q, k, v, attn_mask=hf),
                       sageattn(q, k, v, attn_mask=pad))
    # any other float mask is an additive bias
    bias = _rand(1, 4, 64, 64, seed=15)
    assert torch.equal(F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
                       sageattn(q, k, v, attn_mask=bias))


def test_gqa_defaults_and_dropout():
    q = _rand(1, 8, 64, 64, seed=16)
    k, v = (_rand(1, 2, 64, 64, seed=s) for s in (17, 18))
    undo = patch_torch_sdpa(pv_dtype="fp8", smooth_k=False)
    try:
        out = F.scaled_dot_product_attention(q, k, v, enable_gqa=True, is_causal=True)
        assert torch.equal(out, sageattn(q, k, v, is_causal=True, pv_dtype="fp8",
                                         smooth_k=False))
        with pytest.raises(NotImplementedError, match="dropout"):
            F.scaled_dot_product_attention(q, k, v, dropout_p=0.1, enable_gqa=True)
    finally:
        undo()
    assert F.scaled_dot_product_attention is ORIG


@pytest.mark.parametrize("opts", [{"smooth_q": True}, {"qk_bits": 4},
                                  {"qk_quant_gran": "per_token"}])
def test_qk_option_backward_under_patch_equals_unpatched(monkeypatch, opts):
    """A Q/K option's backward is exact recompute (``RecomputeFunction``);
    on its SDPA route it must take the original SDPA, not the patch."""
    monkeypatch.setattr(autodiff, "_sdpa_route", lambda q: True)
    q, k, v = (_rand(1, 4, 96, 64, seed=s) for s in (19, 20, 21))
    do = _rand(1, 4, 96, 64, seed=22)

    def grads():
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = sageattn(*xs, is_causal=True, **opts)
        return [out.detach()] + list(torch.autograd.grad(out, xs, do))

    want = grads()
    calls = []
    undo = patch_torch_sdpa()
    inner = F.scaled_dot_product_attention

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    F.scaled_dot_product_attention = counted
    try:
        got = grads()
    finally:
        undo()
    assert not calls
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the route taken was SDPA's: exact attention's gradient, not the fp32 reference's
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    ORIG(*xs, is_causal=True).backward(do)
    assert torch.allclose(got[1], xs[0].grad, atol=1e-6)


def test_baselines_ignore_the_patch(patched):
    q, k, v = (_rand(1, 2, 64, 32, seed=s) for s in (23, 24, 25))
    got = [baselines.sdpa(q, k, v, is_causal=True), baselines.flash(q, k, v)]
    assert not patched
    assert torch.equal(got[0], ORIG(q, k, v, is_causal=True))
    assert torch.equal(got[1], ORIG(q, k, v))


def test_sdpa_backend_under_patch_is_the_sage_backend(patched):
    """A VideoDiT on the "sdpa" backend under the patch: eps equal to the
    "sage" backend's, every layer through the patch; after undo() the
    backend is SDPA again."""
    cfg = models.MODEL_CONFIGS["cogvideox-2b"].scaled(
        depth=2, latent_frames=2, latent_height=8, latent_width=8, text_len=16, hidden=128,
        heads=2, head_dim=64)
    model = serve.load_model(cfg, device="cpu", seed=0)
    lat, txt = serve.make_requests(cfg, 1, device="cpu", seed=1)[0]
    t = torch.tensor([500])
    prev = models.get_attention_backend()
    try:
        with torch.no_grad():
            models.set_attention_backend("sage")
            eps_sage = model(lat, txt, t)
            models.set_attention_backend("sdpa")
            eps_patched = model(lat, txt, t)
            assert len(patched) == cfg.depth
            F.scaled_dot_product_attention = ORIG
            eps_sdpa = model(lat, txt, t)
    finally:
        models.set_attention_backend(prev)
    assert torch.equal(eps_patched, eps_sage)
    assert not torch.equal(eps_sdpa, eps_sage)
