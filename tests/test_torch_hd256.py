"""Head dims above 128 in the port, on the CPU: its plain versions at head
dim 256 (and the padded 160 and 192) against the JAX package, from the same
numpy inputs.  The JAX package pads a head dim in (128, 256] to 256
(``core.py:70-75``), and so does the port.

* Quantizers: kernels 2-4 (the K and Q quantizers) and 5-6 (the V
  quantizers) at d 256 against ``quant.py`` and the Pallas quantizers in
  interpret mode: bit-exact (codes compared as bytes), as at 64 and 128.
* Attention: the plain forward against ``sage_attention_fused`` in
  interpret mode on the same quantized operands, bf16 V and V codes: o
  cosine >= 0.9999 and max-abs <= 2e-2 (the Pallas kernel rounds P to bf16
  before P.V), base-2 LSE within 1e-3.
* ``sageattn`` (and a variant, a window, varlen) against
  ``core._sageattn_hnd(impl="xla", chunk_k=128)``, fp32 inputs.  Without
  K smoothing both sides quantize to the same codes: o within atol 1e-5,
  LSE within 1e-4.  With it, the two K means are summed in other orders,
  which can move a K code by a step (more often at 256 than at 64, with
  four times the codes a head): cosine >= 0.99999, max-abs <= 5e-3, LSE
  within 1e-3, as ``tests/test_torch_qopts.py`` holds the options with a
  mean.
* Backward: the plain dQ/dK/dV against ``sage_attention_bwd(interpret=True)``
  at 256 (cosine >= 0.99999, max-abs <= 1e-3 of the largest entry), and
  ``sageattn``'s gradients against ``quantized_attention_vjp(interpret=True)``
  at 256 and 192: cosine >= 0.99999 and max-abs <= 2e-3 of the largest
  entry without K smoothing (``tests/test_torch_autodiff.py``'s bound),
  5e-3 with it (a K code may move a step, as above).  At 160 the JAX fused backward
  declines (``d % 64``, ``attention_bwd_pallas.py:486``) and falls back to
  exact recompute; the port runs its fused backward at the padded 256 and
  is held to ``jax.vjp`` of exact attention: cosine >= 0.999.
* Decode: kernels 9-12's plain versions against ``decode_pallas`` /
  ``paged_decode_pallas`` in interpret mode at d 256 and 192, int8 and
  packed int4, windowed or not: m bit-exact, o within 1e-5, l 1e-6
  relative.
* The slice as a whole: a ``CausalLM`` with ``head_dim=256`` (2 layers,
  hidden 256, 2 query heads, 1 kv head) against the flax model with
  converted weights, fp32, over a prompt and 3 teacher-forced decode steps
  through the dense and the paged int8 cache: cosine >= 0.99999, max-abs
  <= 5e-3 of the largest logit (``tests/test_torch_llm.py``'s fp32 bound).
* A trainable per-head bias at 256 takes the fused route (the backward's
  bias instances at 256) and agrees with the JAX fused bias VJP
  (``tests/test_torch_bias_grad.py``'s ``_jax_fused_bias_vjp``, Pallas in
  interpret mode) at sq = sk = 256: cosine >= 0.99999 on dq, dk, dv and
  dBias; with a window it takes exact recompute, held to exact attention.
* The limits: head dims above 512 raise naming ROADMAP (d 320 computes,
  ``tests/test_torch_hd512.py``); the Q/K options
  run at 256 (``tests/test_torch_preq_hd256.py`` holds them to the JAX
  package).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu import models as jmodels
from sageattention_tpu import quant as jquant
from sageattention_tpu.models.configs import MODEL_CONFIGS as J_CONFIGS
from sageattention_tpu.ops import (attention_bwd_pallas, attention_pallas, decode_pallas,
                                   paged_decode_pallas, quant_pallas)
from sageattention_tpu.ops import reference as jreference
from sageattention_tpu_torch import core, generate, models, sageattn, sageattn_qk_int8_pv_fp8
from sageattention_tpu_torch import sageattn_varlen
from sageattention_tpu_torch.models.convert import llm_params_from_jax
from sageattention_tpu_torch.ops import (_build, attention_bwd_cuda, attention_cuda, autodiff,
                                         decode_cuda, quant_cuda)
from sageattention_tpu_torch.utils.compare import cosine_similarity

LOG2E = 1.4426950408889634
G = attention_cuda.K_GROUP
V_CODES = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
           "fp8_e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


def _rand(seed, shape, mean=0.0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + mean).astype(np.float32)


def _t(x, requires_grad=False):
    return torch.from_numpy(np.array(x, dtype=np.float32)).requires_grad_(requires_grad)


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _eq(t, j) -> None:
    np.testing.assert_array_equal(_bytes(t), _bytes(j))


def test_pad_head_dim_follows_the_jax_rule():
    """64, a multiple of 128 above it, up to 256."""
    for d in (16, 64, 65, 96, 128, 129, 160, 192, 255, 256):
        assert _build.pad_head_dim(d) == jcore._pad_head_dim(d), d


# --------------------------------------------------------------------------
# quantizers (kernels 2-6)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s", [256, 200])
def test_k_quantizers_bit_exact_hd256(s):
    """Kernel 3 with the JAX km is bit-exact with the Pallas kernel, at a
    ragged length too; kernel 2's km agrees to 1e-6 relative and, against
    the fused Pallas kernel (whole groups), its codes within a step on <=
    1e-4 (the mean's summation order), as at 64 and 128."""
    k = torch.from_numpy(_rand(s, (1, 2, s, 256), scale=2.0)
                         + _rand(s + 1, (1, 2, 1, 256), scale=3.0)).to(torch.bfloat16)
    k_j = jnp.asarray(k.float().numpy()).astype(jnp.bfloat16)
    km_j = jnp.mean(k_j.astype(jnp.float32), axis=-2)
    q_j, s_j = quant_pallas.quant_k_chunked(k_j, km_j, group=G, interpret=True)
    q_t, s_t = quant_cuda.quant_k_chunked(k, torch.from_numpy(np.array(km_j)), group=G)
    _eq(q_t, q_j)
    _eq(s_t, s_j)
    q_t, s_t, km_t = quant_cuda.quant_k_fused_mean(k, group=G)
    if s % G:  # the fused Pallas kernel takes whole groups only
        np.testing.assert_allclose(km_t.numpy(), np.asarray(km_j), rtol=1e-6, atol=1e-7)
        return
    q_f, s_f, km_f = quant_pallas.quant_k_fused_mean(k_j, group=G, interpret=True)
    np.testing.assert_allclose(km_t.numpy(), np.asarray(km_f), rtol=1e-6, atol=1e-7)
    diff = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_f).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_f), rtol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_q_bit_exact_hd256(dtype, bits):
    x = _rand(3, (2, 3, 77, 256), scale=3.0)
    x[0, 0, 0] = 0.0  # the 1e-30 floor
    jx = jnp.asarray(x).astype(dtype)
    fold = 256**-0.5 * LOG2E
    q_j, s_j = jquant.quant_int8(jx, granularity="per_token", scale_fold=fold, bits=bits)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    q_t, s_t = quant_cuda.quant_q_per_token(tx, scale_fold=fold, bits=bits)
    _eq(q_t, q_j)
    _eq(s_t, s_j)


@pytest.mark.parametrize("code", sorted(V_CODES))
@pytest.mark.parametrize("kernel", ["single_pass", "blocked"])
def test_v_quantizers_bit_exact_hd256(kernel, code):
    """Kernels 5 and 6 without smooth-v: codes and scales bit-exact with
    the Pallas kernels; kernel 6 over several of its 512-row blocks."""
    jdt, tdt = V_CODES[code]
    s = 256 if kernel == "single_pass" else 1100
    x = _rand(s, (1, 2, s, 256)) + _rand(s + 1, (1, 2, 1, 256), scale=3.0)
    if kernel == "single_pass":
        want = quant_pallas.quant_v_per_channel(jnp.asarray(x), dtype=jdt, interpret=True)
        got = quant_cuda.quant_v_per_channel(torch.from_numpy(x), dtype=tdt)
    else:
        want = quant_pallas._quant_v_blocked(jnp.asarray(x), dtype=jdt, smooth=False,
                                             interpret=True)
        got = quant_cuda.quant_v_blocked(torch.from_numpy(x), dtype=tdt, smooth=False)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_v_quantizer_pads_192_to_256():
    """A d-192 V is quantized before padding: its 64 pad channels get code 0
    and the first 192 the codes of the unpadded V."""
    x = torch.from_numpy(_rand(5, (1, 2, 200, 192)))
    q, sc, _ = quant_cuda.quant_v_per_channel(x, dtype=torch.int8, d_pad=256)
    q_j, s_j, _ = jquant.per_channel_quant(jnp.asarray(x.numpy()), dtype=jnp.int8)
    assert q.shape == (1, 2, 200, 256)
    _eq(q[..., :192], q_j)
    _eq(sc[..., :192], s_j)
    assert not q[..., 192:].any()


# --------------------------------------------------------------------------
# attention (kernel 1)
# --------------------------------------------------------------------------


def _k_codes(k):
    km = jnp.mean(jnp.asarray(k), axis=-2)
    return quant_pallas.quant_k_chunked(jnp.asarray(k), km, group=G, interpret=True)


@pytest.mark.parametrize("pv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("b,hq,hkv,s,causal", [(1, 2, 2, 256, False), (1, 4, 2, 256, True)])
def test_plain_attention_matches_pallas_hd256(b, hq, hkv, s, causal, pv):
    d = 256
    q, k, v = _rand(s, (b, hq, s, d)), _rand(s + 1, (b, hkv, s, d)), _rand(s + 2, (b, hkv, s, d))
    k_i8, k_scale = (np.array(x) for x in _k_codes(k))
    fold = d**-0.5 * LOG2E
    if pv == "bf16":
        v_j = jnp.asarray(v).astype(jnp.bfloat16)
        v_t = torch.from_numpy(np.array(v_j.astype(jnp.float32))).to(torch.bfloat16)
        extra_j, vs_t = (), None
    else:
        v_j, v_scale, _ = jquant.per_channel_quant(jnp.asarray(v), dtype=V_CODES[pv][0])
        v_t = torch.from_numpy(_bytes(v_j).copy()).view(V_CODES[pv][1])
        extra_j, vs_t = (v_scale,), torch.from_numpy(np.array(v_scale))
    o_j, l_j = attention_pallas.sage_attention_fused(
        jnp.asarray(q), None, jnp.asarray(k_i8), jnp.asarray(k_scale), v_j, *extra_j,
        is_causal=causal, pv_dtype=pv, q_fold=fold, return_lse=True, block_q=128,
        block_k=128, sub_q=128, chunk_k=G, out_dtype=jnp.float32, interpret=True)
    o_t, l_t = attention_cuda.sage_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k_i8), torch.from_numpy(k_scale), v_t, vs_t,
        is_causal=causal, q_fold=fold, return_lse=True)
    assert o_t.shape == (b, hq, s, d)
    assert cosine_similarity(o_t, np.asarray(o_j)) >= 0.9999
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-2)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-3)


def _jax_sageattn(q, k, v, *, causal, smooth_k=True, pv_dtype="bf16", window=None):
    return jcore._sageattn_hnd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None, None, None, None,
        impl="xla", chunk_k=G, qk_quant_gran="auto", pv_dtype=pv_dtype, smooth_k=smooth_k,
        smooth_v=False, return_lse=True, is_causal=causal, sm_scale=None, block_q=128,
        block_k=128, window=window)


SAGE_CASES = {
    # name: (b, hq, hkv, sq, sk, d, causal)
    "d256": (1, 2, 2, 256, 256, 256, False),
    "d256_gqa_causal_ragged": (2, 4, 2, 200, 200, 256, True),
    "d192_rectangular": (1, 2, 1, 130, 333, 192, False),
    "d160_causal": (1, 2, 2, 150, 150, 160, True),
}


def _assert_close_o(o_t, lse_t, o_j, lse_j, smooth_k):
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    if smooth_k:
        assert cosine_similarity(o_t, o_j) >= 0.99999
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=5e-3)
        np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-3)
    else:
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=1e-5)
        np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-4)


@pytest.mark.parametrize("smooth_k", [False, True])
@pytest.mark.parametrize("name", sorted(SAGE_CASES))
def test_sageattn_matches_jax_hd256(name, smooth_k):
    b, hq, hkv, sq, sk, d, causal = SAGE_CASES[name]
    q, k, v = (_rand(len(name), (b, hq, sq, d)), _rand(len(name) + 1, (b, hkv, sk, d), 0.5),
               _rand(len(name) + 2, (b, hkv, sk, d)))
    o_t, lse_t = sageattn(_t(q), _t(k), _t(v), is_causal=causal, return_lse=True,
                          smooth_k=smooth_k)
    o_j, lse_j = _jax_sageattn(q, k, v, causal=causal, smooth_k=smooth_k)
    assert o_t.shape == (b, hq, sq, d) and o_t.dtype == torch.float32
    _assert_close_o(o_t, lse_t, o_j, lse_j, smooth_k)


def test_fp8_variant_matches_jax_hd256():
    shape = (1, 2, 256, 256)
    q, k, v = _rand(1, shape), _rand(2, shape, 0.5), _rand(3, shape)
    o_t, lse_t = sageattn_qk_int8_pv_fp8(_t(q), _t(k), _t(v), is_causal=True, return_lse=True)
    o_j, lse_j = _jax_sageattn(q, k, v, causal=True, pv_dtype="fp8")
    _assert_close_o(o_t, lse_t, o_j, lse_j, smooth_k=True)


@pytest.mark.parametrize("d,window", [(256, 100), (192, 37)])
def test_window_matches_jax_hd256(d, window):
    q = _rand(d, (1, 4, 300, d))
    k, v = _rand(d + 1, (1, 2, 300, d), 0.5), _rand(d + 2, (1, 2, 300, d))
    o_t, lse_t = sageattn(_t(q), _t(k), _t(v), is_causal=True, return_lse=True, window=window,
                          smooth_k=False)
    o_j, lse_j = _jax_sageattn(q, k, v, causal=True, smooth_k=False, window=window)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4)


@pytest.mark.parametrize("d", [256, 192])
def test_varlen_matches_jax_hd256(d):
    lens = [128, 200, 56]
    rng = np.random.default_rng(d)
    tot = sum(lens)
    q = rng.standard_normal((tot, 4, d)).astype(np.float32)
    k = (rng.standard_normal((tot, 2, d)) + 0.5).astype(np.float32)
    v = rng.standard_normal((tot, 2, d)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    o_t, lse_t = sageattn_varlen(*(torch.from_numpy(x) for x in (q, k, v, cu, cu)),
                                 is_causal=True, return_lse=True)
    o_j, lse_j = jcore.sageattn_varlen(*(jnp.asarray(x) for x in (q, k, v, cu, cu)),
                                       is_causal=True, return_lse=True, impl="xla",
                                       block_q=128, block_k=128)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4)


# --------------------------------------------------------------------------
# backward (kernels 7-8)
# --------------------------------------------------------------------------


def _assert_close_grads(got, want, cos_min, rel_max=None):
    for name, g, w in zip("qkv", got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        assert cosine_similarity(g, w) >= cos_min, (name, cosine_similarity(g, w))
        if rel_max is not None:
            assert np.abs(g - w).max() / np.abs(w).max() <= rel_max, name


def _bf16_t(x):
    return _t(x.astype(jnp.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 100)])
def test_plain_backward_matches_pallas_hd256(causal, window):
    b, hq, hkv, s, d = 1, 4, 2, 256, 256
    q, k, v, do = (_rand(7, (b, hq, s, d)), _rand(8, (b, hkv, s, d), 0.5),
                   _rand(9, (b, hkv, s, d)), _rand(10, (b, hq, s, d)))
    sm = d**-0.5
    km = jnp.mean(jnp.asarray(k), axis=-2)
    k_sm = jnp.asarray(k) - km[..., None, :]
    q_i8, q_scale = jquant.quant_int8(jnp.asarray(q), granularity="per_token",
                                      scale_fold=sm * LOG2E)
    k_i8, k_scale = jquant.quant_int8_block_scales(k_sm, group=G)
    v_bf, k_bf, q_bf = (jnp.asarray(x).astype(jnp.bfloat16) for x in (v, k_sm, q))
    o, lse2 = attention_pallas.sage_attention_fused(
        q_i8, q_scale, k_i8, k_scale, v_bf, is_causal=causal, pv_dtype="bf16", window=window,
        return_lse=True, block_q=128, block_k=128, chunk_k=G, interpret=True)
    want = attention_bwd_pallas.sage_attention_bwd(
        q_i8, q_scale, k_i8, k_scale, k_bf, q_bf, v_bf, o, lse2, jnp.asarray(do),
        is_causal=causal, sm_scale=sm, block_q=128, block_k=128, chunk_k=G,
        scale_group=G, window=window, interpret=True)
    o_t, do_t = _t(np.asarray(o.astype(jnp.float32))), _t(do)
    ops = dict(q_i8=torch.from_numpy(np.array(q_i8)), q_scale=_t(q_scale),
               k_i8=torch.from_numpy(np.array(k_i8)), k_scale=_t(k_scale), v=_bf16_t(v_bf),
               do=do_t.to(torch.bfloat16), lse2=_t(lse2), dvec=(do_t * o_t).sum(-1))
    kw = dict(is_causal=causal, sm_scale=sm, window=window)
    dq = attention_bwd_cuda.sage_attention_bwd_dq(k_sm=_bf16_t(k_bf), **ops, **kw)
    dk, dv = attention_bwd_cuda.sage_attention_bwd_dkv(q_bf=_bf16_t(q_bf), **ops, **kw)
    _assert_close_grads((dq, dk, dv), want, cos_min=0.99999, rel_max=1e-3)


def _jax_fused_vjp(q, k, v, do, *, causal, smooth_k=True):
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o, lse = _jax_sageattn(q, k, v, causal=causal, smooth_k=smooth_k)
    km = jnp.mean(jk, axis=-2) if smooth_k else None
    k_i8, k_scale = jquant.quant_int8_block_scales(jk - km[..., None, :] if smooth_k else jk,
                                                   group=G)
    return attention_bwd_pallas.quantized_attention_vjp(
        jq, jk, jv, jnp.asarray(do), is_causal=causal, sm_scale=None, o=o, lse_nat=lse,
        dlse=None, smooth_k=smooth_k, fwd_res={"k_i8": k_i8, "k_scale": k_scale, "km": km},
        interpret=True)


@pytest.mark.parametrize("smooth_k", [False, True])
@pytest.mark.parametrize("d,causal", [(256, False), (256, True), (192, True)])
def test_sageattn_grads_match_jax_fused_vjp_hd256(d, causal, smooth_k):
    """The fused backward at the padded head dim against the JAX fused VJP
    (lengths of 128 multiples, which it takes)."""
    q, k, v, do = (_rand(d, (1, 4, 256, d)), _rand(d + 1, (1, 2, 256, d), 0.5),
                   _rand(d + 2, (1, 2, 256, d)), _rand(d + 3, (1, 4, 256, d)))
    want = _jax_fused_vjp(q, k, v, do, causal=causal, smooth_k=smooth_k)
    assert want is not None
    qt, kt, vt = (_t(x, True) for x in (q, k, v))
    out = sageattn(qt, kt, vt, is_causal=causal, smooth_k=smooth_k)
    got = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    _assert_close_grads(got, want, cos_min=0.99999, rel_max=5e-3 if smooth_k else 2e-3)


def _exact_vjp(q, k, v, do, causal):
    rep = q.shape[1] // k.shape[1]

    def exact(q, k, v):
        return jreference.attention_reference(q, jnp.repeat(k, rep, axis=1),
                                              jnp.repeat(v, rep, axis=1), is_causal=causal)

    _, vjp = jax.vjp(exact, *(jnp.asarray(x) for x in (q, k, v)))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("d,s", [(160, 256), (160, 150), (192, 150)])
def test_grads_where_jax_falls_back_match_exact_vjp(d, s):
    """d 160 (the JAX fused backward declines it) and ragged lengths: the
    port's fused backward at 256 against the exact VJP the JAX package
    falls back to."""
    q, k, v, do = (_rand(d + s, (1, 4, s, d)), _rand(d + s + 1, (1, 2, s, d), 0.5),
                   _rand(d + s + 2, (1, 2, s, d)), _rand(d + s + 3, (1, 4, s, d)))
    assert _jax_fused_vjp(q, k, v, do, causal=True) is None
    want = _exact_vjp(q, k, v, do, True)
    qt, kt, vt = (_t(x, True) for x in (q, k, v))
    out = sageattn(qt, kt, vt, is_causal=True)
    assert out.grad_fn is not None and "SageAttnFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    _assert_close_grads(got, want, cos_min=0.999)


def test_bias_at_hd256_takes_exact_recompute():
    """A trainable per-head bias with a window at 256 (the JAX package sends
    a bias with a window to its exact VJP, and so does the port): exact
    recompute, whose gradients are exact attention's with the bias and the
    band."""
    s, d, w = 130, 256, 50
    q, k, v, do = (_rand(1, (1, 2, s, d)), _rand(2, (1, 2, s, d)), _rand(3, (1, 2, s, d)),
                   _rand(4, (1, 2, s, d)))
    bias = _rand(5, (1, 2, s, s), scale=0.5)
    xs = [_t(x, True) for x in (q, k, v, bias)]
    out = sageattn(*xs[:3], attn_bias=xs[3], is_causal=True, window=w)
    assert "RecomputeFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, xs, _t(do))
    xr = [_t(x, True) for x in (q, k, v, bias)]
    o_r = autodiff._exact_attention(*xr, is_causal=True, sm_scale=None, window=w,
                                    return_lse=False)
    want = torch.autograd.grad(o_r, xr, _t(do))
    for g, w_ in zip(got, want):
        assert cosine_similarity(g, w_) >= 0.99999


@pytest.mark.parametrize("d,causal", [(256, True), (256, False), (192, True)])
def test_bias_at_hd256_takes_the_fused_route(d, causal):
    """A trainable per-head [b, hq, sq, sk] bias at 256 (and 192, padded)
    takes ``SageAttnFunction`` and the backward's bias instances at 256; its
    four gradients against the JAX fused bias VJP (Pallas in interpret
    mode) on the forward of ``_sageattn_hnd(impl="pallas")``, whole 128
    tiles as that backward takes: cosine >= 0.99999 and max-abs <= 5e-3 of
    the largest entry (``tests/test_torch_bias_grad.py``'s bound), with a
    row biased to -inf on every key giving 0 in its dq and dBias."""
    from test_torch_bias_grad import _assert_close, _grads, _inputs, _jax_fused_bias_vjp

    q, k, v, do, bias = _inputs(1, 2, 1, 256, 256, d, seed=d + causal)
    bias[0, 1, 9] = -np.inf
    want = _jax_fused_bias_vjp(q, k, v, do, bias, causal=causal)
    assert want is not None
    got, fn = _grads(q, k, v, do, bias, is_causal=causal)
    assert fn == "SageAttnFunctionBackward"
    _assert_close(got, want, cos_min=0.99999, rel_max=5e-3)
    assert (got[0][0, 1, 9] == 0).all() and (got[3][0, 1, 9] == 0).all()


# --------------------------------------------------------------------------
# decode (kernels 9-12)
# --------------------------------------------------------------------------


def _cache(rng, lead, S, d, packed):
    rows = S // 2 if packed else S
    lo, hi = (-128, 128) if packed else (-127, 128)
    k = rng.integers(lo, hi, (*lead, rows, d)).astype(np.int8)
    v = rng.integers(lo, hi, (*lead, rows, d)).astype(np.int8)
    ks = (rng.random((*lead, S)) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random((*lead, S)) * 0.05 + 0.01).astype(np.float32)
    return k, ks, v, vs


def _compare_decode(res_t, res_j):
    np.testing.assert_allclose(res_t[0].float().numpy(), np.asarray(res_j[0], np.float32),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(res_t[1].numpy(), np.asarray(res_j[1]))
    np.testing.assert_allclose(res_t[2].numpy(), np.asarray(res_j[2]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", [
    # b, hq, hkv, t_q, S, d, lengths, chunk, window, packed
    (2, 2, 2, 1, 512, 256, [300, 200], 128, None, False),
    (2, 4, 2, 3, 512, 256, [512, 129], 256, None, True),
    (2, 2, 1, 1, 1024, 256, [1000, 37], 4096, 200, False),
    (2, 4, 2, 2, 512, 192, [400, 7], 128, 100, True),
], ids=lambda c: f"tq{c[3]}-d{c[5]}-w{c[8]}-{'int4' if c[9] else 'int8'}")
def test_dense_decode_plain_matches_pallas_hd256(case):
    b, hq, hkv, t_q, S, d, lengths, chunk, window, packed = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q = rng.standard_normal((b, hq, t_q, d)).astype(np.float32)
    k, ks, v, vs = _cache(rng, (b, hkv), S, d, packed)
    L = np.array(lengths, np.int32)
    res_j = decode_pallas.sage_decode_attention(
        *(jnp.array(x) for x in (q, k, ks, v, vs, L)), chunk=chunk, window=window,
        return_state=True, interpret=True)
    res_t = decode_cuda.sage_decode_attention(
        *(torch.tensor(x) for x in (q, k, ks, v, vs, L)), chunk=chunk, window=window,
        return_state=True)
    _compare_decode(res_t, res_j)


@pytest.mark.parametrize("window,packed", [(None, False), (40, True)])
def test_paged_decode_plain_matches_pallas_hd256(window, packed):
    b, hq, hkv, t_q, page, pool, max_pages, d = 2, 4, 2, 1, 16, 40, 20, 256
    rng = np.random.default_rng(7 + int(packed))
    q = rng.standard_normal((b, hq, t_q, d)).astype(np.float32)
    k, ks, v, vs = _cache(rng, (pool, hkv), page, d, packed)
    table = rng.permutation(pool)[:b * max_pages].reshape(b, max_pages).astype(np.int32)
    args = (q, k, ks, v, vs, table, np.array([300, 17], np.int32))
    res_j = paged_decode_pallas.sage_paged_decode_attention(
        *(jnp.array(x) for x in args), window=window, return_state=True, interpret=True)
    res_t = decode_cuda.sage_paged_decode_attention(
        *(torch.tensor(x) for x in args), window=window, return_state=True)
    _compare_decode(res_t, res_j)


# --------------------------------------------------------------------------
# the slice as a whole: a CausalLM at head dim 256 against flax
# --------------------------------------------------------------------------

PROMPT, STEPS, PAGE, MAX_LEN = 16, 3, 16, 64


def _tiny(cfgs):
    return cfgs["llm-8b-gqa"].scaled(depth=2, hidden=256, heads=2, kv_heads=1, head_dim=256,
                                     vocab=128, mlp_hidden=256)


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_causal_lm_hd256_matches_flax(cache):
    prev_j, prev_t = jmodels.get_attention_backend(), models.get_attention_backend()
    jmodels.set_attention_backend("reference")
    models.set_attention_backend("reference")
    try:
        jm = jmodels.CausalLM(_tiny(J_CONFIGS), dtype=jnp.float32)
        toks = np.random.default_rng(0).integers(0, 128, (2, PROMPT + STEPS)).astype(np.int32)
        params = jm.init(jax.random.PRNGKey(1), jnp.array(toks[:, :8]))
        sd = llm_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
        tm = generate.load_llm(_tiny(models.MODEL_CONFIGS), device="cpu", state_dict=sd,
                               dtype=torch.float32)
        b = toks.shape[0]
        if cache == "paged":
            table = np.random.default_rng(2).permutation(b * MAX_LEN // PAGE).reshape(b, -1)
            jc = jm.init_paged_caches(b, MAX_LEN, page_size=PAGE, page_table=jnp.array(table))
            tc = tm.init_paged_caches(b, MAX_LEN, page_size=PAGE,
                                      page_table=torch.tensor(table, dtype=torch.int32))
        else:
            jc, tc = jm.init_caches(b, MAX_LEN), tm.init_caches(b, MAX_LEN)
        jl, tl = jnp.zeros((b,), jnp.int32), torch.zeros(b, dtype=torch.int32)
        with torch.inference_mode():
            for s, n, dec in [(0, PROMPT, False)] + [(PROMPT + i, 1, True) for i in range(STEPS)]:
                jlog, jc = jm.apply(params, jnp.array(toks[:, s:s + n]), caches=jc, lengths=jl,
                                    decode=dec)
                tlog, tc = tm(torch.tensor(toks[:, s:s + n]), caches=tc, lengths=tl, decode=dec)
                j = torch.tensor(np.asarray(jlog, np.float32))
                assert cosine_similarity(tlog, j) >= 0.99999
                assert ((tlog - j).abs().max() / j.abs().max()).item() <= 5e-3
                jl, tl = jl + n, tl + n
    finally:
        jmodels.set_attention_backend(prev_j)
        models.set_attention_backend(prev_t)


def test_generate_hd256_on_cpu():
    """``generate`` at head dim 256 (the "sage" prefill through the forward
    at 256, decode through kernel 9's plain version) against an exact
    refeed of the generated sequence: cosine >= 0.999."""
    cfg = _tiny(models.MODEL_CONFIGS)
    model = generate.load_llm(cfg, device="cpu", seed=3, dtype=torch.float32)
    prompt = torch.tensor(np.random.default_rng(4).integers(0, 128, (2, PROMPT)))
    prev = models.get_attention_backend()
    models.set_attention_backend("sage")
    try:
        out = generate.generate(model, prompt, 4, max_len=MAX_LEN)
        seq = torch.cat([prompt, out["tokens"][:, :-1]], dim=1)
        models.set_attention_backend("reference")
        with torch.inference_mode():
            ref = model(seq)[:, PROMPT - 1:]
    finally:
        models.set_attention_backend(prev)
    assert torch.equal(ref[:, 0].argmax(dim=-1), out["tokens"][:, 0])
    assert cosine_similarity(out["logits"][:, -1], ref[:, -1]) >= 0.999


# --------------------------------------------------------------------------
# the limits
# --------------------------------------------------------------------------


def test_limits_above_256_and_qk_options_above_128_raise():
    """Head dims above 512 raise naming ROADMAP, with the Q/K options too
    (above 256 they compute since the wide instances, tests/test_torch_hd512.py:
    d 320 runs forward and, by exact recompute, backward); the options run
    at 256, forward and (exact recompute) backward.  Decode takes every head
    dim up to 512 (272 too, which is not a multiple of 16) and refuses
    those above naming ROADMAP."""
    x = torch.zeros(1, 1, 128, 640)
    for grad in (False, True):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sageattn(x.clone().requires_grad_(grad), x, x)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sageattn(x.clone().requires_grad_(grad), x, x, smooth_q=True)
    for d in (256, 320):
        y = torch.randn(1, 1, 128, d, generator=torch.Generator().manual_seed(3))
        for opts in ({"smooth_q": True}, {"qk_bits": 4}, {"qk_quant_gran": "per_block"}):
            assert sageattn(y, y, y, **opts).shape == y.shape
            yg = y.clone().requires_grad_()
            out = sageattn(yg, y, y, **opts)
            assert type(out.grad_fn).__name__ == "RecomputeFunctionBackward"
            (g,) = torch.autograd.grad(out.sum(), yg)
            assert g.shape == y.shape and bool(torch.isfinite(g).all())
    qf, _ = decode_cuda._device_args(torch.zeros(1, 1, 1, 272), torch.zeros(1))
    assert qf.shape == (1, 1, 1, 272)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_cuda._device_args(torch.zeros(1, 1, 1, 640), torch.zeros(1))
