"""Head dims above 256 in the port, on the CPU: its plain versions at head
dims 384 and 512 (and the padded 320) against the JAX package, from the
same numpy inputs.  The JAX package pads a head dim above 64 to the next
multiple of 128 (``core.py:70-75``), and so does the port, up to 512.

* Quantizers: kernels 2-4 (the K and Q quantizers) and 5-6 (the V
  quantizers) at d 384 and 512 against the Pallas quantizers in interpret
  mode: bit-exact (codes compared as bytes), as at 64, 128 and 256.
* Attention: the plain forward against ``sage_attention_fused`` in
  interpret mode on the same quantized operands, at d 320 (padded to 384),
  384 and 512, bf16, int8 and fp8 V, causal and not: o cosine >= 0.9999
  and max-abs <= 2e-2 (the Pallas kernel rounds P to bf16 before P.V),
  base-2 LSE within 1e-3.  The masked plain path with a window and the
  pre-quantized one with smooth_q's column bias and +-7 codes at 512 the
  same way (the Pallas ``qk_int4`` operand type has no CPU path; its
  numbers are those of the same +-7 codes in the int8 product).
* The plain versions at d 384 and 512 at ragged lengths (sq 200 / sk
  129), causal and not: bf16 V and e4m3 codes, and the pre-quantized one
  with per-row K scales and a column bias, against the Pallas kernel in
  interpret mode at the tolerance above.
* ``sageattn`` at d 320 and 512 against ``core._sageattn_hnd(impl="xla",
  chunk_k=128)`` (fp32 inputs; with K smoothing a K code may move a step,
  the two means summed in other orders: cosine >= 0.99999, max-abs <=
  5e-3, LSE within 1e-3) and against exact attention (cosine >= 0.999);
  the fp8 variant, a window, varlen and the Q/K options at 512 too.
* The gradient at d 320: exact recompute (``RecomputeFunction``, no fused
  backward, whose kernels have no instance above 256, as the JAX fused
  backward declines d > 256) against ``jax.vjp`` of exact attention:
  cosine >= 0.999.
* Decode: kernels 9-12's plain versions against ``decode_pallas`` /
  ``paged_decode_pallas`` in interpret mode at d 384 and 512, int8 and
  packed int4, windowed or not: m bit-exact, o within 1e-5, l 1e-6
  relative (``tests/test_torch_decode.py``'s tolerances).
* The limit: head dims above 512 raise naming the ROADMAP row.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu import quant as jquant
from sageattention_tpu.ops import attention_pallas, decode_pallas, paged_decode_pallas
from sageattention_tpu.ops import quant_pallas
from sageattention_tpu.ops import reference as jreference
from sageattention_tpu_torch import core, sageattn, sageattn_qk_int8_pv_fp8, sageattn_varlen
from sageattention_tpu_torch.ops import _build, attention_cuda, autodiff, decode_cuda, quant_cuda
from sageattention_tpu_torch.ops.attention_cuda import Masks
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


def test_pad_head_dim_follows_the_jax_rule_up_to_512():
    """64, then the next multiple of 128, up to 512; above it the op raises
    naming the ROADMAP row."""
    for d in (257, 300, 320, 383, 384, 385, 448, 511, 512):
        assert _build.pad_head_dim(d) == jcore._pad_head_dim(d), d
    y = torch.zeros(1, 1, 64, 520)
    with pytest.raises(NotImplementedError, match="ROADMAP: limits, head dims above 512"):
        sageattn(y, y, y)


# --------------------------------------------------------------------------
# quantizers (kernels 2-6)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("d", [384, 512])
def test_k_quantizers_bit_exact_wide(d, bits):
    """Kernel 3 with the JAX km is bit-exact with the Pallas kernel; kernel
    2's km agrees to 1e-6 relative and its codes within a step on <= 1e-3
    of the entries (the mean summed in another order)."""
    s = 256
    k = torch.from_numpy(_rand(d, (1, 2, s, d), scale=2.0)
                         + _rand(d + 1, (1, 2, 1, d), scale=3.0)).to(torch.bfloat16)
    k_j = jnp.asarray(k.float().numpy()).astype(jnp.bfloat16)
    km_j = jnp.mean(k_j.astype(jnp.float32), axis=-2)
    q_j, s_j = quant_pallas.quant_k_chunked(k_j, km_j, group=G, bits=bits, interpret=True)
    q_t, s_t = quant_cuda.quant_k_chunked(k, torch.from_numpy(np.array(km_j)), group=G,
                                          bits=bits)
    _eq(q_t, q_j)
    _eq(s_t, s_j)
    q_f, s_f, km_f = quant_pallas.quant_k_fused_mean(k_j, group=G, bits=bits, interpret=True)
    q_t, s_t, km_t = quant_cuda.quant_k_fused_mean(k, group=G, bits=bits)
    np.testing.assert_allclose(km_t.numpy(), np.asarray(km_f), rtol=1e-6, atol=1e-7)
    diff = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_f).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_f), rtol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [384, 512])
def test_quant_q_bit_exact_wide(d, dtype, bits):
    """Kernel 4 against the Pallas ``quant_q_per_token`` in interpret mode
    and the JAX spec: the same codes and folded scales."""
    x = _rand(d + bits, (2, 3, 77, d), scale=3.0)
    x[0, 0, 0] = 0.0  # the 1e-30 floor
    jx = jnp.asarray(x).astype(dtype)
    fold = d**-0.5 * LOG2E
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    q_t, s_t = quant_cuda.quant_q_per_token(tx, scale_fold=fold, bits=bits)
    q_j, s_j = jquant.quant_int8(jx, granularity="per_token", scale_fold=fold, bits=bits)
    _eq(q_t, q_j)
    _eq(s_t, s_j)
    q_p, _ = quant_pallas.quant_q_per_token(jx, scale_fold=fold, bits=bits, interpret=True)
    _eq(q_t, q_p)


@pytest.mark.parametrize("code", sorted(V_CODES))
@pytest.mark.parametrize("kernel", ["single_pass", "blocked"])
@pytest.mark.parametrize("d", [384, 512])
def test_v_quantizers_bit_exact_wide(d, kernel, code):
    """Kernels 5 and 6 without smooth-v: codes and scales bit-exact with
    the Pallas kernels; kernel 6 over several of its 512-row blocks, whose
    wide statistics combine more row groups than a warp holds."""
    jdt, tdt = V_CODES[code]
    s = 200 if kernel == "single_pass" else 1100
    x = _rand(s + d, (1, 2, s, d)) + _rand(s + d + 1, (1, 2, 1, d), scale=3.0)
    if kernel == "single_pass":
        want = quant_pallas.quant_v_per_channel(jnp.asarray(x), dtype=jdt, interpret=True)
        got = quant_cuda.quant_v_per_channel(torch.from_numpy(x), dtype=tdt)
    else:
        want = quant_pallas._quant_v_blocked(jnp.asarray(x), dtype=jdt, smooth=False,
                                             interpret=True)
        got = quant_cuda.quant_v_blocked(torch.from_numpy(x), dtype=tdt, smooth=False)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_v_quantizer_pads_320_to_384():
    """A d-320 V is quantized before padding: its 64 pad channels get code 0
    and the first 320 the codes of the unpadded V."""
    x = torch.from_numpy(_rand(5, (1, 2, 200, 320)))
    q, sc, _ = quant_cuda.quant_v_per_channel(x, dtype=torch.int8, d_pad=384)
    q_j, s_j, _ = jquant.per_channel_quant(jnp.asarray(x.numpy()), dtype=jnp.int8)
    assert q.shape == (1, 2, 200, 384)
    _eq(q[..., :320], q_j)
    _eq(sc[..., :320], s_j)
    assert not q[..., 320:].any()


# --------------------------------------------------------------------------
# attention (kernel 1)
# --------------------------------------------------------------------------


def _k_codes(k, bits=8):
    km = jnp.mean(jnp.asarray(k), axis=-2)
    return quant_pallas.quant_k_chunked(jnp.asarray(k), km, group=G, bits=bits, interpret=True)


def _v_operands(v, pv):
    """(V for the JAX kernel, its extra operands, V for the port, v_scale)."""
    if pv == "bf16":
        v_j = jnp.asarray(v).astype(jnp.bfloat16)
        return v_j, (), torch.from_numpy(np.array(v_j.astype(jnp.float32))).to(torch.bfloat16), None
    v_j, v_scale, _ = jquant.per_channel_quant(jnp.asarray(v), dtype=V_CODES[pv][0])
    v_t = torch.from_numpy(_bytes(v_j).copy()).view(V_CODES[pv][1])
    return v_j, (v_scale,), v_t, torch.from_numpy(np.array(v_scale))


def _fused(q, q_scale, k_i8, k_scale, v_j, extra, *, causal, pv, **kw):
    return attention_pallas.sage_attention_fused(
        q, q_scale, jnp.asarray(k_i8), jnp.asarray(k_scale), v_j, *extra, is_causal=causal,
        pv_dtype=pv, return_lse=True, block_q=128, block_k=128, sub_q=128, chunk_k=G,
        out_dtype=jnp.float32, interpret=True, **kw)


def _close_kernel(o_t, l_t, o_j, l_j):
    live = np.isfinite(np.asarray(l_j))
    assert cosine_similarity(o_t, np.asarray(o_j)) >= 0.9999
    np.testing.assert_allclose(o_t.float().numpy(), np.asarray(o_j), atol=2e-2)
    np.testing.assert_allclose(l_t.numpy()[live], np.asarray(l_j)[live], atol=1e-3)


@pytest.mark.parametrize("pv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("d,causal", [(320, True), (384, False), (512, True), (512, False)])
def test_plain_attention_matches_pallas_wide(d, causal, pv):
    """At d 320 both sides take the operands zero-padded to 384, as both
    packages' ops pad them."""
    b, hq, hkv, s = 1, 4, 2, 128
    d_pad = _build.pad_head_dim(d)
    pad = ((0, 0),) * 3 + ((0, d_pad - d),)
    q, k, v = (np.pad(_rand(d + i, (b, h, s, d)), pad) for i, h in ((0, hq), (1, hkv), (2, hkv)))
    k_i8, k_scale = (np.array(x) for x in _k_codes(k))
    fold = d**-0.5 * LOG2E
    v_j, extra, v_t, vs_t = _v_operands(v, pv)
    o_j, l_j = _fused(jnp.asarray(q), None, k_i8, k_scale, v_j, extra, causal=causal, pv=pv,
                      q_fold=fold)
    o_t, l_t = attention_cuda.sage_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k_i8), torch.from_numpy(k_scale), v_t, vs_t,
        is_causal=causal, q_fold=fold, return_lse=True)
    assert o_t.shape == (b, hq, s, d_pad)
    _close_kernel(o_t, l_t, o_j, l_j)


@pytest.mark.parametrize("pv", ["bf16", "int8"])
def test_masked_plain_matches_pallas_hd512(pv):
    """The masked instantiation's plain version with a sliding window, GQA."""
    b, hq, hkv, s, d, w = 1, 4, 2, 256, 512, 100
    q, k, v = _rand(41, (b, hq, s, d)), _rand(42, (b, hkv, s, d), 0.5), _rand(43, (b, hkv, s, d))
    k_i8, k_scale = (np.array(x) for x in _k_codes(k))
    fold = d**-0.5 * LOG2E
    v_j, extra, v_t, vs_t = _v_operands(v, pv)
    o_j, l_j = _fused(jnp.asarray(q), None, k_i8, k_scale, v_j, extra, causal=True, pv=pv,
                      q_fold=fold, window=w)
    o_t, l_t = attention_cuda.sage_attention_fwd_masked(
        torch.from_numpy(q), torch.from_numpy(k_i8), torch.from_numpy(k_scale), v_t, vs_t,
        masks=Masks(window=w), is_causal=True, q_fold=fold, return_lse=True)
    _close_kernel(o_t, l_t, o_j, l_j)


@pytest.mark.parametrize("bits,window", [(8, None), (4, None), (4, 100)])
def test_preq_plain_matches_pallas_hd512(bits, window):
    """The pre-quantized instantiation's plain version: per-row Q codes
    (+-7 at 4 bits) with sm_scale*log2(e) in their scales, smooth_q's
    column bias, per-tile K scales, causal, with a window or not."""
    b, hq, hkv, s, d = 1, 4, 2, 256, 512
    q, k, v = _rand(51, (b, hq, s, d)), _rand(52, (b, hkv, s, d), 0.5), _rand(53, (b, hkv, s, d))
    q_i8, q_sc = jquant.quant_int8(jnp.asarray(q), scale_fold=d**-0.5 * LOG2E, bits=bits)
    k_i8, k_sc = (np.array(x) for x in _k_codes(k, bits))
    cb = _rand(54, (b, hq, s), scale=0.5)
    v_j, extra, v_t, _ = _v_operands(v, "bf16")
    o_j, l_j = _fused(q_i8, q_sc, k_i8, k_sc, v_j, extra, causal=True, pv="bf16",
                      score_col_bias=jnp.asarray(cb), window=window)
    o_t, l_t = attention_cuda.sage_attention_fwd_preq(
        torch.from_numpy(np.array(q_i8)), torch.from_numpy(np.array(q_sc)),
        torch.from_numpy(k_i8), torch.from_numpy(k_sc), v_t, is_causal=True, return_lse=True,
        out_dtype=torch.float32, col_bias=torch.from_numpy(cb),
        masks=Masks(window=window) if window else None)
    _close_kernel(o_t, l_t, o_j, l_j)


# ragged lengths at the wide head dims: sq not a multiple of the wide kernel's
# 64-row Q tile, sk not one of its KV tiles, sq > sk
RAGGED_SHAPE = (1, 2, 1, 200, 129)  # b, hq, hkv, sq, sk


def _ragged_operands(d, seed, pv):
    """Q, K codes with per-tile scales and V (bf16 or e4m3 codes) at
    RAGGED_SHAPE and head dim d."""
    b, hq, hkv, sq, sk = RAGGED_SHAPE
    rng = np.random.default_rng(seed)
    q = _rand(seed, (b, hq, sq, d))
    k_i8 = rng.integers(-127, 128, (b, hkv, sk, d), dtype=np.int8)
    k_scale = (rng.random((b, hkv, -(-sk // G))) + 0.5).astype(np.float32) * 2e-2
    return q, k_i8, k_scale, _v_operands(_rand(seed + 1, (b, hkv, sk, d)), pv)


def _pad_rows(x, n, axis=2, value=0):
    pad = [(0, 0)] * np.ndim(x)
    pad[axis] = (0, n - np.shape(x)[axis])
    return np.pad(np.asarray(x), pad, constant_values=value)


def _fused_ragged(q, q_scale, k_i8, k_scale, v_j, extra, *, causal, pv, **kw):
    """The Pallas kernel at RAGGED_SHAPE's lengths: Q and K/V padded to one
    256-row block each, the padded keys masked by ``kv_live`` (one KV
    step), the padded rows cropped."""
    sq, sk, n = RAGGED_SHAPE[3], RAGGED_SHAPE[4], 256
    v_pad = jnp.pad(v_j, ((0, 0), (0, 0), (0, n - sk), (0, 0)))
    o, lse = attention_pallas.sage_attention_fused(
        jnp.asarray(_pad_rows(q, n)), None if q_scale is None else jnp.asarray(_pad_rows(
            q_scale, n, value=1.0)), jnp.asarray(_pad_rows(k_i8, n)),
        jnp.asarray(k_scale), v_pad, *extra, is_causal=causal, pv_dtype=pv, return_lse=True,
        block_q=128, block_k=n, sub_q=128, chunk_k=G, kv_live=sk, out_dtype=jnp.float32,
        interpret=True, **kw)
    return o[:, :, :sq], lse[:, :, :sq]


@pytest.mark.parametrize("pv", ["bf16", "fp8"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [384, 512])
def test_ragged_plain_matches_pallas_wide(d, causal, pv):
    """The forward's plain version at RAGGED_SHAPE agrees with the Pallas
    kernel (interpret mode) at ``test_plain_attention_matches_pallas_wide``'s
    tolerance."""
    q, k_i8, k_scale, (v_j, extra, v_t, vs_t) = _ragged_operands(d, d + causal, pv)
    fold = d**-0.5 * LOG2E
    o_t, l_t = attention_cuda.sage_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k_i8), torch.from_numpy(k_scale), v_t, vs_t,
        is_causal=causal, q_fold=fold, return_lse=True)
    o_j, l_j = _fused_ragged(q, None, k_i8, k_scale, v_j, extra, causal=causal, pv=pv,
                             q_fold=fold)
    _close_kernel(o_t, l_t, o_j, l_j)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [384, 512])
def test_ragged_preq_plain_matches_pallas_wide(d, causal):
    """The same for the pre-quantized forward, with per-row K scales and
    smooth_q's column bias."""
    b, hq, hkv, sq, sk = RAGGED_SHAPE
    q, k_i8, _, (v_j, extra, v_t, _) = _ragged_operands(d, d + 7 + causal, "bf16")
    q_i8, q_sc = jquant.quant_int8(jnp.asarray(q), scale_fold=d**-0.5 * LOG2E)
    ks = (np.random.default_rng(d).random((b, hkv, sk)) + 0.5).astype(np.float32) * 2e-2
    cb = _rand(d + 9, (b, hq, sk), scale=0.5)
    o_t, l_t = attention_cuda.sage_attention_fwd_preq(
        torch.from_numpy(np.array(q_i8)), torch.from_numpy(np.array(q_sc)),
        torch.from_numpy(k_i8), torch.from_numpy(ks), v_t, is_causal=causal, return_lse=True,
        out_dtype=torch.float32, col_bias=torch.from_numpy(cb))
    o_j, l_j = _fused_ragged(q_i8, q_sc, k_i8, jnp.asarray(_pad_rows(ks, 256, value=1.0)), v_j,
                             extra, causal=causal, pv="bf16",
                             score_col_bias=jnp.asarray(_pad_rows(cb, 256)))
    _close_kernel(o_t, l_t, o_j, l_j)


def _jax_sageattn(q, k, v, *, causal, smooth_k=True, pv_dtype="bf16", window=None, **opts):
    return jcore._sageattn_hnd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None, None, None, None,
        impl="xla", chunk_k=G, qk_quant_gran=opts.get("qk_quant_gran", "auto"),
        pv_dtype=pv_dtype, smooth_k=smooth_k, smooth_v=False, return_lse=True,
        is_causal=causal, sm_scale=None, block_q=128, block_k=128, window=window,
        **{n: x for n, x in opts.items() if n != "qk_quant_gran"})


def _assert_close_o(o_t, lse_t, o_j, lse_j, smooth_k):
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    if smooth_k:
        assert cosine_similarity(o_t, o_j) >= 0.99999
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=5e-3)
        np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-3)
    else:
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=1e-5)
        np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-4)


SAGE_CASES = {
    # name: (b, hq, hkv, sq, sk, d, causal)
    "d512": (1, 2, 2, 256, 256, 512, False),
    "d512_gqa_causal_ragged": (1, 4, 2, 200, 200, 512, True),
    "d320_rectangular": (1, 2, 1, 130, 333, 320, False),
    "d320_causal": (1, 2, 2, 150, 150, 320, True),
}


@pytest.mark.parametrize("smooth_k", [False, True])
@pytest.mark.parametrize("name", sorted(SAGE_CASES))
def test_sageattn_matches_jax_wide(name, smooth_k):
    """The op against the JAX op, and against exact fp32 attention."""
    b, hq, hkv, sq, sk, d, causal = SAGE_CASES[name]
    seed = zlib.crc32(name.encode())
    q, k, v = (_rand(seed, (b, hq, sq, d)), _rand(seed + 1, (b, hkv, sk, d), 0.5),
               _rand(seed + 2, (b, hkv, sk, d)))
    o_t, lse_t = sageattn(_t(q), _t(k), _t(v), is_causal=causal, return_lse=True,
                          smooth_k=smooth_k)
    o_j, lse_j = _jax_sageattn(q, k, v, causal=causal, smooth_k=smooth_k)
    assert o_t.shape == (b, hq, sq, d) and o_t.dtype == torch.float32
    _assert_close_o(o_t, lse_t, o_j, lse_j, smooth_k)
    rep = hq // hkv
    o_x = jreference.attention_reference(jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=1),
                                         jnp.repeat(jnp.asarray(v), rep, axis=1),
                                         is_causal=causal)
    assert cosine_similarity(o_t, np.asarray(o_x)) >= 0.999


def test_fp8_variant_and_window_match_jax_hd512():
    shape = (1, 2, 256, 512)
    q, k, v = _rand(1, shape), _rand(2, shape, 0.5), _rand(3, shape)
    o_t, lse_t = sageattn_qk_int8_pv_fp8(_t(q), _t(k), _t(v), is_causal=True, return_lse=True)
    o_j, lse_j = _jax_sageattn(q, k, v, causal=True, pv_dtype="fp8")
    _assert_close_o(o_t, lse_t, o_j, lse_j, smooth_k=True)
    o_t, lse_t = sageattn(_t(q), _t(k), _t(v), is_causal=True, return_lse=True, window=100,
                          smooth_k=False)
    o_j, lse_j = _jax_sageattn(q, k, v, causal=True, smooth_k=False, window=100)
    _assert_close_o(o_t, lse_t, o_j, lse_j, smooth_k=False)


@pytest.mark.parametrize("smooth_k", [False, True])
def test_varlen_matches_jax_hd512(smooth_k):
    """Four packed prompts at 512, int8 V (varlen's default); with the
    global K mean a K code may move a step, as in the op's cases."""
    lens = [128, 200, 56]
    rng = np.random.default_rng(512)
    tot, d = sum(lens), 512
    q = rng.standard_normal((tot, 4, d)).astype(np.float32)
    k = (rng.standard_normal((tot, 2, d)) + 0.5).astype(np.float32)
    v = rng.standard_normal((tot, 2, d)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    o_t, lse_t = sageattn_varlen(*(torch.from_numpy(x) for x in (q, k, v, cu, cu)),
                                 is_causal=True, return_lse=True, smooth_k=smooth_k)
    o_j, lse_j = jcore.sageattn_varlen(*(jnp.asarray(x) for x in (q, k, v, cu, cu)),
                                       is_causal=True, return_lse=True, impl="xla",
                                       block_q=128, block_k=128, smooth_k=smooth_k)
    _assert_close_o(o_t, lse_t, o_j, lse_j, smooth_k)


@pytest.mark.parametrize("opts", [dict(smooth_q=True), dict(qk_bits=4),
                                  dict(qk_quant_gran="per_block")],
                         ids=["smooth_q", "int4", "per_block"])
def test_qk_options_match_jax_hd512(opts):
    """The Q/K options at 512, K smoothing off (its mean is summed in
    another order): without a mean to take, the same codes; with smooth_q's
    qm a code may move a step (``tests/test_torch_qopts.py``'s bounds)."""
    shape = (1, 2, 200, 512)
    q, k, v = _rand(61, shape), _rand(62, shape, 0.5), _rand(63, shape)
    o_t, lse_t = sageattn(_t(q), _t(k), _t(v), is_causal=True, return_lse=True, smooth_k=False,
                          **opts)
    o_j, lse_j = _jax_sageattn(q, k, v, causal=True, smooth_k=False, **opts)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    if opts.get("smooth_q"):
        assert cosine_similarity(o_t, o_j) >= 0.99999
        assert np.abs(o_t.numpy() - o_j).max() <= 5e-3
        np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-3)
    else:
        np.testing.assert_allclose(o_t.numpy(), o_j, atol=1e-5)
        np.testing.assert_allclose(lse_t.numpy(), lse_j, atol=1e-4)


# --------------------------------------------------------------------------
# the gradient: exact recompute above 256
# --------------------------------------------------------------------------


def _exact_vjp(q, k, v, do, causal):
    rep = q.shape[1] // k.shape[1]

    def exact(q, k, v):
        return jreference.attention_reference(q, jnp.repeat(k, rep, axis=1),
                                              jnp.repeat(v, rep, axis=1), is_causal=causal)

    _, vjp = jax.vjp(exact, *(jnp.asarray(x) for x in (q, k, v)))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("causal", [True, False])
def test_grads_at_d320_take_exact_recompute(monkeypatch, causal):
    """At d 320 (padded to 384) the call takes ``RecomputeFunction`` and
    never reaches the fused backward (kernels 7-8), as the JAX package
    sends d > 256 to its exact VJP; the gradients match ``jax.vjp`` of
    exact attention."""
    s, d = 150, 320
    q, k, v, do = (_rand(71, (1, 4, s, d)), _rand(72, (1, 2, s, d), 0.5),
                   _rand(73, (1, 2, s, d)), _rand(74, (1, 4, s, d)))

    def refuse(*args, **kwargs):
        raise AssertionError("the fused backward ran at d 320")

    monkeypatch.setattr(autodiff, "quantized_attention_vjp", refuse)
    qt, kt, vt = (_t(x, True) for x in (q, k, v))
    out = sageattn(qt, kt, vt, is_causal=causal)
    assert type(out.grad_fn).__name__ == "RecomputeFunctionBackward"
    got = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    want = _exact_vjp(q, k, v, do, causal)
    for name, g, w in zip("qkv", got, want):
        assert cosine_similarity(g, np.asarray(w)) >= 0.999, name


# --------------------------------------------------------------------------
# decode (kernels 9-12)
# --------------------------------------------------------------------------


def _cache(rng, lead, S, d, packed):
    rows = S // 2 if packed else S
    lo, hi = (-128, 128) if packed else (-127, 128)  # a packed byte holds any two nibbles
    k = rng.integers(lo, hi, (*lead, rows, d)).astype(np.int8)
    v = rng.integers(lo, hi, (*lead, rows, d)).astype(np.int8)
    ks = (rng.random((*lead, S)) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random((*lead, S)) * 0.05 + 0.01).astype(np.float32)
    return k, ks, v, vs


def _compare_decode(res_t, res_j):
    o_t, o_j = res_t[0].float().numpy(), np.asarray(res_j[0], np.float32)
    np.testing.assert_allclose(o_t, o_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(res_t[1].numpy(), np.asarray(res_j[1]))
    np.testing.assert_allclose(res_t[2].numpy(), np.asarray(res_j[2]), rtol=1e-6, atol=0)


DECODE_CASES = [
    # d, b, hq, hkv, t_q, S, lengths, chunk, window, packed
    (384, 2, 4, 2, 1, 512, [300, 200], 128, None, False),
    (384, 2, 4, 2, 3, 512, [512, 129], 128, 200, True),
    (512, 2, 4, 4, 1, 512, [500, 37], 256, None, True),
    (512, 2, 4, 2, 2, 512, [400, 300], 128, 150, False),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"d{c[0]}-tq{c[4]}-w{c[8]}"
                         f"-{'int4' if c[9] else 'int8'}")
def test_dense_decode_plain_matches_pallas_wide(case):
    d, b, hq, hkv, t_q, S, lengths, chunk, window, packed = case
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


PAGED_CASES = [
    # d, b, hq, hkv, t_q, page, pool, max_pages, lengths, window, packed
    (384, 2, 4, 2, 1, 16, 40, 20, [300, 17], None, False),
    (512, 2, 4, 2, 2, 16, 40, 20, [300, 150], 64, True),
    (512, 2, 4, 4, 1, 32, 20, 10, [310, 99], None, False),
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: f"d{c[0]}-tq{c[4]}-w{c[9]}"
                         f"-{'int4' if c[10] else 'int8'}")
def test_paged_decode_plain_matches_pallas_wide(case):
    d, b, hq, hkv, t_q, page, pool, max_pages, lengths, window, packed = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q = rng.standard_normal((b, hq, t_q, d)).astype(np.float32)
    k, ks, v, vs = _cache(rng, (pool, hkv), page, d, packed)
    table = rng.permutation(pool)[:b * max_pages].reshape(b, max_pages).astype(np.int32)
    L = np.array(lengths, np.int32)
    args = (q, k, ks, v, vs, table, L)
    res_j = paged_decode_pallas.sage_paged_decode_attention(
        *(jnp.array(x) for x in args), window=window, return_state=True, interpret=True)
    res_t = decode_cuda.sage_paged_decode_attention(
        *(torch.tensor(x) for x in args), window=window, return_state=True)
    _compare_decode(res_t, res_j)


def test_decode_refuses_head_dims_above_512():
    q = torch.zeros(1, 2, 1, 520, device="meta")
    k = torch.zeros(1, 2, 64, 520, dtype=torch.int8, device="meta")
    ks = torch.zeros(1, 2, 64, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP: limits, head dims above 512"):
        decode_cuda._device_args(q, torch.zeros(1, dtype=torch.int32, device="meta"), k, ks)
