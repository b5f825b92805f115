"""The port's masked ``sageattn`` (segment ids, positions, bool masks,
additive bias, sliding window) against the JAX package's
``core._sageattn_hnd``, which normalises the masks the same way, on the CPU.

* Masks whose every row keeps a live key: against the XLA pipeline
  (``impl="xla"``, ``chunk_k`` the port's K-scale group), without K
  smoothing, so that both quantize the same inputs to the same codes (the
  two K means are summed in different orders and can move a K code by a
  step): o within atol 1e-5 and the LSE within 1e-4 (fp32 inputs), as in
  ``tests/test_torch_core.py``.
* Rows with no live key and the additive bias: against the Pallas kernel
  in interpret mode (``impl="pallas"``), whose rules the port follows: a
  dead row gives o = 0 and LSE -inf (the XLA path averages V instead),
  and the bias joins the dequantized base-2 scores (the XLA path runs a
  bias through exact attention).  The Pallas kernel rounds P to bf16
  before P.V, the plain version keeps fp32: o cosine >= 0.9999 and
  max-abs <= 2e-2 (``tests/test_torch_attention.py``'s limits); live LSE
  within 2e-3, where that file holds 1e-3: at head dim 64 the Pallas kernel
  takes the row sum from the bf16 P.V product (its ones lane), and a bias
  that peaks the softmax on a few keys keeps that rounding from averaging
  out; dead rows exactly 0 and -inf on both sides.
* The shape rules, the refusals and the kernel's tile-liveness table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu_torch import core, sageattn
from sageattention_tpu_torch.ops import attention_cuda, reference
from sageattention_tpu_torch.utils.compare import cosine_similarity

G = core.K_GROUP


def _jax(q, k, v, *, impl, causal=False, window=None, q_seg=None, kv_seg=None, q_pos=None,
         kv_pos=None, bias=None, mask=None, smooth_k=True):
    def j(x):
        return None if x is None else jnp.asarray(x)

    return jcore._sageattn_hnd(
        j(q), j(k), j(v), j(q_seg), j(kv_seg), j(q_pos), j(kv_pos), j(bias), j(mask),
        impl=impl, chunk_k=G, qk_quant_gran="auto", pv_dtype="bf16", smooth_k=smooth_k,
        smooth_v=False, return_lse=True, is_causal=causal, sm_scale=None, block_q=128,
        block_k=128, window=window)


def _port(q, k, v, *, causal=False, window=None, q_seg=None, kv_seg=None, q_pos=None,
          kv_pos=None, bias=None, mask=None, smooth_k=True):
    def t(x):
        return None if x is None else torch.from_numpy(np.asarray(x))

    return sageattn(t(q), t(k), t(v), is_causal=causal, return_lse=True, window=window,
                    q_segment_ids=t(q_seg), kv_segment_ids=t(kv_seg), q_positions=t(q_pos),
                    kv_positions=t(kv_pos), attn_bias=t(bias), attn_mask=t(mask),
                    smooth_k=smooth_k)


def _qkv(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            (rng.standard_normal((b, hkv, sk, d)) + 0.5).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _zigzag(s, parts=4):
    """Positions of a zig-zag ring split: chunk i and chunk 2n-1-i side by side."""
    chunks = np.array_split(np.arange(s), 2 * parts)
    order = [c for i in range(parts) for c in (chunks[i], chunks[2 * parts - 1 - i])]
    return np.concatenate(order).astype(np.int32)


def _live_cases():
    """name -> (shape (b, hq, hkv, sq, sk, d), causal, window, masks): every
    row keeps at least its diagonal key."""
    rng = np.random.default_rng(3)
    seg_rand = rng.integers(0, 3, (2, 200)).astype(np.int32)  # non-contiguous ids
    seg_sorted = np.sort(rng.integers(0, 4, (1, 384)), axis=-1).astype(np.int32)
    pos = _zigzag(256)[None]
    m2 = rng.random((200, 200)) > 0.5
    np.fill_diagonal(m2, True)
    m4 = rng.random((1, 4, 128, 128)) > 0.6
    m4[..., np.arange(128), np.arange(128)] = True
    pad = np.ones((2, 1, 1, 200), bool)
    pad[1, ..., 150:] = False  # key padding of the second sequence
    cpos = np.random.default_rng(4).permutation(200).astype(np.int32)[None]
    m_c = rng.random((1, 1, 200, 200)) > 0.3
    m_c[..., np.arange(200), np.arange(200)] = True
    return {
        "segments_noncontiguous": ((2, 4, 2, 200, 200, 64), False, None,
                                   dict(q_seg=seg_rand, kv_seg=seg_rand)),
        "segments_sorted_causal_d128": ((1, 4, 2, 384, 384, 128), True, None,
                                        dict(q_seg=seg_sorted, kv_seg=seg_sorted)),
        "positions_zigzag": ((1, 4, 2, 256, 256, 64), False, None, dict(q_pos=pos, kv_pos=pos)),
        "bool_mask_2d": ((1, 4, 2, 200, 200, 64), False, None, dict(mask=m2)),
        "bool_mask_per_head": ((1, 4, 2, 128, 128, 128), True, None, dict(mask=m4)),
        "key_padding": ((2, 4, 2, 128, 200, 64), False, None, dict(mask=pad)),
        "window_ragged": ((1, 4, 2, 200, 200, 64), True, 50, {}),
        "window_rectangular_d128": ((2, 2, 1, 128, 384, 128), True, 100, {}),
        "window_1": ((1, 2, 2, 128, 128, 64), True, 1, {}),
        "combined": ((1, 4, 2, 200, 200, 64), True, 64,
                     dict(q_seg=seg_rand[:1], kv_seg=seg_rand[:1], q_pos=cpos, kv_pos=cpos,
                          mask=m_c)),
    }


LIVE = _live_cases()


@pytest.mark.parametrize("name", sorted(LIVE))
def test_live_masks_match_jax_xla(name):
    shape, causal, window, masks = LIVE[name]
    q, k, v = _qkv(*shape, seed=len(name))
    o_t, lse_t = _port(q, k, v, causal=causal, window=window, smooth_k=False, **masks)
    o_j, lse_j = _jax(q, k, v, impl="xla", causal=causal, window=window, smooth_k=False,
                      **masks)
    b, hq, _, sq, _, d = shape
    assert o_t.shape == (b, hq, sq, d) and bool(torch.isfinite(lse_t).all())
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-4)


def _dead_cases():
    """name -> (shape, causal, masks): rows with no live key, and biases."""
    rng = np.random.default_rng(5)
    dead = rng.random((2, 1, 200, 384)) > 0.4
    dead[0, 0, [0, 17, 199]] = False  # padded query rows
    dead[1, 0, 64:128] = False        # a whole 64-row tile
    hq, s = 4, 256
    slopes = 2.0 ** (-8.0 * np.arange(1, hq + 1) / hq)
    dist = np.abs(np.arange(s)[:, None] - np.arange(s)[None, :])
    alibi = (-slopes[:, None, None] * dist)[None].astype(np.float32)
    inf_bias = rng.standard_normal((1, 1, 200, 200)).astype(np.float32)
    inf_bias[rng.random((1, 1, 200, 200)) > 0.7] = -np.inf
    inf_bias[0, 0, 33] = -np.inf  # a row whose every key is -inf
    mb = rng.random((1, hq, s, s)) > 0.2
    mb[0, :, 5] = False
    return {
        "bool_mask_dead_rows": ((2, 4, 2, 200, 384, 64), False, dict(mask=dead)),
        "alibi_bias": ((1, hq, 2, s, s, 64), False, dict(bias=alibi)),
        "alibi_bias_causal_d128": ((1, hq, 2, s, s, 128), True, dict(bias=alibi)),
        "bias_with_inf_rows": ((1, 4, 2, 200, 200, 64), False, dict(bias=inf_bias)),
        "mask_and_bias_causal": ((1, hq, 2, s, s, 64), True, dict(mask=mb, bias=alibi)),
    }


DEAD = _dead_cases()


@pytest.mark.parametrize("name", sorted(DEAD))
def test_dead_rows_and_bias_match_pallas(name):
    shape, causal, masks = DEAD[name]
    q, k, v = _qkv(*shape, seed=20 + len(name))
    o_t, lse_t = _port(q, k, v, causal=causal, **masks)
    o_j, lse_j = (np.asarray(x) for x in _jax(q, k, v, impl="pallas", causal=causal, **masks))
    o_t, lse_t = o_t.numpy(), lse_t.numpy()
    dead_j = np.isneginf(lse_j)
    np.testing.assert_array_equal(np.isneginf(lse_t), dead_j)
    assert (o_t[dead_j] == 0).all() and (o_j[dead_j] == 0).all()
    if "dead" in name or "inf" in name:
        assert dead_j.any()
    assert cosine_similarity(o_t, o_j) >= 0.9999
    np.testing.assert_allclose(o_t, o_j, atol=2e-2)
    np.testing.assert_allclose(lse_t[~dead_j], lse_j[~dead_j], atol=2e-3)


@pytest.mark.parametrize("name", ["alibi_bias_causal_d128", "combined"])
def test_masked_close_to_exact_attention(name):
    """The quantized masked op against exact fp32 attention with the same
    masks: cosine >= 0.999 (the verify skill's threshold)."""
    if name in LIVE:
        shape, causal, window, masks = LIVE[name]
    else:
        (shape, causal, masks), window = DEAD[name], None
    q, k, v = _qkv(*shape, seed=40)
    o_t, _ = _port(q, k, v, causal=causal, window=window, **masks)
    t = {n: None if x is None else torch.from_numpy(np.asarray(x)) for n, x in masks.items()}
    o_r = reference.attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), is_causal=causal, window=window,
        q_segment_ids=t.get("q_seg"), kv_segment_ids=t.get("kv_seg"),
        q_positions=t.get("q_pos"), kv_positions=t.get("kv_pos"), attn_mask=t.get("mask"),
        attn_bias=t.get("bias"))
    assert cosine_similarity(o_t, o_r) >= 0.999


def test_mask_shapes_broadcast_as_jax():
    """2-D, 3-D and 4-D masks, batch 1 against b, [b,1,1,sk] key padding:
    each equal to its expanded [b, hq, sq, sk] form; a float attn_mask is a
    bias, added to attn_bias."""
    b, hq, s = 2, 4, 128
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, hq, 2, s, s, 64, seed=9))
    rng = np.random.default_rng(9)
    m = torch.from_numpy(rng.random((s, s)) > 0.4)
    m.fill_diagonal_(True)

    def run(**kw):
        return sageattn(q, k, v, **kw)

    full = run(attn_mask=m.expand(b, hq, s, s))
    for form in (m, m[None], m[None, None], m.expand(b, 1, s, s)):
        torch.testing.assert_close(run(attn_mask=form), full, rtol=0, atol=0)
    pad = torch.ones(b, 1, 1, s, dtype=torch.bool)
    pad[0, ..., 100:] = False
    torch.testing.assert_close(run(attn_mask=pad), run(attn_mask=pad.expand(b, 1, s, s)),
                               rtol=0, atol=0)
    bias = torch.from_numpy(rng.standard_normal((1, hq, s, s)).astype(np.float32))
    extra = torch.from_numpy(rng.standard_normal((s, s)).astype(np.float32))
    torch.testing.assert_close(run(attn_mask=bias), run(attn_bias=bias), rtol=0, atol=0)
    torch.testing.assert_close(run(attn_mask=extra, attn_bias=bias),
                               run(attn_bias=bias + extra), rtol=0, atol=0)
    # a bf16 bias is read as it is: the same as its exact fp32 value
    bf = bias.to(torch.bfloat16)
    torch.testing.assert_close(run(attn_bias=bf), run(attn_bias=bf.float()), rtol=0, atol=0)


def test_masks_in_nhd_layout_equal_hnd():
    b, hq, s = 1, 4, 200
    q, k, v = (torch.from_numpy(x) for x in _qkv(b, hq, 2, s, s, 64, seed=10))
    seg = torch.from_numpy(np.sort(np.random.default_rng(10).integers(0, 3, (b, s)), -1))
    kw = dict(is_causal=True, window=70, q_segment_ids=seg, kv_segment_ids=seg,
              return_lse=True)
    o_h, l_h = sageattn(q, k, v, **kw)
    o_n, l_n = sageattn(*(x.transpose(1, 2) for x in (q, k, v)), tensor_layout="NHD", **kw)
    torch.testing.assert_close(o_n.transpose(1, 2), o_h, rtol=0, atol=0)
    torch.testing.assert_close(l_n, l_h, rtol=0, atol=0)


def _x(requires_grad=False):
    return torch.zeros(1, 2, 128, 64, requires_grad=requires_grad)


@pytest.mark.parametrize("kwargs,grad,exc,match", [
    ({"q_segment_ids": torch.zeros(1, 128)}, False, ValueError, "together"),
    ({"kv_segment_ids": torch.zeros(1, 128)}, False, ValueError, "together"),
    ({"q_positions": torch.zeros(1, 128)}, False, ValueError, "together"),
    ({"kv_positions": torch.zeros(1, 128)}, False, ValueError, "together"),
    ({"window": 16}, False, ValueError, "is_causal"),
    ({"window": 0, "is_causal": True}, False, ValueError, ">= 1"),
    ({"attn_mask": torch.ones(1, 3, 128, 128, dtype=torch.bool)}, False, ValueError, "head dim"),
    ({"attn_mask": torch.ones(128, 100, dtype=torch.bool)}, False, ValueError, "trailing"),
    ({"attn_bias": torch.zeros(2, 1, 128, 128)}, False, ValueError, "batch dim"),
    ({"attn_mask": torch.ones(1, 1, 1, 128, dtype=torch.bool)}, True, NotImplementedError,
     "no gradient"),
    ({"q_segment_ids": torch.zeros(1, 128), "kv_segment_ids": torch.zeros(1, 128)}, True,
     NotImplementedError, "no gradient"),
    ({"q_positions": torch.zeros(1, 128), "kv_positions": torch.zeros(1, 128)}, True,
     NotImplementedError, "no gradient"),
    # a lone bias has a gradient (tests/test_torch_bias_grad.py), not one
    # beside a bool mask
    ({"attn_bias": torch.zeros(128, 128),
      "attn_mask": torch.ones(128, 128, dtype=torch.bool)}, True, NotImplementedError,
     "no gradient"),
    ({"attn_mask": torch.zeros(128, 128)}, True, NotImplementedError, "dBias"),
    # smooth_q is ported (tests/test_torch_qopts.py); the masks beside it are checked
    ({"smooth_q": True, "window": 16}, False, ValueError, "is_causal"),
], ids=["lone_q_seg", "lone_kv_seg", "lone_q_pos", "lone_kv_pos", "window_not_causal",
        "window_0", "mask_heads", "mask_trailing", "bias_batch", "grad_mask", "grad_segments",
        "grad_positions", "grad_bias", "grad_float_mask", "smooth_q"])
def test_mask_refusals(kwargs, grad, exc, match):
    kwargs = dict(kwargs)
    causal = kwargs.pop("is_causal", False)
    with pytest.raises(exc, match=match):
        sageattn(_x(grad), _x(), _x(), is_causal=causal, **kwargs)


def test_trainable_bias_is_refused_under_grad():
    """A trainable bias has a gradient alone (tests/test_torch_bias_grad.py),
    none beside segment ids (nor in the JAX package), and runs under
    no_grad with them."""
    bias = torch.zeros(128, 128, requires_grad=True)
    ids = torch.zeros(1, 128, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no gradient"):
        sageattn(_x(), _x(), _x(), attn_bias=bias, q_segment_ids=ids, kv_segment_ids=ids)
    with torch.no_grad():
        assert sageattn(_x(), _x(), _x(), attn_bias=bias, q_segment_ids=ids,
                        kv_segment_ids=ids).shape == (1, 2, 128, 64)


@pytest.mark.parametrize("sq,sk", [(300, 700), (256, 512)], ids=["ragged", "whole_tiles"])
@pytest.mark.parametrize("sorted_ids", [True, False])
def test_tile_liveness_covers_every_live_element(sorted_ids, sq, sk):
    """The table the masked kernel skips by: every (Q tile, KV tile) that
    holds a live element is marked live (1 or 2), every tile marked 2 is
    live in all its elements in bounds (the kernel then skips the element
    rule), and with sorted segment ids the tiles marked live are exactly
    those (the varlen band).  Lengths off the tiles pad a copy of the mask,
    whole tiles reduce views of it, also of a broadcast one."""
    rng = np.random.default_rng(11 + sorted_ids)
    b, h = 2, 3
    seg_q = rng.integers(0, 3, (b, sq))
    seg_k = rng.integers(0, 3, (b, sk))
    if sorted_ids:  # runs of ~100 and ~230 ids: some tiles of one id
        seg_q, seg_k = np.sort(seg_q, -1), np.sort(seg_k, -1)
    mask = torch.ones(b, h, sq, sk, dtype=torch.bool)
    mask[0, 1, :130, 200:] = False  # tiles wholly dead under the mask
    mask[1, :, 150:] = torch.from_numpy(rng.random((h, sq - 150, sk)) > 0.001)
    masks = attention_cuda.Masks(q_seg=torch.from_numpy(seg_q).int(),
                                 kv_seg=torch.from_numpy(seg_k).int(), mask=mask)
    tq, tk = attention_cuda.Q_TILE, attention_cuda.K_GROUP

    def per_tile(elem, hm):
        nq, nk = -(-sq // tq), -(-sk // tk)
        live = torch.zeros(b, hm, nq * tq, nk * tk, dtype=torch.bool)
        inb = torch.zeros_like(live)
        live[..., :sq, :sk], inb[..., :sq, :sk] = elem, True
        view = (b, hm, nq, tq, nk, tk)
        any_live = live.view(view).any(5).any(3)
        all_live = ~(inb & ~live).view(view).any(5).any(3)
        return any_live, all_live

    for m, hm in ((masks, h), (masks._replace(mask=None), 1)):
        table = attention_cuda.tile_liveness(m, sq, sk)
        assert table.dtype == torch.uint8 and table.shape == (b, hm, -(-sq // tq), -(-sk // tk))
        elem = reference._build_mask(sq, sk, is_causal=False, device="cpu",
                                     q_segment_ids=m.q_seg, kv_segment_ids=m.kv_seg,
                                     attn_mask=m.mask)
        any_live, all_live = per_tile(elem, hm)
        assert bool(((table > 0) | ~any_live).all())  # no live element in a skipped tile
        assert bool(((table < 2) | all_live).all())   # "all live" is true
        if sorted_ids:
            assert bool((table == 0).any()) and bool((table == 2).any())
        if sorted_ids and m.mask is None:
            assert torch.equal(table > 0, any_live)
            assert torch.equal(table == 2, all_live & any_live)
    one = mask[1:, :1]  # a [1, 1, sq, sk] mask broadcast over the batch
    table = attention_cuda.tile_liveness(masks._replace(mask=one.expand(b, 1, sq, sk)), sq, sk)
    assert torch.equal(table, attention_cuda.tile_liveness(
        masks._replace(mask=one.expand(b, 1, sq, sk).contiguous()), sq, sk))


def test_kernel_strides_broadcast_every_dim_of_size_1():
    """The masked kernel indexes a mask or bias with the query head, batch,
    row and column it computes: a dim of size 1 must read stride 0, also
    where ``expand`` left the view's own stride (a [1, 1, s, s] view of a
    2-D mask has nonzero strides in its size-1 dims)."""
    s = 256
    m = core._mask4(torch.ones(s, s, dtype=torch.bool), "attn_mask", 1, 8, s, s)
    assert m.shape == (1, 1, s, s) and m.stride()[:2] != (0, 0)
    assert attention_cuda.broadcast_strides(m) == [0, 0, s, 1]
    pad = core._mask4(torch.ones(2, 1, 1, s, dtype=torch.bool), "attn_mask", 2, 8, 128, s)
    assert attention_cuda.broadcast_strides(pad) == [s, 0, 0, 1]
    b = core._mask4(torch.zeros(1, 8, s, s), "attn_bias", 3, 8, s, s)
    assert attention_cuda.broadcast_strides(b) == [0, s * s, s, 1]
    assert attention_cuda.broadcast_strides(None) == [0, 0, 0, 0]


def test_masked_wrapper_refuses_devices_it_has_no_kernel_for():
    q = torch.empty(1, 1, 128, 64, device="meta")
    k = torch.empty(1, 1, 128, 64, dtype=torch.int8, device="meta")
    ks = torch.empty(1, 1, 1, device="meta")
    v = torch.empty(1, 1, 128, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        attention_cuda.sage_attention_fwd_masked(
            q, k, ks, v, masks=attention_cuda.Masks(window=8), is_causal=True, q_fold=1.0)
