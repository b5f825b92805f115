"""The Python side of kernel 1's TMA-fed ``wgmma`` forward and of kernel 2's
chunked K mean, on the CPU.

* :func:`attention_cuda.route` for every head dim of ``HEAD_DIMS``, with
  and without masks, default and pre-quantized Q: the library and entry
  point each wrapper calls, both in ``_build.SIGNATURES``, and the kernel
  it launches: a ``wgmma`` kernel for every call, whose source includes
  its header (``csrc/attention_fwd_sm90.cuh`` at 64, 128 or 256,
  ``csrc/attention_fwd_sm90_wide.cuh`` at 384 and 512).  No forward source
  holds ``mma.sync`` or includes the old body.
* :func:`attention_cuda.cta_tiles`, the KV tiles a masked CTA visits (the
  kernel's formulas), at 64- and 128-row CTAs and 128- and 64-column
  tiles, against the JAX package's masks (``reference._build_mask``,
  ``window_band_mask``, varlen's segment ids): every live element lies in
  a listed tile, and no tile that the liveness table marks dead for each
  of the CTA's table rows is listed.
* :func:`attention_cuda.widen_v_codes`, which widens V codes to bf16
  before the ``wgmma`` forward: on the CPU its plain version, every finite
  int8, e4m3 and e5m2 code against the TPU kernel's ``astype(bfloat16)``,
  bit for bit.
* The K mean's chunk plan (:func:`quant_cuda.mean_chunk_rows` and
  :func:`quant_cuda.mean_chunks`) at ``s`` in {1, 129, 1000, 4100}: every
  row in exactly one chunk, the chunks in row order, each a multiple of 64
  rows but the last, and enough CTAs to fill the card where the rows
  allow.
* The kernel's arithmetic order, as plain fp32 sums: each chunk's rows
  summed, the chunks' sums added in chunk order, divided by ``s``, against
  the JAX package's K mean within fp32 round-off (1e-6 relative, 1e-7
  absolute: the two sums run in other orders): the Pallas
  ``quant_pallas.quant_k_fused_mean`` (interpret mode, as the JAX tests run
  it on the CPU) where ``core`` runs it (s a multiple of 128), with its
  codes within +-1 on at most 1e-4 of entries through ``quant_k_chunked``'s
  plain version, and ``core``'s ``jnp.mean`` at the ragged lengths.  The
  kernels themselves run only on the card (``chip_smoke.py``,
  ``tools/ab_attention_fwd.py``).
"""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu.ops import quant_pallas
from sageattention_tpu.ops import reference as jreference
from sageattention_tpu_torch import core
from sageattention_tpu_torch import quant as tq
from sageattention_tpu_torch.ops import _build, attention_cuda, quant_cuda

H100_SMS = 132


@pytest.mark.parametrize("preq", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", _build.HEAD_DIMS)
def test_route(d, masked, preq):
    lib, entry, kernel = attention_cuda.route(d, masked=masked, preq=preq)
    kind = "_preq" if preq else "_masked" if masked else ""
    sfx = "_hd256" if d == 256 else "_wide" if d > 256 else ""
    assert (lib, entry) == ("attention_fwd" + kind + sfx, "sage_attn_fwd" + kind + sfx)
    assert entry in _build.SIGNATURES[lib]
    assert kernel == "wgmma"
    source = (_build.CSRC / f"{lib}.cu").read_text()
    # every call reaches a wgmma kernel's header (at 384 and 512 the wide
    # one, O's columns split between two warpgroups)
    header = "attention_fwd_sm90_wide.cuh" if d > 256 else "attention_fwd_sm90.cuh"
    assert f'#include "{header}"' in source


@pytest.mark.parametrize("name", ["int8", "fp8", "fp8_e5m2"])
def test_widen_v_codes_plain_matches_jax(name):
    """Every finite V code widened to bf16 as the TPU kernel widens a V
    tile (``attention_pallas.py:807``, ``v.astype(jnp.bfloat16)``): bit for
    bit."""
    dtype = tq.V_DTYPES[name]
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(dtype)
    codes = codes[torch.isfinite(codes.float())]
    got = attention_cuda.widen_v_codes(codes)  # the CPU path: the plain version
    jdt = {torch.int8: jnp.int8, torch.float8_e4m3fn: jnp.float8_e4m3fn,
           torch.float8_e5m2: jnp.float8_e5m2}[dtype]
    want = jnp.asarray(codes.view(torch.uint8).numpy()).view(jdt).astype(jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and len(got) == (256 if name == "int8" else
                                                       254 if name == "fp8" else 248)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


FWD_SOURCES = sorted(p.name for p in _build.CSRC.glob("attention_fwd*.cu*"))


@pytest.mark.parametrize("name", FWD_SOURCES)
def test_no_mma_sync_in_the_forward(name):
    """Kernel 1's mma.sync body is gone: no forward source or header holds
    an mma.sync product or names the old body, and the body's file is
    gone."""
    source = (_build.CSRC / name).read_text()
    assert "mma.sync" not in source and "attention_fwd_body.cuh" not in source
    assert not re.search(r"\b(mma_s8|mma_bf16|mma_a_rows|ldsm_x4_trans)\s*\(", source)
    assert not re.search(r"\bsage_attn_fwd_kernel\b", source)
    assert not (_build.CSRC / "attention_fwd_body.cuh").exists()


def _varlen(lens):
    """The JAX varlen's segment ids of packed sequences (``core.py``'s
    searchsorted over cu_seqlens) and the port's per-row key ranges
    (``core.varlen_rows``)."""
    cu = np.array([0, *itertools.accumulate(lens)], np.int32)
    s = int(cu[-1])
    seg = np.asarray(jnp.searchsorted(jnp.asarray(cu), jnp.arange(s), side="right"))[None]
    _, _, lo, hi = core.varlen_rows(torch.from_numpy(cu), torch.from_numpy(cu), s, s)
    return seg.astype(np.int32), lo[None].int().contiguous(), hi[None].int().contiguous()


def _cta_cases():
    """name -> (b, h, sq, sk, causal, the port's Masks, the JAX package's
    element mask [b, 1 or h, sq, sk])."""
    rng = np.random.default_rng(21)
    out = {}
    sq, w = 700, 150
    band = np.asarray(jreference.window_band_mask(sq, sq, w)
                      & jreference._build_mask(sq, sq, is_causal=True, q_segment_ids=None,
                                               kv_segment_ids=None, attn_mask=None))
    out["window"] = (1, 1, sq, sq, True, attention_cuda.Masks(window=w), band)
    seg, lo, hi = _varlen((300, 129, 64, 250))
    elem = jreference._build_mask(743, 743, is_causal=True, q_segment_ids=jnp.asarray(seg),
                                  kv_segment_ids=jnp.asarray(seg), attn_mask=None)
    out["varlen_ranges"] = (1, 1, 743, 743, True, attention_cuda.Masks(kv_lo=lo, kv_hi=hi),
                            np.asarray(elem))
    for name, ids in (("ids_sorted", np.sort(rng.integers(0, 5, (2, 600)), -1)),
                      # unsorted: two ids shuffled inside each run of 200
                      ("ids_unsorted", np.arange(600) // 200 * 2 + rng.integers(0, 2, (2, 600)))):
        ids = ids.astype(np.int32)
        elem = jreference._build_mask(600, 600, is_causal=False, q_segment_ids=jnp.asarray(ids),
                                      kv_segment_ids=jnp.asarray(ids), attn_mask=None)
        t = torch.from_numpy(ids)
        out[name] = (2, 1, 600, 600, False, attention_cuda.Masks(q_seg=t, kv_seg=t),
                     np.asarray(elem))
    mask = rng.random((1, 2, 500, 900)) > 0.995  # sparse: most tiles hold no live key
    mask[0, 0, 64:200] = False                   # dead rows, a whole table row among them
    mask[0, 1, :, 300:700] = False
    elem = jreference._build_mask(500, 900, is_causal=False, q_segment_ids=None,
                                  kv_segment_ids=None, attn_mask=jnp.asarray(mask))
    out["bool_mask_dead_rows"] = (1, 2, 500, 900, False,
                                  attention_cuda.Masks(mask=torch.from_numpy(mask)),
                                  np.asarray(elem))
    return out


CTA_CASES = _cta_cases()


@pytest.mark.parametrize("kt", [128, 64])
@pytest.mark.parametrize("rows", [128, 64])
@pytest.mark.parametrize("name", list(CTA_CASES))
def test_cta_tiles_cover_the_jax_masks(name, rows, kt):
    b, h, sq, sk, causal, masks, elem = CTA_CASES[name]
    elem = np.broadcast_to(elem, (b, h, sq, sk))
    live = attention_cuda.tile_liveness(masks, sq, sk)
    n_tiles, skipped = -(-sk // kt), 0
    for bi, hh, q0 in itertools.product(range(b), range(h), range(0, sq, rows)):
        listed = attention_cuda.cta_tiles(masks, live, bi, hh, q0, rows, sq, sk, kt, causal)
        assert listed == sorted(set(listed))
        cols = np.flatnonzero(elem[bi, hh, q0:q0 + rows].any(0))
        assert set(cols // kt) <= set(listed), (bi, hh, q0)  # every live element's tile
        if live is not None:
            table = live[bi, hh if live.shape[1] > 1 else 0]
            trows = [table[(q0 + r) // 64] for r in range(0, rows, 64) if q0 + r < sq]
            dead = [j for j in range(n_tiles) if all(int(t[j * kt // 128]) == 0 for t in trows)]
            assert not set(dead) & set(listed), (bi, hh, q0)
            skipped += len(dead)
        else:
            skipped += n_tiles - len(listed)
    assert skipped > 0  # the masks leave tiles to skip


@pytest.mark.parametrize("bh", [1, 30, 64])
@pytest.mark.parametrize("s", [1, 129, 1000, 4100])
def test_mean_chunk_plan(s, bh):
    rows = quant_cuda.mean_chunk_rows(s, bh, H100_SMS)
    chunks = quant_cuda.mean_chunks(s, rows)
    assert rows % quant_cuda.MEAN_ROW_STEP == 0 and rows > 0
    # every row once, the chunks in row order
    assert [r for c in chunks for r in c] == list(range(s))
    assert all(len(c) == rows for c in chunks[:-1]) and 0 < len(chunks[-1]) <= rows
    # a CTA on every SM, unless the rows run out first
    assert bh * len(chunks) >= min(H100_SMS, bh * -(-s // quant_cuda.MEAN_ROW_STEP))
    # and no more chunks than the card holds CTAs at once
    assert len(chunks) <= max(1, -(-quant_cuda.MEAN_CTAS_PER_SM * H100_SMS // bh))


def _chunk_ordered_mean(k: torch.Tensor, rows: int) -> torch.Tensor:
    """The kernel's order: each chunk's fp32 sums, then the chunks' sums
    added in chunk order, divided by s."""
    s = k.shape[-2]
    total = torch.zeros(*k.shape[:-2], k.shape[-1], dtype=torch.float32)
    for c in quant_cuda.mean_chunks(s, rows):
        total = total + k[..., c.start:c.stop, :].float().sum(dim=-2)
    return total / s


def _jax_mean_and_codes(k_j, s: int):
    """The JAX package's K mean (and codes where it has them): the Pallas
    ``quant_k_fused_mean`` where ``core`` runs it (``k_fused_eligible``: s a
    multiple of the group), else ``core``'s own ``jnp.mean`` over the
    sequence (``core.py:267-268``)."""
    if quant_pallas.k_fused_eligible(s, k_j.shape[-1], 128):
        q_j, _, km_j = quant_pallas.quant_k_fused_mean(k_j, group=128, interpret=True)
        return np.asarray(km_j), np.asarray(q_j)
    return np.asarray(jnp.mean(k_j.astype(jnp.float32), axis=-2)), None


@pytest.mark.parametrize("s", [1, 129, 1000, 4100, 128, 4096])
def test_chunk_ordered_mean_matches_jax(s):
    b, h, d = 1, 2, 64
    x = (np.random.default_rng(s).standard_normal((b, h, s, d)) + 0.5).astype(np.float32)
    k_t = torch.from_numpy(x).to(torch.bfloat16)
    k_j = jnp.asarray(k_t.float().numpy()).astype(jnp.bfloat16)
    km_j, q_j = _jax_mean_and_codes(k_j, s)
    rows = quant_cuda.mean_chunk_rows(s, b * h, H100_SMS)
    assert len(quant_cuda.mean_chunks(s, rows)) == -(-s // 64)  # one chunk of 64 rows a CTA
    km = _chunk_ordered_mean(k_t, rows)
    np.testing.assert_allclose(km.numpy(), km_j, rtol=1e-6, atol=1e-7)
    if q_j is not None:
        # the codes the chunk-ordered mean gives, through the chunked quantizer
        q_t, _ = quant_cuda.quant_k_chunked_plain(k_t, km, group=128)
        diff = np.abs(q_t.numpy().astype(np.int32) - q_j.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    # and the port's plain mean, which the CPU path runs
    np.testing.assert_allclose(km.numpy(), quant_cuda.k_channel_mean(k_t).numpy(), rtol=1e-6,
                               atol=1e-7)
