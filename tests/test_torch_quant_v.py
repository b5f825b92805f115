"""The port's per-channel V quantizers against the JAX package's (CPU).

* ``sageattention_tpu_torch.quant.per_channel_quant`` against
  ``sageattention_tpu.quant.per_channel_quant``: without smooth-v the codes
  (compared as bytes) and scales are bit-exact; with it the mean agrees to
  1e-6 relative (XLA sums in another order) and, given the JAX mean, the
  port's chain is bit-exact with the JAX chain fed the same centred V.
  Against the JAX function's own smooth-v codes the scales are bit-exact
  and at most 1e-4 of the codes differ: inside that jitted function XLA
  does not subtract exactly the mean it returns (measured on 4,096,000
  entries: 14 fp8 codes of either type, no int8 code).
* The plain versions of kernel 5 (``quant_cuda.quant_v_per_channel``) and
  kernel 6 (``quant_cuda.quant_v_blocked``), which the wrappers run on CPU
  tensors, against the Pallas kernels ``quant_pallas.quant_v_per_channel``
  and ``quant_pallas._quant_v_blocked`` in interpret mode, with the same
  tolerances; kernel 6 at a sequence of several of its blocks.
* The dispatch: a (b,h) slab of more than ``V_SINGLE_PASS_BYTES``,
  counted on the caller's V (its head dim and itemsize), takes the
  two-pass quantizer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import quant as jq
from sageattention_tpu.ops import quant_pallas
from sageattention_tpu_torch import quant as tq
from sageattention_tpu_torch.ops import quant_cuda

CODES = {
    "int8": (torch.int8, jnp.int8),
    "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
    "e5m2": (torch.float8_e5m2, jnp.float8_e5m2),
}


def _v(shape, seed, dtype=np.float32):
    """V with a per-channel offset, so that smooth-v changes the codes."""
    rng = np.random.default_rng(seed)
    b, h, s, d = shape
    v = rng.standard_normal(shape) + 3 * rng.standard_normal((b, h, 1, d))
    return v.astype(np.float32).astype(dtype)


def _bytes(x) -> np.ndarray:
    """Codes as their bytes: torch int8 / fp8 or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _smooth_matches(x, got, want, tdt, jdt) -> None:
    """Smooth-v results (codes, scales, mean) of the port (``got``) and of
    the JAX package (``want``) on fp32 ``x``: see the module docstring."""
    q_t, s_t, m_t = got
    q_j, s_j, m_j = want
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6)
    centred = x - np.array(m_j)[..., None, :]
    q_c, s_c, _ = tq.per_channel_quant(torch.from_numpy(centred), dtype=tdt, smooth=False)
    q_jc, s_jc, _ = jq.per_channel_quant(jnp.asarray(centred), dtype=jdt, smooth=False)
    np.testing.assert_array_equal(_bytes(q_c), _bytes(q_jc))
    _eq(s_c, s_jc)
    _eq(s_c, s_j)
    assert (_bytes(q_c) != _bytes(q_j)).mean() <= 1e-4


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("shape", [(2, 3, 77, 64), (1, 2, 333, 80)])
def test_per_channel_quant_matches_jax_spec(shape, code, smooth):
    tdt, jdt = CODES[code]
    x = _v(shape, seed=shape[2])
    q_t, s_t, m_t = tq.per_channel_quant(torch.from_numpy(x), dtype=tdt, smooth=smooth)
    q_j, s_j, m_j = jq.per_channel_quant(jnp.asarray(x), dtype=jdt, smooth=smooth)
    assert q_t.dtype == tdt and q_t.shape == shape and s_t.shape == shape[:2] + shape[3:]
    if not smooth:
        assert m_t is None and m_j is None
        np.testing.assert_array_equal(_bytes(q_t), _bytes(q_j))
        _eq(s_t, s_j)
        return
    _smooth_matches(x, (q_t, s_t, m_t), (q_j, s_j, m_j), tdt, jdt)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("code", sorted(CODES))
def test_single_pass_plain_matches_pallas(code, smooth):
    """Kernel 5's plain version against ``_quant_v_kernel`` (interpret)."""
    tdt, jdt = CODES[code]
    x = _v((1, 3, 500, 64), seed=7, dtype=jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    q_t, s_t, m_t = quant_cuda.quant_v_per_channel(xt, dtype=tdt, smooth=smooth)
    q_j, s_j, m_j = quant_pallas.quant_v_per_channel(jnp.asarray(x), dtype=jdt, smooth=smooth,
                                                      interpret=True)
    if not smooth:
        np.testing.assert_array_equal(_bytes(q_t), _bytes(q_j))
        _eq(s_t, s_j)
        return
    _smooth_matches(np.asarray(x, np.float32), (q_t, s_t, m_t), (q_j, s_j, m_j), tdt, jdt)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("code", sorted(CODES))
def test_two_pass_plain_matches_pallas(code, smooth):
    """Kernel 6's plain version against ``_v_stats_kernel`` +
    ``_v_apply_kernel`` (interpret) at 5,000 rows: three of the Pallas
    kernel's 2,048-row blocks, the last one ragged."""
    tdt, jdt = CODES[code]
    x = _v((2, 1, 5000, 64), seed=8)
    xt = torch.from_numpy(x)
    q_t, s_t, m_t = quant_cuda.quant_v_blocked(xt, dtype=tdt, smooth=smooth)
    q_j, s_j, m_j = quant_pallas._quant_v_blocked(jnp.asarray(x), dtype=jdt, smooth=smooth,
                                                  interpret=True)
    if not smooth:
        assert m_t is None
        np.testing.assert_array_equal(_bytes(q_t), _bytes(q_j))
        _eq(s_t, s_j)
        return
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6)
    # the combine and the apply step, given the JAX mean: bit-exact
    gmax, gmin, _ = quant_cuda.v_channel_stats_plain(xt, smooth=False)
    mean = torch.from_numpy(np.array(m_j))
    s_c, r = quant_cuda.v_scale_from_stats(gmax, gmin, mean, tdt)
    _eq(s_c, s_j)
    q_c = quant_cuda.quant_v_apply_plain(xt, r, mean, dtype=tdt)
    np.testing.assert_array_equal(_bytes(q_c), _bytes(q_j))


def test_two_pass_equals_single_pass_without_smoothing():
    """amax from the block maxima and minima is exact: both quantizers give
    the same codes and scales."""
    xt = torch.from_numpy(_v((1, 2, 700, 128), seed=9))
    for tdt, _ in CODES.values():
        q1, s1, _ = quant_cuda.quant_v_per_channel_plain(xt, dtype=tdt, smooth=False)
        q2, s2, _ = quant_cuda.quant_v_blocked_plain(xt, dtype=tdt, smooth=False)
        np.testing.assert_array_equal(_bytes(q1), _bytes(q2))
        torch.testing.assert_close(s1, s2, rtol=0, atol=0)


def _spy(monkeypatch, calls, name):
    fn = getattr(quant_cuda, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(quant_cuda, name, counted)


@pytest.mark.parametrize(
    "s,dtype,want",
    [
        (100, torch.bfloat16, "quant_v_per_channel_plain"),  # 100*80*2 bytes: at the limit
        (101, torch.bfloat16, "quant_v_blocked"),           # one row over it
        (100, torch.float32, "quant_v_blocked"),            # the caller's itemsize counts
    ],
)
def test_dispatch_by_the_callers_slab_bytes(monkeypatch, s, dtype, want):
    """The rule counts the caller's V (d = 80 here), not the padded one
    (d = 128) the kernels read."""
    monkeypatch.setattr(quant_cuda, "V_SINGLE_PASS_BYTES", 100 * 80 * 2)
    calls = []
    for name in ("quant_v_per_channel_plain", "quant_v_blocked"):
        _spy(monkeypatch, calls, name)
    v = torch.from_numpy(_v((1, 2, s, 80), seed=10)).to(dtype)
    quant_cuda.quant_v_per_channel(v, dtype=torch.int8, d_pad=128)
    assert calls == [want]


@pytest.mark.parametrize("smooth", [False, True])
def test_codes_come_at_the_padded_head_dim(smooth):
    """d = 80 pads to 128: the real channels are the spec's on the
    unpadded V (bit-exact without smooth-v; with it the mean to 1e-6
    relative, torch summing the padded rows in another order), the pad
    channels code 0 and mean 0."""
    x = torch.from_numpy(_v((1, 2, 64, 80), seed=11))
    for tdt, _ in CODES.values():
        q, s, m = quant_cuda.quant_v_per_channel(x, dtype=tdt, smooth=smooth, d_pad=128)
        q_s, s_s, m_s = tq.per_channel_quant(x, dtype=tdt, smooth=smooth)
        assert q.shape == (1, 2, 64, 128) and s.shape == (1, 2, 128)
        assert not q[..., 80:].view(torch.uint8).any()
        if not smooth:
            assert m is None
            np.testing.assert_array_equal(_bytes(q[..., :80].contiguous()), _bytes(q_s))
            torch.testing.assert_close(s[..., :80], s_s, rtol=0, atol=0)
            continue
        assert m.shape == (1, 2, 128) and not m[..., 80:].any()
        torch.testing.assert_close(m[..., :80], m_s, rtol=1e-6, atol=0)
        torch.testing.assert_close(s[..., :80], s_s, rtol=1e-6, atol=0)


def test_v_wrappers_refuse_devices_they_have_no_kernel_for():
    """Only CPU tensors take the plain versions; anything else is the
    kernel's or an error, never a silent fallback."""
    v = torch.empty(1, 1, 128, 64, dtype=torch.bfloat16, device="meta")
    vec = torch.empty(1, 1, 64, device="meta")
    with pytest.raises(ValueError):
        quant_cuda.quant_v_per_channel(v, dtype=torch.float8_e4m3fn)
    with pytest.raises(ValueError):
        quant_cuda.v_channel_stats(v, smooth=True)
    with pytest.raises(ValueError):
        quant_cuda.quant_v_apply(v, vec, None, dtype=torch.int8)
