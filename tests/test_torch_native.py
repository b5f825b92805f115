"""The port's ``native`` (its own build of ``csrc/host/varlen_pack.cpp``
through ctypes) against the JAX package's ``native``, on the CPU.

``pack_ragged``, ``unpack_ragged`` and ``expand_cu_seqlens`` move bytes and
count offsets, so the port equals the JAX functions bit for bit: fp32,
int8 and bf16 (compared as bytes; numpy holds the JAX side's bf16 through
``ml_dtypes``), one to many sequences, a zero-length one, and a padded
``total`` past ``cu[-1]``.  The port's plain PyTorch versions give the
same bits.  The library is built into the port's build directory, never
into a source directory.  A ``pack_ragged`` batch through the port's
``sageattn_varlen`` equals the JAX ``sageattn_varlen(impl="xla")`` on the
JAX-packed batch at ``tests/test_torch_varlen.py``'s tolerance (o within
atol 1e-5, global K smoothing, fp32 inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sageattention_tpu import core as jcore
from sageattention_tpu import native as jnative
from sageattention_tpu_torch import native, sageattn_varlen
from sageattention_tpu_torch.ops import _build

LENS = {
    "one": [37],
    "two": [5, 128],
    "many": [5, 1, 17, 128, 3, 64, 2],
    "zero_length": [9, 0, 33, 0],
}
DTYPES = ["float32", "int8", "bfloat16"]


def _seqs(lens, dtype: str, trailing=(3, 8), seed=0):
    """The same sequences for both sides: (numpy for JAX, tensors for the port)."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((n, *trailing)).astype(np.float32) for n in lens]
    if dtype == "int8":
        xs = [np.clip(np.round(x * 40), -127, 127).astype(np.int8) for x in xs]
        return xs, [torch.from_numpy(x) for x in xs]
    if dtype == "bfloat16":
        ts = [torch.from_numpy(x).bfloat16() for x in xs]
        return [np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in xs], ts
    return xs, [torch.from_numpy(x) for x in xs]


def _bytes(x) -> np.ndarray:
    """The elements' bits, as integers of their width."""
    if isinstance(x, torch.Tensor):
        return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]).numpy()
    return x.view({1: np.uint8, 2: np.int16, 4: np.int32}[x.dtype.itemsize])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(LENS))
def test_pack_and_unpack_match_jax(name, dtype):
    xs, ts = _seqs(LENS[name], dtype)
    packed, cu = native.pack_ragged(ts)
    jpacked, jcu = jnative.pack_ragged(xs)
    assert packed.dtype == ts[0].dtype and cu.dtype == torch.int32
    np.testing.assert_array_equal(_bytes(packed), _bytes(jpacked))
    np.testing.assert_array_equal(cu.numpy(), jcu)
    outs = native.unpack_ragged(packed, cu)
    jouts = jnative.unpack_ragged(jpacked, jcu)
    assert len(outs) == len(jouts) == len(ts)
    for o, jo, t in zip(outs, jouts, ts):
        np.testing.assert_array_equal(_bytes(o), _bytes(jo))
        assert torch.equal(o, t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_give_the_same_bits(dtype):
    _, ts = _seqs(LENS["many"], dtype, seed=1)
    packed, cu = native.pack_ragged(ts, threads=3)
    p2, c2 = native.pack_ragged_plain(ts)
    np.testing.assert_array_equal(_bytes(packed), _bytes(p2))
    assert torch.equal(cu, c2)
    for a, b in zip(native.unpack_ragged(packed, cu), native.unpack_ragged_plain(packed, cu)):
        np.testing.assert_array_equal(_bytes(a), _bytes(b))


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_byte_ranges_split_across_sequences(threads):
    """A batch of ~7 MiB, so the library cuts the copies into 1-MiB-or-more
    byte ranges that start and end inside sequences and skip the empty
    ones: the same bits as the JAX functions."""
    xs, ts = _seqs([0, 3001, 1, 0, 4093, 17, 0], "float32", trailing=(256,), seed=2)
    packed, cu = native.pack_ragged(ts, threads=threads)
    jpacked, jcu = jnative.pack_ragged(xs)
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    np.testing.assert_array_equal(cu.numpy(), jcu)
    for o, jo in zip(native.unpack_ragged(packed, cu, threads=threads),
                     jnative.unpack_ragged(jpacked, jcu)):
        np.testing.assert_array_equal(o.numpy(), jo)


def test_numpy_arrays_are_taken_as_tensors():
    xs, _ = _seqs(LENS["two"], "float32")
    packed, cu = native.pack_ragged(xs)
    assert isinstance(packed, torch.Tensor)
    np.testing.assert_array_equal(packed.numpy(), np.concatenate(xs))


@pytest.mark.parametrize("pad", [0, 7])
@pytest.mark.parametrize("name", sorted(LENS))
def test_expand_cu_seqlens_matches_jax(name, pad):
    cu = np.concatenate([[0], np.cumsum(LENS[name])]).astype(np.int32)
    total = int(cu[-1]) + pad
    seg, pos = native.expand_cu_seqlens(torch.from_numpy(cu), total if pad else None)
    jseg, jpos = jnative.expand_cu_seqlens(cu, total if pad else None)
    assert seg.dtype == pos.dtype == torch.int32 and seg.shape == (total,)
    np.testing.assert_array_equal(seg.numpy(), jseg)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    pseg, ppos = native.expand_cu_seqlens_plain(cu, total if pad else None)
    assert torch.equal(seg, pseg) and torch.equal(pos, ppos)
    if pad:  # the padded tail: segment n + 1, positions restarting at cu[n]
        assert (seg[int(cu[-1]):] == len(LENS[name]) + 1).all()
        assert torch.equal(pos[int(cu[-1]):], torch.arange(pad, dtype=torch.int32))


def test_library_is_built_into_the_build_directory():
    assert native.has_native()
    built = _build._target("varlen_pack")
    assert built.parent == _build.build_dir() and built.exists()
    host_src = _build.CSRC / "host"
    assert sorted(p.name for p in host_src.iterdir()) == ["varlen_pack.cpp"]


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="at least one"):
        native.pack_ragged([])
    with pytest.raises(ValueError, match="trailing shape and dtype"):
        native.pack_ragged([torch.zeros(2, 3), torch.zeros(2, 4)])
    with pytest.raises(ValueError, match="trailing shape and dtype"):
        native.pack_ragged([torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int8)])
    with pytest.raises(ValueError, match="start at 0"):
        native.expand_cu_seqlens(torch.tensor([1, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="not decrease"):
        native.unpack_ragged(torch.zeros(6, 2), torch.tensor([0, 4, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match="past the 6 packed rows"):
        native.unpack_ragged(torch.zeros(6, 2), torch.tensor([0, 4, 9], dtype=torch.int32))


@pytest.mark.parametrize("causal", [False, True])
def test_packed_batch_through_varlen_matches_jax(causal):
    """Ragged prompts packed on the host by each package, then each
    package's ``sageattn_varlen`` (JAX: ``impl="xla"``, 128-row blocks, the
    port's K-scale group): o within atol 1e-5."""
    lens, hq, hkv, d = [128, 200, 56], 4, 2, 64
    rng = np.random.default_rng(11)
    q = [rng.standard_normal((n, hq, d)).astype(np.float32) for n in lens]
    k = [(rng.standard_normal((n, hkv, d)) + 0.5).astype(np.float32) for n in lens]
    v = [rng.standard_normal((n, hkv, d)).astype(np.float32) for n in lens]
    (qt, cu), (kt, _), (vt, _) = (native.pack_ragged(x) for x in (q, k, v))
    (qj, cuj), (kj, _), (vj, _) = (jnative.pack_ragged(x) for x in (q, k, v))
    o = sageattn_varlen(qt, kt, vt, cu, cu, is_causal=causal)
    oj = jcore.sageattn_varlen(*(jnp.asarray(x) for x in (qj, kj, vj, cuj, cuj)),
                               is_causal=causal, impl="xla", block_q=128, block_k=128)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), atol=1e-5)
    back = native.unpack_ragged(o, cu)
    assert [x.shape[0] for x in back] == lens
