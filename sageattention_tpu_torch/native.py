"""Native host runtime: the ctypes binding of ``csrc/host/varlen_pack.cpp``,
the counterpart of the JAX package's ``native.py``.

The compute path runs on the card; the *host* work around it — ragged-batch
packing and cu_seqlens expansion for the varlen pipeline (reference:
sageattention/core.py:362-477 and the host-side scale-offset computation in
triton/quant_per_block_varlen.py:72-79) — runs as native multithreaded C++
on CPU tensors.  ``pack_ragged`` gives the (packed, ``cu_seqlens``) pair
that ``sageattn_varlen`` takes once moved to the card.

The library is the port's own copy of the source, built by ``g++`` into
``build/`` on first use (``ops/_build.lib``); every call goes through
it, and a failed build or load raises with the compiler's message.  Rows
move as bytes through ``data_ptr()``, so any dtype packs, bf16 included.
The ``*_plain`` functions are the same operations in PyTorch, the
reference the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from sageattention_tpu_torch.ops import _build

_THREADS = min(16, os.cpu_count() or 1)


def _lib() -> ctypes.CDLL:
    return _build.lib("varlen_pack")


def has_native() -> bool:
    """True once the host library is built and loaded (it raises if it
    cannot be: the port has no other path)."""
    return _lib() is not None


def _host(x, what: str) -> torch.Tensor:
    """``x`` (a tensor or a numpy array) as a contiguous CPU tensor."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    if t.device.type != "cpu":
        raise ValueError(f"{what} must lie on the CPU (the host library reads host memory), "
                         f"got {t.device}")
    return t.contiguous()


def _cu(cu_seqlens) -> torch.Tensor:
    """``cu_seqlens`` as a contiguous int32 CPU tensor, checked to start at
    0 and not to decrease (the library writes by these offsets)."""
    cu = _host(cu_seqlens, "cu_seqlens").to(torch.int32).contiguous()
    if cu.dim() != 1 or cu.numel() < 1:
        raise ValueError(f"cu_seqlens must be 1-D with at least one entry, got {tuple(cu.shape)}")
    if int(cu[0]) != 0 or bool((cu[1:] < cu[:-1]).any()):
        raise ValueError("cu_seqlens must start at 0 and not decrease")
    return cu


def _row_bytes(x: torch.Tensor) -> int:
    return x.element_size() * int(np.prod(x.shape[1:], dtype=np.int64))


def _check_seqs(seqs) -> list[torch.Tensor]:
    if not len(seqs):
        raise ValueError("need at least one sequence")
    seqs = [_host(x, "each sequence") for x in seqs]
    for x in seqs:
        if x.dim() < 1 or x.shape[1:] != seqs[0].shape[1:] or x.dtype != seqs[0].dtype:
            raise ValueError("sequences must share trailing shape and dtype")
    return seqs


def pack_ragged(seqs, threads: int | None = None):
    """Pack ragged [len_i, ...] tensors (or numpy arrays) into
    ([sum(len), ...], cu_seqlens int32 [n + 1]), both CPU tensors.

    The host prep for ``sageattn_varlen`` (reference: core.py:362-477)."""
    seqs = _check_seqs(seqs)
    lens = torch.tensor([x.shape[0] for x in seqs], dtype=torch.int64)
    out = torch.empty((int(lens.sum()), *seqs[0].shape[1:]), dtype=seqs[0].dtype)
    cu = torch.empty(len(seqs) + 1, dtype=torch.int32)
    srcs = (ctypes.c_void_p * len(seqs))(*(x.data_ptr() for x in seqs))
    _lib().sage_pack_ragged(srcs, ctypes.cast(lens.data_ptr(), _build.P64), len(seqs),
                            _row_bytes(seqs[0]), out.data_ptr(),
                            ctypes.cast(cu.data_ptr(), _build.P32), threads or _THREADS)
    return out, cu


def unpack_ragged(packed, cu_seqlens, threads: int | None = None) -> list[torch.Tensor]:
    """Split a packed [total, ...] tensor back into per-sequence tensors."""
    packed, cu = _host(packed, "packed"), _cu(cu_seqlens)
    if int(cu[-1]) > packed.shape[0]:
        raise ValueError(f"cu_seqlens ends at {int(cu[-1])}, past the {packed.shape[0]} "
                         f"packed rows")
    n = cu.numel() - 1
    outs = [torch.empty((int(cu[i + 1] - cu[i]), *packed.shape[1:]), dtype=packed.dtype)
            for i in range(n)]
    dsts = (ctypes.c_void_p * max(n, 1))(*(o.data_ptr() for o in outs))
    _lib().sage_unpack_ragged(packed.data_ptr(), ctypes.cast(cu.data_ptr(), _build.P32), n,
                              _row_bytes(packed), dsts, threads or _THREADS)
    return outs


def expand_cu_seqlens(cu_seqlens, total: int | None = None, threads: int | None = None):
    """cu_seqlens -> (segment_ids [total] int32 1-based, positions [total]
    int32), CPU tensors.

    The segment ids are ``searchsorted(cu, arange(total), side="right")``
    (what ``sageattn_varlen`` computes on the device), the positions restart
    at each boundary; a padded tail past ``cu[-1]`` gets segment n + 1 and
    positions that restart at ``cu[n]``."""
    cu = _cu(cu_seqlens)
    n = cu.numel() - 1
    total = int(cu[-1]) if total is None else int(total)
    seg = torch.empty(total, dtype=torch.int32)
    pos = torch.empty(total, dtype=torch.int32)
    _lib().sage_expand_cu_seqlens(ctypes.cast(cu.data_ptr(), _build.P32), n, total,
                                  ctypes.cast(seg.data_ptr(), _build.P32),
                                  ctypes.cast(pos.data_ptr(), _build.P32), threads or _THREADS)
    return seg, pos


def pack_ragged_plain(seqs):
    """:func:`pack_ragged` in PyTorch (``torch.cat`` and a cumulative sum)."""
    seqs = _check_seqs(seqs)
    lens = torch.tensor([x.shape[0] for x in seqs], dtype=torch.int64)
    cu = torch.cat([torch.zeros(1, dtype=torch.int64), lens.cumsum(0)]).to(torch.int32)
    return torch.cat(seqs), cu


def unpack_ragged_plain(packed, cu_seqlens) -> list[torch.Tensor]:
    """:func:`unpack_ragged` in PyTorch (a copy of each slice)."""
    packed, cu = _host(packed, "packed"), _cu(cu_seqlens)
    return [packed[int(cu[i]):int(cu[i + 1])].clone() for i in range(cu.numel() - 1)]


def expand_cu_seqlens_plain(cu_seqlens, total: int | None = None):
    """:func:`expand_cu_seqlens` in PyTorch (``searchsorted``)."""
    cu = _cu(cu_seqlens)
    n = cu.numel() - 1
    total = int(cu[-1]) if total is None else int(total)
    idx = torch.arange(total, dtype=torch.int64)
    seg = torch.searchsorted(cu.long(), idx, right=True)
    starts = cu.long()[(seg - 1).clamp(0, n)]  # the padded tail restarts at cu[n]
    return seg.to(torch.int32), (idx - starts).to(torch.int32)
