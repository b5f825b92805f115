"""Build the CUDA sources under ``csrc/`` on first use and load them.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so`` at the repo
root (``$SAGEATTN_TORCH_BUILD`` overrides the directory), compiled by
``nvcc`` for ``sm_90a`` with a plain C interface and loaded with
``ctypes``.  The hash covers the sources and the flags, so an edited
kernel is rebuilt and a built one is reused.

No ``--use_fast_math``: it turns ``1/scale`` into an approximate divide
and flushes denormals, and the quantizers must match the spec bit for
bit.  Nothing here runs at import time, so the package imports on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

# the head dims the kernels compute at; a caller's head dim is padded up
# to one of them by the JAX rule (pad_head_dim)
HEAD_DIMS = (64, 128, 256, 384, 512)
MAX_HEAD_DIM = HEAD_DIMS[-1]


def pad_head_dim(d: int) -> int:
    """The kernels' head dim for d <= 512: 64, 128, 256, 384 or 512 (the
    JAX rule: 64, or the next multiple of 128)."""
    return 64 if d <= 64 else -(-d // 128) * 128


_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# every source's entry points, with their ctypes signatures: pointers and
# the stream are c_void_p (a bare int would be cut to 32 bits)
P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES = {
    "quant_k": {
        # k, the chunks' sums, the counters, km; bh, s, d, chunk rows, bf16; the stream
        "k_channel_mean": [P] * 4 + [I] * 5 + [P],
        # k, km, out, scales; bh, s, d, group, bf16; qmax, 1/qmax; the plan
        # (unit rows, stages, staged rows, grid); the stream
        "quant_k_chunked": [P, P, P, P, I, I, I, I, I, F, F, I, I, I, I, P],
    },
    "quant_q": {
        # x, mean, out, scales; bh, s, d, x_is_f32, group, cast; qs_mul, qmax,
        # 1/qmax; the plan (slots, cluster size, tiles a slab); the stream
        "quant_rows": [P] * 4 + [I] * 6 + [F] * 3 + [I] * 3 + [P],
    },
    "quant_v": {
        # v, out, scale, mean; bh, s, d, bf16, kind, smooth; the plan (cluster
        # size, rows a CTA, rows it stages, clusters); the stream
        "quant_v_per_channel": [P] * 4 + [I] * 10 + [P],
        # cluster size, shared memory a CTA, bf16; out: the clusters the card
        # holds at once
        "quant_v_cluster_room": [I, I, I, P],
        "quant_v_stats": [P] * 4 + [I] * 5 + [P],
        "quant_v_apply": [P] * 4 + [I] * 6 + [P],
    },
    "attention_fwd": {
        "sage_attn_fwd": [P] * 8 + [I] * 11 + [F, P],
    },
    # V codes -> bf16 before the wgmma forward: src, dst, n, the V kind, the stream
    "widen_v": {
        "widen_v_codes": [P, P, LL, I, P],
    },
    "attention_fwd_masked": {
        # sage_attn_fwd's operands, the nine mask pointers, ten strides,
        # the window and the bias type
        "sage_attn_fwd_masked": [P] * 8 + [I] * 11 + [F, P] + [P] * 9 + [LL] * 10 + [I] * 2,
    },
    # the forward's D = 256 instances, with the operands of the two above
    "attention_fwd_hd256": {
        "sage_attn_fwd_hd256": [P] * 8 + [I] * 11 + [F, P],
    },
    "attention_fwd_masked_hd256": {
        "sage_attn_fwd_masked_hd256": [P] * 8 + [I] * 11 + [F, P] + [P] * 9 + [LL] * 10 + [I] * 2,
    },
    "attention_fwd_preq": {
        # sage_attn_fwd's operands less q_is_f32 and qs_mul; ks_per_row,
        # o_f32, q_scale, col_bias, the stream; then `masked` and
        # sage_attn_fwd_masked's masks
        "sage_attn_fwd_preq": [P] * 8 + [I] * 12 + [P] * 3 + [I] + [P] * 9 + [LL] * 10 + [I] * 2,
    },
    # the pre-quantized forward's D = 256 instances, with its operands
    "attention_fwd_preq_hd256": {
        "sage_attn_fwd_preq_hd256": [P] * 8 + [I] * 12 + [P] * 3 + [I] + [P] * 9 + [LL] * 10
        + [I] * 2,
    },
    # the forward's D = 384 and 512 instances, with the operands of the
    # default, masked and pre-quantized forwards; the unmasked ones are one
    # CTA a Q tile with O's columns split between two warpgroups, the masked
    # ones split O over CTAs
    "attention_fwd_wide": {
        "sage_attn_fwd_wide": [P] * 8 + [I] * 11 + [F, P],
    },
    "attention_fwd_masked_wide": {
        "sage_attn_fwd_masked_wide": [P] * 8 + [I] * 11 + [F, P] + [P] * 9 + [LL] * 10 + [I] * 2,
    },
    "attention_fwd_preq_wide": {
        "sage_attn_fwd_preq_wide": [P] * 8 + [I] * 12 + [P] * 3 + [I] + [P] * 9 + [LL] * 10
        + [I] * 2,
    },
    "attention_bwd": {
        "sage_attn_bwd_dq": [P] * 10 + [I] * 9 + [F, P],
        "sage_attn_bwd_dkv": [P] * 11 + [I] * 9 + [F, P],
        # the operands, the bias and (dQ) dBias; the shape, causal, the bias
        # kind (bit 0 bf16, bit 1 the loads) and the group; sm_scale, the stream
        "sage_attn_bwd_dq_bias": [P] * 12 + [I] * 9 + [F, P],
        "sage_attn_bwd_dkv_bias": [P] * 12 + [I] * 9 + [F, P],
    },
    "probe_mma": {
        # wg, op, n, ks; x, y, out; reps, grid; blocks_per_sm (or NULL), the stream
        "probe_mma": [I] * 4 + [P] * 3 + [I] * 2 + [P] * 2,
        # body; x, out; reps, grid; blocks_per_sm (or NULL), the stream
        "probe_elem": [I, P, P, I, I, P, P],
        # copy; src, dst (or the partial sums); n16, reps, grid, the stream
        "probe_hbm": [I, P, P, LL, I, I, P],
    },
    # kernels 9-12 take the split walk's plan (cl, splits) and its workspace
    # (partials, tickets; NULL with one split) after the stream
    "decode": {
        "sage_decode": [P] * 9 + [I] * 10 + [F, P] + [I, I, P, P],
        "sage_decode_window": [P] * 9 + [I] * 10 + [F, P] + [I, I, P, P],
    },
    "paged_decode": {
        # decode's operands with the page table and the owned mask (or NULL)
        "sage_paged_decode": [P] * 11 + [I] * 10 + [F, P] + [I, I, P, P],
        "sage_paged_decode_window": [P] * 11 + [I] * 10 + [F, P] + [I, I, P, P],
    },
    # the decode kernels' instances at head dims in (256, 512], with the
    # operands of the two above
    "decode_wide": {
        "sage_decode_wide": [P] * 9 + [I] * 10 + [F, P] + [I, I, P, P],
        "sage_decode_window_wide": [P] * 9 + [I] * 10 + [F, P] + [I, I, P, P],
    },
    "paged_decode_wide": {
        "sage_paged_decode_wide": [P] * 11 + [I] * 10 + [F, P] + [I, I, P, P],
        "sage_paged_decode_window_wide": [P] * 11 + [I] * 10 + [F, P] + [I, I, P, P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
# one lock per library, so that threads loading different libraries
# compile them in parallel
_LOCKS = {name: threading.Lock() for name in SIGNATURES}


def build_dir() -> pathlib.Path:
    return pathlib.Path(
        os.environ.get("SAGEATTN_TORCH_BUILD", _PKG.parent / "build")
    )


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of sageattention_tpu_torch cannot be built"
    )


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        # headers are shared, so every library hashes all of them
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> None:
    out = _target(name)
    if out.exists():
        return
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCKS[name]:
        if name not in _LIBS:
            _compile(name)
            so = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(so, fn).argtypes = argtypes
                getattr(so, fn).restype = ctypes.c_int
            _LIBS[name] = so
        return _LIBS[name]


def count_launch(fn, d: int) -> None:
    """One more launch on wrapper ``fn``'s counter for head dim ``d``: the
    instances at 64 and 128 in ``fn.launches``, those at 256, 384 and 512
    apart, in ``fn.hd<d>_launches``."""
    attr = "launches" if d <= 128 else f"hd{d}_launches"
    setattr(fn, attr, getattr(fn, attr) + 1)


def zero_counters(*fns) -> None:
    """Every head dim's launch counter of each wrapper in ``fns``, at 0."""
    for fn in fns:
        fn.launches = fn.hd256_launches = fn.hd384_launches = fn.hd512_launches = 0


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")
