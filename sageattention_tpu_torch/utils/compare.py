"""Accuracy comparators (reference: utils/count.py, count_per_row.py,
count_per_col.py, torch_per_row.py).

The reference validates cross-backend numerics with offline tensor diffs:
chunked elementwise comparison with a relative-error rate at a 0.002
threshold (reference: utils/count.py:8-10) and per-row / per-column cosine
similarity exported to CSV (reference: utils/count_per_row.py:1-12).
A copy of the JAX package's ``utils/compare.py``, used by the tests and
the stage-dump parity harness (``utils/dump.py``).  The cosines are
summed in fp64, the rest follows the JAX arithmetic.  Inputs are numpy
arrays or CPU tensors (``.cpu()`` a CUDA tensor first).
"""

from __future__ import annotations

import numpy as np


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def cosine_similarity(a, b) -> float:
    """Whole-tensor cosine similarity, summed in fp64: an fp32 dot over
    millions of elements can lose 2e-4 of the cosine (an attention output
    of 34M elements against exact attention read 0.999734 summed in fp32,
    0.999935 in fp64)."""
    a, b = np.asarray(a, dtype=np.float64).ravel(), np.asarray(b, dtype=np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0.0 and nb == 0.0:
        return 1.0
    return float(np.dot(a, b) / max(na * nb, 1e-45))


def max_abs_err(a, b) -> float:
    """Largest elementwise |a - b|."""
    diff = np.abs(_f32(a) - _f32(b))
    return float(diff.max()) if diff.size else 0.0


def rel_err_rate(a, b, threshold: float = 0.002) -> float:
    """Fraction of elements whose |a-b| / (|b|+eps) exceeds ``threshold``
    (reference: utils/count.py:8-10 counts errors at the 0.002 level)."""
    a, b = _f32(a).ravel(), _f32(b).ravel()
    rel = np.abs(a - b) / (np.abs(b) + 1e-6)
    return float(np.mean(rel > threshold))


def per_axis_cosine(a, b, axis: int = -1) -> np.ndarray:
    """Cosine similarity along one axis, all other axes kept (reference:
    utils/count_per_row.py / count_per_col.py per-row/per-col CSVs),
    summed in fp64 and returned in fp32."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    num = np.sum(a * b, axis=axis)
    den = np.linalg.norm(a, axis=axis) * np.linalg.norm(b, axis=axis)
    return (num / np.maximum(den, 1e-45)).astype(np.float32)


def compare_report(a, b, name: str = "tensor", threshold: float = 0.002) -> dict:
    """The full diff report the reference's comparators print: max/mean
    absolute error, rel-err rate, cosine, worst-row cosine."""
    a32, b32 = _f32(a), _f32(b)
    diff = np.abs(a32 - b32)
    row_cos = per_axis_cosine(a32, b32, axis=-1)
    return {
        "name": name,
        "shape": tuple(a32.shape),
        "max_abs_err": float(diff.max()) if diff.size else 0.0,
        "mean_abs_err": float(diff.mean()) if diff.size else 0.0,
        "rel_err_rate": rel_err_rate(a32, b32, threshold),
        "cosine": cosine_similarity(a32, b32),
        "worst_row_cosine": float(row_cos.min()) if row_cos.size else 1.0,
    }
