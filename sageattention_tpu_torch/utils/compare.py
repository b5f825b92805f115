"""Accuracy comparators: whole-tensor cosine similarity (the reference's
headline end-to-end metric, reference: utils/count_per_row.py) and the
largest absolute difference.  A copy of the JAX package's
``utils/compare.py`` for what the port uses, the cosine summed in fp64.
Inputs are numpy arrays or CPU tensors (``.cpu()`` a CUDA tensor first).
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
