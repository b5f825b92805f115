"""Stage-dump parity harness (reference: the fork's save-once tensor dumps,
core.py:320-352 / core.py:845-881 / gfx942.hip:270-323 — reimagined without
hot-path hacks or hardcoded /home/tmp paths).  The counterpart of the JAX
package's ``utils/dump.py``.

Usage::

    dumper = StageDumper("dumps/run1")
    dumper("q_int8", q_i8)                  # saves once per key
    ...
    # offline, against another backend's dumps:
    report = dumper.compare_against("dumps/run2")

Each tensor is written once per key per run (atomic marker semantics like
the reference, but per-directory instead of global).  A tensor on the card
is copied to the host first, and a 16-bit or fp8 float tensor is saved as
fp32, so that every dump loads with plain numpy (which has no bf16 or fp8)
and compares with :mod:`utils.compare`.  A dump of the port and one of the
JAX package compare in both directions where their stages are fp32 or
integer.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from sageattention_tpu_torch.utils import compare

# the float types numpy cannot hold, widened to fp32 before saving
_WIDEN = (torch.bfloat16, torch.float16, torch.float8_e4m3fn, torch.float8_e5m2)


def _host_array(value) -> np.ndarray:
    """``value`` as a numpy array on the host, 16-bit and fp8 floats as fp32."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype in _WIDEN:
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def _npy_keys(directory: str) -> list[str]:
    return sorted(f[:-4] for f in os.listdir(directory) if f.endswith(".npy"))


class StageDumper:
    """Save named intermediate tensors once each, for offline parity diffs."""

    def __init__(self, directory: str, enabled: bool = True):
        self.directory = directory
        self.enabled = enabled
        self._seen: set[str] = set()
        if enabled:
            os.makedirs(directory, exist_ok=True)

    def __call__(self, key: str, value) -> None:
        if not self.enabled or key in self._seen:
            return
        self._seen.add(key)
        path = os.path.join(self.directory, f"{key}.npy")
        if os.path.exists(path):
            return  # another process/run already dumped this stage
        # per-process temp name: concurrent rank dumps of the same key
        # must not interleave writes before the atomic publish
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:  # handle: np.save would append .npy
            np.save(f, _host_array(value))
        os.replace(tmp, path)  # atomic publish

    def keys(self) -> list[str]:
        return _npy_keys(self.directory)

    def load(self, key: str) -> np.ndarray:
        return load_dump(self.directory, key)

    def compare_against(self, other_dir: str, threshold: float = 0.002) -> list[dict]:
        """Diff every common stage against another dump directory
        (the offline analogue of reference utils/count.py runs)."""
        common = set(self.keys()) & set(_npy_keys(other_dir))
        return [compare.compare_report(self.load(key), load_dump(other_dir, key), name=key,
                                       threshold=threshold)
                for key in sorted(common)]


def load_dump(directory: str, key: str) -> np.ndarray:
    return np.load(os.path.join(directory, f"{key}.npy"))


def write_report(reports: list[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(reports, f, indent=2)
