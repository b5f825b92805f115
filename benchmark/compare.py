"""The numbers that decide ``correct``: how far what the timed path
produced lies from the plain reference, each held to the cell's limit
(``limits/<workload>.json``, set from the readings PERF.md gives).

Denoise: a step's answer is its update x' - x of the fp32 sampler state.
``rel_l2`` is ||update - reference update|| / ||reference update||, and
``max_gap`` the largest element's gap in units of the reference update's
root mean square, which one altered element cannot hide from.

Fine-tuning, over the steps the reference follows (``followed_steps``):
``grad_gap`` the worst leaf's gap between the norms of the first gradient
(as AdamW holds it after one step); ``change_gap`` the worst leaf's gap
between the norms of the parameters' change over the followed steps.  A
leaf's gap is measured against the reference's norm of that leaf or of
the median leaf, whichever is larger.  Leaves whose reference gradient is
under a thousandth of the median leaf's (a key norm's bias, which softmax
cancels) move under Adam by round-off alone and are left out of
``change_gap``.  ``loss_gap``, the largest relative gap of a step's loss,
is reported and not compared: neither the control nor a fault reads three
times its sound runs' highest (PERF.md, section 2).
"""

from __future__ import annotations

import statistics

import torch

TINY_GRADIENT = 1e-3  # of the median leaf's reference gradient norm


def update_readings(update, ref_update) -> dict:
    diff = (update.double() - ref_update.double())
    ref = ref_update.double()
    ref_norm = ref.norm().item()
    return {"rel_l2": diff.norm().item() / ref_norm,
            "max_gap": diff.abs().max().item() / (ref_norm / ref.numel() ** 0.5)}


def _worst_leaf(prog: dict, ref: dict, leaves) -> float:
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves)


def training_readings(prog: dict, ref: dict) -> tuple:
    """(the compared readings; the loss gap and the leaves left out, which
    are not compared) of ``prog`` against ``ref``, each {"losses": [...],
    "grad": {leaf: norm}, "change": {leaf: norm}}."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    leaves = sorted(ref["grad"])
    med = statistics.median(ref["grad"][k] for k in leaves)
    moved = [k for k in leaves if ref["grad"][k] >= TINY_GRADIENT * med]
    compared = {"grad_gap": _worst_leaf(prog["grad"], ref["grad"], leaves),
                "change_gap": _worst_leaf(prog["change"], ref["change"], moved)}
    return compared, {"loss_gap": loss_gap, "left_out": sorted(set(leaves) - set(moved))}


def leaf_norms(tensors: dict, scale: float = 1.0) -> dict:
    """name -> float norm (fp64 sum) of each tensor times ``scale``, read
    with one copy to the host."""
    names = list(tensors)
    norms = torch.stack([tensors[k].detach().double().norm() for k in names]) * scale
    return dict(zip(names, norms.cpu().tolist()))


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, checks): each reading ``<where>_<what>`` beside the limit
    ``<what>`` (or ``<where>_<what>``); a missing limit or a reading that is
    not a number fails."""
    checks, ok = {}, True
    for name, value in readings.items():
        key = name if name in limits else name.split("_", 1)[-1]
        limit = limits.get(key)
        passed = limit is not None and value == value and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
