"""Tiny versions of the benchmark's cells for the CPU tests: each cell's
configuration and traffic at a few hundred tokens, with its own limits."""

import copy

from benchmark import cells


def tiny_cell(workload: str) -> cells.Cell:
    cell = cells.load_cell(workload)
    config = copy.deepcopy(cell.config)
    run = config["run"]
    run.update(hidden=128, heads=2, head_dim=64, text_len=8)
    run["depth"] = {k: 2 for k in run["depth"]} if isinstance(run["depth"], dict) else 2
    traffic = dict(cell.traffic, frames=5, height=64, width=64)
    return cells.Cell(cell.name, 1, config, traffic, cell.end_to_end, cell.per_layer, cell.limits)
