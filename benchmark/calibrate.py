"""The readings a cell's limits are set from (PERF.md, section 2), in one
process:

    python -m benchmark.calibrate --workload <name> --first-seed <n>

Each of :data:`SEEDS` seeds sets the cell up afresh (its own weights and
inputs), runs :data:`STEPS` steps through the timed path and compares as a
run does.  The first :data:`CONTROL` seeds also read the control (the
reference in fp8 in the program's place) and, for training, the
half-batch fault (the reference with its loss over half of the clip).  It
measures nothing and needs the card; each seed's readings go to stdout as
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import cells, run

SEEDS, CONTROL, STEPS = 12, 3, 3


def calibrate(cell, seeds: list, control: int, steps: int, device="cuda") -> None:
    """Print each seed's readings as they come."""
    for i, seed in enumerate(seeds):
        t0 = time.time()
        job = cell.job_module().Job(cell, seed, device)
        job.setup()
        job.window(steps=steps)
        job.release()
        t1 = time.time()
        faults = {"half_batch": i < control} if job.training else {}
        row = {"seed": seed, "setup_and_steps_s": t1 - t0,
               **job.check(control=i < control, **faults)}
        row["check_s"] = time.time() - t1
        print(json.dumps(row), flush=True)
        del job


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("calibration reads the card's numbers; no CUDA device", file=sys.stderr)
        return 2
    run.cache_dirs(cells.ROOT)
    calibrate(cell, [args.first_seed + i for i in range(SEEDS)], CONTROL, STEPS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
