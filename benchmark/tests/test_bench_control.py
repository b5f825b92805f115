"""The control on the card, at each cell's own size: the reference put in
the program's place with the configuration's bf16 products in fp8 must
come out not correct under the cell's limits, on three seeds, where the
program on the same seeds comes out correct.  ``benchmark.calibrate``
reads the same numbers on more seeds for PERF.md."""

import pytest

from benchmark import cells, compare

SEEDS = (3900000001, 3900000002, 3900000003)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in cells.load_benchmark()["workloads"]])
def test_the_control_fails_where_the_program_passes(workload, card):
    from benchmark import run

    run.cache_dirs(cells.ROOT)
    cell = cells.load_cell(workload)
    for seed in SEEDS:
        job = cell.job_module().Job(cell, seed, card)
        job.setup()
        job.window(steps=3)
        job.release()
        got = job.check(control=True)
        assert compare.verdict(got["program"], cell.limits)[0], (seed, got["program"])
        assert not compare.verdict(got["control"], cell.limits)[0], (seed, got["control"])
