"""A measurement without the card fails and prints no result: it never
falls back to the CPU; nor does a run in a directory that holds only the
benchmark."""

import os
import shutil
import subprocess
import sys

from benchmark import cells

ARGS = ["-m", "benchmark.run", "--workload", "cogvideox-2b.t2v-cfg", "--seed", "3000000019",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    out = _run(cells.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "not measuring" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
