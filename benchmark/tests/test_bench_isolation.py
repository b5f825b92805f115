"""The benchmark runs the port without JAX: no module under benchmark/
imports jax, jaxlib, flax or the JAX package (top-level names compared
whole, so sageattention_tpu_torch passes), and the plain reference
imports nothing but torch, the standard library and itself."""

import ast
import pathlib
import subprocess
import sys

import pytest

from benchmark import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "sageattention_tpu"}
MODULES = sorted(p for p in cells.HERE.rglob("*.py") if p.parent.name != "tests")
REFERENCE = sorted((cells.HERE / "reference").glob("*.py"))


def modules(path: pathlib.Path) -> set:
    """Every module ``path`` imports, by its full name, with the names of
    ``importlib.import_module`` calls given as constants."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(node.args[0].value)
    return out


def tops(path) -> set:
    return {m.split(".")[0] for m in modules(path)}


def test_names_are_compared_whole():
    assert "sageattention_tpu_torch" in tops(cells.HERE / "jobs" / "common.py")
    assert not tops(cells.HERE / "jobs" / "common.py") & FORBIDDEN


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(cells.HERE)))
def test_no_module_imports_jax(path):
    assert not tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for m in modules(path):
        assert m.split(".")[0] in {"__future__", "contextlib", "math", "torch"} or \
            m.startswith("benchmark.reference"), m


def test_loading_every_cell_loads_no_jax():
    code = ("from benchmark import calibrate, cells, run\n"
            "for w in cells.load_benchmark()['workloads']:\n"
            "    c = cells.load_cell(w['name']); c.job_module(); c.reference()\n"
            "    [cells.metric_reader(m['name']) for m in c.per_layer]\n"
            "import sageattention_tpu_torch.serve, sageattention_tpu_torch.train\n"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
