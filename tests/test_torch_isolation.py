"""The port stands alone and hides no fallback.

* No file of ``sageattention_tpu_torch/`` nor ``chip_smoke.py`` imports
  ``jax``, ``flax`` or ``sageattention_tpu`` (the JAX package).
* The kernel wrappers, the build module and the op contain no ``try``, so no
  failed build or launch is swallowed.
* Every launch in a kernel wrapper runs under ``torch.cuda.device`` of its
  tensors, so a launch never goes to another device than its data's.
* Importing the package builds nothing; a build without ``nvcc`` raises.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "sageattention_tpu_torch"
FORBIDDEN = ("jax", "flax", "sageattention_tpu")
WRAPPERS = ("ops/quant_cuda.py", "ops/attention_cuda.py", "ops/attention_bwd_cuda.py",
            "ops/decode_cuda.py")
NO_TRY = ("ops/_build.py", *WRAPPERS, "ops/autodiff.py", "core.py", "train.py", "kvcache.py",
          "generate.py", "parallel/mesh.py", "parallel/decode.py", "parallel/ring.py",
          "parallel/ulysses.py", "parallel/api.py", "speculative.py", "baselines.py",
          "interop/__init__.py", "interop/torch_adapter.py", "models/mmdit.py")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("rel", NO_TRY)
def test_no_try_around_builds_or_launches(rel):
    tree = ast.parse((PKG / rel).read_text())
    tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert not tries, f"{rel}: try statements at lines {tries}"


def _is_build_lib(node):
    f = node.func if isinstance(node, ast.Call) else None
    return (isinstance(f, ast.Attribute) and f.attr == "lib"
            and isinstance(f.value, ast.Name) and f.value.id == "_build")


def _is_cuda_device_guard(item):
    f = item.context_expr.func if isinstance(item.context_expr, ast.Call) else None
    return isinstance(f, ast.Attribute) and ast.unparse(f) == "torch.cuda.device"


@pytest.mark.parametrize("rel", WRAPPERS)
def test_launches_run_under_their_tensors_device(rel):
    tree = ast.parse((PKG / rel).read_text())
    guarded = {
        id(n)
        for w in ast.walk(tree)
        if isinstance(w, ast.With) and any(map(_is_cuda_device_guard, w.items))
        for stmt in w.body for n in ast.walk(stmt)
    }
    launches = [n for n in ast.walk(tree) if _is_build_lib(n)]
    assert launches, f"{rel}: no kernel launch found"
    bare = [n.lineno for n in launches if id(n) not in guarded]
    assert not bare, f"{rel}: launches outside torch.cuda.device(...) at lines {bare}"


@pytest.mark.parametrize("rel,fn", [
    ("ops/attention_cuda.py", "sage_attention_fwd"),
    ("ops/attention_cuda.py", "sage_attention_fwd_masked"),
    ("ops/attention_cuda.py", "sage_attention_fwd_preq"),
    ("ops/quant_cuda.py", "quant_q_per_token"),
    ("ops/quant_cuda.py", "quant_k_chunked"),
])
def test_each_wrapper_guards_and_counts_its_launch(rel, fn):
    """The wrapper holds a launch under its tensors' device guard and counts
    it once on its own counters, through ``_build.count_launch(<wrapper>,
    d)`` (``<wrapper>.launches`` or ``.hd<d>_launches`` by head dim)."""
    tree = ast.parse((PKG / rel).read_text())
    func = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == fn)
    guards = [w for w in ast.walk(func) if isinstance(w, ast.With)
              and any(map(_is_cuda_device_guard, w.items))]
    assert any(_is_build_lib(n) for w in guards for n in ast.walk(w)), fn
    counts = [n for n in ast.walk(func) if isinstance(n, ast.Call)
              and ast.unparse(n.func) == "_build.count_launch"
              and ast.unparse(n.args[0]) == fn]
    assert len(counts) == 1, fn


@pytest.mark.parametrize("d,attr", [(64, "launches"), (128, "launches"),
                                    (256, "hd256_launches"), (384, "hd384_launches"),
                                    (512, "hd512_launches")])
def test_count_launch_picks_the_head_dims_counter(d, attr):
    """``count_launch`` adds one to the counter of head dim ``d`` alone."""
    from sageattention_tpu_torch.ops import _build

    def wrapper():
        pass

    _build.zero_counters(wrapper)
    _build.count_launch(wrapper, d)
    names = ("launches", "hd256_launches", "hd384_launches", "hd512_launches")
    assert {n: getattr(wrapper, n) for n in names} == {n: int(n == attr) for n in names}


def test_top_level_exports_resolve():
    """Every top-level name of the JAX package is the port's too."""
    import sageattention_tpu as jpkg

    import sageattention_tpu_torch as port

    for name in ("sageattn", "sageattn_varlen", "sageattn_qk_int8_pv_bf16",
                 "sageattn_qk_int8_pv_int8", "sageattn_qk_int8_pv_fp8", "quant", "reference",
                 "QuantKVCache", "PagedKVCache", "init_kv_cache", "init_paged_kv_cache",
                 "append_kv", "paged_append", "paged_prefill", "calibrate", "sageattn_decode",
                 "sageattn_paged_decode", "models", "speculative_verify", "__version__"):
        assert name in port.__all__ and getattr(port, name) is not None, name
    assert set(jpkg.__all__) <= set(port.__all__)
    assert port.__version__ == jpkg.__version__
    assert port.sageattn_decode.__module__ == "sageattention_tpu_torch.kvcache"
    assert port.speculative_verify.__module__ == "sageattention_tpu_torch.speculative"


def test_model_exports_resolve():
    """Every name of the JAX ``models`` package is the port's too."""
    from sageattention_tpu import models as jmodels

    from sageattention_tpu_torch import models as tmodels

    assert set(jmodels.__all__) <= set(tmodels.__all__)
    for name in jmodels.__all__:
        assert getattr(tmodels, name) is not None, name


def test_parallel_exports_resolve():
    """The names of the JAX ``parallel`` package resolve in the port's, and
    its modules import neither JAX nor the JAX package (checked with the
    other files above)."""
    from sageattention_tpu import parallel as jpar

    import sageattention_tpu_torch.parallel as tpar

    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    for name in jpar.__all__:
        assert callable(getattr(tpar, name)), name
    assert {p.name for p in (PKG / "parallel").glob("*.py")} >= {
        "__init__.py", "mesh.py", "decode.py", "ring.py", "ulysses.py", "api.py"}


def test_import_builds_nothing():
    from sageattention_tpu_torch.ops import _build

    import sageattention_tpu_torch  # noqa: F401

    assert _build._LIBS == {}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from sageattention_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("SAGEATTN_TORCH_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.lib("quant_k")
    assert "quant_k" not in _build._LIBS


def test_failed_launch_raises():
    from sageattention_tpu_torch.ops import _build

    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="cudaError 1"):
        _build.check(1, "a kernel")
