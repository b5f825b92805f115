"""The port's context-parallel attention (``sageattention_tpu_torch.parallel``:
the KV ring, Ulysses, ``make_parallel_sageattn`` and the "sage_parallel"
backend) in a world of 4 ranks under gloo on the CPU, against the JAX
package.

How the worlds run: a module-scoped fixture starts 4 processes of this file
(``python tests/test_torch_parallel.py --worker DIR RANK 4``), each of which
joins one gloo group through a ``FileStore`` in ``DIR`` (no port) with a
60 s collective timeout and one thread, and runs every case of the file in
it, writing each case's result (or its traceback) to ``DIR``.  The parent
joins them with a timeout and kills them past it, failing with their logs,
so no test can hang the suite.  The ranks import torch, numpy and the port
only; the JAX references are computed here, from the same seeded numpy
inputs (:func:`qkv`).

The JAX ``ring_sageattn``, Ulysses and ``make_parallel_sageattn`` raise at
this revision (``core._entry``), so the references are put back together
from pieces that work: each ring step is ``core._sageattn_hnd(impl="xla",
chunk_k=G, return_lse=True)`` (G the port's K-scale group), merged by the
JAX ``ring._merge``.  Without K smoothing, port and reference quantize
the same blocks to the same codes, so they agree to fp32 round-off, the
tolerance of ``test_torch_core.py``: o atol 1e-5, LSE 1e-4.  With it (the
default) the two K means are summed in other orders, which can move a K
code one step (as in ``test_torch_qopts.py`` and ``test_torch_hd256.py``):
cosine >= 0.99999, o max-abs <= 5e-3, LSE 1e-3.  Each case runs both.
Against exact fp32 attention the cosine stays >= 0.999 (the verify skill's
threshold).
"""

from __future__ import annotations

import datetime
import os
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from sageattention_tpu_torch import core, models, serve  # noqa: E402
from sageattention_tpu_torch import parallel as tpar  # noqa: E402
from sageattention_tpu_torch.ops import reference  # noqa: E402
from sageattention_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from sageattention_tpu_torch.parallel import ring as tring  # noqa: E402
from sageattention_tpu_torch.utils.compare import cosine_similarity  # noqa: E402

if "--worker" not in sys.argv:  # the spawned ranks import torch, numpy and the port only
    import jax.numpy as jnp

    from sageattention_tpu import core as jcore
    from sageattention_tpu.parallel import ring as jring

WORLD = 4
JOIN_TIMEOUT_S = 240
G = core.K_GROUP


# --------------------------------------------------------------------------
# the worlds: spawned ranks, their results
# --------------------------------------------------------------------------


def spawn_world(script: str, workdir: pathlib.Path, world: int = WORLD) -> pathlib.Path:
    """Run ``script --worker workdir rank world`` in ``world`` processes and
    wait for them all; fail with their logs if one fails or the join times
    out (the processes are killed then)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, script, "--worker", str(workdir), str(r),
                               str(world)], stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    timed_out = False
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs:
        f.close()
    codes = [p.returncode for p in procs]
    if timed_out or any(codes):
        text = "\n".join(f"--- rank {r} (exit {codes[r]}) ---\n"
                         f"{(workdir / f'rank{r}.log').read_text()[-6000:]}"
                         for r in range(world))
        pytest.fail(f"the world of {world} {'timed out' if timed_out else 'failed'}:\n{text}")
    return workdir


def worker_main(cases: dict, argv) -> None:
    """A rank: join the gloo group, run every case, save each result."""
    workdir, rank, world = pathlib.Path(argv[2]), int(argv[3]), int(argv[4])
    torch.set_num_threads(1)
    store = dist.FileStore(str(workdir / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    for name, fn in cases.items():
        try:  # a case that fails is reported by its test; the others still run
            out = fn(rank)
        except Exception:
            (workdir / f"{name}.rank{rank}.err").write_text(traceback.format_exc())
            continue
        torch.save(out, workdir / f"{name}.rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def result(workdir: pathlib.Path, name: str, rank: int):
    err = workdir / f"{name}.rank{rank}.err"
    if err.exists():
        pytest.fail(f"case {name} raised on rank {rank}:\n{err.read_text()}")
    return torch.load(workdir / f"{name}.rank{rank}.pt")


# --------------------------------------------------------------------------
# inputs and the JAX references
# --------------------------------------------------------------------------


def qkv(seed: int, b: int, hq: int, hkv: int, s: int, d: int):
    """Seeded fp32 numpy q, k, v [b, h, s, d] (K with an offset, which K
    smoothing takes out)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) + 0.5).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


def jax_step(q, k, v, causal: bool, smooth_k: bool):
    o, lse = jcore._sageattn_hnd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None, None, None, None,
        impl="xla", chunk_k=G, qk_quant_gran="auto", pv_dtype="bf16", smooth_k=smooth_k,
        smooth_v=False, return_lse=True, is_causal=causal, sm_scale=None, block_q=128,
        block_k=128)
    return o, lse


def jax_ring(q, k, v, n: int, causal: bool, smooth_k: bool):
    """The JAX ring over ``n`` blocks of the sequence, step by step: global
    (o, LSE) as numpy."""
    b, hq, s, d = q.shape
    sl = s // n
    blk = [slice(i * sl, (i + 1) * sl) for i in range(n)]
    outs, lses = [], []
    for idx in range(n):
        qi = q[:, :, blk[idx]]
        o_acc = jnp.zeros((b, hq, sl, d), jnp.float32)
        lse_acc = jnp.full((b, hq, sl), jring._NEG, jnp.float32)
        for step in range(n):
            src = (idx - step) % n
            if causal and src > idx:
                continue
            o_i, lse_i = jax_step(qi, k[:, :, blk[src]], v[:, :, blk[src]], causal and src == idx,
                                  smooth_k)
            o_acc, lse_acc = jring._merge(o_acc, lse_acc, o_i.astype(jnp.float32), lse_i)
        outs.append(np.asarray(o_acc))
        lses.append(np.asarray(jnp.where(lse_acc < jring._NEG / 2, -jnp.inf, lse_acc)))
    return np.concatenate(outs, axis=2), np.concatenate(lses, axis=2)


def exact(q, k, v, causal: bool) -> torch.Tensor:
    return reference.attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), is_causal=causal)


# --------------------------------------------------------------------------
# the cases each rank runs (global view unless the name says local)
# --------------------------------------------------------------------------

# name: (seed, b, hq, hkv, s, d, causal)
RING = {
    "ring_causal_gqa": (1, 1, 4, 2, 256, 64, True),
    "ring_full_gqa": (2, 2, 4, 2, 256, 64, False),
    "ring_causal_ragged_d80": (3, 1, 2, 2, 200, 80, True),
}
ULYSSES = {
    "ulysses_causal_gqa": (4, 1, 8, 4, 256, 64, True),
    "ulysses_full": (5, 2, 4, 4, 128, 64, False),
}
ALLGATHER = {"allgather_causal": (6, 1, 4, 2, 256, 64, True)}
# name: (seed, b, hq, hkv, s, d, causal, (data, seq, heads), layout)
API = {
    "api_seq2_heads2_causal": (7, 1, 4, 2, 256, 64, True, (1, 2, 2), "HND"),
    "api_data2_seq2_causal_nhd": (8, 2, 4, 2, 256, 64, True, (2, 2, 1), "NHD"),
    "api_seq4_full": (9, 1, 4, 4, 256, 64, False, (1, 4, 1), "HND"),
}

_MESHES: dict = {}


def mesh_of(shape):
    """The (data, seq, heads) mesh of this world (made once a process: a
    mesh makes its groups collectively)."""
    if shape not in _MESHES:
        _MESHES[shape] = tpar.make_mesh(*shape, device_type="cpu")
    return _MESHES[shape]


def both(call) -> dict:
    """``call(**kw)``'s (o, LSE) without K smoothing ("o", "lse") and with it,
    the default ("o_sk", "lse_sk")."""
    o, lse = call(smooth_k=False)
    o_sk, lse_sk = call()
    return {"o": o, "lse": lse, "o_sk": o_sk, "lse_sk": lse_sk}


def _ring_case(spec):
    seed, b, hq, hkv, s, d, causal = spec

    def run(rank):
        q, k, v = (torch.from_numpy(x) for x in qkv(seed, b, hq, hkv, s, d))
        out = both(lambda **kw: tpar.make_ring_attention(
            mesh_of((1, WORLD, 1)), "seq", is_causal=causal, return_lse=True, **kw)(q, k, v))
        # the local body on this rank's blocks, with the default group
        blk = slice(rank * s // WORLD, (rank + 1) * s // WORLD)
        out["o_local"], out["lse_local"] = tpar.ring_sageattn(
            q[:, :, blk], k[:, :, blk], v[:, :, blk], is_causal=causal, return_lse=True,
            smooth_k=False)
        return out

    return run


def _ulysses_case(spec):
    seed, b, hq, hkv, s, d, causal = spec

    def run(rank):
        q, k, v = (torch.from_numpy(x) for x in qkv(seed, b, hq, hkv, s, d))
        return both(lambda **kw: tpar.make_ulysses_attention(
            mesh_of((1, 1, WORLD)), "heads", is_causal=causal, return_lse=True, **kw)(q, k, v))

    return run


def _allgather_case(spec):
    seed, b, hq, hkv, s, d, causal = spec

    def run(rank):
        q, k, v = (torch.from_numpy(x) for x in qkv(seed, b, hq, hkv, s, d))
        blk = slice(rank * s // WORLD, (rank + 1) * s // WORLD)
        return both(lambda **kw: tring.allgather_sageattn(
            q[:, :, blk], k[:, :, blk], v[:, :, blk], is_causal=causal, return_lse=True, **kw))

    return run


def _api_case(spec):
    seed, b, hq, hkv, s, d, causal, shape, layout = spec

    def run(rank):
        q, k, v = (torch.from_numpy(x) for x in qkv(seed, b, hq, hkv, s, d))
        if layout == "NHD":
            q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        out = both(lambda **kw: tpar.make_parallel_sageattn(
            mesh_of(shape), is_causal=causal, tensor_layout=layout, return_lse=True, **kw)(q, k, v))
        if layout == "NHD":
            out = {n: x.transpose(1, 2) if n.startswith("o") else x for n, x in out.items()}
        return out

    return run


def tiny_dit_cfg():
    return models.MODEL_CONFIGS["cogvideox-2b"].scaled(
        depth=2, latent_frames=2, latent_height=8, latent_width=8, text_len=7, hidden=128,
        heads=4, head_dim=32)


def _dit_case(rank):
    """A narrow VideoDiT through "sage_parallel" (ring 2 x Ulysses 2) and
    through "sage", the same weights and a CFG pair of requests."""
    mesh = mesh_of((1, 2, 2))
    cfg = serve.parallel_config(tiny_dit_cfg(), mesh)
    model = serve.load_model(cfg, device="cpu", dtype=torch.float32, seed=3)
    reqs = serve.make_requests(cfg, 1, device="cpu", dtype=torch.float32, seed=4, batch=2)
    par = serve.serve_parallel(model, reqs, 2, mesh)
    ref = serve.serve(model, reqs, 2)
    return {"parallel": par["outputs"][0], "sage": ref["outputs"][0], "text_len": cfg.text_len,
            "seq_len": cfg.seq_len, "backend_after": models.get_attention_backend()}


def _guards_case(rank):
    """The entry points raise, and do not fall back: under grad, a
    Ulysses degree that does not divide the heads, an axis the mesh lacks."""
    mesh = mesh_of((1, WORLD, 1))
    q = torch.randn(1, 4, 64, 32, requires_grad=True)
    k, v = torch.randn(1, 2, 64, 32), torch.randn(1, 2, 64, 32)
    raised = {}
    for name, call in {
        "ring": lambda: tpar.ring_sageattn(q[:, :, :16], k[:, :, :16], v[:, :, :16]),
        "api": lambda: tpar.make_parallel_sageattn(mesh)(q, k, v),
        "ulysses": lambda: tpar.ulysses_sageattn(q[:, :, :16], k[:, :, :16], v[:, :, :16]),
        "sharded_decode": lambda: tpar.make_sharded_decode(mesh)(q, None, None),
    }.items():
        try:
            call()
            raised[name] = None
        except NotImplementedError as e:
            raised[name] = str(e)
    with torch.no_grad():
        try:
            tpar.ulysses_sageattn(torch.randn(1, 6, 16, 32), torch.randn(1, 2, 16, 32),
                                  torch.randn(1, 2, 16, 32))
            raised["divisibility"] = None
        except ValueError as e:
            raised["divisibility"] = str(e)
        try:
            tpar.make_ring_attention(mesh, "nope")
            raised["axis"] = None
        except ValueError as e:
            raised["axis"] = str(e)
    return raised


CASES = {
    **{n: _ring_case(s) for n, s in RING.items()},
    **{n: _ulysses_case(s) for n, s in ULYSSES.items()},
    **{n: _allgather_case(s) for n, s in ALLGATHER.items()},
    **{n: _api_case(s) for n, s in API.items()},
    "dit": _dit_case,
    "guards": _guards_case,
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(__file__, tmp_path_factory.mktemp("parallel_world"))


def jax_refs(q, k, v, causal, n: int):
    """The JAX ring over ``n`` blocks (one block: the whole op), without and
    with K smoothing."""
    def one(sk):
        if n > 1:
            return jax_ring(q, k, v, n, causal, sk)
        return tuple(np.asarray(x) for x in jax_step(q, k, v, causal, sk))

    return one(False), one(True)


def _check(r, q, k, v, causal, refs):
    (o_ref, lse_ref), (o_sk, lse_sk) = refs
    np.testing.assert_allclose(r["o"].numpy(), o_ref, atol=1e-5)
    np.testing.assert_allclose(r["lse"].numpy(), lse_ref, atol=1e-4)
    assert cosine_similarity(r["o_sk"], torch.tensor(o_sk)) >= 0.99999
    np.testing.assert_allclose(r["o_sk"].numpy(), o_sk, atol=5e-3)
    np.testing.assert_allclose(r["lse_sk"].numpy(), lse_sk, atol=1e-3)
    ex = exact(q, k, v, causal)
    assert cosine_similarity(r["o"], ex) >= 0.999 and cosine_similarity(r["o_sk"], ex) >= 0.999


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_matches_jax_ring(world, name):
    """Every rank's global output and LSE, and its local block, against the
    JAX ring put back together; GQA, causal (4 aligned, 6 full, 6 skipped
    steps) and not, a ragged length and a padded head dim."""
    seed, b, hq, hkv, s, d, causal = RING[name]
    q, k, v = qkv(seed, b, hq, hkv, s, d)
    refs = jax_refs(q, k, v, causal, WORLD)
    sl = s // WORLD
    for rank in range(WORLD):
        r = result(world, name, rank)
        _check(r, q, k, v, causal, refs)
        blk = slice(rank * sl, (rank + 1) * sl)
        np.testing.assert_array_equal(r["o_local"].numpy(), r["o"][:, :, blk].numpy())
        np.testing.assert_array_equal(r["lse_local"].numpy(), r["lse"][:, :, blk].numpy())


@pytest.mark.parametrize("name", sorted(ULYSSES))
def test_ulysses_matches_jax(world, name):
    """Ulysses over 4 ranks is whole-sequence attention on a quarter of the
    heads each: it equals the JAX op on the whole sequence."""
    seed, b, hq, hkv, s, d, causal = ULYSSES[name]
    q, k, v = qkv(seed, b, hq, hkv, s, d)
    refs = jax_refs(q, k, v, causal, 1)
    for rank in range(WORLD):
        _check(result(world, name, rank), q, k, v, causal, refs)


@pytest.mark.parametrize("name", sorted(ALLGATHER))
def test_allgather_matches_jax_causal(world, name):
    """Each rank's queries against the gathered K/V, causal through
    positions (the masked kernel's plain version): the rows of the JAX op
    on the whole sequence."""
    seed, b, hq, hkv, s, d, causal = ALLGATHER[name]
    q, k, v = qkv(seed, b, hq, hkv, s, d)
    parts = [result(world, name, r) for r in range(WORLD)]
    whole = {n: torch.cat([p[n] for p in parts], dim=2) for n in parts[0]}
    assert whole["o"].shape == q.shape
    _check(whole, q, k, v, causal, jax_refs(q, k, v, causal, 1))


@pytest.mark.parametrize("name", sorted(API))
def test_parallel_sageattn_matches_jax(world, name):
    """``make_parallel_sageattn`` in the global view: seq 2 x heads 2 (Ulysses
    with the ring inside; the sequence blocks seq-major), data 2 x seq 2 in
    NHD, and seq 4; every rank gets the global output and LSE.  Causal
    checks catch a wrong block order, which non-causal attention hides."""
    seed, b, hq, hkv, s, d, causal, (dn, rn, un), _ = API[name]
    q, k, v = qkv(seed, b, hq, hkv, s, d)
    refs = jax_refs(q, k, v, causal, rn)
    for rank in range(WORLD):
        _check(result(world, name, rank), q, k, v, causal, refs)


def test_sage_parallel_backend_in_a_dit(world):
    """The "sage_parallel" backend in a narrow VideoDiT (ring 2 x Ulysses 2,
    a CFG pair, the text padded to the SP degree): the same denoised
    latents as "sage" on every rank (the ring's merge reorders fp32 sums:
    cosine >= 0.9999, max-abs 1e-3), and the backend set back after."""
    outs = [result(world, "dit", r) for r in range(WORLD)]
    assert outs[0]["seq_len"] % WORLD == 0 and outs[0]["text_len"] >= tiny_dit_cfg().text_len
    for r in outs:
        assert r["backend_after"] == "sage"
        assert cosine_similarity(r["parallel"], r["sage"]) >= 0.9999
        assert float((r["parallel"] - r["sage"]).abs().max()) <= 1e-3
        np.testing.assert_array_equal(r["parallel"].numpy(), outs[0]["parallel"].numpy())


def test_parallel_entry_points_refuse_grad_and_bad_meshes(world):
    for rank in range(WORLD):
        raised = result(world, "guards", rank)
        for name in ("ring", "api", "ulysses", "sharded_decode"):
            assert raised[name] and "ROADMAP" in raised[name], name
        assert raised["divisibility"] and "divisible" in raised["divisibility"]
        assert raised["axis"] and "no axis" in raised["axis"]


# --------------------------------------------------------------------------
# single-process checks
# --------------------------------------------------------------------------


def test_merge_attention_partials_matches_jax():
    """The port's ``merge_attention_partials`` against the JAX one on three
    partials of exact attention over disjoint KV blocks, and against the
    whole attention."""
    from sageattention_tpu.ops import reference as jref

    q, k, v = qkv(11, 1, 2, 2, 96, 32)
    parts = [reference.attention_reference(torch.from_numpy(q), torch.from_numpy(k[:, :, i:i + 32]),
                                           torch.from_numpy(v[:, :, i:i + 32]), return_lse=True)
             for i in (0, 32, 64)]
    o, lse = reference.merge_attention_partials([p[0] for p in parts], [p[1] for p in parts])
    oj, lsej = jref.merge_attention_partials([jnp.asarray(p[0].numpy()) for p in parts],
                                             [jnp.asarray(p[1].numpy()) for p in parts])
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lsej), atol=1e-6)
    np.testing.assert_allclose(o.numpy(), exact(q, k, v, False).numpy(), atol=1e-5)


def test_ring_steps_one_after_another_match_the_ring():
    """A world of 4's ring run by one process, rank after rank and step after
    step (``ring_step``, ``_merge``), as the card runs it: the JAX ring's
    numbers, and the causal launch pattern (4 aligned, 6 full, 6 skipped)."""
    q, k, v = qkv(12, 1, 4, 2, 256, 64)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    o_ref, lse_ref = jax_ring(q, k, v, WORLD, True, False)
    sl = 256 // WORLD
    kinds = {"aligned": 0, "full": 0, "skipped": 0}
    for idx in range(WORLD):
        o_acc, lse_acc = tring.init_state(qt[:, :, :sl])
        for step in range(WORLD):
            src = (idx - step) % WORLD
            part = tring.ring_step(qt[:, :, idx * sl:(idx + 1) * sl], kt[:, :, src * sl:(src + 1) * sl],
                                   vt[:, :, src * sl:(src + 1) * sl], src=src, idx=idx,
                                   is_causal=True, smooth_k=False)
            kinds["skipped" if part is None else "aligned" if src == idx else "full"] += 1
            if part is not None:
                o_acc, lse_acc = tring._merge(o_acc, lse_acc, part[0], part[1])
        o, lse = tring.finish(o_acc, lse_acc, qt.dtype, True)
        np.testing.assert_allclose(o.numpy(), o_ref[:, :, idx * sl:(idx + 1) * sl], atol=1e-5)
        np.testing.assert_allclose(lse.numpy(), lse_ref[:, :, idx * sl:(idx + 1) * sl], atol=1e-4)
    assert kinds == {"aligned": 4, "full": 6, "skipped": 6}


def test_mesh_refuses_without_a_group_or_a_card():
    if dist.is_initialized():
        pytest.fail("a process group is initialized in the test process")
    with pytest.raises(RuntimeError, match="no process group"):
        tpar.make_mesh(1, 1, 1, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.make_mesh(1, 1, 1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.initialize_multihost(world_size=1, rank=0)


def test_sage_parallel_without_a_mesh_raises():
    models.set_mesh(None)
    q = torch.randn(1, 2, 16, 32)
    with pytest.raises(RuntimeError, match="set_mesh"):
        models.attention(q, q, q, backend="sage_parallel")


if __name__ == "__main__":
    worker_main(CASES, sys.argv)
