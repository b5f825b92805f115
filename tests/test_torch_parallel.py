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

Gradients: each rank takes the gradients of sum(o do) + sum(lse dlse)
(seeded cotangents) through the global view, where every rank's gradient
is the whole global one, and through the local bodies on its own blocks.
The JAX ring's gradient is rebuilt the same way as its forward: each
step's o, LSE and K codes from ``_sageattn_hnd(impl="xla")``, the steps
chained by ``jax.vjp`` of ``ring._merge``, each step's backward the fused
``quantized_attention_vjp(interpret=True)`` fed that step's cotangents
(blocks of 128 tokens, the multiple the JAX fused backward takes).  The
data-parallel case's flax weights are written into the world's directory
before the ranks start, and the parent runs ``jax.grad``.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
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

from sageattention_tpu_torch import core, models, serve, train  # noqa: E402
from sageattention_tpu_torch import parallel as tpar  # noqa: E402
from sageattention_tpu_torch.ops import reference  # noqa: E402
from sageattention_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from sageattention_tpu_torch.parallel import ring as tring  # noqa: E402
from sageattention_tpu_torch.utils.compare import cosine_similarity  # noqa: E402

if "--worker" not in sys.argv:  # the spawned ranks import torch, numpy and the port only
    import jax
    import jax.numpy as jnp
    from test_torch_train import _jax_loss_fn, _xla_sage_trainable

    from sageattention_tpu import core as jcore
    from sageattention_tpu import models as jmodels
    from sageattention_tpu import quant as jquant
    from sageattention_tpu.models.attention import register_backend as j_register
    from sageattention_tpu.models.configs import MODEL_CONFIGS as J_CONFIGS
    from sageattention_tpu.ops import attention_bwd_pallas
    from sageattention_tpu.parallel import ring as jring

    from sageattention_tpu_torch.models.convert import params_from_jax

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
    """What still raises, and does not fall back: the sharded decoders and
    causal ``allgather_sageattn`` under grad, a Ulysses degree that does not
    divide the heads, an axis the mesh lacks."""
    mesh = mesh_of((1, WORLD, 1))
    q = torch.randn(1, 4, 64, 32, requires_grad=True)
    k, v = torch.randn(1, 2, 64, 32), torch.randn(1, 2, 64, 32)
    raised = {}
    for name, call in {
        "sharded_decode": lambda: tpar.make_sharded_decode(mesh)(q, None, None),
        "sharded_paged_decode": lambda: tpar.make_sharded_paged_decode(mesh)(q, None, None),
        "sharded_append": lambda: tpar.make_sharded_append(mesh)(None, None, q, q),
        "sharded_paged_append": lambda: tpar.make_sharded_paged_append(mesh)(None, None, q, q),
        "allgather_causal": lambda: tring.allgather_sageattn(
            q[:, :, :16], k[:, :, :16], v[:, :, :16], is_causal=True),
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


# --------------------------------------------------------------------------
# the gradient cases: each rank's gradients of the loss sum(o do) (+ sum(lse
# dlse)) through the global view (every rank's gradient is the whole global
# one) and, where the name says so, through the local body on its blocks
# --------------------------------------------------------------------------

# name: (seed, b, hq, hkv, s, d, causal); the ring's blocks are 128 tokens,
# a multiple the JAX fused backward takes
RING_GRAD = {
    "ring_grad_full_gqa": (21, 1, 4, 2, 512, 64, False),
    "ring_grad_causal_gqa": (22, 1, 4, 2, 512, 64, True),
}
ULYSSES_GRAD = {"ulysses_grad_causal_gqa": (23, 1, 8, 4, 256, 64, True)}
ALLGATHER_GRAD = {"allgather_grad_full": (24, 1, 4, 2, 512, 64, False)}
# name: (seed, b, hq, hkv, s, d, causal, (data, seq, heads), layout)
API_GRAD = {
    "api_grad_seq2_heads2": (25, 1, 4, 2, 256, 64, True, (1, 2, 2), "HND"),
    "api_grad_seq2_heads2_nhd": (27, 1, 4, 2, 256, 64, True, (1, 2, 2), "NHD"),
    "api_grad_data2_seq2": (28, 2, 4, 2, 256, 64, True, (2, 2, 1), "HND"),
    "api_grad_data2_seq2_nhd": (26, 2, 4, 2, 256, 64, True, (2, 2, 1), "NHD"),
}
# the ring's variants: (K smoothing, an LSE cotangent)
GRAD_VARIANTS = [(False, False), (False, True), (True, False), (True, True)]


def cotangents(seed: int, b: int, hq: int, s: int, d: int):
    """Seeded fp32 numpy cotangents do [b, hq, s, d] and dlse [b, hq, s]."""
    rng = np.random.default_rng(seed + 1000)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hq, s)).astype(np.float32))


def grads_of(fn, q, k, v, do, dlse=None):
    """(dq, dk, dv) of sum(o do) + sum(lse dlse) (no LSE term when ``dlse``
    is None: the LSE output is then unused) through ``fn(q, k, v) -> (o,
    lse)``."""
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = fn(*xs)
    loss = (o * do).sum()
    if dlse is not None:
        loss = loss + (lse * dlse).sum()
    return [g.detach() for g in torch.autograd.grad(loss, xs)]


def _grad_inputs(seed, b, hq, hkv, s, d):
    q, k, v = (torch.from_numpy(x) for x in qkv(seed, b, hq, hkv, s, d))
    do, dlse = (torch.from_numpy(x) for x in cotangents(seed, b, hq, s, d))
    return q, k, v, do, dlse


def _ring_grad_case(spec):
    seed, b, hq, hkv, s, d, causal = spec

    def run(rank):
        q, k, v, do, dlse = _grad_inputs(seed, b, hq, hkv, s, d)
        out = {}
        for sk, with_dlse in GRAD_VARIANTS:
            fn = tpar.make_ring_attention(mesh_of((1, WORLD, 1)), "seq", is_causal=causal,
                                          return_lse=True, smooth_k=sk)
            out[(sk, with_dlse)] = grads_of(fn, q, k, v, do, dlse if with_dlse else None)
        # the local body on this rank's blocks, the default group, the loss's
        # terms of its own rows
        blk = slice(rank * s // WORLD, (rank + 1) * s // WORLD)
        out["local"] = grads_of(
            lambda *x: tpar.ring_sageattn(*x, is_causal=causal, return_lse=True, smooth_k=False),
            q[:, :, blk], k[:, :, blk], v[:, :, blk], do[:, :, blk], dlse[:, :, blk])
        return out

    return run


def _ulysses_grad_case(spec):
    seed, b, hq, hkv, s, d, causal = spec

    def run(rank):
        q, k, v, do, dlse = _grad_inputs(seed, b, hq, hkv, s, d)
        fn = tpar.make_ulysses_attention(mesh_of((1, 1, WORLD)), "heads", is_causal=causal,
                                         return_lse=True)
        blk = slice(rank * s // WORLD, (rank + 1) * s // WORLD)
        return {"global": grads_of(fn, q, k, v, do, dlse),
                "local": grads_of(
                    lambda *x: tpar.ulysses_sageattn(*x, is_causal=causal, return_lse=True),
                    q[:, :, blk], k[:, :, blk], v[:, :, blk], do[:, :, blk], dlse[:, :, blk])}

    return run


def _allgather_grad_case(spec):
    seed, b, hq, hkv, s, d, causal = spec

    def run(rank):
        q, k, v, do, dlse = _grad_inputs(seed, b, hq, hkv, s, d)
        blk = slice(rank * s // WORLD, (rank + 1) * s // WORLD)
        return grads_of(
            lambda *x: tring.allgather_sageattn(*x, is_causal=causal, return_lse=True),
            q[:, :, blk], k[:, :, blk], v[:, :, blk], do[:, :, blk], dlse[:, :, blk])

    return run


def _api_grad_case(spec):
    seed, b, hq, hkv, s, d, causal, shape, layout = spec

    def run(rank):
        q, k, v, do, dlse = _grad_inputs(seed, b, hq, hkv, s, d)
        if layout == "NHD":
            q, k, v, do = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        out = {}
        for sk in (False, True):
            fn = tpar.make_parallel_sageattn(mesh_of(shape), is_causal=causal,
                                             tensor_layout=layout, return_lse=True, smooth_k=sk)
            g = grads_of(fn, q, k, v, do, dlse)
            out[sk] = [x.transpose(1, 2) for x in g] if layout == "NHD" else g
        return out

    return run


def _param_grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _dit_train_case(rank):
    """One flow-matching loss and its parameter gradients of a narrow
    VideoDiT through "sage_parallel" (ring 2 x Ulysses 2) and through
    "sage" in the same process, the same weights, batch and (t, eps)."""
    mesh = mesh_of((1, 2, 2))
    cfg = serve.parallel_config(tiny_dit_cfg(), mesh)
    tr = train.load_trainer(cfg, device="cpu", dtype=torch.float32, seed=3)
    x0, txt = serve.make_requests(cfg, 1, device="cpu", dtype=torch.float32, seed=4)[0]
    t, eps = train.step_noise(x0, 7, 0)
    out = {}
    for backend in ("sage_parallel", "sage"):
        models.set_mesh(mesh if backend == "sage_parallel" else None)
        models.set_attention_backend(backend)
        try:
            tr.model.zero_grad(set_to_none=True)
            loss = train.flow_loss(tr.model, x0, txt, t, eps)
            loss.backward()
        finally:
            models.set_attention_backend("sage")
            models.set_mesh(None)
        out[backend] = {"loss": loss.item(), "grads": _param_grads(tr.model)}
    out["backend_after"] = models.get_attention_backend()
    return out


def dp_cfg(cfgs):
    """The data-parallel trainer's DiT: 32 text + 2 x 4 x 12 video tokens =
    128, a sequence the JAX fused backward takes."""
    return cfgs["cogvideox-2b"].scaled(depth=1, latent_frames=2, latent_height=8, latent_width=24,
                                       text_len=32, hidden=128, heads=2, head_dim=64)


DP_SEED = 5  # the trainer's (t, eps) seed at step 1


def dp_batch():
    """The global batch of 4 and step 0's (t, eps), seeded numpy fp32."""
    cfg = dp_cfg(models.MODEL_CONFIGS)
    rng = np.random.default_rng(31)
    x0 = rng.standard_normal((WORLD, cfg.latent_frames, cfg.latent_height, cfg.latent_width,
                              16)).astype(np.float32)
    txt = rng.standard_normal((WORLD, cfg.text_len, 512)).astype(np.float32)
    t = rng.uniform(size=(WORLD,)).astype(np.float32)
    eps = rng.standard_normal(x0.shape).astype(np.float32)
    return x0, txt, t, eps


def _dp_case(rank):
    """Data parallelism over the 4 ranks ("data" dim of a (4, 1, 1) mesh),
    one sample each, from the weights the parent carried over from flax:
    step 0 with the given (t, eps) (its averaged gradients kept), step 1
    through ``train``, which draws its own."""
    mesh = mesh_of((WORLD, 1, 1))
    workdir = pathlib.Path(sys.argv[sys.argv.index("--worker") + 1])
    tr = train.load_trainer(dp_cfg(models.MODEL_CONFIGS), device="cpu", dtype=torch.float32,
                            state_dict=torch.load(workdir / "dp_weights.pt"), data=mesh)
    x0, txt, t, eps = (torch.from_numpy(x) for x in dp_batch())
    c = train.data_info(mesh)[2]
    mine = slice(c, c + 1)
    loss0 = train.train_step(tr, x0[mine], txt[mine], t[mine], eps[mine], data=mesh)
    grads0 = _param_grads(tr.model)
    out = train.train(tr, x0, txt, 1, seed=DP_SEED, start=1, data=mesh)
    return {"coord": c, "loss0": loss0.item(), "grads0": grads0, "loss1": out["losses"][0],
            "params": {n: p.detach().clone() for n, p in tr.model.named_parameters()},
            "noise1": train.step_noise(x0[mine], DP_SEED, 1, c)}


CASES = {
    **{n: _ring_case(s) for n, s in RING.items()},
    **{n: _ulysses_case(s) for n, s in ULYSSES.items()},
    **{n: _allgather_case(s) for n, s in ALLGATHER.items()},
    **{n: _api_case(s) for n, s in API.items()},
    "dit": _dit_case,
    "guards": _guards_case,
    **{n: _ring_grad_case(s) for n, s in RING_GRAD.items()},
    **{n: _ulysses_grad_case(s) for n, s in ULYSSES_GRAD.items()},
    **{n: _allgather_grad_case(s) for n, s in ALLGATHER_GRAD.items()},
    **{n: _api_grad_case(s) for n, s in API_GRAD.items()},
    "dit_train": _dit_train_case,
    "dp": _dp_case,
}


@contextlib.contextmanager
def jax_sage_backend():
    """The flax models' attention through ``test_torch_train.py``'s JAX
    backend (the XLA forward with the fused Pallas VJP: the JAX ``sageattn``
    raises at this revision), set back after."""
    j_register("torch_port_xla_sage_trainable", _xla_sage_trainable)
    prev = jmodels.get_attention_backend()
    jmodels.set_attention_backend("torch_port_xla_sage_trainable")
    try:
        yield
    finally:
        jmodels.set_attention_backend(prev)


@functools.lru_cache(maxsize=None)
def dp_jax_model():
    """The flax DiT of the data-parallel case and its seeded parameters."""
    jm = jmodels.VideoDiT(dp_cfg(J_CONFIGS), dtype=jnp.float32)
    x0, txt, t, _ = dp_batch()
    with jax_sage_backend():
        params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x0[:1]), jnp.asarray(txt[:1]),
                         (t[:1] * 1000).astype(np.int32))
    return jm, params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world's results; the data-parallel case's weights, carried over
    from flax, written for the ranks first."""
    workdir = tmp_path_factory.mktemp("parallel_world")
    torch.save(params_from_jax(jax.tree.map(np.asarray, dp_jax_model()[1])),
               workdir / "dp_weights.pt")
    return spawn_world(__file__, workdir)


def jax_refs(q, k, v, causal, n: int):
    """The JAX ring over ``n`` blocks (one block: the whole op), without and
    with K smoothing."""
    def one(sk):
        if n > 1:
            return jax_ring(q, k, v, n, causal, sk)
        return tuple(np.asarray(x) for x in jax_step(q, k, v, causal, sk))

    return one(False), one(True)


def jax_ring_grad(q, k, v, do, dlse, n: int, causal: bool, smooth_k: bool):
    """(dq, dk, dv), numpy, of sum(o do) + sum(lse dlse) through the JAX ring
    over ``n`` blocks (one block: the whole op), rebuilt: each rank's steps
    are ``_sageattn_hnd(impl="xla", chunk_k=G)`` with their blocks' K codes,
    chained by ``jax.vjp`` of ``ring._merge``, and each step's backward is
    the fused ``quantized_attention_vjp(interpret=True)`` fed that step's
    cotangents and that forward's o, LSE and K codes.  ``dlse`` None: no
    LSE term."""
    b, hq, s, d = q.shape
    sl = s // n
    blk = [slice(i * sl, (i + 1) * sl) for i in range(n)]
    if dlse is None:
        dlse = np.zeros((b, hq, s), np.float32)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for idx in range(n):
        qi = jnp.asarray(q[:, :, blk[idx]])
        steps = []
        for src in ((idx - step) % n for step in range(n)):
            if causal and src > idx:
                continue
            kb, vb = jnp.asarray(k[:, :, blk[src]]), jnp.asarray(v[:, :, blk[src]])
            diag = causal and src == idx
            o_i, lse_i = jax_step(qi, kb, vb, diag, smooth_k)
            km = jnp.mean(kb, axis=-2) if smooth_k else None
            k_i8, k_scale = jquant.quant_int8_block_scales(
                kb - km[..., None, :] if smooth_k else kb, group=G)
            steps.append((src, diag, kb, vb, (o_i.astype(jnp.float32), lse_i),
                          {"k_i8": k_i8, "k_scale": k_scale, "km": km}))

        def merged(parts):
            o_acc = jnp.zeros((b, hq, sl, d), jnp.float32)
            lse_acc = jnp.full((b, hq, sl), jring._NEG, jnp.float32)
            for o_i, lse_i in parts:
                o_acc, lse_acc = jring._merge(o_acc, lse_acc, o_i, lse_i)
            return o_acc, lse_acc

        _, vjp = jax.vjp(merged, [st[4] for st in steps])
        (cts,) = vjp((jnp.asarray(do[:, :, blk[idx]]), jnp.asarray(dlse[:, :, blk[idx]])))
        for (src, diag, kb, vb, (o_i, lse_i), res), (do_i, dlse_i) in zip(steps, cts):
            g = attention_bwd_pallas.quantized_attention_vjp(
                qi, kb, vb, do_i, is_causal=diag, sm_scale=None, o=o_i, lse_nat=lse_i,
                dlse=dlse_i, smooth_k=smooth_k, fwd_res=res, interpret=True)
            dq[:, :, blk[idx]] += np.asarray(g[0])
            dk[:, :, blk[src]] += np.asarray(g[1])
            dv[:, :, blk[src]] += np.asarray(g[2])
    return dq, dk, dv


def exact_grads(q, k, v, do, dlse, causal: bool):
    """Exact fp32 attention's (dq, dk, dv) of the same loss."""
    return grads_of(lambda *x: reference.attention_reference(*x, is_causal=causal,
                                                             return_lse=True),
                    *(torch.from_numpy(x) for x in (q, k, v, do)),
                    None if dlse is None else torch.from_numpy(dlse))


def sageattn_grads(q, k, v, do, dlse, causal: bool):
    """The port's one ``sageattn`` over the whole sequence: its (dq, dk, dv)."""
    return grads_of(lambda *x: core.sageattn(*x, is_causal=causal, return_lse=True),
                    *(torch.from_numpy(x) for x in (q, k, v, do, dlse)))


def check_grads(got, want, cos_min: float, rel_max: float | None = None, what: str = ""):
    """Each of (dq, dk, dv) at cosine >= ``cos_min`` and, with ``rel_max``,
    max-abs <= ``rel_max`` * max|want|."""
    for name, g, w in zip("qkv", got, want):
        w = torch.as_tensor(np.asarray(w))
        cos = cosine_similarity(g, w)
        assert cos >= cos_min, (what, "d" + name, cos)
        if rel_max is not None:
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            assert err <= rel_max * scale, (what, "d" + name, err, scale)


def check_same_on_every_rank(grads: list, what: str = ""):
    for r, g in enumerate(grads[1:], 1):
        for a, b in zip(g, grads[0]):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{what} rank {r}")


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
    """Under grad the sharded decoders still raise (the JAX decode kernels
    have no VJP), and causal ``allgather_sageattn`` (positions have no
    gradient), each naming its reason; the bad-mesh guards stay."""
    for rank in range(WORLD):
        raised = result(world, "guards", rank)
        for name in ("sharded_decode", "sharded_paged_decode", "sharded_append",
                     "sharded_paged_append"):
            assert raised[name] and "decode kernels define no VJP" in raised[name], name
            assert "ROADMAP limits" in raised[name] and "module item" not in raised[name]
        assert raised["allgather_causal"] and "positions" in raised["allgather_causal"]
        assert raised["divisibility"] and "divisible" in raised["divisibility"]
        assert raised["axis"] and "no axis" in raised["axis"]


@pytest.mark.parametrize("smooth_k,with_dlse", GRAD_VARIANTS,
                         ids=[f"{'smooth' if a else 'nosmooth'}-{'dlse' if b else 'nodlse'}"
                              for a, b in GRAD_VARIANTS])
@pytest.mark.parametrize("name", sorted(RING_GRAD))
def test_ring_grad_matches_jax_ring(world, name, smooth_k, with_dlse):
    """``make_ring_attention``'s dq, dk, dv on every rank (the whole global
    gradient, the same on every rank) against the JAX ring's gradient
    rebuilt from its steps' fused VJPs: without K smoothing cosine >=
    0.99999 and max-abs <= 1e-3 of the largest entry; with it (the blocks'
    K means summed in other orders, which can move a code a step) cosine
    >= 0.9999; against exact fp32 attention's gradient >= 0.999.  Causal:
    4 aligned, 6 full and 6 skipped steps."""
    seed, b, hq, hkv, s, d, causal = RING_GRAD[name]
    q, k, v = qkv(seed, b, hq, hkv, s, d)
    do, dlse = cotangents(seed, b, hq, s, d)
    dlse = dlse if with_dlse else None
    want = jax_ring_grad(q, k, v, do, dlse, WORLD, causal, smooth_k)
    ex = exact_grads(q, k, v, do, dlse, causal)
    grads = [result(world, name, r)[(smooth_k, with_dlse)] for r in range(WORLD)]
    check_same_on_every_rank(grads, name)
    if smooth_k:
        check_grads(grads[0], want, 0.9999, what=name)
    else:
        check_grads(grads[0], want, 0.99999, 1e-3, what=name)
    check_grads(grads[0], ex, 0.999, what=name + " vs exact")


@pytest.mark.parametrize("name", sorted(RING_GRAD))
def test_ring_local_grads_are_the_global_blocks(world, name):
    """``ring_sageattn`` on a rank's own blocks, the loss's terms of its own
    rows: its dq, dk, dv are that rank's blocks of the global view's,
    bit for bit (each block's dK/dV came home over the ring)."""
    s = RING_GRAD[name][4]
    sl = s // WORLD
    for rank in range(WORLD):
        r = result(world, name, rank)
        blk = slice(rank * sl, (rank + 1) * sl)
        for g_loc, g_glob in zip(r["local"], r[(False, True)]):
            np.testing.assert_array_equal(g_loc.numpy(), g_glob[:, :, blk].numpy())


@pytest.mark.parametrize("name", sorted(ULYSSES_GRAD))
def test_ulysses_grad_matches_sageattn(world, name):
    """Ulysses over 4 ranks is whole-sequence attention on a quarter of the
    heads: its gradients equal the port's one ``sageattn`` over the whole
    sequence and the JAX fused VJP of it (cosine >= 0.99999), on every
    rank the same; ``ulysses_sageattn`` on a rank's blocks gives that
    rank's blocks of them."""
    seed, b, hq, hkv, s, d, causal = ULYSSES_GRAD[name]
    q, k, v = qkv(seed, b, hq, hkv, s, d)
    do, dlse = cotangents(seed, b, hq, s, d)
    port = sageattn_grads(q, k, v, do, dlse, causal)
    want = jax_ring_grad(q, k, v, do, dlse, 1, causal, True)
    outs = [result(world, name, r) for r in range(WORLD)]
    check_same_on_every_rank([o["global"] for o in outs], name)
    check_grads(outs[0]["global"], port, 0.99999, 1e-3, what=name + " vs sageattn")
    check_grads(outs[0]["global"], want, 0.99999, what=name + " vs JAX")
    sl = s // WORLD
    for rank, o in enumerate(outs):
        blk = slice(rank * sl, (rank + 1) * sl)
        for g_loc, g_glob in zip(o["local"], o["global"]):
            np.testing.assert_array_equal(g_loc.numpy(), g_glob[:, :, blk].numpy())


@pytest.mark.parametrize("name", sorted(ALLGATHER_GRAD))
def test_allgather_grad_matches_sageattn(world, name):
    """Non-causal ``allgather_sageattn``: each rank's gradients of its own
    blocks (the gathered K/V's reduce-scattered home), put together, equal
    the one ``sageattn``'s and the JAX fused VJP's (cosine >= 0.99999)."""
    seed, b, hq, hkv, s, d, causal = ALLGATHER_GRAD[name]
    q, k, v = qkv(seed, b, hq, hkv, s, d)
    do, dlse = cotangents(seed, b, hq, s, d)
    parts = [result(world, name, r) for r in range(WORLD)]
    whole = [torch.cat([p[i] for p in parts], dim=2) for i in range(3)]
    check_grads(whole, sageattn_grads(q, k, v, do, dlse, causal), 0.99999, 1e-3, what=name)
    check_grads(whole, jax_ring_grad(q, k, v, do, dlse, 1, causal, True), 0.99999, what=name)


@pytest.mark.parametrize("name", sorted(API_GRAD))
def test_parallel_sageattn_grad_matches_jax_ring(world, name):
    """``make_parallel_sageattn``'s gradients on (1, 2, 2) (Ulysses with the
    ring inside) and (2, 2, 1) in NHD against the JAX ring of 2 rebuilt, at
    the ring's tolerances, causal (a wrong block order would show); every
    rank holds the whole global gradient, the same on every rank."""
    seed, b, hq, hkv, s, d, causal, (_, rn, _), _ = API_GRAD[name]
    q, k, v = qkv(seed, b, hq, hkv, s, d)
    do, dlse = cotangents(seed, b, hq, s, d)
    ex = exact_grads(q, k, v, do, dlse, causal)
    for smooth_k in (False, True):
        want = jax_ring_grad(q, k, v, do, dlse, rn, causal, smooth_k)
        grads = [result(world, name, r)[smooth_k] for r in range(WORLD)]
        check_same_on_every_rank(grads, name)
        if smooth_k:
            check_grads(grads[0], want, 0.9999, what=name)
        else:
            check_grads(grads[0], want, 0.99999, 1e-3, what=name)
        check_grads(grads[0], ex, 0.999, what=name + " vs exact")


def _check_param_grads(got: dict, want: dict, cos_min: float, what: str):
    """Every parameter gradient at cosine >= ``cos_min`` and, over them all,
    the norm within 1 - ``cos_min`` relative (a gradient n times too large
    keeps its cosine); the key norm's bias, whose exact gradient is 0, held
    negligible beside its scale's (``test_torch_train.py``'s rule)."""
    assert set(got) == set(want)
    sq_got = sq_want = 0.0
    for name, g in want.items():
        g = torch.as_tensor(np.asarray(g))
        if name.endswith("k_norm.bias"):
            ref = torch.as_tensor(np.asarray(want[name.replace("bias", "weight")])).norm()
            assert max(g.norm(), got[name].norm()) <= 1e-2 * ref, (what, name)
            continue
        cos = cosine_similarity(got[name], g)
        assert cos >= cos_min, (what, name, cos)
        sq_got += float(got[name].double().square().sum())
        sq_want += float(g.double().square().sum())
    assert abs(sq_got**0.5 / sq_want**0.5 - 1) <= 1 - cos_min, (what, sq_got, sq_want)


def test_sage_parallel_training_step_in_a_dit(world):
    """A narrow VideoDiT's flow-matching gradients through "sage_parallel"
    (ring 2 x Ulysses 2): every parameter's within cosine >= 0.999 of
    "sage"'s in one process (``test_torch_train.py``'s level) and bit for
    bit the same on every rank, which runs the replicated model on the
    global view; the backend set back after."""
    outs = [result(world, "dit_train", r) for r in range(WORLD)]
    for r in outs:
        assert r["backend_after"] == "sage"
        _check_param_grads(r["sage_parallel"]["grads"], r["sage"]["grads"], 0.999, "dit")
        assert r["sage_parallel"]["loss"] == outs[0]["sage_parallel"]["loss"]
        for name, g in r["sage_parallel"]["grads"].items():
            np.testing.assert_array_equal(g.numpy(), outs[0]["sage_parallel"]["grads"][name]
                                          .numpy(), err_msg=name)
    assert abs(outs[0]["sage_parallel"]["loss"] - outs[0]["sage"]["loss"]) <= \
        1e-3 * abs(outs[0]["sage"]["loss"])


def test_data_parallel_training_matches_one_process(world):
    """DP over 4 ranks, one sample each: the averaged step-0 gradients
    against the port's single-process step on the whole batch (cosine >=
    0.99999 a parameter, the loss within 1e-5 relative, fp32 compute) and
    against ``jax.grad`` of the example's loss on the whole batch with the
    same (t, eps), which is what ``pmean`` over equal shards gives (0.999,
    ``test_torch_train.py``'s level); every replica's parameters bit for
    bit the same after 2 steps; at step 1 the ranks draw their own (t, eps)
    (``train.step_noise`` by data coordinate), and the averaged loss is the
    one-process loss on the batch with those draws (1e-4 relative)."""
    outs = sorted((result(world, "dp", r) for r in range(WORLD)), key=lambda o: o["coord"])
    assert [o["coord"] for o in outs] == list(range(WORLD))
    x0, txt, t, eps = dp_batch()
    jm, params = dp_jax_model()
    cfg = dp_cfg(models.MODEL_CONFIGS)
    tr = train.load_trainer(cfg, device="cpu", dtype=torch.float32,
                            state_dict=params_from_jax(jax.tree.map(np.asarray, params)))
    xt, tt = torch.from_numpy(x0), torch.from_numpy(txt)
    models.set_attention_backend("sage")
    loss0 = train.train_step(tr, xt, tt, torch.from_numpy(t), torch.from_numpy(eps)).item()
    one = _param_grads(tr.model)
    with jax_sage_backend():
        loss_j, grads_j = jax.value_and_grad(_jax_loss_fn(jm, jnp.float32))(
            params, jnp.asarray(x0), jnp.asarray(txt), jnp.asarray(t), jnp.asarray(eps))
    want_j = params_from_jax(jax.tree.map(lambda g: np.asarray(g, np.float32), grads_j))
    for o in outs:
        assert abs(o["loss0"] - loss0) <= 1e-5 * abs(loss0)
        assert abs(o["loss0"] - float(loss_j)) <= 1e-5 * abs(float(loss_j))
        _check_param_grads(o["grads0"], one, 0.99999, "dp vs one process")
        _check_param_grads(o["grads0"], want_j, 0.999, "dp vs jax")
        assert o["loss1"] == outs[0]["loss1"]
        for name, p in o["params"].items():
            np.testing.assert_array_equal(p.numpy(), outs[0]["params"][name].numpy(),
                                          err_msg=name)
    assert not torch.equal(outs[0]["noise1"][0], outs[1]["noise1"][0])
    t1, eps1 = (torch.cat([o["noise1"][i] for o in outs]) for i in range(2))
    loss1 = train.train_step(tr, xt, tt, t1, eps1).item()
    assert abs(outs[0]["loss1"] - loss1) <= 1e-4 * abs(loss1), (outs[0]["loss1"], loss1)


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
