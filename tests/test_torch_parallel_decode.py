"""Sequence- and tensor-parallel serving decode of the port (the ``owned``
page mask of kernels 11-12, ``pool_start``, ``parallel.decode``) against the
JAX package, on the CPU.

In one process: the plain ``owned`` decode against the Pallas
``sage_paged_decode_attention(owned=..., return_state=True,
interpret=True)`` over a shard's forward-filled local table, with and
without a window, int8 and int4, t_q 1 and 4 (m bit-exact, l 1e-4
relative, o 1e-5, as ``test_torch_decode.py``); a shard that owns no live
page; ``owned`` without ``return_state`` raising; ``paged_append`` /
``paged_prefill`` with ``pool_start`` bit-exact against the JAX functions,
with another shard's pages dropped and not wrapped; and every shard's local
body run in turn and merged, as the card runs them.

In a world of 4 ranks under gloo (the fixture and protocol of
``test_torch_parallel.py``): the four sharded factories at SP 4 and at TP 2
x SP 2, each rank holding only its shard, against JAX's
``make_sharded_decode`` / ``make_sharded_append`` /
``make_sharded_paged_decode`` / ``make_sharded_paged_append``
(``interpret=True``) on the virtual 8-device mesh and against the port's
single-process cache and decode: caches bit-exact, outputs within 1e-4
(the merge's fp32 sums in another order; the JAX tests' tolerance).  The
dense shards decode at the chunk their ``S_local`` gives, so the
single-process decode runs at that chunk.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [p for p in (str(ROOT), str(ROOT / "tests")) if p not in sys.path]

from test_torch_parallel import result, spawn_world, worker_main  # noqa: E402

from sageattention_tpu_torch import generate  # noqa: E402
from sageattention_tpu_torch import kvcache as tkv  # noqa: E402
from sageattention_tpu_torch import parallel as tpar  # noqa: E402
from sageattention_tpu_torch.ops import decode_cuda  # noqa: E402
from sageattention_tpu_torch.parallel import decode as tdec  # noqa: E402
from sageattention_tpu_torch.parallel.mesh import axis_info  # noqa: E402

if "--worker" not in sys.argv:  # the spawned ranks import torch, numpy and the port only
    import jax
    import jax.numpy as jnp

    from sageattention_tpu import kvcache as jkv
    from sageattention_tpu import parallel as jpar
    from sageattention_tpu.ops import paged_decode_pallas
    from sageattention_tpu.parallel import decode as jdec

B, HQ, HKV, D, S, PAGE = 2, 8, 2, 32, 512, 32
NPG = B * S // PAGE  # 32 pages: 8 a shard at SP 4, 16 at SP 2


def _compare_state(res_t, res_j):
    o_t, m_t, l_t = (x.float().numpy() for x in res_t)
    o_j, m_j, l_j = (np.asarray(x, np.float32) for x in res_j)
    np.testing.assert_allclose(o_t, o_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_allclose(l_t, l_j, rtol=1e-4, atol=0)


def _pool(rng, n, hkv, page, d, packed):
    rows = page // 2 if packed else page
    lo = -128 if packed else -127
    k = rng.integers(lo, 128, (n, hkv, rows, d)).astype(np.int8)
    v = rng.integers(lo, 128, (n, hkv, rows, d)).astype(np.int8)
    ks = (rng.random((n, hkv, page)) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random((n, hkv, page)) * 0.05 + 0.01).astype(np.float32)
    return k, ks, v, vs


# ---------------------------------------------------------------------------
# one process: the owned kernels' plain versions, pool_start, local bodies
# ---------------------------------------------------------------------------

# t_q, window, packed
OWNED = [(t_q, w, p) for t_q in (1, 4) for w in (None, 100) for p in (False, True)]


@pytest.mark.parametrize("case", OWNED, ids=lambda c: f"tq{c[0]}-w{c[1]}-"
                         f"{'int4' if c[2] else 'int8'}")
def test_owned_plain_matches_pallas(case):
    """Shard 1 of 4 of a scrambled 32-page pool: its 8 pages, the table's
    owned mask and the forward-filled local table (bit-exact with the JAX
    ``_ffill``), then kernels 11/12's plain versions against Pallas."""
    t_q, window, packed = case
    rng = np.random.default_rng(100 + OWNED.index(case))
    pp, shard = NPG // 4, 1
    table = rng.permutation(NPG).reshape(B, S // PAGE).astype(np.int32)
    pool = _pool(rng, pp, HKV, PAGE, D, packed)
    q = rng.standard_normal((B, HQ, t_q, D)).astype(np.float32)
    L = np.array([S - 3, 290], np.int32)
    owned, local = tdec.owned_pages(torch.tensor(table), shard, pp)
    jt = jnp.array(table)
    jown = (jt >= shard * pp) & (jt < (shard + 1) * pp)
    np.testing.assert_array_equal(owned.numpy(), np.asarray(jown, np.int32))
    np.testing.assert_array_equal(local.numpy(),
                                  np.asarray(jdec._ffill(jnp.where(jown, jt - shard * pp, 0), jown)))
    res_t = decode_cuda.sage_paged_decode_attention(
        torch.tensor(q), *(torch.tensor(x) for x in pool), local, torch.tensor(L), owned=owned,
        window=window, return_state=True)
    res_j = paged_decode_pallas.sage_paged_decode_attention(
        jnp.array(q), *(jnp.array(x) for x in pool), jnp.array(local.numpy()), jnp.array(L),
        owned=jnp.array(owned.numpy()), window=window, return_state=True, interpret=True)
    _compare_state(res_t, res_j)


def test_owned_shard_without_a_live_page_gives_zero():
    """A row whose live pages all lie on other shards: o = 0, m = NEG_INIT,
    l = 0, and it weighs nothing in the merge."""
    rng = np.random.default_rng(7)
    pool = [torch.tensor(x) for x in _pool(rng, 4, HKV, PAGE, D, False)]
    table = torch.arange(B * 8, dtype=torch.int32).reshape(B, 8)
    owned, local = tdec.owned_pages(table, 1, 4)  # pages 4-7: batch 0's pages 4-7
    q = torch.randn(B, HQ, 1, D)
    o, m, l = decode_cuda.sage_paged_decode_attention(q, *pool, local,
                                                      torch.tensor([200, 200], dtype=torch.int32),
                                                      owned=owned, return_state=True)
    assert owned[1].sum() == 0 and owned[0].sum() == 4
    assert torch.all(o[1] == 0) and torch.all(l[1] == 0) and torch.all(m[1] == decode_cuda.NEG_INIT)
    assert torch.all(l[0] > 0)


def test_owned_requires_return_state():
    rng = np.random.default_rng(8)
    pool = [torch.tensor(x) for x in _pool(rng, 4, HKV, PAGE, D, False)]
    table = torch.zeros(B, 4, dtype=torch.int32)
    q, L = torch.randn(B, HQ, 1, D), torch.tensor([10, 10], dtype=torch.int32)
    for fn in (decode_cuda.sage_paged_decode_attention,
               decode_cuda.sage_paged_decode_attention_plain):
        with pytest.raises(ValueError, match="return_state"):
            fn(q, *pool, table, L, owned=torch.ones_like(table))
    cache = tkv.init_paged_kv_cache(4, HKV, D, table, page_size=PAGE, device="cpu")
    with pytest.raises(ValueError, match="return_state"):
        tkv.sageattn_paged_decode(q, cache, L, owned=torch.ones_like(table))


def _same(t, j):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


def _with_means(jc, tc):
    """The JAX cache with the port cache's calibrated means: the two means
    of many tokens are summed in other orders (an ulp apart), which
    ``test_torch_kvcache.py`` covers; here the writes are the point."""
    return dataclasses.replace(jc, k_mean=jnp.array(tc.k_mean.numpy()),
                               v_mean=jnp.array(tc.v_mean.numpy()))


POOL_FIELDS = ("pages_k", "pages_k_scale", "pages_v", "pages_v_scale")


@pytest.mark.parametrize("bits", [8, 4])
def test_pool_start_writes_match_jax(bits):
    """Each of 4 shards of a scrambled pool prefilled and appended to with
    ``pool_start``, against the JAX ``paged_prefill`` / ``paged_append``
    with the same ``pool_start``: bit-exact, and the shards together are
    the global pool (another shard's rows dropped, none wrapped)."""
    rng = np.random.default_rng(9 + bits)
    pp = NPG // 4
    table = rng.permutation(NPG).reshape(B, S // PAGE).astype(np.int32)
    k0, v0 = (rng.standard_normal((B, HKV, 96, D)).astype(np.float32) for _ in range(2))
    steps = [(rng.standard_normal((B, HKV, t, D)).astype(np.float32),
              rng.standard_normal((B, HKV, t, D)).astype(np.float32)) for t in (5, 1, 40)]
    whole = tkv.init_paged_kv_cache(NPG, HKV, D, torch.tensor(table), page_size=PAGE, bits=bits,
                                    device="cpu")
    whole = tkv.calibrate(whole, torch.tensor(k0), torch.tensor(v0))
    whole, lw = tkv.paged_prefill(whole, torch.tensor(k0), torch.tensor(v0))
    for k, v in steps:
        whole, lw = tkv.paged_append(whole, lw, torch.tensor(k), torch.tensor(v))
    for shard in range(4):
        start = shard * pp
        tc = tkv.init_paged_kv_cache(pp, HKV, D, torch.tensor(table), page_size=PAGE, bits=bits,
                                     device="cpu")
        tc = tkv.calibrate(tc, torch.tensor(k0), torch.tensor(v0))
        jc = _with_means(jkv.init_paged_kv_cache(pp, HKV, D, jnp.array(table), page_size=PAGE,
                                                 bits=bits), tc)
        tc, lt = tkv.paged_prefill(tc, torch.tensor(k0), torch.tensor(v0), pool_start=start)
        jc, lj = jkv.paged_prefill(jc, jnp.array(k0), jnp.array(v0), pool_start=start)
        for k, v in steps:
            tc, lt = tkv.paged_append(tc, lt, torch.tensor(k), torch.tensor(v), pool_start=start)
            jc, lj = jkv.paged_append(jc, lj, jnp.array(k), jnp.array(v), pool_start=start)
        _same(lt, lj)
        for f in POOL_FIELDS:
            _same(getattr(tc, f), getattr(jc, f))
            _same(getattr(tc, f), getattr(whole, f)[start:start + pp])


@pytest.mark.parametrize("window", [None, 100])
def test_local_bodies_in_turn_match_jax_sharded(window):
    """Every shard's local body run in one process, one after another, and
    merged (``merge_decode_partials``): the JAX sharded decoders on the
    virtual mesh, dense (SP 4 over a cache filled by the sharded append's
    local body) and paged (SP 4 over a scrambled pool)."""
    rng = np.random.default_rng(20 + (window or 0))
    t = 450
    k, v = (rng.standard_normal((B, HKV, t, D)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((B, HQ, 1, D)).astype(np.float32)
    L = np.array([t, 333], np.int32)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
    # dense
    jc, _ = jkv.append_kv(jkv.init_kv_cache(B, HKV, S, D), jnp.zeros((B,), jnp.int32),
                          jnp.array(k), jnp.array(v))
    o_j = jpar.make_sharded_decode(jmesh, axis="seq", window=window, interpret=True)(
        jnp.array(q), jc, jnp.array(L))
    parts = []
    for shard in range(4):
        c = tkv.init_kv_cache(B, HKV, S // 4, D, device="cpu")
        c, _ = tdec.local_shard_append(c, torch.zeros(B, dtype=torch.int32), torch.tensor(k),
                                       torch.tensor(v), shard=shard, n_shards=4)
        for f in ("k_i8", "k_scale", "v_i8", "v_scale"):
            _same(getattr(c, f), np.asarray(getattr(jc, f))[:, :, shard * S // 4:(shard + 1) * S // 4])
        parts.append(tdec.local_shard_decode(torch.tensor(q), c, torch.tensor(L), shard=shard,
                                             window=window))
    o = decode_cuda.merge_decode_partials(*(torch.stack(x) for x in zip(*parts)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-4, rtol=0)
    # paged
    table = rng.permutation(NPG).reshape(B, S // PAGE).astype(np.int32)
    kp, vp = (rng.standard_normal((B, HKV, S, D)).astype(np.float32) for _ in range(2))
    jp, _ = jkv.paged_prefill(jkv.init_paged_kv_cache(NPG, HKV, D, jnp.array(table),
                                                      page_size=PAGE), jnp.array(kp), jnp.array(vp))
    o_j = jpar.make_sharded_paged_decode(jmesh, axis="seq", window=window, interpret=True)(
        jnp.array(q), jp, jnp.array(L))
    whole = tkv.init_paged_kv_cache(NPG, HKV, D, torch.tensor(table), page_size=PAGE, device="cpu")
    whole, _ = tkv.paged_prefill(whole, torch.tensor(kp), torch.tensor(vp))
    parts = [tdec.local_paged_shard_decode(torch.tensor(q), tdec.paged_shard(whole, shard=s,
                                                                             n_shards=4),
                                           torch.tensor(L), shard=s, window=window)
             for s in range(4)]
    o = decode_cuda.merge_decode_partials(*(torch.stack(x) for x in zip(*parts)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-4, rtol=0)


# name: paged, bits, window
SERVE = {"dense_int8": (False, 8, None), "dense_int4_window": (False, 4, 100),
         "paged_int8": (True, 8, None), "paged_int4_window": (True, 4, 100)}
SERVE_KW = dict(b=B, hq=HQ, hkv=HKV, d=D, context=S, gen=3, depth=2, page_size=PAGE, seed=3)


def _serve_unsharded(name, sp):
    paged, bits, window = SERVE[name]
    ops = generate.local_shard_ops(n_seq=sp, paged=paged, window=window, sharded=False)
    return generate.serve_shards([ops], paged=paged, bits=bits, device="cpu", **SERVE_KW)


def _check_served(outs, caches, cut, w, name, heads=slice(None)):
    """Served outputs [step][layer] within 1e-4 of the unsharded loop's
    (the merge's fp32 sums), and each shard's layer caches ``cut`` (the
    (shard, head shard) keywords of ``dense_shard`` / ``paged_shard``) of
    its unsharded caches, bit for bit."""
    for os_, ows in zip(outs, w["outputs"]):
        for o, o_w in zip(os_, ows):
            np.testing.assert_allclose(o.float().numpy(), o_w[:, heads].numpy(), atol=1e-4,
                                       rtol=0)
    shard_of = tdec.paged_shard if SERVE[name][0] else tdec.dense_shard
    for c, whole in zip(caches, w["caches"][0]):
        want = dataclasses.asdict(shard_of(whole, **cut))
        for field, x in (c if isinstance(c, dict) else dataclasses.asdict(c)).items():
            np.testing.assert_array_equal(x.numpy(), want[field].numpy(), err_msg=field)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_serve_shards_in_turn_match_unsharded(name):
    """``generate.serve_shards`` with every shard of TP 2 x SP 2 in one
    process (``local_shard_ops``, as the card runs them) against the same
    loop over one unsharded cache (a dense decode at the shards' chunk):
    the merged outputs of every step and layer within 1e-4, the caches bit
    for bit."""
    paged, bits, window = SERVE[name]
    tp, sp = 2, 2
    shards = [generate.local_shard_ops(head=t, seq=s, n_seq=sp, paged=paged, window=window)
              for t in range(tp) for s in range(sp)]
    r = generate.serve_shards(shards, tp=tp, sp=sp, paged=paged, bits=bits, device="cpu",
                              **SERVE_KW)
    w = _serve_unsharded(name, sp)
    np.testing.assert_array_equal(r["lengths"].numpy(), w["lengths"].numpy())
    assert len(r["outputs"]) == SERVE_KW["gen"] and r["outputs"][0][0].shape == (B, HQ, 1, D)
    for sh, layers in zip(shards, r["caches"]):
        _check_served(r["outputs"], layers, dict(shard=sh.seq, n_shards=sp, head_shard=sh.head,
                                                 n_head_shards=tp), w, name)


# ---------------------------------------------------------------------------
# a world of 4: the four factories, each rank holding its shard
# ---------------------------------------------------------------------------

# mesh name: ((data, seq, heads), axis, head_axis)
MESHES = {"sp4": ((1, 4, 1), "seq", None), "tp2sp2": ((1, 2, 2), "seq", "heads")}
# name: kind, bits, the appends' lengths (the first one the prefill), the
# start lengths, t_q, window, what the decode's lengths lack of the cache's
SPECS = {
    "dense_int8": ("dense", 8, (300, 100, 60, 1, 1), (0, 37), 1, None, (0, 0)),
    "dense_tq4_window": ("dense", 8, (300, 4), (0, 100), 4, 100, (0, 0)),
    "dense_int4": ("dense", 4, (290, 1, 1), (0, 0), 1, None, (0, 3)),
    "dense_overflow": ("dense", 8, (100,), (470, 200), 1, None, (0, 0)),
    "paged_int8": ("paged", 8, (320, 5, 1, 40), (0, 0), 1, None, (0, 57)),
    "paged_int4_window": ("paged", 4, (256, 3, 1), (0, 0), 4, 100, (0, 30)),
}


def _inputs(name):
    """The seeded global numpy blocks, query, table and start lengths of a case."""
    kind, bits, ts, len0, t_q, window, minus = SPECS[name]
    rng = np.random.default_rng(sorted(SPECS).index(name))
    blocks = [(rng.standard_normal((B, HKV, t, D)).astype(np.float32) * 1.5,
               rng.standard_normal((B, HKV, t, D)).astype(np.float32)) for t in ts]
    q = rng.standard_normal((B, HQ, t_q, D)).astype(np.float32)
    table = rng.permutation(NPG).reshape(B, S // PAGE).astype(np.int32)
    return blocks, q, table, np.array(len0, np.int32), np.array(minus, np.int32)


_MESH_OBJ: dict = {}


def _world_case(name, mesh_name):
    def run(rank):
        kind, bits, _, _, _, window, _ = SPECS[name]
        shape, axis, head_axis = MESHES[mesh_name]
        if shape not in _MESH_OBJ:
            _MESH_OBJ[shape] = tpar.make_mesh(*shape, device_type="cpu")
        mesh = _MESH_OBJ[shape]
        _, sp, si = axis_info(mesh, axis)
        _, tp, ti = axis_info(mesh, head_axis)
        kh = slice(ti * HKV // tp, (ti + 1) * HKV // tp)
        qh = slice(ti * HQ // tp, (ti + 1) * HQ // tp)
        blocks, q, table, len0, minus = _inputs(name)
        blocks = [(torch.tensor(k)[:, kh], torch.tensor(v)[:, kh]) for k, v in blocks]
        if kind == "dense":
            cache = tkv.init_kv_cache(B, HKV // tp, S // sp, D, bits=bits, device="cpu")
            first = app = tpar.make_sharded_append(mesh, axis=axis, head_axis=head_axis)
            dec = tpar.make_sharded_decode(mesh, axis=axis, head_axis=head_axis, window=window)
        else:
            cache = tkv.init_paged_kv_cache(NPG // sp, HKV // tp, D, torch.tensor(table),
                                            page_size=PAGE, bits=bits, device="cpu")
            first = tpar.make_sharded_paged_append(mesh, axis=axis, head_axis=head_axis,
                                                   prefill=True)
            app = tpar.make_sharded_paged_append(mesh, axis=axis, head_axis=head_axis)
            dec = tpar.make_sharded_paged_decode(mesh, axis=axis, head_axis=head_axis,
                                                 window=window)
        if bits == 4:
            cache = tkv.calibrate(cache, *(x.contiguous() for x in blocks[0]))
        lengths = torch.tensor(len0)
        for i, (k, v) in enumerate(blocks):
            cache, lengths = (first if i == 0 else app)(cache, lengths, k, v)
        o = dec(torch.tensor(q)[:, qh], cache, lengths - torch.tensor(minus))
        return {"sp": si, "tp": ti, "n_sp": sp, "n_tp": tp, "o": o, "lengths": lengths,
                "cache": dataclasses.asdict(cache)}

    return run


def _serve_case(name, mesh_name):
    def run(rank):
        paged, bits, window = SERVE[name]
        shape, axis, head_axis = MESHES[mesh_name]
        if shape not in _MESH_OBJ:
            _MESH_OBJ[shape] = tpar.make_mesh(*shape, device_type="cpu")
        mesh = _MESH_OBJ[shape]
        r = generate.sharded_serve(mesh, axis=axis, head_axis=head_axis, window=window,
                                   paged=paged, bits=bits, **SERVE_KW)
        _, sp, si = axis_info(mesh, axis)
        _, tp, ti = axis_info(mesh, head_axis)
        return {"sp": si, "tp": ti, "n_sp": sp, "n_tp": tp, "outputs": r["outputs"],
                "lengths": r["lengths"], "caches": [dataclasses.asdict(c) for c in r["caches"][0]]}

    return run


SERVED = [("paged_int8", "sp4"), ("dense_int4_window", "tp2sp2")]
CASES = {f"{n}.{m}": _world_case(n, m) for n in SPECS for m in MESHES}
CASES.update({f"serve.{n}.{m}": _serve_case(n, m) for n, m in SERVED})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(__file__, tmp_path_factory.mktemp("decode_world"))


def _references(name, mesh_name):
    """(JAX's global o and cache, the port's single-process o and cache)."""
    kind, bits, _, _, _, window, _ = SPECS[name]
    (_, sp, tp), axis, head_axis = MESHES[mesh_name]
    blocks, q, table, len0, minus = _inputs(name)
    devs = np.array(jax.devices()[:4])
    if head_axis is None:
        jmesh, jaxis, jhead = jax.sharding.Mesh(devs, ("sp",)), "sp", None
    else:
        jmesh, jaxis, jhead = jax.sharding.Mesh(devs.reshape(sp, tp), ("sp", "tp")), "sp", "tp"
    jb = [(jnp.array(k), jnp.array(v)) for k, v in blocks]
    tb = [(torch.tensor(k), torch.tensor(v)) for k, v in blocks]
    if kind == "dense":
        jc = jkv.init_kv_cache(B, HKV, S, D, bits=bits)
        tc = tkv.init_kv_cache(B, HKV, S, D, bits=bits, device="cpu")
        jfirst = japp = jpar.make_sharded_append(jmesh, axis=jaxis, head_axis=jhead)
        jd = jpar.make_sharded_decode(jmesh, axis=jaxis, head_axis=jhead, window=window,
                                      interpret=True)
    else:
        jc = jkv.init_paged_kv_cache(NPG, HKV, D, jnp.array(table), page_size=PAGE, bits=bits)
        tc = tkv.init_paged_kv_cache(NPG, HKV, D, torch.tensor(table), page_size=PAGE, bits=bits,
                                     device="cpu")
        jfirst = jpar.make_sharded_paged_append(jmesh, axis=jaxis, head_axis=jhead, prefill=True)
        japp = jpar.make_sharded_paged_append(jmesh, axis=jaxis, head_axis=jhead)
        jd = jpar.make_sharded_paged_decode(jmesh, axis=jaxis, head_axis=jhead, window=window,
                                            interpret=True)
    if bits == 4:
        tc = tkv.calibrate(tc, *tb[0])
        jc = _with_means(jc, tc)
    jl, tl = jnp.array(len0), torch.tensor(len0)
    for i, ((jk, jv), (tk, tv)) in enumerate(zip(jb, tb)):
        jc, jl = (jfirst if i == 0 else japp)(jc, jl, jk, jv)
        if kind == "dense":
            tc, tl = tkv.append_kv(tc, tl, tk, tv)
        elif i == 0:
            tc, tl = tkv.paged_prefill(tc, tk, tv)
        else:
            tc, tl = tkv.paged_append(tc, tl, tk, tv)
    o_j = jd(jnp.array(q), jc, jl - jnp.array(minus))
    if kind == "dense":
        o_t = tkv.sageattn_decode(torch.tensor(q), tc, tl - torch.tensor(minus), chunk=S // sp,
                                  window=window)
    else:
        o_t = tkv.sageattn_paged_decode(torch.tensor(q), tc, tl - torch.tensor(minus),
                                        window=window)
    return (np.asarray(o_j), jc), (o_t, tc, tl)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_sharded_factories_match_jax_and_single_process(world, name, mesh_name):
    kind = SPECS[name][0]
    (o_j, jc), (o_t, tc, tl) = _references(name, mesh_name)
    jc_t = type(tc)(**{f.name: torch.tensor(np.asarray(getattr(jc, f.name)))
                       for f in dataclasses.fields(tc)})
    for rank in range(4):
        r = result(world, f"{name}.{mesh_name}", rank)
        cut = dict(shard=r["sp"], n_shards=r["n_sp"], head_shard=r["tp"], n_head_shards=r["n_tp"])
        qh = slice(r["tp"] * HQ // r["n_tp"], (r["tp"] + 1) * HQ // r["n_tp"])
        np.testing.assert_array_equal(r["lengths"].numpy(), tl.numpy())
        for ref in (tc, jc_t):
            want = tdec.dense_shard(ref, **cut) if kind == "dense" else tdec.paged_shard(ref, **cut)
            for field, x in dataclasses.asdict(want).items():
                np.testing.assert_array_equal(r["cache"][field].numpy(), x.numpy(), err_msg=field)
        np.testing.assert_allclose(r["o"].numpy(), o_j[:, qh], atol=1e-4, rtol=0)
        np.testing.assert_allclose(r["o"].numpy(), o_t[:, qh].numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name,mesh_name", SERVED, ids=[f"{n}-{m}" for n, m in SERVED])
def test_sharded_serve_matches_unsharded(world, name, mesh_name):
    """``generate.sharded_serve`` on a mesh, each rank holding its shard and
    going through the four factories: every step's merged output (cast to
    q's bf16 by the merge) within one bf16 step of the unsharded loop's
    fp32, each rank's caches its slice of the unsharded caches bit for
    bit."""
    w = _serve_unsharded(name, MESHES[mesh_name][0][1])
    for rank in range(4):
        r = result(world, f"serve.{name}.{mesh_name}", rank)
        qh = slice(r["tp"] * HQ // r["n_tp"], (r["tp"] + 1) * HQ // r["n_tp"])
        np.testing.assert_array_equal(r["lengths"].numpy(), w["lengths"].numpy())
        for os_, ows in zip(r["outputs"], w["outputs"]):
            for o, o_w in zip(os_, ows):
                assert o.dtype == torch.bfloat16
                np.testing.assert_allclose(o.float().numpy(), o_w[:, qh].numpy(), atol=1e-4,
                                           rtol=2**-8)
        _check_served([], r["caches"], dict(shard=r["sp"], n_shards=r["n_sp"],
                                            head_shard=r["tp"], n_head_shards=r["n_tp"]), w, name)


if __name__ == "__main__":
    worker_main(CASES, sys.argv)
