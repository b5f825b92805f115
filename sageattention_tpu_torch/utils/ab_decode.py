"""A/B of decode kernels 9-12 against another revision.

Run from the repository root on a card, with a checkout of the other
revision (``git archive REV | tar -x -C DIR``)::

    python -m sageattention_tpu_torch.utils.ab_decode DIR

Both trees' ``decode`` and ``paged_decode`` sources (head dims up to 256)
and their wide sources (384 and 512) are built (one ``nvcc`` a source, all
at once); it prints every kernel instance's registers and stack bytes in
both (``cuobjdump``), and those of the instances both trees have side by
side (another tree's ``sage_decode_split_kernel`` stands for this tree's
``sage_decode_kernel``, which runs kernels 9 and 10, and the same for the
paged ones). Cases: d 64 / 128 / 256, int8 and int4, t_q 1 and 4, window
4096 or none, a dense cache or pages of 16 and 1024 (b 2, lengths 8189 and
1000); a `sharded_paged` shard (kernel 11 with ``owned``: b 1, 32/8, d 128,
a quarter of 128 scrambled 1024-token pages, length 131,056); pages of 16
at d 512 (b 4, 16/16, length 4112); the serving cells' decode steps (the
`llm_dense` / `llm_paged` step, b 4, 32/8, d 128, 4112 of 8192 tokens, int8
and int4; a `sharded_dense` shard, b 1, 16/4, 65,520 tokens; the Gemma-7B
step at d 256; the `llm_window_dense` / `llm_window_paged` step, b 2, 32/8,
8208 of 9216 tokens, window 4096, int8 and int4, and the same at d 256
(16/16) and d 512 (b 4, 16/16, 4128 of 8192)); and the 512-token extend
blocks of the windowed server (b 2, 32/8, d 128, length 8192 of 9216,
window 4096, dense and pages of 1024) and of kernels 9 and 11 (no window,
length 3000). Kernels 9 and 11 at t_q 1 and 4 must give bit-identical (o,
m, l) in both trees; every other case must agree within ``chip_smoke``'s
``decode_agreement`` limits (o cosine >= 0.9999, max-abs <= 2e-2, m within
1e-5, l within 1e-4 relative: the windowed kernels moved to the split walk,
which sums l in another order, and extend blocks take their tile's own
slabs). Each launch is timed (CUDA events, median of 20, L2 flushed, in the
order this, other, other, this and averaged). The extend blocks are also
timed, in this tree, under the other cluster sizes (cl 1, 2, 4 and 8, one
split), each held to this tree's plan within ``decode_agreement``. Both
trees' kernels are called through their C entry points with the same
preallocated operands and each tree's own plan, so the times hold no
wrapper work (the split workspaces are allocated before the timing). The
last line is a JSON summary; it exits 1 if a case disagrees. It uses
``chip_smoke.py``'s helpers.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from sageattention_tpu_torch import quant
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import decode_cuda as dc

    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    ops = pathlib.Path(argv[0]) / "sageattention_tpu_torch" / "ops"
    ob = _load("other_build", ops / "_build.py")
    odc = _load("other_decode_cuda", ops / "decode_cuda.py")  # its plans
    cs.log(f"card: {cs.card_line()}")
    libs = ("decode", "paged_decode", "decode_wide", "paged_decode_wide")
    trees = (("this", _build), ("other", ob))
    with ThreadPoolExecutor(2 * len(libs)) as pool:  # one nvcc a source, all at once
        list(pool.map(lambda x: x[0].lib(x[1]), [(b_, lib) for _, b_ in trees for lib in libs]))
    regs_by = {}
    for name, b_ in trees:
        for lib in libs:
            for kern, regs, stack in cs.kernel_registers(b_, lib):
                cs.log(f"ab {name} {lib} {kern}: {regs} registers, {stack} bytes of stack")
                head, args = kern.split("<", 1)
                args = args.split(">", 1)[0].split(",")
                head = head.replace("_split_kernel", "_kernel")  # the same <D, PACKED, RAGGED>
                regs_by.setdefault((lib, f"{head}<{','.join(args)}>"), {})[name] = (regs, stack)
    shared = {k: v for k, v in regs_by.items() if len(v) == 2}
    moved = [f"{lib} {kern}: {v['other']} -> {v['this']}" for (lib, kern), v in shared.items()
             if v["this"] != v["other"]]
    cs.log(f"ab registers: {len(shared)} instances in both trees, {len(moved)} moved {moved}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    stream = torch.cuda.current_stream().cuda_stream

    def case(d, hq, hkv, b, S, lengths, packed, t_q, window, page, own_frac=None,
             variants=()):
        """One case in both trees (and in this tree under each of
        ``variants``' (cl, splits) plans): its record."""
        cache = cs.random_cache(gen, (b, hkv), S, d, packed)
        q = torch.randn(b, hq, t_q, d, generator=gen, device="cuda")
        L = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        rows = hq // hkv * t_q
        qs_mul = quant.fold_multiplier(d**-0.5 * cs.LOG2E, 119.0 if packed else 127.0)
        qf = q.float().contiguous()
        sfx = "_wide" if d > 256 else ""
        fn = ("sage_decode" if page is None else "sage_paged_decode") + (
            "" if window is None else "_window")
        lib = ("decode" if page is None else "paged_decode") + sfx
        if page is None:
            C, n_chunks, n_live = dc.dense_plan(S, rows, t_q, 4096, window)
            lead = 21  # the operands before the split walk's

            def head(o):
                return (qf.data_ptr(), *(x.data_ptr() for x in cache), L.data_ptr(),
                        *(x.data_ptr() for x in o), b, hkv, rows, t_q, S, d, int(packed), C,
                        window or 0, n_live or 0, qs_mul, stream)
        else:
            pool, table = cs.paged_from_dense(gen, cache, page)
            C = page
            n_chunks = table.shape[1]
            n_live = dc.paged_plan(page, n_chunks, rows, hq // hkv, t_q, window)
            owned = None
            if own_frac is not None:
                owned = (torch.rand(table.shape, generator=gen, device="cuda")
                         < own_frac).int()
            lead = 23

            def head(o):
                return (qf.data_ptr(), *(x.data_ptr() for x in pool), table.data_ptr(),
                        0 if owned is None else owned.data_ptr(), L.data_ptr(),
                        *(x.data_ptr() for x in o), b, hkv, rows, t_q, page, n_chunks, d,
                        int(packed), window or 0, n_live or 0, qs_mul, stream)

        def plan_of(mod):
            """A tree's own (cl, splits), or None where its entry point takes
            no plan (the windowed kernels before they took the split walk)."""
            if len((ob if mod is odc else _build).SIGNATURES[lib][fn + sfx]) == lead:
                return None
            if window is not None:
                return mod.window_split_plan(q.shape, hkv, C, n_live)
            return (mod.dense_split_plan(q.shape, hkv, S, C) if page is None
                    else mod.paged_split_plan(q.shape, hkv, page, n_chunks))

        def tail(mod, plan):
            if plan is None:
                return ()
            return (*plan, *mod.split_workspace(q.device, stream, plan, b, hkv, rows, d))

        plans = [(dc, plan_of(dc)), (odc, plan_of(odc))]
        plans += [(dc, p) for p in variants if p != plans[0][1]]
        for mod, plan in plans:  # every workspace grown before any launcher holds it
            tail(mod, plan)
        outs = [[torch.empty(b, hkv, rows, d, device="cuda"),
                 *(torch.empty(b, hkv, rows, device="cuda") for _ in range(2))]
                for _ in plans]

        def launcher(i):
            mod, plan = plans[i]
            args = (*head(outs[i]), *tail(mod, plan))
            entry = getattr((ob if mod is odc else _build).lib(lib), fn + sfx)
            return lambda: entry(*args)

        calls = [launcher(i) for i in range(len(plans))]
        for i, call in enumerate(calls):
            err = call()
            cs.require(err == 0, f"ab: {fn}{sfx} under {plans[i][1]} failed: {err}")
        torch.cuda.synchronize()
        label = (f"{fn}{sfx} d{d} {hq}/{hkv} {'int4' if packed else 'int8'} t_q {t_q} "
                 f"window {window} page {page}{'' if own_frac is None else ' owned'}")
        rec = {"case": label, "plan": plans[0][1], "other_plan": plans[1][1]}
        same = all(torch.equal(x, y) for x, y in zip(outs[0], outs[1]))
        ok, what, _ = cs.decode_agreement(outs[0], outs[1])
        # kernels 9 and 11 at t_q 1 and 4: bit for bit; the rest within the limits
        must_match = window is None and t_q <= 4
        rec.update(bit_identical=same, exact=must_match, agrees=same if must_match else ok)
        msg = f"bit-identical {same}; agrees ({what})"
        t = [cs.cuda_ms(calls[i], reps=20, cold=True) for i in (0, 1, 1, 0)]  # ABBA
        rec.update(ms=(t[0] + t[3]) / 2, other_ms=(t[1] + t[2]) / 2)
        timing = f"ms this {rec['ms']:.4f} {plans[0][1]}, other {rec['other_ms']:.4f}"
        rec["variants"] = []
        for i in range(2, len(plans)):
            ok_v, what_v, _ = cs.decode_agreement(outs[i], outs[0])
            ms_v = cs.cuda_ms(calls[i], reps=20, cold=True)
            rec["variants"].append({"plan": plans[i][1], "ms": ms_v, "agrees": ok_v})
            rec["agrees"] = rec["agrees"] and ok_v
            timing += f"; {plans[i][1]} {ms_v:.4f} (agrees {ok_v}: {what_v})"
        cs.log(f"ab {label}: {msg}; {timing}")
        return rec

    cases = []
    for d, hq, hkv in ((64, 8, 2), (128, 32, 8), (256, 16, 16)):
        for packed, t_q, window, page in itertools.product((False, True), (1, 4), (None, 4096),
                                                           (None, 16, 1024)):
            cases.append(case(d, hq, hkv, 2, 8192, [8189, 1000], packed, t_q, window, page))
    # a sharded_paged shard: a quarter of 128 scrambled pages of 1024 owned
    for packed in (False, True):
        cases.append(case(128, 32, 8, 1, 131072, [131072 - 16], packed, 1, None, 1024,
                          own_frac=0.25))
    # pages of 16 at d 512, the wide serving cell's
    for packed in (False, True):
        cases.append(case(512, 16, 16, 4, 8192, [4112] * 4, packed, 1, None, 16))
    # the serving cells' decode steps: llm_dense / llm_paged (b 4, 32/8, d 128,
    # 4112 of 8192 tokens), a sharded_dense shard (b 1, 16/4, 65,520 of
    # 65,536), the Gemma-7B step (b 4, 16/16, d 256)
    for packed, page in itertools.product((False, True), (None, 1024)):
        cases.append(case(128, 32, 8, 4, 8192, [4112] * 4, packed, 1, None, page))
    cases.append(case(128, 16, 4, 1, 65536, [65536 - 16], False, 1, None, None))
    for page in (None, 1024):
        cases.append(case(256, 16, 16, 4, 8192, [4112] * 4, False, 1, None, page))
    # the windowed cells' decode steps: llm_window_dense / _paged (b 2, 32/8,
    # d 128, 8208 of 9216 tokens, window 4096), at d 256 (16/16) and the wide
    # serving cells' at d 512 (b 4, 16/16, 4128 of 8192)
    for packed, page in itertools.product((False, True), (None, 1024)):
        cases.append(case(128, 32, 8, 2, 9216, [8208] * 2, packed, 1, 4096, page))
    for page in (None, 1024):
        cases.append(case(256, 16, 16, 2, 9216, [8208] * 2, False, 1, 4096, page))
        cases.append(case(512, 16, 16, 4, 8192, [4128] * 4, False, 1, 4096, page))
    # the extend blocks (t_q 512): the windowed server's prefill in blocks
    # and kernels 9 and 11's, under each cluster size
    extend = []
    for window, length in ((4096, 8192), (None, 3000)):
        for page in (None, 1024):
            rec = case(128, 32, 8, 2, 9216, [length] * 2, False, 512, window, page,
                       variants=[(cl, 1) for cl in (1, 2, 4, 8)])
            extend.append(rec)
            cases.append(rec)
    bad = [c["case"] for c in cases if not c["agrees"]]
    ratio = [c["ms"] / c["other_ms"] for c in cases]
    print(json.dumps({"cases": len(cases), "disagree": bad,
                      "bit_identical": sum(c["bit_identical"] for c in cases),
                      "bit_identical_required": sum(c["exact"] for c in cases),
                      "ms_ratio_min": min(ratio), "ms_ratio_max": max(ratio),
                      "slower": [c["case"] for c in cases if c["ms"] > c["other_ms"]],
                      "extend": [{k: c[k] for k in ("case", "plan", "ms", "other_ms",
                                                    "variants")} for c in extend],
                      "shared_instances": len(shared), "registers_moved": moved}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
