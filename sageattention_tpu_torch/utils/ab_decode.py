"""A/B of decode kernels 9-12 against another revision.

Run from the repository root on a card, with a checkout of the other
revision (``git archive REV | tar -x -C DIR``)::

    python -m sageattention_tpu_torch.utils.ab_decode DIR

Both trees' ``decode`` and ``paged_decode`` sources (head dims up to 256)
and their wide sources (384 and 512) are built; it prints every kernel
instance's registers and stack bytes in both (``cuobjdump``) and compares
those of the instances both trees have (an instance whose last template
argument, RAGGED, is 0 stands for the same instance without it in a tree
from before RAGGED).  Cases: d 64 / 128 / 256, int8 and int4, t_q 1 and 4,
window 4096 or none, a dense cache or pages of 16 and 1024 (b 2, lengths
8189 and 1000); a `sharded_paged` shard (kernel 11 with ``owned``: b 1,
32/8, d 128, a quarter of 128 scrambled 1024-token pages, length 131,056);
pages of 16 at d 512 (b 4, 16/16, length 4112); the serving cells' decode
steps (the `llm_dense` / `llm_paged` step, b 4, 32/8, d 128, 4112 of 8192
tokens, int8 and int4; a `sharded_dense` shard, b 1, 16/4, 65,520 tokens;
the Gemma-7B step at d 256).  Kernels 10 and 12 (the
window) must give bit-identical (o, m, l) in both trees; kernels 9 and 11
(the split walk) must agree within ``chip_smoke``'s
``decode_agreement`` limits (o cosine >= 0.9999, max-abs <= 2e-2, m
within 1e-5, l within 1e-4 relative: the split sums l in another order).
Each launch is timed (CUDA events, median of 20, L2 flushed, in the order
this, other, other, this and averaged); kernels 9 and 11 are also timed
under design B's plan (a cluster of one CTA, the splits alone), beside
this tree's plan (``decode_cuda.split_plan``).  Both trees' kernels are
called through their C entry points with the same preallocated operands,
so the times hold no wrapper work (this tree's split workspace is the
wrapper's, allocated before the timing).  The last line is a JSON summary;
it exits 1 if a case disagrees or any shared instance's registers or
stack moved.  It uses ``chip_smoke.py``'s helpers.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import pathlib
import sys


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from sageattention_tpu_torch import quant
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import decode_cuda as dc

    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    path = pathlib.Path(argv[0]) / "sageattention_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
    ob = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ob)
    cs.log(f"card: {cs.card_line()}")
    libs = ("decode", "paged_decode", "decode_wide", "paged_decode_wide")
    regs_by = {}
    for name, b_ in (("this", _build), ("other", ob)):
        for lib in libs:
            b_.lib(lib)
            for kern, regs, stack in cs.kernel_registers(b_, lib):
                cs.log(f"ab {name} {lib} {kern}: {regs} registers, {stack} bytes of stack")
                head, args = kern.split("<", 1)
                args = args.split(">", 1)[0].split(",")
                if head == "sage_decode_kernel" or head == "sage_paged_decode_kernel":
                    if len(args) == 5:  # <D, MW, PACKED, WINDOW, RAGGED>
                        if args[4] != "0":
                            continue
                        args = args[:4]
                regs_by.setdefault((lib, f"{head}<{','.join(args)}>"), {})[name] = (regs, stack)
    shared = {k: v for k, v in regs_by.items() if len(v) == 2}
    moved = [f"{lib} {kern}: {v['other']} -> {v['this']}" for (lib, kern), v in shared.items()
             if v["this"] != v["other"]]
    cs.log(f"ab registers: {len(shared)} instances in both trees, {len(moved)} moved {moved}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    stream = torch.cuda.current_stream().cuda_stream

    def plan_b(n_chunks, rows, b, hkv):
        """Design B: clusters of one CTA, the grid's splits alone."""
        base = -(-rows // dc.SPLIT_RT) * hkv * b
        splits = min(n_chunks, dc.SPLITS_MAX, -(-2 * 132 // base))
        per = -(-n_chunks // splits)
        return 1, -(-n_chunks // per)

    def case(d, hq, hkv, b, S, lengths, packed, t_q, window, page, own_frac=None):
        cache = cs.random_cache(gen, (b, hkv), S, d, packed)
        q = torch.randn(b, hq, t_q, d, generator=gen, device="cuda")
        L = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        rows = hq // hkv * t_q
        qs_mul = quant.fold_multiplier(d**-0.5 * cs.LOG2E, 119.0 if packed else 127.0)
        qf = q.float().contiguous()
        sfx = "_wide" if d > 256 else ""
        outs = [[torch.empty(b, hkv, rows, d, device="cuda"),
                 *(torch.empty(b, hkv, rows, device="cuda") for _ in range(2))]
                for _ in range(3)]
        if page is None:
            C, n_chunks, n_live = dc.dense_plan(S, rows, t_q, 4096, window)
            fn = "sage_decode" if window is None else "sage_decode_window"
            lib = "decode" + sfx
            plan = dc.dense_split_plan(q.shape, hkv, S, C)

            def head(build, o):
                return (qf.data_ptr(), *(x.data_ptr() for x in cache), L.data_ptr(),
                        *(x.data_ptr() for x in o), b, hkv, rows, t_q, S, d, int(packed), C,
                        window or 0, n_live or 0, qs_mul, stream)
        else:
            pool, table = cs.paged_from_dense(gen, cache, page)
            n_chunks = table.shape[1]
            n_live = dc.paged_plan(page, n_chunks, rows, hq // hkv, t_q, window)
            owned = None
            if own_frac is not None:
                owned = (torch.rand(table.shape, generator=gen, device="cuda")
                         < own_frac).int()
            fn = "sage_paged_decode" if window is None else "sage_paged_decode_window"
            lib = "paged_decode" + sfx
            plan = dc.paged_split_plan(q.shape, hkv, page, n_chunks)

            def head(build, o):
                # a tree with the sharded pool takes owned (NULL or the mask) after the table
                with_owned = len(build.SIGNATURES["paged_decode"][fn]) > 22
                return (qf.data_ptr(), *(x.data_ptr() for x in pool), table.data_ptr(),
                        *((0 if owned is None else owned.data_ptr(),) if with_owned else ()),
                        L.data_ptr(), *(x.data_ptr() for x in o), b, hkv, rows, t_q, page,
                        n_chunks, d, int(packed), window or 0, n_live or 0, qs_mul, stream)

        def split_tail(build, plan_):
            # a tree with the split walk takes its plan and workspace after the
            # stream of kernels 9 and 11, four arguments more than the window's
            sigs = build.SIGNATURES[lib]
            if window is not None or len(sigs[fn + sfx]) != len(sigs[fn + "_window" + sfx]) + 4:
                return ()
            return (*plan_, *dc.split_workspace(q.device, stream, plan_, b, hkv, rows, d))

        def launcher(build, o, plan_=plan):
            args = (*head(build, o), *split_tail(build, plan_))
            entry = getattr(build.lib(lib), fn + sfx)
            return lambda: entry(*args)

        if window is None:  # the workspace of both plans before any launcher holds it
            pb = plan_b(n_chunks, rows, b, hkv)
            split_tail(_build, pb)
        calls = [launcher(_build, outs[0]), launcher(ob, outs[1])]
        for which, call in zip(("this", "other"), calls):
            err = call()
            cs.require(err == 0, f"ab: {which} tree's {fn} failed: {err}")
        torch.cuda.synchronize()
        label = (f"{fn}{sfx} d{d} {hq}/{hkv} {'int4' if packed else 'int8'} t_q {t_q} "
                 f"window {window} page {page}{'' if own_frac is None else ' owned'}")
        rec = {"case": label}
        if window is None:
            ok, what, _ = cs.decode_agreement(outs[0], outs[1])
            call_b = launcher(_build, outs[2], pb)
            cs.require(call_b() == 0, f"ab: design B's {fn} failed")
            ok_b, what_b, _ = cs.decode_agreement(outs[2], outs[1])
            rec.update(agrees=ok and ok_b, plan=list(plan), plan_b=list(pb))
            msg = f"agrees with the other tree {ok} ({what}); design B {ok_b}"
        else:
            same = all(torch.equal(x, y) for x, y in zip(outs[0], outs[1]))
            rec.update(agrees=same, bit_identical=same)
            msg = f"bit-identical {same}"
        t = [cs.cuda_ms(calls[i], reps=20, cold=True) for i in (0, 1, 1, 0)]  # ABBA
        rec.update(ms=(t[0] + t[3]) / 2, other_ms=(t[1] + t[2]) / 2)
        timing = f"ms this {rec['ms']:.4f}, other {rec['other_ms']:.4f}"
        if window is None:
            rec["ms_b"] = cs.cuda_ms(call_b, reps=20, cold=True)
            timing += f", design B {rec['ms_b']:.4f} (plans {plan} / {pb})"
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
    bad = [c["case"] for c in cases if not c["agrees"]]
    ratio = [c["ms"] / c["other_ms"] for c in cases]
    print(json.dumps({"cases": len(cases), "disagree": bad,
                      "window_bit_identical": sum(c.get("bit_identical", False) for c in cases),
                      "ms_ratio_min": min(ratio), "ms_ratio_max": max(ratio),
                      "slower": [c["case"] for c in cases if c["ms"] > c["other_ms"]],
                      "shared_instances": len(shared), "registers_moved": moved}))
    return 1 if bad or moved else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
