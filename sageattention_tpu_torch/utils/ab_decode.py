"""A/B of decode kernels 9-12 without ``owned`` against another revision.

Run from the repository root on a card, with a checkout of the other
revision (``git archive REV | tar -x -C DIR``)::

    python -m sageattention_tpu_torch.utils.ab_decode DIR

Both trees' ``decode`` and ``paged_decode`` sources (head dims up to 256)
are built; it prints every kernel instance's registers and stack bytes in
both (``cuobjdump``) and compares those of the instances both trees have
(an instance whose last template argument, RAGGED, is 0 stands for the
same instance without it in a tree from before RAGGED), and for each case
(d 64 / 128 / 256, int8 and int4, t_q 1 and 4, window 4096 or none, a
dense cache or pages of 16 and 1024; b 2, lengths 8189 and 1000) whether
the two give bit-identical (o, m, l) on the same inputs, and each launch's
time (CUDA events, median of 20, L2 flushed, timed in the order this,
other, other, this and averaged).  Both trees' kernels are called through
their C entry points with the same preallocated operands, so the times
hold no wrapper work.  The last line is a JSON summary; it exits 1 if any
case differs or any shared instance's registers or stack moved.  It uses
``chip_smoke.py``'s helpers.
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
    regs_by = {}
    for name, b_ in (("this", _build), ("other", ob)):
        for lib in ("decode", "paged_decode"):
            b_.lib(lib)
            for kern, regs, stack in cs.kernel_registers(b_, lib):
                cs.log(f"ab {name} {lib} {kern}: {regs} registers, {stack} bytes of stack")
                head, args = kern.split("<", 1)
                args = args.split(">", 1)[0].split(",")
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
    cases, differ = [], 0
    for d, hq, hkv in ((64, 8, 2), (128, 32, 8), (256, 16, 16)):
        for packed, t_q, window, page in itertools.product((False, True), (1, 4), (None, 4096),
                                                           (None, 16, 1024)):
            b, S = 2, 8192
            cache = cs.random_cache(gen, (b, hkv), S, d, packed)
            q = torch.randn(b, hq, t_q, d, generator=gen, device="cuda")
            L = torch.tensor([8189, 1000], dtype=torch.int32, device="cuda")
            rows = hq // hkv * t_q
            qs_mul = quant.fold_multiplier(d**-0.5 * cs.LOG2E, 119.0 if packed else 127.0)
            qf = q.float().contiguous()
            outs = [[torch.empty(b, hkv, rows, d, device="cuda"),
                     *(torch.empty(b, hkv, rows, device="cuda") for _ in range(2))]
                    for _ in range(2)]
            if page is None:
                C, _, n_live = dc.dense_plan(S, rows, t_q, 4096, window)
                fn = "sage_decode" if window is None else "sage_decode_window"

                def launch(build, o):
                    return getattr(build.lib("decode"), fn)(
                        qf.data_ptr(), *(x.data_ptr() for x in cache), L.data_ptr(),
                        *(x.data_ptr() for x in o), b, hkv, rows, t_q, S, d, int(packed), C,
                        window or 0, n_live or 0, qs_mul, stream)
            else:
                pool, table = cs.paged_from_dense(gen, cache, page)
                n_live = dc.paged_plan(page, table.shape[1], rows, hq // hkv, t_q, window)
                fn = "sage_paged_decode" if window is None else "sage_paged_decode_window"

                def launch(build, o):
                    # a tree from PR 9 on takes owned (NULL here) after the table
                    owned = len(build.SIGNATURES["paged_decode"][fn]) > 22
                    return getattr(build.lib("paged_decode"), fn)(
                        qf.data_ptr(), *(x.data_ptr() for x in pool), table.data_ptr(),
                        *((0,) if owned else ()), L.data_ptr(),
                        *(x.data_ptr() for x in o), b, hkv, rows, t_q, page, table.shape[1], d,
                        int(packed), window or 0, n_live or 0, qs_mul, stream)
            calls = [lambda: launch(_build, outs[0]), lambda: launch(ob, outs[1])]
            for which, call in zip(("this", "other"), calls):
                err = call()
                cs.require(err == 0, f"ab: {which} tree's {fn} failed: {err}")
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(*outs))
            differ += not same
            t = [cs.cuda_ms(calls[i], reps=20, cold=True) for i in (0, 1, 1, 0)]  # ABBA
            ms, ms_other = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            label = (f"{fn} d{d} {'int4' if packed else 'int8'} t_q {t_q} window {window} "
                     f"page {page}")
            cs.log(f"ab {label}: bit-identical {same}; ms this {ms:.4f}, other {ms_other:.4f}")
            cases.append({"case": label, "same": same, "ms": ms, "other_ms": ms_other})
    ratio = [c["ms"] / c["other_ms"] for c in cases]
    print(json.dumps({"cases": len(cases), "bit_identical": len(cases) - differ,
                      "ms_ratio_min": min(ratio), "ms_ratio_max": max(ratio),
                      "shared_instances": len(shared), "registers_moved": moved}))
    return 1 if differ or moved else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
