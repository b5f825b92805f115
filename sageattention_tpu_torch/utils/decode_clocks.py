"""Where a CTA of the decode split walk (kernels 9-12) spends its time.

Run from the repository root on a card::

    python -m sageattention_tpu_torch.utils.decode_clocks

It copies ``csrc/paged_decode.cu`` and the headers it includes into
``build/decode_clocks/``, adds ``clock64`` counters at the phase boundaries
of ``csrc/decode_split_sm90.cuh`` (thread 0 of each CTA adds the cycles
since its last boundary to one of 14 global counters), builds the copy,
and launches kernel 12 at the windowed server's extend block (b 2, 32/8
heads of 128, t_q 512, length 8192 of 9216, window 4096, pages of 1024)
and decode step (t_q 1, length 8208) under the wrapper's plan and others.
For each launch it prints the instrumented kernel's time (CUDA events,
median of 10, L2 flushed; the counters' atomics add to it) and the mean
microseconds a CTA spends in each phase, thread 0's view, at the SM clock
``nvidia-smi`` reads after the runs.  The sources themselves are not
changed; a boundary whose code moved stops the run with the text it
looked for.  It uses ``chip_smoke.py``'s helpers.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

PHASES = ["setup", "wait", "issue", "scores", "m_c rows", "l_c pass", "l_c rows",
          "codes+V^T", "P.V mma", "push", "merge", "epilogue", "cluster sync", "step return"]

# (the text a counter follows or precedes, the same text with the counter)
MARKS = [
    ("namespace dsplit {\n",
     "namespace dsplit {\n\n__device__ unsigned long long g_clocks[16];\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  long long t0 = clock64();\n"
     "  auto mark = [&](int i) {\n"
     "    if (threadIdx.x == 0) {\n"
     "      const long long t1 = clock64();\n"
     "      atomicAdd(&g_clocks[i], (unsigned long long)(t1 - t0));\n"
     "      t0 = t1;\n"
     "    }\n"
     "  };\n"
     "  cg::cluster_group cluster = cg::this_cluster();\n"),
    ("  float acc[L::NACC];",
     "  mark(0);\n  if (threadIdx.x == 0) atomicAdd(&g_clocks[15], 1ull);\n  float acc[L::NACC];"),
    ("    if (cur_issued <= i) issue(s, cur_issued++);  // nothing was in flight\n",
     "    if (cur_issued <= i) issue(s, cur_issued++);  // nothing was in flight\n    mark(2);\n"),
    ("    __syncthreads();\n    const int upto = i + L::NSTAGE;",
     "    __syncthreads();\n    mark(1);\n    const int upto = i + L::NSTAGE;"),
    ("    return sStage + ((consumed++) % L::NSTAGE) * L::STAGE;",
     "    mark(2);\n    return sStage + ((consumed++) % L::NSTAGE) * L::STAGE;"),
    ("live1 ? v1 : NEG_INIT);\n      }\n    }\n  };",
     "live1 ? v1 : NEG_INIT);\n      }\n    }\n    mark(3);\n  };"),
    ("      cta_rows(mx0, mx1, 0.f, 0.f, false);\n      cluster_sync();",
     "      cta_rows(mx0, mx1, 0.f, 0.f, false);\n      mark(4);\n      cluster_sync();\n"
     "      mark(12);"),
    ("      cta_rows(ls0, ls1, pm0, pm1, true);\n      cluster_sync();",
     "      mark(5);\n      cta_rows(ls0, ls1, pm0, pm1, true);\n      mark(6);\n"
     "      cluster_sync();\n      mark(12);"),
    ("          const unsigned char* st = step(s, it++);\n",
     "          const unsigned char* st = step(s, it++);\n          mark(13);\n"),
    ("          __syncthreads();\n#pragma unroll\n          for (int kk = 0; kk < L::SLAB / 32;",
     "          mark(7);\n          __syncthreads();\n          mark(1);\n#pragma unroll\n"
     "          for (int kk = 0; kk < L::SLAB / 32;"),
    ("mma_s8(pacc[nt], a, b[nt][0], b[nt][1]);\n          }\n        }\n      }",
     "mma_s8(pacc[nt], a, b[nt][0], b[nt][1]);\n          }\n          mark(8);\n        }\n"
     "      }"),
    ("      cluster_sync();\n\n      // ---- this CTA's D / CL columns",
     "      mark(9);\n      cluster_sync();\n      mark(12);\n\n"
     "      // ---- this CTA's D / CL columns"),
    ("      if (ci_next >= c1) break;", "      mark(10);\n      if (ci_next >= c1) break;"),
    ("  cluster_sync();  // no CTA leaves while another reads its shared memory\n",
     "  cluster_sync();  // no CTA leaves while another reads its shared memory\n  mark(12);\n"),
    ("  if (w.splits == 1) {\n", "  if (w.splits == 1) {\n    mark(11);\n"),
]

READ = """
extern "C" int clocks_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, dsplit::g_clocks, sizeof(unsigned long long) * 16);
}
extern "C" int clocks_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(dsplit::g_clocks, z, sizeof(z));
}
"""


def build(_build) -> ctypes.CDLL:
    """The instrumented paged decode library."""
    out = _build.build_dir() / "decode_clocks"
    out.mkdir(parents=True, exist_ok=True)
    for name in ("decode_body.cuh", "decode_paged.cuh", "mma_sm90.cuh", "paged_decode.cu",
                 "decode_split_sm90.cuh"):
        text = (_build.CSRC / name).read_text()
        if name == "decode_split_sm90.cuh":
            for old, new in MARKS:
                if text.count(old) != 1:
                    raise RuntimeError(f"decode_clocks: {old!r} is not in {name} once")
                text = text.replace(old, new)
        if name == "paged_decode.cu":
            text += READ
        (out / name).write_text(text)
    so = out / "libdecode_clocks.so"
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(so), str(out / "paged_decode.cu")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.sage_paged_decode_window.argtypes = _build.SIGNATURES["paged_decode"][
        "sage_paged_decode_window"]
    lib.sage_paged_decode_window.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    import chip_smoke as cs
    from sageattention_tpu_torch import quant
    from sageattention_tpu_torch.ops import _build
    from sageattention_tpu_torch.ops import decode_cuda as dc

    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}")
    lib = build(_build)
    fn = lib.sage_paged_decode_window
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    stream = torch.cuda.current_stream().cuda_stream
    hq, hkv, d, page, S, window = 32, 8, 128, 1024, 9216, 4096
    runs = []
    for label, b, t_q, length, plans in (("extend block, t_q 512", 2, 512, 8192, [(1, 1), (4, 1)]),
                                         ("decode step, t_q 1", 2, 1, 8208, [(2, 5), (4, 1)])):
        cache = cs.random_cache(gen, (b, hkv), S, d, False)
        pool, table = cs.paged_from_dense(gen, cache, page)
        q = torch.randn(b, hq, t_q, d, generator=gen, device="cuda")
        L = torch.full((b,), length, dtype=torch.int32, device="cuda")
        rows = hq // hkv * t_q
        n_live = dc.paged_plan(page, S // page, rows, hq // hkv, t_q, window)
        o = torch.empty(b, hkv, rows, d, device="cuda")
        m, l = (torch.empty(b, hkv, rows, device="cuda") for _ in range(2))
        qs_mul = quant.fold_multiplier(d**-0.5 * cs.LOG2E, 127.0)
        plan = dc.window_split_plan(q.shape, hkv, page, n_live)
        for p in [plan] + [x for x in plans if x != plan]:
            work, tickets = dc.split_workspace(q.device, stream, p, b, hkv, rows, d)
            args = (q.data_ptr(), *(x.data_ptr() for x in pool), table.data_ptr(), None,
                    L.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(), b, hkv, rows, t_q,
                    page, S // page, d, 0, window, n_live, qs_mul, stream, *p, work, tickets)
            cs.require(fn(*args) == 0, f"decode_clocks: the launch under {p} failed")
            ms = cs.cuda_ms(lambda: fn(*args), reps=10, cold=True)
            lib.clocks_reset()
            fn(*args)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            lib.clocks_read(buf)
            runs.append((label, p, p == plan, ms, buf[15], list(buf[:len(PHASES)])))
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
                                "nounits"], capture_output=True, text=True).stdout.split()[0])
    for label, p, own, ms, ctas, cycles in runs:
        us = [c / ctas / mhz for c in cycles]
        parts = ", ".join(f"{n} {u:.2f}" for n, u in zip(PHASES, us) if u)
        cs.log(f"clocks {label}, (cl, splits) {p}{' (the plan)' if own else ''}: {ms:.4f} ms, "
               f"{ctas} CTAs, {sum(us):.2f} us a CTA at {mhz:.0f} MHz: {parts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
