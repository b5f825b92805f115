"""Pieces shared by ``chip_smoke.py`` and the kernel A/B tools of this
package: another tree's ``ops/_build.py``, the registers of a built
library, ``torch.profiler``'s kernel times, and kernel 4's inputs and cases
(``offset_rows``, ``rows_cases``).  Nothing here runs at import; each
function imports ``torch`` itself.
"""

from __future__ import annotations

import importlib.util
import os
import pathlib
import re
import shutil
import subprocess


def load_build(tree: pathlib.Path, name: str):
    """``ops/_build.py`` of the checkout at ``tree`` as a module of its own
    (named ``name``), which builds that tree's sources into its own
    ``build/``."""
    path = tree / "sageattention_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def registers(build, lib: str) -> list[str]:
    """Registers and stack bytes of each kernel of ``lib`` as ``build``
    built it, by ``cuobjdump -res-usage``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-res-usage", str(build._target(lib))],
                         capture_output=True, text=True, timeout=120).stdout
    rows, fn = [], None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+)", line)
        if m and fn:
            rows.append(f"{fn[-60:]}: {m.group(1)} registers, {m.group(2)} bytes of stack")
    return rows


def device_ms(fn, kernel: str, calls: int = 20) -> float:
    """The mean device time of the kernels whose name holds ``kernel`` over
    ``calls`` calls of ``fn``, as ``torch.profiler`` records them (NaN
    where it records none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    return sum(spans) / len(spans) / 1e3 if spans else float("nan")


def offset_rows(gen, shape, dtype: str):
    """Random rows on the card with a per-(b, h) channel offset (what a
    mean takes off), as kernel 4 reads them: bf16, fp32, or fp16 values
    widened to fp32."""
    import torch

    b, h, s, d = shape
    x = (torch.randn(b, h, s, d, generator=gen, device="cuda")
         + torch.randn(b, h, 1, d, generator=gen, device="cuda") * 3)
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    return x.half().float() if dtype == "fp16" else x


def rows_cases(x, mean):
    """Kernel 4's instances on x: (group, form, mean, cast) for groups of 1
    (per_token), 32 (per_subtile) and 128 (per_block) rows, each on x, on
    ``f32(x) - mean`` (K smoothed) and on that rounded back to the 16-bit
    type (smooth_q's Q: bf16 for bf16 x, fp16 for fp32 x)."""
    import torch

    cast = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float16
    for group in (1, 32, 128):
        for form, m, c in (("x", None, None), ("x - mean", mean, None),
                           ("cast(x - mean)", mean, cast)):
            yield group, form, m, c
