"""A rate probe of one NVIDIA Hopper card: the port of the TPU kernel
``tools/probe_mxu.py`` (``_time_variant`` -> ``_probe_kernel``).

Run from the repository root on a card::

    python -m sageattention_tpu_torch.utils.probe_mma

The JAX probe timed the MXU and VPU primitives the fused attention kernel
issues, to answer its design questions on the TPU.  This one asks them of
the card (``csrc/probe_mma.cu``, whose header describes the kernels):

1. int8 Q.K^T at contraction 64, 128 and 256, as ``mma.sync.m16n8k32``
   (the fragment the port's kernels issue) and as ``wgmma.mma_async
   m64n256k32`` (the route of later, faster kernels);
2. P.V at output widths 64, 128 and 256 in bf16 (``m16n8k16``,
   ``wgmma k16``), e4m3 (``m16n8k32``, ``wgmma k32``) and int8 (the
   question of kernel 1's ``pv_compute="int8"``);
3. the softmax chain, per element: ``ex2.approx.f32``, ``exp2f`` as the
   kernels compile it, a row max and a row sum by warp shuffles, f32 ->
   bf16, f32 -> int8 quantize of a P tile;
4. device memory: a streaming read (a reduction) and a copy over 4 GiB;

and, as the library rows, cuBLAS through ``torch._int_mm``,
``torch.matmul`` in bf16 and ``torch._scaled_mm`` in e4m3 at 8192^3, and
``Tensor.sum`` / ``Tensor.copy_`` over the same bytes as the memory rows.

Each product or pass is the JAX probe's dependent chain with a zeroed
accumulator (:func:`plain_chain`, :func:`plain_elem_chain`): rep r
perturbs each row's operand by its accumulator's column 0, then adds the
body's result to the accumulator.  :func:`chain` runs a row's kernel on a
CUDA tensor and its plain chain on a CPU one; the card's results are held
to the plain chain, run on the same card tensors, over the rate's own
grid at small ``reps`` (int32 bit-exact, fp32 within 1e-3 relative).  A
rate is the slope between two rep counts (the JAX probe's method, which
cancels the launch), operations (2 M N K a rep, ``probe_mxu.probe``'s
``2 * M * N * d``), elements or bytes over seconds, beside its peak.
Every unit's peak is its width a clock and an SM times the SMs and the
card's largest SM clock (``nvidia-smi``): dense 8192 int8 or e4m3 and
4096 bf16 operations for the tensor cores (the data sheet's 1,979 and
989 T/s are these widths at 132 SMs and 1,830 MHz), 16 ``ex2`` for the
special-function units and 128 for the FP32 lanes (Hopper tuning
guide); device memory's is the data sheet's 3.35 TB/s.  Each row also
gives its share of the data-sheet figure.  A rate above 105 % of its
peak raises (:func:`check_rate`): the chain was folded or the count is
wrong.  It
counts its launches in ``chain.launches``.  It refuses to run without a
card, and it imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
from typing import NamedTuple

import torch

from sageattention_tpu_torch.ops import _build

# data-sheet peaks of one H100 SXM (dense): operations a second, bytes a second
PEAK = {"s8": 1979e12, "e4m3": 1979e12, "bf16": 989e12, "hbm": 3.35e12}
# dense tensor-core operations a clock an SM: PEAK over 132 SMs at 1,830 MHz
TC_PER_CLK_SM = {"s8": 8192, "e4m3": 8192, "bf16": 4096}
# results a clock an SM: the special-function units (ex2) and the FP32 lanes
SFU_PER_CLK_SM, FP32_PER_CLK_SM = 16, 128
GUARD = 1.05  # a rate above this share of its peak is refused
KB = 32        # bytes of K a step (k32 for 8-bit codes, k16 for bf16)
EW = 128       # columns of a pass's fragment
ROWS_PER_CTA = 64  # every product and pass kernel: 4 warps of 16 rows
TARGET_MS = 8.0    # the longer of a rate's two timings
OPS = ("s8", "bf16", "e4m3")
BODIES = ("ex2", "exp2f", "rowmax", "rowsum", "cast_bf16", "quant_int8")
DTYPES = {"s8": torch.int8, "bf16": torch.bfloat16, "e4m3": torch.float8_e4m3fn}


class Row(NamedTuple):
    """One probe: ``kind`` "sync" or "wgmma" (a product: ``op`` the operand
    type, ``n`` output columns (mma.sync: a warp's, 8 an accumulator;
    wgmma: the instruction's N), ``ks`` 32-byte K steps a rep), "elem" (a
    pass: ``op`` the body) or "hbm" (``op`` "read" or "copy")."""

    name: str
    kind: str
    op: str
    n: int = 0
    ks: int = 0

    @property
    def k(self) -> int:
        """Elements of K a rep."""
        return self.ks * KB // (2 if self.op == "bf16" else 1)


def _rows() -> list[Row]:
    rows = []
    for d in (64, 128, 256):  # Q.K^T, int8: contraction d
        rows.append(Row(f"qk s8 d{d} mma.sync", "sync", "s8", 64 if d < 256 else 32, d // KB))
        rows.append(Row(f"qk s8 d{d} wgmma", "wgmma", "s8", 256, d // KB))
    for dv in (64, 128, 256):  # P.V: output width dv
        for op in OPS:
            rows.append(Row(f"pv {op} dv{dv} mma.sync", "sync", op, dv, 1))
            rows.append(Row(f"pv {op} dv{dv} wgmma", "wgmma", op, dv, 4 if op == "bf16" else 2))
    rows += [Row(f"pass {b}", "elem", b, EW) for b in BODIES]
    rows += [Row("hbm read", "hbm", "read"), Row("hbm copy", "hbm", "copy")]
    return rows


ROWS = _rows()


def ops_per_rep(row: Row, m: int) -> int:
    """What a rep does over ``m`` rows: 2 M N K operations for a product
    (``probe_mxu.probe``'s ``2 * M * N * d``), M x 128 elements for a pass."""
    if row.kind == "elem":
        return m * row.n
    return 2 * m * row.n * row.k


def check_rate(name: str, rate: float, peak: float) -> float:
    """``rate`` / ``peak``; raises above :data:`GUARD`."""
    share = rate / peak
    if share > GUARD:
        raise RuntimeError(f"probe {name}: {rate:.4g} a second is {share:.1%} of its peak "
                           f"{peak:.4g}: the chain was folded or its count is wrong")
    return share


# --------------------------------------------------------------------------
# the plain chains (probe_mxu.py:43-56 with a zeroed accumulator)
# --------------------------------------------------------------------------


def _perturb(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x perturbed by its rows' acc[:, 0:1] ``s``: + (s & 1) wrapping on
    int8 codes, + bf16(s) * bf16(1e-30) on bf16, nothing on e4m3 (1e-30
    is 0 there)."""
    if x.dtype == torch.int8:
        return ((x.int() + (s & 1) + 128) % 256 - 128).to(torch.int8)
    if x.dtype == torch.bfloat16:
        tiny = torch.tensor(1e-30, dtype=torch.bfloat16, device=x.device)
        return x + s.to(torch.bfloat16) * tiny
    return x


def plain_chain(x: torch.Tensor, y: torch.Tensor, reps: int) -> torch.Tensor:
    """acc [M, N] after ``reps`` steps of acc += perturb(x, acc[:, :1]) .
    y^T: int32 for int8 x [M, K] and y [N, K] (summed exactly in fp64),
    fp32 for bf16 and e4m3."""
    codes = x.dtype == torch.int8
    acc = torch.zeros(x.shape[0], y.shape[0], device=x.device,
                      dtype=torch.int64 if codes else torch.float32)
    yt = y.double().t() if codes else y.float().t()
    for _ in range(reps):
        xr = _perturb(x, acc[:, :1])
        acc += (xr.double() @ yt).long() if codes else xr.float() @ yt
    return acc.int() if codes else acc


def _body(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("ex2", "exp2f"):
        return torch.exp2(x)
    if name == "rowmax":
        return x.amax(dim=1, keepdim=True) + x * 1e-30
    if name == "rowsum":
        return x.sum(dim=1, keepdim=True) + x * 1e-30
    if name == "cast_bf16":
        return x.to(torch.bfloat16).float()
    if name == "quant_int8":
        return (x * 127.0 + 0.5).to(torch.int32).to(torch.int8).float()
    raise ValueError(f"unknown pass {name!r}")


def plain_elem_chain(body: str, x: torch.Tensor, reps: int) -> torch.Tensor:
    """acc [M, W] fp32 after ``reps`` steps of acc += body(x + acc[:, :1] *
    1e-30), the row reductions over W."""
    acc = torch.zeros_like(x, dtype=torch.float32)
    for _ in range(reps):
        acc += _body(body, x + acc[:, :1] * 1e-30)
    return acc


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def blocks_per_sm(row: Row) -> int:
    """The CTAs of ``row``'s kernel an SM holds (the CUDA occupancy API)."""
    import ctypes

    n = ctypes.c_int(0)
    lib = _build.lib("probe_mma")
    if row.kind == "elem":
        err = lib.probe_elem(BODIES.index(row.op), None, None, 0, 0, ctypes.addressof(n), None)
    else:
        err = lib.probe_mma(int(row.kind == "wgmma"), OPS.index(row.op), row.n, row.ks, None,
                            None, None, 0, 0, ctypes.addressof(n), None)
    _build.check(err, f"probe {row.name} (occupancy)")
    return n.value


def chain(row: Row, x: torch.Tensor, y: torch.Tensor | None = None, reps: int = 1):
    """``row``'s chain on ``x`` (and ``y`` for a product), ``reps`` reps: the
    plain chain on CPU tensors, the kernel on CUDA ones.  Products: x [M,
    K] (M a multiple of 64), y [N, K], returns acc [M, N]; passes: x [M,
    128] fp32, returns acc; memory: x int32 [n] (n a multiple of 4), returns
    the sum of its values over the passes (int64, "read") or the copy
    ("copy")."""
    if x.device.type == "cpu":
        if row.kind == "hbm":
            return x.sum(dtype=torch.int64) * reps if row.op == "read" else x.clone()
        if row.kind == "elem":
            return plain_elem_chain(row.op, x, reps)
        return plain_chain(x, y, reps)
    if x.device.type != "cuda":
        raise ValueError(f"probe {row.name}: tensor on {x.device}")
    lib = _build.lib("probe_mma")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if row.kind == "hbm":
            grid = torch.cuda.get_device_properties(x.device).multi_processor_count * 8
            out = (torch.empty(grid, dtype=torch.int64, device=x.device) if row.op == "read"
                   else torch.empty_like(x))
            err = lib.probe_hbm(int(row.op == "copy"), x.data_ptr(), out.data_ptr(),
                                x.numel() // 4, reps, grid, stream)
        else:
            m = x.shape[0]
            if m % ROWS_PER_CTA or not x.is_contiguous():
                raise ValueError(f"probe {row.name}: x must be contiguous with rows a multiple "
                                 f"of {ROWS_PER_CTA}, got {tuple(x.shape)}")
            grid = m // ROWS_PER_CTA
            if row.kind == "elem":
                out = torch.empty_like(x)
                err = lib.probe_elem(BODIES.index(row.op), x.data_ptr(), out.data_ptr(), reps,
                                     grid, None, stream)
            else:
                out = torch.empty(m, row.n, device=x.device,
                                  dtype=torch.int32 if row.op == "s8" else torch.float32)
                err = lib.probe_mma(int(row.kind == "wgmma"), OPS.index(row.op), row.n, row.ks,
                                    x.data_ptr(), y.data_ptr(), out.data_ptr(), reps, grid,
                                    None, stream)
    _build.check(err, f"probe {row.name}")
    chain.launches += 1
    return out.sum() if row.kind == "hbm" and row.op == "read" else out


chain.launches = 0


def inputs(row: Row, m: int, gen: torch.Generator, device="cuda"):
    """(x, y) of ``m`` rows (``m`` int32 values for memory): int8 codes in
    [-7, 7), as the JAX probe draws them, standard normal bf16 and e4m3,
    fp32 normal for the passes, uniform in [0, 1) for the quantize (a P
    tile)."""
    if row.kind == "hbm":
        return torch.randint(-1000, 1000, (m,), generator=gen, device=device,
                             dtype=torch.int32), None
    if row.kind == "elem":
        if row.op == "quant_int8":
            return torch.rand(m, row.n, generator=gen, device=device), None
        return torch.randn(m, row.n, generator=gen, device=device), None

    def mk(r):
        if row.op == "s8":
            return torch.randint(-7, 7, (r, row.k), generator=gen, device=device,
                                 dtype=torch.int8)
        return torch.randn(r, row.k, generator=gen, device=device).to(DTYPES[row.op])

    return mk(m), mk(row.n)


# --------------------------------------------------------------------------
# on the card: check, SASS, rates
# --------------------------------------------------------------------------


def smi() -> str:
    """The card's name, power limit and SM clock, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def peak_of(row: Row, sms: int, clk: float) -> float:
    """``row``'s unit's peak at ``sms`` SMs and the SM clock ``clk`` (Hz)."""
    if row.kind == "hbm":
        return PEAK["hbm"]
    if row.kind == "elem":
        width = SFU_PER_CLK_SM if row.op in ("ex2", "exp2f") else FP32_PER_CLK_SM
    else:
        width = TC_PER_CLK_SM[row.op]
    return width * sms * clk


def datasheet_peak(row: Row, sms: int, clk: float) -> float:
    """The data sheet's figure for ``row``'s unit (the tensor cores' and
    memory's); the units it gives none for, their clock-scaled peak."""
    if row.kind in ("sync", "wgmma", "hbm"):
        return PEAK["hbm" if row.kind == "hbm" else row.op]
    return peak_of(row, sms, clk)


def grid_rows(row: Row, sms: int) -> int:
    """The rows of a product or pass at full occupancy: every SM's CTAs."""
    return blocks_per_sm(row) * sms * ROWS_PER_CTA


def check(row: Row, gen: torch.Generator, sms: int, reps: int = 5) -> float:
    """``row``'s kernel against its plain chain on the same card tensors, at
    ``reps`` reps over the rate's grid (:func:`grid_rows`; memory: 1 Mi
    values and 3 passes): int32 and the copy bit-exact, fp32 within 1e-3
    relative (||got - want|| / ||want||: the e4m3 wgmma accumulates in
    fewer than fp32's bits, which puts its largest element 1.0-1.4e-3 of
    the largest entry away on an H100).  Returns the error (max-abs for
    int32, relative for fp32)."""
    if row.kind == "hbm":
        x, _ = inputs(row, 1 << 20, gen)
        got, want = chain(row, x, reps=3), chain(row, x.cpu(), reps=3)
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"probe {row.name}: the kernel disagrees with its plain version")
        return 0.0
    x, y = inputs(row, grid_rows(row, sms), gen)
    got = chain(row, x, y, reps)
    want = plain_elem_chain(row.op, x, reps) if row.kind == "elem" else plain_chain(x, y, reps)
    if got.dtype == torch.int32:
        if not torch.equal(got, want):
            bad = (got != want).sum().item()
            raise AssertionError(f"probe {row.name}: {bad} int32 results differ from the plain "
                                 f"chain")
        return 0.0
    err = ((got - want).double().norm() / want.double().norm().clamp_min(1e-30)).item()
    if not err <= 1e-3:
        raise AssertionError(f"probe {row.name}: relative error {err:.3e} > 1e-3")
    return err


def sass_counts() -> dict:
    """{(kind, op, n, ks): {family: count}} of the tensor-core instructions
    (IMMA, HMMA, QMMA, IGMMA, HGMMA, QGMMA, ...) in each product kernel's
    SASS (``cuobjdump -sass``); the rep loop is not unrolled, so a
    kernel's count is a rep's."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    _build.lib("probe_mma")
    out = subprocess.run([tool, "-sass", str(_build._target("probe_mma"))], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    return parse_sass(out)


def parse_sass(text: str) -> dict:
    counts, key = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"probe_(sync|wgmma)_kernelILi(\d+)ELi(\d+)ELi(\d+)E", m.group(1))
            key = None
            if k:
                kind, op, a, ks = k.group(1), OPS[int(k.group(2))], int(k.group(3)), int(k.group(4))
                key = (kind, op, a * 8 if kind == "sync" else a, ks)
                counts[key] = {}
            continue
        if key is not None:
            for fam in re.findall(r"\b([A-Z]*MMA)\.", line):
                counts[key][fam] = counts[key].get(fam, 0) + 1
    return counts


def expected_mma(row: Row) -> int:
    """Tensor-core instructions a rep: one wgmma a K step; one mma.sync a
    (8-column n-tile, K step), two for e4m3 (sm_90 has no fp8 mma.sync:
    ptxas splits m16n8k32 e4m3 into two f16 HMMA.16816 with the codes
    converted, as the SASS of an H100 build shows)."""
    if row.kind == "wgmma":
        return row.ks
    return row.n // 8 * row.ks * (2 if row.op == "e4m3" else 1)


def _ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rate(row: Row, gen: torch.Generator, sms: int, clk: float) -> dict:
    """``row``'s rate at full occupancy (every SM's CTAs; 4 GiB for memory):
    the slope between two rep counts, the larger taking about
    TARGET_MS."""
    if row.kind == "hbm":
        n = (1 << 30) if row.op == "read" else (1 << 29)  # 4 GiB read, or 2 + 2 GiB moved
        x, y = inputs(row, n, gen)
        per_rep_bytes = n * 4 * (1 if row.op == "read" else 2)
        lo, hi = 1, 4
        m = n
    else:
        m = grid_rows(row, sms)
        x, y = inputs(row, m, gen)
        per_rep_bytes = None
        est = _ms(lambda: chain(row, x, y, 64), reps=3) / 64
        hi = int(min(max(TARGET_MS / max(est, 1e-6), 256), 1 << 20))
        lo = hi // 4
    t_lo = _ms(lambda: chain(row, x, y, lo))
    t_hi = _ms(lambda: chain(row, x, y, hi))
    per_rep_s = max(t_hi - t_lo, 1e-9) / 1e3 / (hi - lo)
    work = per_rep_bytes if row.kind == "hbm" else ops_per_rep(row, m)
    r = work / per_rep_s
    peak = peak_of(row, sms, clk)
    out = {"row": row.name, "kind": row.kind, "op": row.op, "n": row.n, "k": row.k,
           "m": m, "reps": [lo, hi], "ms": [t_lo, t_hi], "per_rep_us": per_rep_s * 1e6,
           "rate": r, "unit": "B/s" if row.kind == "hbm" else
           ("elements/s" if row.kind == "elem" else "ops/s"), "peak": peak,
           "share_of_peak": check_rate(row.name, r, peak),
           "share_of_datasheet": r / datasheet_peak(row, sms, clk)}
    del x, y
    return out


def library_rows(sms: int, clk: float) -> list:
    """cuBLAS's rates at 8192^3 (``torch._int_mm``, ``torch.matmul`` bf16,
    ``torch._scaled_mm`` e4m3 -> bf16) and PyTorch's sum and copy over the
    memory rows' bytes: one call each, the median of 5, beside the peaks
    of :func:`peak_of` and the data sheet's."""
    n = 8192
    a8 = torch.randint(-7, 7, (n, n), dtype=torch.int8, device="cuda")
    b8 = torch.randint(-7, 7, (n, n), dtype=torch.int8, device="cuda").t()  # column-major
    abf, bbf = (torch.randn(n, n, device="cuda", dtype=torch.bfloat16) for _ in range(2))
    one = torch.ones((), device="cuda")
    ae, be = abf.to(torch.float8_e4m3fn), bbf.to(torch.float8_e4m3fn).t()
    big = torch.randint(-1000, 1000, (1 << 30,), dtype=torch.int32, device="cuda")
    src = big[: 1 << 29]
    dst = torch.empty_like(src)
    rows = []
    for name, fn, work, unit_of in (
            ("torch._int_mm int8 8192^3", lambda: torch._int_mm(a8, b8), 2 * n**3,
             Row("", "sync", "s8")),
            ("torch.matmul bf16 8192^3", lambda: abf @ bbf, 2 * n**3, Row("", "sync", "bf16")),
            ("torch._scaled_mm e4m3 8192^3", lambda: torch._scaled_mm(
                ae, be, scale_a=one, scale_b=one, out_dtype=torch.bfloat16), 2 * n**3,
             Row("", "sync", "e4m3")),
            ("Tensor.sum int32 4 GiB", lambda: big.sum(dtype=torch.int64), big.numel() * 4,
             Row("", "hbm", "read")),
            ("Tensor.copy_ 2 GiB", lambda: dst.copy_(src), src.numel() * 8,
             Row("", "hbm", "copy"))):
        ms = _ms(fn)
        r = work / (ms / 1e3)
        peak = peak_of(unit_of, sms, clk)
        rows.append({"row": name, "kind": "library", "ms": ms, "rate": r,
                     "unit": "B/s" if unit_of.kind == "hbm" else "ops/s", "peak": peak,
                     "share_of_peak": check_rate(name, r, peak),
                     "share_of_datasheet": r / datasheet_peak(unit_of, sms, clk)})
    del a8, b8, abf, bbf, ae, be, big, src, dst
    torch.cuda.empty_cache()
    return rows


def run(log=print, before_rates=None) -> dict:
    """Every row on the card: the check against the plain chain and the
    SASS count, then (after calling ``before_rates``, if given: the
    launches from here on are the measurement's) the rates and the library
    rows.  Raises on the first row that fails.  Returns the table."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures a CUDA card, and there is none")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    before = smi()
    log(f"probe card before: {before}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk = max_sm_clock_hz()
    sass = sass_counts()
    checked = {}
    for row in ROWS:
        found = None
        if row.kind in ("sync", "wgmma"):
            found = sass.get((row.kind, row.op, row.n, row.ks), {})
            if sum(found.values()) != expected_mma(row):
                raise AssertionError(f"probe {row.name}: SASS holds {found} tensor-core "
                                     f"instructions, want {expected_mma(row)} a rep")
        checked[row] = dict(check_err=check(row, gen, sms), sass=found)
    if before_rates is not None:
        before_rates()
    table = []
    for row in ROWS:
        r = rate(row, gen, sms, clk)
        r.update(checked[row])
        err, found = r["check_err"], r["sass"]
        table.append(r)
        log(f"probe {row.name}: {r['rate']:.4g} {r['unit']} ({r['share_of_peak']:.1%} of "
            f"{r['peak']:.4g}, {r['share_of_datasheet']:.1%} of the data sheet's); "
            f"{r['per_rep_us']:.4f} us a rep over {r['m']} rows; check {err:.2e}; SASS {found}")
        torch.cuda.empty_cache()
    lib = library_rows(sms, clk)
    for r in lib:
        log(f"probe library {r['row']}: {r['ms']:.4f} ms, {r['rate']:.4g} {r['unit']} "
            f"({r['share_of_peak']:.1%} of {r['peak']:.4g}, {r['share_of_datasheet']:.1%} of "
            f"the data sheet's)")
    after = smi()
    log(f"probe card after: {after}")
    return {"card_before": before, "card_after": after, "sms": sms, "max_sm_clock_hz": clk,
            "rows": table, "library": lib}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    out = run()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
