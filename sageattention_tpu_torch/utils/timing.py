"""Device timing of a C entry point's calls with CUDA events, shared by
``chip_smoke.py`` and the quantizer A/B and sweep tools (``tools/``).

``queued_ms`` times calls back to back, each sample queued behind a 1 ms
sleep on the card so that the host's time to issue them is not counted;
what the calls read stays in L2 from one call to the next where it fits.
``cold_ms`` times one call at a time after writing a buffer larger than
the L2, so that the call reads its inputs from device memory.
"""

from __future__ import annotations

import statistics

SLEEP_CYCLES = 2_000_000  # ~1 ms at 1.98 GHz
L2_FLUSH_BYTES = 64 * 2**20  # over the H100's 50 MB L2


def queued_ms(fn, inner: int = 10, samples: int = 20) -> float:
    """The median over ``samples`` of the mean of ``inner`` back-to-back
    calls of ``fn``, after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(inner):
            fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z) / inner)
    return statistics.median(times)


def cold_ms(fn, samples: int = 20) -> float:
    """The median over ``samples`` of one call of ``fn``, each after
    ``L2_FLUSH_BYTES`` are written and queued behind a 1 ms sleep, after
    one warm-up call."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(samples):
        flush.zero_()
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)
