"""Device ms a step in the GEMM kernels (cuBLAS: gemm, cutlass, nvjet, xmma):
the group "gemm" of ``benchmark.profile`` over the window, divided by the
steps counted.  Nothing to read where the group is empty."""


def read(ctx):
    secs = ctx.trace.group_s["gemm"]
    return secs * 1e3 / ctx.steps if secs else None
