"""Device ms a step in the quantizers (kernels 2-6) and the V-code widening:
the group "quant" of ``benchmark.profile`` over the window, divided by the
steps counted.  Nothing to read where the group is empty."""


def read(ctx):
    secs = ctx.trace.group_s["quant"]
    return secs * 1e3 / ctx.steps if secs else None
