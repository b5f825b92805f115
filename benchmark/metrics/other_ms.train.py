"""Device ms a step in every kernel, copy and set outside attention, the
quantizers and the GEMMs (the model's elementwise passes, their backward,
and AdamW): the group "other" of ``benchmark.profile`` over the window,
divided by the steps counted.  Nothing to read where the group is empty."""


def read(ctx):
    secs = ctx.trace.group_s["other"]
    return secs * 1e3 / ctx.steps if secs else None
