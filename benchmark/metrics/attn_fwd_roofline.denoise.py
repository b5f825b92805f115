"""Kernel 1's share of its roofline in a denoise step: the forward bound
of every attention call the window made (``roofline.attention_forward``
at the cell's shapes and P.V type) over the device time of the
``sage_attn_fwd*`` kernels.  Nothing to read where no such kernel ran."""

from benchmark import roofline


def read(ctx):
    secs = ctx.trace.group_s["sage_attn_fwd"]
    if not secs:
        return None
    bound_ms = sum(roofline.attention_forward(*a, pv=ctx.pv).ms for a in ctx.attentions)
    return 100.0 * bound_ms * ctx.steps / (secs * 1e3)
