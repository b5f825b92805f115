"""Kernels 7-8's share of their roofline in a training step: the backward
bound of every attention call the window made
(``roofline.attention_backward``) over the device time of the
``sage_attn_bwd*`` kernels.  Nothing to read where no such kernel ran."""

from benchmark import roofline


def read(ctx):
    secs = ctx.trace.group_s["sage_attn_bwd"]
    if not secs:
        return None
    bound_ms = sum(roofline.attention_backward(*a).ms for a in ctx.attentions)
    return 100.0 * bound_ms * ctx.steps / (secs * 1e3)
