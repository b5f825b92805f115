"""The whole training step's share of the chip's peaks, in %: the least time
the step's matrix products take at the peaks of their declared precisions
(``roofline.step_matrix_ms`` with the backward: every linear layer three
times at bf16, each attention's forward and its five backward products)
over the traced window's time a step."""

from benchmark import roofline


def read(ctx):
    ideal_ms = roofline.step_matrix_ms(ctx.linears, ctx.attentions, ctx.pv, training=True)
    return 100.0 * ideal_ms * ctx.steps / (ctx.trace.window_s * 1e3)
