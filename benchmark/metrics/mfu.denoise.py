"""The whole denoise step's share of the chip's peaks, in %: the least time
the step's matrix products take at the peaks of their declared precisions
(``roofline.step_matrix_ms``: every linear layer at bf16, each attention's
Q.K^T at int8 and P.V at the cell's type) over the traced window's time a
step."""

from benchmark import roofline


def read(ctx):
    ideal_ms = roofline.step_matrix_ms(ctx.linears, ctx.attentions, ctx.pv, training=False)
    return 100.0 * ideal_ms * ctx.steps / (ctx.trace.window_s * 1e3)
