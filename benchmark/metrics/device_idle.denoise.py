"""The device's idle share of the window, in %: 1 - the union of the
device spans over the window's wall time (``benchmark.profile``)."""


def read(ctx):
    return 100.0 * ctx.trace.idle_share
