"""The share of the traced window (%) in which no operation ran on the
device: 100 x (1 - busy / window); nothing where any launch lost its
device operation."""


def read(ctx):
    if (ctx.trace is None or not ctx.trace.whole
            or ctx.trace.window_s <= 0):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
