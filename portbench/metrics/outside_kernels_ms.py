"""Device milliseconds a run spends under no ``work:<function>`` scope of
the program: the draws' integer ops, sampling, allocation and glue;
nothing where any launch lost its device operation."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.whole:
        return None
    us = sum(o.end_us - o.start_us for o in ctx.trace.ops if o.scope is None)
    return us / 1e3 / ctx.runs
