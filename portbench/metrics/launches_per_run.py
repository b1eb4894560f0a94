"""Launches a run makes (kernels, copies and sets), counted from the
runtime calls in the profiler's trace; nothing where any launch lost its
device operation."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.whole:
        return None
    return ctx.trace.launches / ctx.runs
