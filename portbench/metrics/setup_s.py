"""Seconds from process start to the first timed run: imports, loading
(or building) the kernels, making and partitioning the data, and the
warm-up run (host clock)."""


def read(ctx):
    return ctx.setup_s
