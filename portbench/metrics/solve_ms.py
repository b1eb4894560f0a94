"""Milliseconds a traced run spends in Algorithm 2's solve on the coreset: the
program's ``phase_times["solve"]``, which synchronises the device at the
phase's edges, averaged over the traced runs."""


def read(ctx):
    return ctx.phase_ms("solve")
