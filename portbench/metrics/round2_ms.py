"""Milliseconds a traced run spends in Round 2 (allocation and sampling): the
program's ``phase_times["round2"]``, which synchronises the device at the
phase's edges, averaged over the traced runs."""


def read(ctx):
    return ctx.phase_ms("round2")
