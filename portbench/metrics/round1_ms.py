"""Milliseconds a traced run spends in Round 1 (local solves and costs): the
program's ``phase_times["round1"]``, which synchronises the device at the
phase's edges, averaged over the traced runs."""


def read(ctx):
    return ctx.phase_ms("round1")
