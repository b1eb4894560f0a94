"""Seconds to one distributed clustering: the window's start to the end of
its last completed run, over the runs completed (host clock). Each cell
reports it under the end-to-end metric its bound belongs to
(``clustering_s``, ``clustering_s.kmedian``)."""


def read(ctx):
    return ctx.window_s / ctx.runs if ctx.mode == "window" else None
