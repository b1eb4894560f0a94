"""Device milliseconds a run spends under the program's draw scopes,
``work:draw.<name>`` (the threefry draws of ``core/prng.py``, one scope per
outermost draw); nothing where any launch lost its device operation, or
where the program opens no draw scope."""


def _draw(name):
    return name.split("/")[-1].startswith("draw.")


def read(ctx):
    t = ctx.trace
    if (t is None or not t.whole
            or not any(_draw(name) for _, _, name in t.ranges)):
        return None
    us = sum(o.end_us - o.start_us for o in t.ops
             if o.function is not None and _draw(o.function))
    return us / 1e3 / ctx.runs
