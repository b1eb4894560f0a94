"""Device operations a run launches under the program's draw scopes,
``work:draw.<name>`` (the threefry draws of ``core/prng.py``); on a whole
trace each operation is one launch. Nothing where any launch lost its
device operation, or where the program opens no draw scope."""


def _draw(name):
    return name.split("/")[-1].startswith("draw.")


def read(ctx):
    t = ctx.trace
    if (t is None or not t.whole
            or not any(_draw(name) for _, _, name in t.ranges)):
        return None
    return sum(1 for o in t.ops
               if o.function is not None and _draw(o.function)) / ctx.runs
