"""Milliseconds a run the device sits idle inside the traced window while
the innermost host range open is one of the program's draw scopes
(``work:draw.<name>``, named ``<phase>/draw.<name>`` inside a phase): the
idle gaps the host's draws leave. Nothing where any launch lost its device
operation, or where the program opens no draw scope."""


def _draw(name):
    return name.split("/")[-1].startswith("draw.")


def read(ctx):
    t = ctx.trace
    if (t is None or not t.whole
            or not any(_draw(name) for _, _, name in t.ranges)):
        return None
    return 1e3 * sum(s for name, s in t.gaps() if _draw(name)) / ctx.runs
