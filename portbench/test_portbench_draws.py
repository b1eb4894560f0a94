"""The draw readers (``draws_ms``, ``draw_launches_per_run``,
``draw_idle_ms``) on hand-built traces: sums and counts under the
program's ``work:draw.<name>`` scopes, idle gaps named by a draw, and
nothing where the trace is not whole or the program opens no draw scope."""
import pytest
import torch

from portbench import run as harness
from portbench import tracing

READERS = ("draws_ms", "draw_launches_per_run", "draw_idle_ms")
Op = tracing.Op


def _trace(missing=0, draws=True):
    """Two runs' worth of one round: two split ops and a categorical op
    under draw scopes, a kernel under ``work:lloyd_stats``, glue under no
    scope, the ledger's copy after the phase (microseconds)."""
    ops = [Op("xor", 12.0, 15.0, "draw.split", "round1", 1),
           Op("add", 20.0, 25.0, "draw.split", "round1", 1),
           Op("lloyd_stats_kernel", 45.0, 55.0, "lloyd_stats", "round1", 2),
           Op("log", 66.0, 70.0, "draw.categorical", "round1", 3),
           Op("cumsum", 80.0, 90.0, None, "round1", None),
           Op("Memcpy DtoH", 104.0, 106.0, "ledger", None, 4)]
    ranges = [(0.0, 100.0, "round1"), (10.0, 30.0, "round1/draw.split"),
              (40.0, 60.0, "round1/lloyd_stats"),
              (65.0, 75.0, "round1/draw.categorical"),
              (100.0, 110.0, "ledger")]
    if not draws:
        # the program before the draw scopes: its draw ops under no scope
        ops = [o if o.function is None or not o.function.startswith("draw.")
               else Op(o.name, o.start_us, o.end_us, None, o.phase, None)
               for o in ops]
        ranges = [r for r in ranges if "draw." not in r[2]]
    return tracing.Trace(ops, (0.0, 120.0), ranges, {},
                         launches=len(ops), missing=missing)


def _ctx(trace):
    return harness.Context(mode="trace", runs=2, trace=trace)


def test_the_gaps_are_named_by_the_draw_open_at_their_start():
    gaps = sorted(_trace().gaps())
    assert [name for name, _ in gaps] == [
        "ledger", "round1", "round1", "round1/draw.categorical",
        "round1/draw.split", "round1/draw.split", "round1/lloyd_stats"]
    assert [s for _, s in gaps] == pytest.approx(
        [14e-6, 12e-6, 14e-6, 10e-6, 5e-6, 20e-6, 11e-6])


@pytest.mark.parametrize("name,value", [
    ("draws_ms", (3.0 + 5.0 + 4.0) / 1e3 / 2),
    ("draws_ms.kmedian", (3.0 + 5.0 + 4.0) / 1e3 / 2),
    ("draw_launches_per_run", 3 / 2),
    ("draw_launches_per_run.kmedian", 3 / 2),
    ("draw_idle_ms", (5.0 + 20.0 + 10.0) / 1e3 / 2),
    ("draw_idle_ms.kmedian", (5.0 + 20.0 + 10.0) / 1e3 / 2)])
def test_each_reader_sums_under_the_draw_scopes(name, value):
    assert harness.reader(name)(_ctx(_trace())) == pytest.approx(value)


def test_draws_and_the_glue_share_what_was_outside_the_kernels():
    """With the draw scopes ``outside_kernels_ms`` reads the glue alone;
    with the draws it reads what it read before them."""
    outside = harness.reader("outside_kernels_ms")
    draws = harness.reader("draws_ms")(_ctx(_trace()))
    assert outside(_ctx(_trace())) == pytest.approx(10.0 / 1e3 / 2)
    assert draws + outside(_ctx(_trace())) == pytest.approx(
        outside(_ctx(_trace(draws=False))))


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["no trace", "not whole", "no draw scope"])
def test_a_reader_reads_nothing_it_cannot_see(name, case):
    trace = {"no trace": None, "not whole": _trace(missing=1),
             "no draw scope": _trace(draws=False)}[case]
    assert harness.reader(name)(_ctx(trace)) is None


class _Event:
    """What ``tracing.reduce`` reads of a profiler event."""

    def __init__(self, id, name, start, end, parent=None, device=False):
        self.id, self.name, self.cpu_parent = id, name, parent
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.is_user_annotation = False


def test_the_readers_read_what_reduce_makes_of_a_draw_scope():
    """A run with a draw scope inside Round 1, its launch and its device
    operation: the operation is tied to ``draw.split``, and the gap after
    it, named by the draw open at its start, is ``round1/draw.split`` to
    the window's end."""
    E = _Event
    run = E(1, tracing.RUN_SCOPE, 0.0, 100.0)
    phase = E(2, "round1", 0.0, 90.0, run)
    draw = E(3, "work:draw.split", 10.0, 50.0, phase)
    launch = E(40, "cudaLaunchKernel", 12.0, 13.0, draw)
    events = [run, phase, draw, launch,
              E(40, "xor_kernel", 14.0, 20.0, device=True)]
    trace = tracing.reduce(events)
    assert trace.whole and [o.function for o in trace.ops] == ["draw.split"]
    assert trace.gaps() == [("round1/draw.split", pytest.approx(80e-6)),
                            ("round1", pytest.approx(14e-6))]
    ctx = harness.Context(mode="trace", runs=1, trace=trace)
    assert harness.reader("draws_ms")(ctx) == pytest.approx(6e-3)
    assert harness.reader("draw_launches_per_run")(ctx) == 1
    assert harness.reader("draw_idle_ms")(ctx) == pytest.approx(80e-3)
