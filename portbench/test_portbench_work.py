"""The roofline's yardstick counts the data's rows, not the padding."""
import pytest
import torch

from portbench import data, tracing
from portbench import work as work_mod

PEAKS = work_mod.PEAKS["NVIDIA H100 80GB HBM3"]


def _ledger(cfg, points, mask):
    from repro_torch.core import distributed, prng, topology
    from repro_torch.roofline import trace
    n, edges = data.graph_edges(cfg["topology"])
    with trace.record() as led:
        distributed.graph_distributed_kmeans(
            prng.PRNGKey(7), points, mask, cfg["k"], cfg["t"],
            topology.Graph(n, tuple(edges)), lloyd_iters=cfg["lloyd_iters"],
            backend="cuda", device="cpu")
    return led


def test_work_does_not_change_with_padding(small):
    sites = data.make_sites({**_base(), **small}, 11, torch.device("cpu"))
    cfg = {**_base(), **small}
    pad = torch.nn.functional.pad
    wide = (pad(sites.points, (0, 0, 0, 64)), pad(sites.mask, (0, 64)))
    works = []
    for points, mask in ((sites.points, sites.mask), wide):
        led = _ledger(cfg, points, mask)
        shapes = sorted({c.shape for c in led})
        works.append((shapes, [work_mod.call_work(
            c.label, c.phase, sites.sizes, cfg["k"], cfg["t"], cfg["d"])
            for c in led]))
    assert works[0][0] != works[1][0]          # the program's padded shapes
    assert works[0][1] == works[1][1]          # the yardstick's work
    assert works[0][1]


def test_roofline_counts_only_complete_scopes():
    sizes, k, t, d = [100, 50], 2, 12, 3
    ops = [tracing.Op("a", 0.0, 10.0, "lloyd_stats", "round1", 1),
           tracing.Op("b", 10.0, 30.0, "lloyd_stats", "solve", 2),
           tracing.Op("c", 30.0, 90.0, "lloyd_stats", "round1", 3),
           tracing.Op("d", 90.0, 95.0, None, None, None)]
    tr = tracing.Trace(ops, (0.0, 100.0), [],
                       {1: ("lloyd_stats", "round1"),
                        2: ("lloyd_stats", "solve")})
    bound = (work_mod.bound_s(work_mod.call_work(
        "lloyd_stats", "round1", sizes, k, t, d), PEAKS)
        + work_mod.bound_s(work_mod.call_work(
            "lloyd_stats", "solve", sizes, k, t, d), PEAKS))
    got = tr.roofline("lloyd_stats", sizes, k, t, d, PEAKS)
    assert abs(got - bound / 30e-6) <= 1e-12 * got
    assert tr.roofline("weiszfeld_stats", sizes, k, t, d, PEAKS) is None
    assert abs(tr.busy_s() - 95e-6) < 1e-12
    assert tr.gaps() == [("outside phases", 5e-6)]


@pytest.mark.parametrize("missing", [0, 1])
def test_whole_trace_readers_read_nothing_from_a_trace_that_lost_ops(
        missing):
    import types
    from portbench import run as harness
    ops = [tracing.Op("a", 0.0, 40.0, "lloyd_stats", "round1", 1),
           tracing.Op("b", 50.0, 80.0, None, None, None)]
    tr = tracing.Trace(ops, (0.0, 100.0), [], {1: ("lloyd_stats", "round1")},
                       launches=2 + missing, missing=missing)
    ctx = types.SimpleNamespace(trace=tr, runs=2)
    got = {name: harness.reader(name)(ctx) for name in
           ("launches_per_run", "outside_kernels_ms", "idle_share")}
    if missing:
        assert got == dict.fromkeys(got)
    else:
        assert got == pytest.approx({"launches_per_run": 1.0,
                                     "outside_kernels_ms": 0.015,
                                     "idle_share": 30.0})


def _base():
    import json
    from pathlib import Path
    return json.loads((Path(__file__).parent / "configs"
                       / "bigcross-grid100.json").read_text())
