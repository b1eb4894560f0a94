"""The port's roofline layer (``repro_torch.roofline``, with
``repro_torch.models.config`` and ``repro_torch.configs``) against the JAX
package's ``repro.roofline``, ``repro.models.config`` and ``repro.configs``:
the ten architectures field by field, the LM analytics exactly, the
collective link factors, and the report's three terms on the reference's
own parse of ``test_dryrun_small``'s two synthetic modules. Then what the
port measures where the reference parses HLO: the work ledger of the
quickstart instance, device spans and their busy time, and the phases."""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.roofline import hlo
from repro.roofline import report as jreport
from repro_torch import configs, roofline
from repro_torch.core import backend, grid, prng
from repro_torch.core.coreset import _phase
from repro_torch.core.distributed import (distributed_kmeans,
                                          distributed_kmeans_tree)
from repro_torch.core.objective import WEISZFELD_ITERS
from repro_torch.core.partition import pad_partition, partition_indices
from repro_torch.core.topology import bfs_spanning_tree
from repro_torch.roofline import report, trace, work

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)


# -- the configurations and the LM analytics --------------------------------------

@pytest.mark.parametrize("which", ["full", "reduced"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_config_field_equals_the_references(arch, which):
    get = {"full": (configs.get, jconfigs.get),
           "reduced": (configs.get_reduced, jconfigs.get_reduced)}[which]
    ours, theirs = get[0](arch), get[1](arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.period, ours.n_full_periods, ours.remainder_kinds,
            ours.runs(), ours.remainder_runs(), ours.vocab_padded) == (
                theirs.period, theirs.n_full_periods, theirs.remainder_kinds,
                theirs.runs(), theirs.remainder_runs(), theirs.vocab_padded)
    if "ssd" in ours.pattern:
        assert (ours.ssm_dinner, ours.ssm_nheads) == (theirs.ssm_dinner,
                                                      theirs.ssm_nheads)


def test_the_architecture_list_is_the_references():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert list(configs.all_configs()) == list(jconfigs.all_configs())


# (seq_len, global_batch, devices, microbatches)
SETTINGS = [(64, 8, 8, 1), (4096, 256, 512, 4), (32768, 1, 1, 1),
            (8192, 64, 16, 8)]


@pytest.mark.parametrize("which", ["full", "reduced"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_lm_analytics_equal_the_references_exactly(arch, which):
    """param_count, active_param_count, model_flops and analytic_hbm_bytes
    for train, prefill and decode at several settings."""
    get = {"full": (configs.get, jconfigs.get),
           "reduced": (configs.get_reduced, jconfigs.get_reduced)}[which]
    ours, theirs = get[0](arch), get[1](arch)
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()
    for kind in ("train", "prefill", "decode"):
        for seq, batch, devices, micro in SETTINGS:
            assert report.model_flops(ours, kind, seq, batch) == \
                jreport.model_flops(theirs, kind, seq, batch)
            assert report.analytic_hbm_bytes(
                ours, kind, seq, batch, devices, micro) == \
                jreport.analytic_hbm_bytes(theirs, kind, seq, batch,
                                           devices, micro)


# -- collectives --------------------------------------------------------------------

@pytest.mark.parametrize("kind", hlo.COLLECTIVES)
def test_collective_link_equals_the_references(kind):
    """The reference's factors on an HLO op of each kind (its replica group
    of n devices, an f32[64,64] result) against collective_link."""
    for n in (1, 2, 4, 8):
        ids = ",".join(str(i) for i in range(n))
        rest = f"%x0), replica_groups={{{{{ids}}}}}, dimensions={{0}}"
        op = hlo.Op("c", kind, "f32[64,64]{1,0}", rest,
                    f"  %c = f32[64,64]{{1,0}} {kind}({rest}")
        got, link, rb, crosses = hlo._collective_link(op, None)
        assert (got, rb, crosses) == (kind, 64 * 64 * 4, False)
        assert trace.collective_link(kind, n, rb) == link, (kind, n)


def test_collective_link_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown collective"):
        trace.collective_link("broadcast", 4, 16)


def test_collective_phase_analysis_by_phase_and_pod():
    """Records in round1_gather count under round1, outside every phase
    under other; a group spanning two pod blocks crosses the network."""
    R = trace.CollectiveRecord
    records = [R("all-gather", (0, 1, 2, 3), 32, "round1_gather"),
               R("collective-permute", (0, 1), 100, "round2_gather"),
               R("collective-permute", (1, 2), 100, "round2"),
               R("all-gather", (0, 1, 2, 3), 16, "output_gather"),
               R("all-gather", (0, 1, 2, 3), 16, None)]
    out = trace.collective_phase_analysis(records, pod_block=2)
    assert out["round1"].collective_counts == {"all-gather": 1}
    assert out["round1"].dcn_collective_bytes == 24.0
    assert out["round2"].collective_counts == {"collective-permute": 2}
    assert out["round2"].ici_collective_bytes == 100.0
    assert out["round2"].dcn_collective_bytes == 100.0
    assert out["other"].collective_counts == {"all-gather": 2}
    assert out["other"].collective_bytes_by_kind == {"all-gather": 24.0}


# -- the report -----------------------------------------------------------------------

LOOP_MODULE = """
HloModule test

%body (p: (s32[], f32[8,8])) -> (s32[], f32[8,8]) {
  %p = (s32[], f32[8,8]{1,0}) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = f32[8,8]{1,0} get-tuple-element(%p), index=1
  %d = f32[8,8]{1,0} dot(%x, %x), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %one = s32[] constant(1)
  %i2 = s32[] add(%i, %one)
  ROOT %t = (s32[], f32[8,8]{1,0}) tuple(%i2, %d)
}

%cond (p2: (s32[], f32[8,8])) -> pred[] {
  %p2 = (s32[], f32[8,8]{1,0}) parameter(0)
  %i3 = s32[] get-tuple-element(%p2), index=0
  %n = s32[] constant(5)
  ROOT %lt = pred[] compare(%i3, %n), direction=LT
}

ENTRY %main (x0: f32[8,8]) -> f32[8,8] {
  %x0 = f32[8,8]{1,0} parameter(0)
  %z = s32[] constant(0)
  %t0 = (s32[], f32[8,8]{1,0}) tuple(%z, %x0)
  %w = (s32[], f32[8,8]{1,0}) while(%t0), condition=%cond, body=%body
  ROOT %out = f32[8,8]{1,0} get-tuple-element(%w), index=1
}
"""

COLLECTIVE_MODULE = """
HloModule test

ENTRY %main (x0: f32[64,64]) -> f32[64,64] {
  %x0 = f32[64,64]{1,0} parameter(0)
  %ar = f32[64,64]{1,0} all-reduce(%x0), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[64,64]{1,0} all-gather(%ar), replica_groups={{0,1,2,3}}, dimensions={0}
  ROOT %cp = f32[64,64]{1,0} collective-permute(%ag), source_target_pairs={{0,1}}
}
"""

# the reference's model, as a Hardware: its peak, memory rate, link rate
REFERENCE_HARDWARE = report.Hardware(
    "the reference's model", 0.0, jreport.PEAK_FLOPS, jreport.PEAK_FLOPS,
    jreport.HBM_BW, jreport.ICI_BW, jreport.HBM_PER_CHIP)


@pytest.mark.parametrize("arch,kind", [
    ("llama3_8b", "train"), ("dbrx_132b", "train"), ("mamba2_370m", "train"),
    ("gemma3_27b", "prefill"), ("recurrentgemma_2b", "decode"),
    ("qwen2_vl_2b", "decode")])
@pytest.mark.parametrize("module", ["loop", "collectives"])
def test_report_equals_the_references_field_for_field(module, arch, kind):
    """build_report on the reference's own analysis of each synthetic
    module of test_dryrun_small, finalized on the reference's figures,
    equals the reference's report."""
    text = {"loop": LOOP_MODULE, "collectives": COLLECTIVE_MODULE}[module]
    ana = hlo.analyze(text)
    ours_ana = trace.Analysis(**dataclasses.asdict(ana))
    cost = {"flops": 123.0, "bytes accessed": 456.0}
    theirs = jreport.build_report(
        arch, "ci", "small", jconfigs.get_reduced(arch), kind, 64, 8, 8,
        text, cost, 1e6, None, microbatches=2)
    ours = report.build_report(
        arch, "ci", "small", configs.get_reduced(arch), kind, 64, 8, 8,
        ours_ana, cost, 1e6, REFERENCE_HARDWARE, microbatches=2,
        network_bytes_per_s=jreport.DCN_BW)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.row() == theirs.row()
    # finalize alone, on a report the reference built
    again = report.RooflineReport(**{
        f.name: getattr(theirs, f.name)
        for f in dataclasses.fields(report.RooflineReport) if f.init})
    assert again.finalize(REFERENCE_HARDWARE,
                          jreport.DCN_BW).to_dict() == theirs.to_dict()


def test_bytes_across_nodes_need_the_networks_rate():
    """No rate is assumed for the network between nodes."""
    rep = report.RooflineReport("a", "s", "m", 2, 1.0, 0.0, 8.0, 0.0, 64.0,
                                {}, {}, 0.0, 0.0, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="no rate was given"):
        rep.finalize(report.H100_SXM)
    rep.finalize(report.H100_SXM, network_bytes_per_s=64.0)
    assert rep.collective_s == 1.0 and rep.bottleneck == "collective"


def test_the_h100_figures_and_the_precision():
    hw = report.H100_SXM
    assert (hw.fp32_flops, hw.bf16_flops, hw.hbm_bytes_per_s,
            hw.power_limit_w) == (67e12, 989e12, 3.35e12, 700.0)
    assert hw.peak("fp32") == 67e12 and hw.peak("bf16") == 989e12
    with pytest.raises(ValueError, match="unknown precision"):
        hw.peak("fp8")


def test_detect_refuses_an_unknown_card(monkeypatch):
    monkeypatch.setattr(report, "card",
                        lambda device=0: ("NVIDIA GeForce RTX 4090", 450.0))
    with pytest.raises(ValueError, match="no figures for the card"):
        report.detect()
    monkeypatch.setattr(report, "card",
                        lambda device=0: ("NVIDIA H100 80GB HBM3", 500.0))
    hw = report.detect()
    assert hw.power_limit_w == 500.0 and hw.hbm_bytes_per_s == 3.35e12


def test_detect_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        report.detect()


# -- the work models ------------------------------------------------------------------

def test_work_models_count_the_data():
    """By hand at small shapes: the distance pass at (S, n, k, d) =
    (2, 10, 3, 4), its batched form against 5 live centres, and each
    statistics function adding its per-point terms."""
    assert work.min_dist_argmin(2, 10, 3, 4) == (
        2 * 10 * 3 * 11 + 2 * 2 * 13 * 4, 4 * 2 * (40 + 12) + 8 * 2 * 10)
    assert work.min_dist_argmin_batched(2, 10, 5, 4) == (
        10 * 5 * 11 + 2 * (20 + 5) * 4, 4 * (80 + 20) + 8 * 20)
    base = work.min_dist_argmin(2, 10, 3, 4)[0]
    assert work.lloyd_stats(2, 10, 3, 4)[0] == base + 2 * 10 * 11
    assert work.weiszfeld_stats(2, 10, 3, 4)[0] == base + 2 * 10 * 28
    assert work.lloyd_stats(2, 10, 3, 4)[1] == \
        work.weiszfeld_stats(2, 10, 3, 4)[1] == 4 * 2 * (40 + 10 + 12) \
        + 4 * 2 * 16
    assert work.lloyd_reduce(2, 10, 3, 4) == (2 * 2 * 10 * 6,
                                              4 * 2 * 10 * 7 + 4 * 2 * 16)
    assert work.weiszfeld_reduce(2, 10, 3, 4) == (
        2 * 10 * 28, 4 * 2 * (10 * 6 + 12) + 4 * 2 * 16)
    hw = report.H100_SXM
    assert work.bound(67e9, 1.0, hw) == (1.0, "operations")
    assert work.bound(1.0, 3.35e9, hw) == (1.0, "bytes")


# -- the work ledger ---------------------------------------------------------------------

K = 5


@pytest.fixture(scope="module")
def quickstart():
    """The quickstart instance: 20,000 points in R^10 from five Gaussians,
    9 weighted sites on a 3x3 grid."""
    rng = np.random.default_rng(0)
    centers = 3.0 * rng.standard_normal((K, 10))
    data = np.concatenate(
        [c + 0.2 * rng.standard_normal((4000, 10)) for c in centers]
    ).astype(np.float32)
    sp, sm = pad_partition(data, partition_indices(data, 9, "weighted",
                                                   seed=1))
    return sp, sm


def _ledger(sp, sm, route, objective, be):
    g = grid(3, 3)
    with roofline.record() as led:
        if route == "flood":
            distributed_kmeans(prng.PRNGKey(0), sp, sm, K, t=400, graph=g,
                               objective=objective, backend=be,
                               device="cpu")
        else:
            distributed_kmeans_tree(prng.PRNGKey(0), sp, sm, K, t=400,
                                    tree=bfs_spanning_tree(g, root=0),
                                    objective=objective, backend=be,
                                    device="cpu")
    return led


@pytest.mark.parametrize("route", ["flood", "tree"])
@pytest.mark.parametrize("objective", ["kmeans", "kmedian"])
def test_the_work_ledger_is_the_paths_whatever_the_backend(
        quickstart, objective, route):
    """The quickstart instance under "torch" and "torch_chunked": the same
    calls (function, shape, phase) in the same order. Round 1 seeds the 9
    sites (k one-centre passes over all of them at once), refines them (8
    steps; k-median's each of WEISZFELD_ITERS passes) and scores them (one
    distance pass); the solve does the same on the gathered coreset. No
    call runs outside a phase."""
    sp, sm = quickstart
    leds = {be: _ledger(sp, sm, route, objective, be)
            for be in ("torch", "torch_chunked")}
    strip = {be: [(c.function, c.sizes(), c.phase) for c in led]
             for be, led in leds.items()}
    assert strip["torch"] == strip["torch_chunked"]
    assert {c.backend for c in leds["torch_chunked"]} == {"torch_chunked"}
    stats = "lloyd_stats" if objective == "kmeans" else "weiszfeld_stats"
    steps = 8 * (1 if objective == "kmeans" else WEISZFELD_ITERS)
    assert collections.Counter(
        (c.phase, c.label) for c in leds["torch"]) == {
        ("round1", "min_dist_argmin[k=1]"): K, ("round1", stats): steps,
        ("round1", "min_dist_argmin"): 1,
        ("solve", "min_dist_argmin[k=1]"): K, ("solve", stats): steps}
    S, M, d = sp.shape
    first = leds["torch"][0]
    assert first.sizes() == (S, M, 1, d) and first.phase == "round1"
    assert leds["torch"].wall_s > 0


def test_no_call_is_recorded_outside_record(quickstart):
    """The recording is decided per call: a backend resolved before
    ``record()`` opens records inside it, into the innermost ledger, and
    nothing outside; resolution hands out the registered instance itself."""
    sp, sm = quickstart
    b = backend.get_backend("torch")
    assert type(b) is backend.TorchBackend
    with roofline.record() as led:
        assert backend.get_backend("torch") is b
        with roofline.record() as inner_led:
            b.min_dist_argmin(torch.from_numpy(sp[0]),
                              torch.from_numpy(sp[0, :3]))
        b.min_dist_argmin(torch.from_numpy(sp), torch.from_numpy(sp[:, :3]))
    b.min_dist_argmin(torch.from_numpy(sp[0]), torch.from_numpy(sp[0, :3]))
    assert [c.sizes() for c in inner_led] == [(1, sp.shape[1], 3, 10)]
    assert [c.sizes() for c in led] == [(9, sp.shape[1], 3, 10)]
    assert [c.backend for c in led] == ["torch"]


def test_collectives_are_recorded_only_inside_record():
    """``note_collective`` (what ``Mesh.all_gather`` and ``Mesh.hop``
    call) appends to the open ledger's collectives in the current phase,
    and keeps nothing outside ``record()``."""
    trace.note_collective("all-gather", (0, 1), 64)
    with roofline.record() as led:
        with trace.phase("round1_gather"):
            trace.note_collective("all-gather", (0, 1, 2, 3), 128)
        trace.note_collective("collective-permute", (2, 3), 32)
    trace.note_collective("all-gather", (0, 1), 64)
    assert led.collectives == [
        trace.CollectiveRecord("all-gather", (0, 1, 2, 3), 128,
                               "round1_gather"),
        trace.CollectiveRecord("collective-permute", (2, 3), 32, None)]
    assert len(led) == 0
    by_phase = trace.collective_phase_analysis(led.collectives)
    assert by_phase["round1"].collective_bytes_by_kind == {
        "all-gather": 128 * 3 / 4}
    assert by_phase["other"].collective_counts == {"collective-permute": 1}


def test_a_batched_call_counts_its_live_centres():
    q = torch.zeros(3, 8, 4)
    c = torch.zeros(3, 6, 4)
    mask = torch.arange(6)[None, :] < torch.tensor([[2], [6], [1]])
    with roofline.record() as led:
        backend.query_assignments_batched(q, c, mask, backend="torch",
                                          device="cpu")
    assert [c.sizes() for c in led] == [(3, 8, 9, 4)]
    row, = trace.analyze(led).rows
    assert row.function == "min_dist_argmin_batched"
    assert row.flops == work.min_dist_argmin_batched(3, 8, 9, 4)[0]


def test_phases_open_without_times():
    """A phase is current inside _phase whether or not walls are taken."""
    assert trace.current_phase() is None
    with _phase(None, "round1", torch.device("cpu")):
        assert trace.current_phase() == "round1"
        times = {}
        with _phase(times, "inner", torch.device("cpu")):
            assert trace.current_phase() == "inner"
        assert trace.current_phase() == "round1" and "inner" in times
    assert trace.current_phase() is None


# -- device time ----------------------------------------------------------------------------

def test_analyze_gives_the_stated_busy_time_and_idle_share():
    """Three kernels of two functions and a copy outside every work scope:
    busy is the union (0-15 and 20-30 and 40-45 us: 30 us), the idle
    share 1 - 30 / 100 over a wall of 100 us, each function's device time
    the sum of its spans, and bound / device per row."""
    led = trace.Ledger([
        trace.Call("lloyd_stats", (1, 1000, 4, 8), "round1", "cuda"),
        trace.Call("min_dist_argmin", (1, 1000, 1, 8), "solve", "cuda")])
    S = trace.Span
    spans = [S("lloyd_stats_kernel", 0.0, 10.0, "lloyd_stats", "round1"),
             S("partials_reduce_kernel", 5.0, 15.0, "lloyd_stats", "round1"),
             S("distance_one_center_kernel", 20.0, 30.0,
               "min_dist_argmin[k=1]", "solve"),
             S("Memcpy HtoD", 40.0, 45.0, None, "solve")]
    out = trace.analyze(led, spans, wall_s=100e-6)
    assert out.busy_ms == pytest.approx(0.030)
    assert out.idle_share == pytest.approx(0.7)
    assert out.device_ops == 4 and out.other_ms == pytest.approx(0.005)
    rows = {(r.phase, r.function): r for r in out.rows}
    lloyd = rows[("round1", "lloyd_stats")]
    assert lloyd.device_ms == pytest.approx(0.020)
    assert lloyd.share == pytest.approx(lloyd.bound_ms / 0.020)
    seed = rows[("solve", "min_dist_argmin[k=1]")]
    assert seed.device_ms == pytest.approx(0.010) and seed.calls == 1
    flops, nbytes = work.min_dist_argmin(1, 1000, 1, 8)
    assert (seed.flops, seed.bytes) == (flops, nbytes)
    assert (seed.bound_ms, seed.bound_by) == work.bound(flops, nbytes,
                                                        report.H100_SXM)
    total = out.analysis()
    assert total.dot_flops == sum(r.flops for r in out.rows)
    assert len(out.lines()) == 4


class _Event:
    """A stand-in for a profiler event: what device_spans reads."""

    def __init__(self, id, name, device, start=0.0, end=0.0, parent=None,
                 annotation=False):
        self.id, self.name, self.cpu_parent = id, name, parent
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.time_range = type("R", (), {"start": start, "end": end})()
        self.is_user_annotation = annotation


def test_device_spans_tie_each_kernel_to_its_launch():
    """A kernel carries its launch's correlation id; the launch's scopes
    give its function and phase. Annotations are left out, and a kernel
    launched outside every work scope has no function."""
    E = _Event
    phase = E(1, "round1", False)
    scope = E(2, "work:lloyd_stats", False, parent=phase)
    launch = E(43, "cudaLaunchKernel", False, parent=scope)
    op = E(44, "aten::mul", False, parent=phase)
    copy = E(45, "cudaLaunchKernel", False, parent=op)
    events = [phase, scope, launch, op, copy,
              E(1, "round1", True, 0.0, 50.0, annotation=True),
              E(2, "work:lloyd_stats", True, 1.0, 9.0, annotation=True),
              E(43, "lloyd_stats_kernel", True, 1.0, 9.0),
              E(45, "elementwise_kernel", True, 10.0, 12.0)]
    spans = trace.device_spans(events, {"round1"})
    assert spans == [
        trace.Span("lloyd_stats_kernel", 1.0, 9.0, "lloyd_stats", "round1"),
        trace.Span("elementwise_kernel", 10.0, 12.0, None, "round1")]


# -- the draw and ledger scopes -------------------------------------------------------------

DRAWS = ("split", "fold_in", "random_bits", "uniform", "gumbel",
         "categorical", "normal", "randint")


def _count_outermost_draws(monkeypatch):
    """Wrap every public draw of ``prng`` (the draws inside ``prng`` call
    each other through the module too) and count the outermost calls by
    name."""
    calls, depth = collections.Counter(), [0]

    def counting(name, fn):
        def wrapped(*args, **kw):
            if depth[0] == 0:
                calls[name] += 1
            depth[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
        return wrapped

    for name in DRAWS:
        monkeypatch.setattr(prng, name, counting(name, getattr(prng, name)))
    return calls


def _flood(sp, sm, route="flood", engine="sim"):
    return distributed_kmeans(prng.PRNGKey(7), sp, sm, K, t=400,
                              graph=grid(3, 3), device="cpu",
                              routing=route, engine=engine)


@pytest.mark.parametrize("route,engine", [("flood", "sim"), ("flood", "exec"),
                                          ("bfs", "sim"), ("bfs", "exec")])
def test_each_outermost_draw_is_one_draw_scope(quickstart, monkeypatch,
                                               route, engine):
    """A small run under ``record()`` and a CPU profiler: one
    ``work:draw.<name>`` range per outermost public draw, named after it,
    none inside another; one ``work:ledger`` range where the path reads
    ``t_i`` to the host for the ledger. No Call is recorded for either, so
    the work ledger is the kernels' alone."""
    sp, sm = quickstart
    calls = _count_outermost_draws(monkeypatch)
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as prof:
        with roofline.record() as led:
            _flood(sp, sm, route, engine)
    events = [e for e in prof.events() if e.name.startswith("work:")]
    draws = [e for e in events if e.name.startswith("work:draw.")]
    assert collections.Counter(
        e.name[len("work:draw."):] for e in draws) == calls
    assert calls["split"] >= 2 and calls["categorical"] == 2 * K
    for e in draws:
        parent = e.cpu_parent
        while parent is not None:
            assert not parent.name.startswith("work:draw."), e.name
            parent = parent.cpu_parent
    assert sum(e.name == "work:ledger" for e in events) == 1
    assert all(c.function in work.MODELS for c in led)


def test_draw_scopes_follow_the_phases(quickstart):
    """The flood run's draws by phase: Round 1's seeding (a split and a
    categorical per centre), Round 2's uniform draw, the solve's seeding;
    the ledger after every phase."""
    sp, sm = quickstart
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as prof:
        with roofline.record():
            _flood(sp, sm)
    phases = ("round1", "round2", "solve")

    def phase_of(e):
        parent = e.cpu_parent
        while parent is not None and parent.name not in phases:
            parent = parent.cpu_parent
        return None if parent is None else parent.name

    where = collections.Counter(
        (phase_of(e), e.name) for e in prof.events()
        if e.name.startswith("work:draw.") or e.name == "work:ledger")
    assert where[("round1", "work:draw.categorical")] == K
    assert where[("solve", "work:draw.categorical")] == K
    assert where[("round1", "work:draw.split")] >= K
    assert where[("solve", "work:draw.split")] >= K
    assert where[("round2", "work:draw.uniform")] == 1
    assert where[(None, "work:ledger")] == 1


def test_draws_open_no_range_outside_record(quickstart, monkeypatch):
    """Outside ``record()`` a draw opens no ``record_function``, and a
    whole run opens only its phases."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args, **kw):
        opened.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    key = prng.PRNGKey(3)
    prng.split(key, 4), prng.fold_in(key, 5), prng.random_bits(key, (6,))
    prng.uniform(key, (6,)), prng.gumbel(key, (6,)), prng.normal(key, (6,))
    prng.categorical(key, torch.zeros(6)), prng.randint(key, (6,), 0, 9)
    assert opened == []
    _flood(*quickstart)
    assert opened and set(opened) <= {"round1", "round2", "solve"}


def test_draws_and_the_run_are_bit_identical_under_record(quickstart):
    """Every draw, and a whole run's keys, indices, coreset, centres and
    ledger, are the same bits with and without ``record()``."""
    key = prng.split(prng.PRNGKey(11), 4)
    logits = torch.linspace(-3.0, 1.0, 50)

    def draws():
        return [prng.split(key, 3), prng.fold_in(key, 9),
                prng.random_bits(key, (5,)), prng.uniform(key, (5,)),
                prng.gumbel(key, (5,)), prng.normal(key, (5,)),
                prng.categorical(key, logits.expand(4, 50)),
                prng.randint(key, (5,), -4, 100)]

    sp, sm = quickstart
    plain, res = draws(), _flood(sp, sm)
    with roofline.record():
        traced, res_traced = draws(), _flood(sp, sm)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in ((res.centers, res_traced.centers),
                 (res.coreset.points, res_traced.coreset.points),
                 (res.coreset.weights, res_traced.coreset.weights),
                 (res.local_costs, res_traced.local_costs)):
        assert torch.equal(a, b)
    assert res.ledger.as_dict(by_phase=True) == \
        res_traced.ledger.as_dict(by_phase=True)


def test_a_draw_that_raises_leaves_the_next_draw_its_scope():
    """The outermost-draw flag is reset when a draw raises, so the next
    draw on the thread opens its own scope."""
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as prof:
        with roofline.record():
            with pytest.raises(TypeError):
                prng.split(torch.zeros(2))
            prng.uniform(prng.PRNGKey(1), (3,))
    names = [e.name for e in prof.events() if e.name.startswith("work:")]
    assert names == ["work:draw.split", "work:draw.uniform"]


def test_scope_records_no_call_and_costs_one_check_outside():
    """``trace.scope`` opens ``work:<label>`` inside ``record()`` and
    records no Call; outside it hands back one shared null context."""
    assert trace.scope("ledger") is trace.scope("other")
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as prof:
        with roofline.record() as led:
            with trace.scope("ledger"):
                torch.ones(3).sum()
    assert len(led) == 0
    assert [e.name for e in prof.events()
            if e.name.startswith("work:")] == ["work:ledger"]


def test_draw_and_ledger_spans_land_in_other_ms():
    """A draw's or the ledger's device operations have no Call's row:
    ``analyze`` puts them in ``other_ms`` beside unscoped operations."""
    led = trace.Ledger([
        trace.Call("lloyd_stats", (1, 1000, 4, 8), "round1", "cuda")])
    S = trace.Span
    spans = [S("lloyd_stats_kernel", 0.0, 10.0, "lloyd_stats", "round1"),
             S("xor_kernel", 10.0, 14.0, "draw.split", "round1"),
             S("Memcpy DtoH", 20.0, 21.0, "ledger", None),
             S("cumsum_kernel", 30.0, 32.0, None, "round2")]
    out = trace.analyze(led, spans, wall_s=100e-6)
    assert out.other_ms == pytest.approx(0.007)
    row, = out.rows
    assert row.device_ms == pytest.approx(0.010)
