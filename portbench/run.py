"""Run one benchmark cell once on the card and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs/<config>.json``: data sizes, sites, topology,
partition, budget) and a traffic mix (``portbench/traffic/<traffic>.json``:
objective, engine, routing, backend, runs to check and to trace); its
limits are ``portbench/limits/<workload>.json`` and each metric is read by
``portbench/metrics/<metric>.py`` (a metric split by the end-to-end metric
its cells report, ``<quantity>.<tag>``, by ``<quantity>.py``). A later
cell, mix or metric is a new file, found by its name.

Set-up makes the sites on the card from ``--seed`` and runs one warm-up
clustering. The window is a closed loop: one distributed clustering at a
time (``repro_torch.core.distributed.graph_distributed_kmeans``, run r
under the key ``fold_in(PRNGKey(seed), r)``), each ending with its centres
and ledger on the host, until ``--seconds`` have passed; the run in flight
then finishes. With ``--trace 1`` the window is instead ``trace_runs``
runs under ``torch.profiler``, and the line carries the per-layer metrics.
After the window a sample of its runs, drawn from the seed, is compared
with the plain reference (:mod:`portbench.check`).

The last line of standard output is the result (JSON); the line before it
names the card, its power limit and clocks, the set-up by stage (imports,
the card's context, the kernel libraries -- ``compiled`` says whether this
run built them, which only a checkout's first run does --, the data, the
warm-up), the peak device memory of the window, the shortest, median and
longest run of the window, and in a traced run the launches and those of
them whose device operation the trace lost.
The numbers compared stand, each beside its limit, at the end of standard
error and under the result's last key, ``checks``. The process exits 1
without a result when no card is there, or when a module of JAX or of the
JAX package is loaded.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
CACHE = BENCH / "cache"


def _pin_caches() -> None:
    """Every kernel cache a run may write, at fixed paths in the checkout
    (the program's own nvcc builds already live in its package)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


if __name__ == "__main__":
    _pin_caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

_T_TORCH = time.perf_counter()

from portbench import check, data, guard, tracing  # noqa: E402
from portbench import work as work_mod  # noqa: E402
from portbench import reference as ref  # noqa: E402
from portbench import threefry as tf  # noqa: E402


def load(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def cell_of(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metrics: with ``trace`` the per-layer ones that list it
    (or, listing none, move an end-to-end metric it reports), else its
    end-to-end ones."""
    def has(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if has(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in moved)]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``; a name split by its cells' metric,
    ``<quantity>.<tag>``, falls back to ``metrics/<quantity>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Context(types.SimpleNamespace):
    """What a metric reader reads: ``mode`` ("window" or "trace"),
    ``runs``, ``window_s``, ``setup_s``, ``phase_times`` (one dict a
    traced run), ``trace`` (a :class:`tracing.Trace` or None), ``cfg``,
    ``sizes`` and ``peaks``."""

    def phase_ms(self, phase: str):
        if not self.phase_times:
            return None
        return 1e3 * sum(p.get(phase, 0.0)
                         for p in self.phase_times) / len(self.phase_times)

    def roofline(self, label: str):
        if self.trace is None or self.peaks is None:
            return None
        share = self.trace.roofline(label, self.sizes, int(self.cfg["k"]),
                                    int(self.cfg["t"]), int(self.cfg["d"]),
                                    self.peaks)
        return None if share is None else 100.0 * share


def card() -> dict:
    """The card's name, count, power limit and clocks (``nvidia-smi``)."""
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    query = "power.limit,clocks.sm,clocks.max.sm,clocks.mem"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
        info.update(zip(query.split(","), (v.strip() for v in out.split(","))))
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = f"not read: {e}"
    return info


def as_output(res) -> ref.Output:
    """The program's result as the reference's :class:`ref.Output`."""
    return ref.Output(res.centers, res.coreset.points, res.coreset.weights,
                      res.ledger.as_dict(by_phase=True), res.local_costs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, overrides: dict = None) -> tuple:
    """Set up, run the window and compare; returns the result's fields and
    what the line before it adds (set-up by stage and whether the kernels
    were compiled, peak memory, the window's shortest, median and longest
    run, and a trace's launches without their device operation).
    ``overrides`` replaces configuration keys: the tests' small cells."""
    stages = {"torch_import_s": _T_TORCH - _T0,
              "harness_s": time.perf_counter() - _T_TORCH}
    lap = time.perf_counter()

    def stage(name):
        nonlocal lap
        now = time.perf_counter()
        stages[name] = now - lap
        lap = now

    from repro_torch.core import distributed, topology
    from repro_torch.roofline import trace as program_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_of(bench, workload)
    cfg = {**load("configs", cell["config"]), **(overrides or {})}
    mix = load("traffic", cell["traffic"])
    limits = load("limits", workload)
    n_nodes, edges = data.graph_edges(cfg["topology"])
    graph = topology.Graph(n_nodes, tuple(edges))
    stage("program_import_s")
    compiled = False
    if device.type == "cuda":
        torch.zeros(1, device=device)
        _sync(device)
        stage("cuda_init_s")
        if mix["backend"] == "cuda":
            # the program's kernel libraries, built here on a checkout's
            # first run and found built on every later one
            from repro_torch.kernels import _build
            compiled = any(r.seconds > 0 for r in _build.build().values())
            stage("build_s")
    sites = data.make_sites(cfg, seed, device)
    _sync(device)
    stage("data_s")
    k, t = int(cfg["k"]), int(cfg["t"])
    base = tf.PRNGKey(seed, device=device)

    def run_once(r: int, phase_times=None):
        res = distributed.graph_distributed_kmeans(
            tf.fold_in(base, r), sites.points, sites.mask, k, t, graph,
            objective=mix["objective"], lloyd_iters=int(cfg["lloyd_iters"]),
            backend=mix["backend"], engine=mix["engine"],
            routing=mix["routing"], device=device, phase_times=phase_times)
        res.centers.cpu()   # the answer on the host (the ledger is host data)
        return res

    run_once(0)
    stage("warmup_s")
    warm_s = stages["warmup_s"]
    setup_s = time.perf_counter() - _T0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    rng = random.Random(seed)
    kept, runs, phase_times, prof, ends = {}, 0, [], None, [0.0]
    if trace:
        want = set(rng.sample(range(1, int(mix["trace_runs"]) + 1),
                              min(int(mix["check_runs"]),
                                  int(mix["trace_runs"]))))
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with program_trace.record():
                start = time.perf_counter()
                for r in range(1, int(mix["trace_runs"]) + 1):
                    times = {}
                    with torch.profiler.record_function(tracing.RUN_SCOPE):
                        res = run_once(r, times)
                    phase_times.append(times)
                    if r in want:
                        kept[r] = res
                    runs = r
                window_s = time.perf_counter() - start
    else:
        # the runs to check, drawn from the seed among those the window
        # will surely finish (the warm-up run is the slowest)
        surely = max(1, int(seconds / warm_s))
        want = set(rng.sample(range(1, surely + 1),
                              min(int(mix["check_runs"]), surely)))
        start = ends[0] = time.perf_counter()
        while ends[-1] - start < seconds:
            runs += 1
            res = run_once(runs)
            if runs in want:
                kept[runs] = res
            ends.append(time.perf_counter())
        window_s = ends[-1] - start
        if not kept:
            kept[runs] = res
    del res
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = guard.loaded()
    if found:
        raise guard.Forbidden(found)

    trace_red = tracing.reduce(prof.events()) if prof is not None else None
    prof = None
    peaks = (work_mod.PEAKS.get(torch.cuda.get_device_name(device))
             if device.type == "cuda" else None)
    ctx = Context(mode="trace" if trace else "window", runs=runs,
                  window_s=window_s, setup_s=setup_s, phase_times=phase_times,
                  trace=trace_red, cfg=cfg, sizes=sites.sizes, peaks=peaks)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the comparison, once the window has closed and its peak is read
    worst, failed = {}, 0
    for r in sorted(kept):
        nums = check.judge(as_output(kept[r]), tf.fold_in(base, r),
                           sites.points, sites.mask, cfg, mix["objective"],
                           len(edges))
        kept[r] = None
        failed += not check.verdict(nums, limits)
        for name, v in nums.items():
            worst[name] = max(worst.get(name, float("-inf")), v)
    out = {"correct": failed == 0, "attempted": runs, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace_red is not None:
        out["device"]["busy_s"] = trace_red.busy_s()
        out["device"]["window_s"] = trace_red.window_s
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in
                           trace_red.device_s_by_name()[:10]],
            "idle_gaps": [[n, s] for n, s in trace_red.gaps()[:10]]}
    out["checks"] = {name: {"value": worst.get(name), "limit": limit}
                     for name, limit in limits.items()}
    laps = sorted(b - a for a, b in zip(ends, ends[1:]))
    window = ({"min": laps[0], "median": laps[len(laps) // 2],
               "max": laps[-1]} if laps else None)
    extra = {"setup": stages, "compiled": compiled,
             "memory_peak_bytes": int(peak), "run_s": window}
    if trace_red is not None:
        extra["trace_launches"] = trace_red.launches
        extra["trace_missing_ops"] = trace_red.missing
    return out, extra


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    found = guard.loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    try:
        out, extra = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device)
    except guard.Forbidden as e:
        print(f"forbidden modules loaded: {e}", file=sys.stderr)
        return 1
    info = {**card(), **extra}
    print(json.dumps({"card": info}))
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
