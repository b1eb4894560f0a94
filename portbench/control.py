"""The readings the limits of ``limits/<workload>.json`` are set from, at
the cell's own size: the numbers of :mod:`portbench.check` for the
program's run 1 on each of a dozen or more seeds (the lower readings), for
the control -- the plain reference in the program's place with every
matrix product in TF32, the precision below the float32 the
configurations state -- on three or more (the upper readings), and for the
program with each fault of :mod:`portbench.faults` planted. Each reading
also carries the harness's verdict under the cell's limits. The
benchmark's own runs never run it.

    python3 portbench/control.py --workload kmeans-bigcross \
        --seeds 11,12,...  --control-seeds 11,12,13 \
        [--faults state_unchanged,half_batch,no_exchange,answer_altered,\
one_site_cost --fault-seeds 11,12,13] [--out FILE]

prints one JSON line a reading: {"seed", "side", "numbers", "correct"}.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

import torch  # noqa: E402

from portbench import check, data, faults as faults_mod  # noqa: E402
from portbench import reference as ref  # noqa: E402
from portbench import run as harness  # noqa: E402
from portbench import threefry as tf  # noqa: E402

CONTROL = ref.Arith(lowp=True)


def readings(workload: str, seeds, control_seeds, device: torch.device,
             overrides: dict = None, faults=(), fault_seeds=()):
    """Yield {"seed", "side", "numbers", "correct"} for the program on
    ``seeds``, the control on ``control_seeds`` and the program with each
    of ``faults`` planted on ``fault_seeds`` (run key 1 of each seed, the
    inputs a run of the cell would make); ``side`` is "program",
    "control" or "fault:<name>"."""
    from repro_torch.core import distributed, topology
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.cell_of(bench, workload)
    cfg = {**harness.load("configs", cell["config"]), **(overrides or {})}
    mix = harness.load("traffic", cell["traffic"])
    limits = harness.load("limits", workload)
    n_nodes, edges = data.graph_edges(cfg["topology"])
    graph = topology.Graph(n_nodes, tuple(edges))
    k, t = int(cfg["k"]), int(cfg["t"])
    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        sites = data.make_sites(cfg, seed, device)
        key = tf.fold_in(tf.PRNGKey(seed, device=device), 1)

        def program():
            return harness.as_output(distributed.graph_distributed_kmeans(
                key, sites.points, sites.mask, k, t, graph,
                objective=mix["objective"],
                lloyd_iters=int(cfg["lloyd_iters"]), backend=mix["backend"],
                engine=mix["engine"], routing=mix["routing"], device=device))

        def broken(fault):
            def run():
                with faults_mod.planted(fault, mix["objective"]):
                    return program()
            return run

        sides = []
        if seed in seeds:
            sides.append(("program", program))
        if seed in control_seeds:
            sides.append(("control", lambda: ref.cluster(
                key, sites.points, sites.mask, k, t, mix["objective"],
                int(cfg["lloyd_iters"]), len(edges), CONTROL)))
        if seed in fault_seeds:
            sides += [(f"fault:{f}", broken(f)) for f in faults]
        for side, produce in sides:
            out = produce()
            numbers = check.judge(out, key, sites.points, sites.mask, cfg,
                                  mix["objective"], len(edges))
            del out
            yield {"seed": seed, "side": side, "numbers": numbers,
                   "correct": check.verdict(numbers, limits)}
        del sites


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness._pin_caches()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1

    def ints(text):
        return [int(s) for s in text.split(",") if s]
    sink = open(args.out, "a") if args.out else None
    try:
        for row in readings(args.workload, ints(args.seeds),
                            ints(args.control_seeds),
                            torch.device("cuda", 0),
                            faults=[f for f in args.faults.split(",") if f],
                            fault_seeds=ints(args.fault_seeds)):
            line = json.dumps({"workload": args.workload, **row})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
