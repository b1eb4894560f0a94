"""Dry run (the port of ``repro.launch.dryrun``): for every (architecture x
input shape) cell, run the real step function on meta tensors laid out
over the production mesh (nothing is allocated), and persist its roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b \\
        --shape train_4k --mesh single [--hardware h100_sxm]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --hardware h100_sxm --network-bytes-per-s 50e9

The port has no compiler. Each cell runs twice, on meta tensors:

* **the global run** (``Cell.lower``): the step on the whole mesh's
  arguments, in the reference's stacked layout, with no grid bound;
* **one rank's run**: rank 0 of the port's own sharded step on a
  stand-in of the cell's mesh (``core.mesh.MeshGrid.stand_in``: the
  grid's axes and groups with no process group, its collectives
  recorded and returning empty tensors). A train cell runs
  ``train_step.mesh_train_step(cfg, tc, grid, "tp")`` on the rank's
  shards of the per-layer params under ``models.model.shard_specs`` (the
  layout the sharded step runs; where the reference's stacked specs cut
  a stacking dim the two differ, and the argument bytes below stay the
  stacked ones), its AdamW state, and its batch rows
  (``sharding.batch_rows`` with the cell's microbatches). A prefill or
  decode cell runs ``launch.specs.build_cell(...).fn`` built on the grid,
  on the rank's shards of the stacked serving params under the cell's
  specs, its token rows and (decode) a ``sharding.GridCache`` of its
  cache shards. A cell the step cannot run fails with the step's own
  message.

What the report reads:

* **argument / output / alias bytes per device**: every meta argument's
  (and output's) shard shape under its spec (``launch.specs``) times its
  itemsize -- the reference's ``memory_analysis`` counts the same
  per-device shapes. An output takes its argument's spec where the step
  updated the argument in place (the train step's params and optimizer
  state, the decode step's cache: those bytes alias), the cache's
  layout for a prefill's cache, and ``("batch", "model")`` for logits.
* **flops per device**: ``torch.utils.flop_counter.FlopCounterMode``'s
  total over the global run (forward, backward with the recomputation
  of remat ``"full"``: the dot products, as the reference's
  ``hlo_dot_flops`` counts them), over the mesh's size.
* **temp bytes**: the port's own working set on one rank, not a
  compiler's: the peak, over the rank's run, of the bytes of the
  storages its operations allocate and that are alive at once
  (:class:`LiveBytes`; the arguments are not counted). It includes the
  buffers of the rank's collectives: every reduction of the port is an
  all-gather summed in rank order, so a reduce-scatter holds the
  group's copies of its operand at once.
* **result bytes**: the bytes of every operation's outputs over the
  global run, over the mesh's size.
* **the collective term**: the rank's collectives as the run made
  them (``roofline.record()``), each priced as the collective it stands
  for (``trace.collective_phase_analysis``); a group whose ranks span
  more than one pod is link bytes across the network between nodes.

The JSON a cell writes has the reference's keys. ``lower_s`` is the time
to build the cell and make the global run, ``compile_s`` the time of the
rank's run (there is no compile step). ``xla_flops`` and ``xla_bytes``
are 0: no other tool counts the program. ``fits_hbm`` holds the peak
(temp + arguments + outputs - aliased) against the memory of the card
the report is for: ``report.detect()`` on the card, or ``H100_SXM`` when
the caller passes it.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch import tree as tree_mod
from repro_torch.core.mesh import MeshGrid
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, all_cells, cells_for
from repro_torch.launch import specs as specs_mod
from repro_torch.models import param_spec, sharding
from repro_torch.models.model import shard_specs
from repro_torch.optim import adamw
from repro_torch.roofline.report import H100_SXM, build_report, detect
from repro_torch.roofline.trace import collective_phase_analysis, record
from repro_torch.train.train_step import mesh_train_step

HARDWARE = {"h100_sxm": H100_SXM}


class LiveBytes(TorchDispatchMode):
    """Within it: ``peak``, the most bytes of storages that operations
    allocated and that were alive at once, and ``result_bytes``, the bytes
    of every operation's outputs. A storage first seen as an operation's
    input was allocated before: it is never counted."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.result_bytes = 0
        self._ours, self._before = set(), set()

    def _free(self, key, n):
        self._ours.discard(key)
        self.live -= n

    def _forget(self, key):
        self._before.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st._cdata
                if key not in self._ours and key not in self._before:
                    self._before.add(key)
                    weakref.finalize(st, self._forget, key)
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            self.result_bytes += t.numel() * t.element_size()
            st = t.untyped_storage()
            key = st._cdata
            if key in self._ours or key in self._before:
                continue
            n = st.nbytes()
            self._ours.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


# -- one cell --------------------------------------------------------------------

def _out_specs(cell, out):
    """Each output's spec (see the module docstring)."""
    mesh = cell.mesh
    if cell.shape.kind == "train":
        return (cell.specs[0], cell.specs[1], {k: () for k in out[2]})
    logits, cache = out
    lspec = sharding.divisible_spec(("batch", "model"), tuple(logits.shape),
                                    mesh, cell.layout)
    return (lspec, sharding.cache_specs(cache, mesh))


def _aliased(cell, out) -> int:
    """Per-device bytes of the outputs that are arguments updated in
    place (the donated arguments)."""
    ours = {id(t) for i in cell.donate
            for t in tree_mod.leaves(cell.args[i])}
    return sum(specs_mod.shard_bytes(t, s, cell.mesh) for t, s in zip(
        tree_mod.leaves(list(out)),
        specs_mod.spec_leaves(list(_out_specs(cell, out))))
        if id(t) in ours)


def _stand_in(mesh):
    """Rank 0 of ``mesh`` with no process group, and the ranks of one pod
    (None on a mesh with no ``pod`` axis)."""
    names = tuple(mesh.axis_names)
    sizes = tuple(mesh.shape[a] for a in names)
    grid = MeshGrid.stand_in(names, sizes, rank=0)
    pod_block = (grid.size // mesh.shape["pod"] if "pod" in names
                 else None)
    return grid, pod_block


def rank_run(cell, grid):
    """This rank's run of the cell on ``grid`` (see the module docstring)
    as ``(fn, args)``: ``fn(*args)`` runs it, on the rank's meta shards
    (made here, so the run's working set leaves them out)."""
    layout, cfg, shape = cell.layout, cell.cfg, cell.shape
    if shape.kind == "train":
        params = sharding.shard(param_spec(cfg), shard_specs(
            cfg, grid, layout), grid)
        opt = adamw.init(params)
        with sharding.set_mesh(grid, layout):
            rows = sharding.batch_rows(shape.global_batch,
                                       cell.microbatches)
        n = len(range(shape.global_batch)[rows]) \
            if isinstance(rows, slice) else len(rows)
        batch = {k: torch.empty((n, shape.seq_len), dtype=torch.int32,
                                device="meta") for k in ("tokens", "labels")}
        i = torch.empty((), dtype=torch.int32, device="meta")
        return (mesh_train_step(cfg, cell.tc, grid, layout),
                (params, opt, batch, i))
    on_grid = specs_mod.build_cell(cell.arch, shape, grid, cfg_override=cfg,
                                   layout=layout)
    args = list(on_grid.args)
    cache = args.pop() if shape.kind == "decode" else None
    args = [sharding.shard(a, s, grid) for a, s in zip(args, on_grid.specs)]
    if cache is not None:
        args.append(sharding.shard_cache(cache, grid))
    return on_grid.fn, tuple(args)


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             verbose: bool = True, hardware=None, cfg_override=None,
             mesh=None, network_bytes_per_s: Optional[float] = None
             ) -> dict:
    """One cell's dry run; ``hardware`` the card the report is for
    (default ``report.detect()``: the card of this machine), ``mesh`` a
    mesh in place of the production one (``mesh_name`` still names it),
    ``network_bytes_per_s`` the rate between nodes, which a multi-pod
    cell's link bytes across pods need."""
    hardware = hardware or detect()
    t0 = time.time()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    cell = specs_mod.build_cell(arch, shape_name, mesh,
                                cfg_override=cfg_override)
    meter = LiveBytes()
    with meter:
        lowered = cell.lower()
    t_lower = time.time() - t0
    grid, pod_block = _stand_in(mesh)
    fn, args = rank_run(cell, grid)
    live = LiveBytes()
    with record() as led, live:
        fn(*args)
    t_compile = time.time() - t0 - t_lower

    arg = sum(specs_mod.tree_bytes(a, s, mesh)
              for a, s in zip(cell.args, cell.specs))
    out = lowered.outputs
    out_bytes = specs_mod.tree_bytes(list(out), list(_out_specs(cell, out)),
                                     mesh)
    alias = _aliased(cell, out)
    temp = live.peak
    peak = float(temp + arg + out_bytes - alias)
    ana = collective_phase_analysis(led.collectives, phases=(),
                                    pod_block=pod_block)["other"]
    ana.dot_flops = lowered.flops / mesh.size
    ana.result_bytes = meter.result_bytes / mesh.size
    rep = build_report(
        arch, shape_name, mesh_name, cell.cfg, cell.shape.kind,
        cell.shape.seq_len, cell.shape.global_batch, mesh.size, ana, None,
        peak, hardware, microbatches=cell.microbatches,
        network_bytes_per_s=network_bytes_per_s)

    result = rep.to_dict()
    result.update({
        "lower_s": t_lower, "compile_s": t_compile,
        "arg_bytes": float(arg), "out_bytes": float(out_bytes),
        "temp_bytes": float(temp), "alias_bytes": float(alias),
        "fits_hbm": peak <= hardware.memory_bytes,
        "hardware": hardware.name, "power_limit_w": hardware.power_limit_w,
        "status": "ok",
    })
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] "
              f"run={t_lower + t_compile:.1f}s peak={peak/1e9:.2f}GB "
              f"fits={result['fits_hbm']} "
              f"compute={rep.compute_s:.3e}s memory={rep.memory_s:.3e}s "
              f"collective={rep.collective_s:.3e}s -> {rep.bottleneck} "
              f"useful={rep.useful_flop_ratio:.2f} "
              f"roofline={rep.roofline_fraction:.2f} "
              f"({hardware.name}, {hardware.power_limit_w:.2f} W)")
        print(f"  per device: args={arg/1e9:.2f}GB "
              f"out={out_bytes/1e9:.2f}GB temp={temp/1e9:.2f}GB "
              f"aliased={alias/1e9:.2f}GB")
        print(f"  flops: counted/dev={rep.hlo_dot_flops:.3e} "
              f"model_flops/dev={rep.model_flops_total/mesh.size:.3e}")
        print(f"  collectives (rank 0's run): {rep.collective_counts} "
              f"link={rep.ici_bytes/1e6:.1f}MB "
              f"network={rep.dcn_bytes/1e6:.1f}MB")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
        with open(fname, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--hardware", choices=sorted(HARDWARE),
                    help="the card the reports are for (default: this "
                         "machine's card)")
    ap.add_argument("--network-bytes-per-s", type=float, default=None,
                    help="rate of the network between nodes: multi-pod "
                         "cells need it")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if "multi" in meshes and args.network_bytes_per_s is None:
        ap.error("--mesh multi/both needs --network-bytes-per-s: no rate "
                 "between nodes is assumed")
    if args.all:
        cells = all_cells()
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        shapes = [args.shape] if args.shape else cells_for(args.arch)
        cells = [(args.arch, s) for s in shapes]
    hardware = HARDWARE[args.hardware] if args.hardware else detect()

    failures = []
    for arch, shape_name in cells:
        for mesh_name in meshes:
            try:
                run_cell(arch, shape_name, mesh_name, args.out,
                         hardware=hardware,
                         network_bytes_per_s=args.network_bytes_per_s)
            except Exception as e:
                traceback.print_exc()
                failures.append((arch, shape_name, mesh_name, str(e)))
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    with open(os.path.join(
                            args.out,
                            f"{arch}__{shape_name}__{mesh_name}.json"),
                            "w") as f:
                        json.dump({"status": "fail", "error": str(e)}, f)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUN CELLS PASSED")


if __name__ == "__main__":
    main()
