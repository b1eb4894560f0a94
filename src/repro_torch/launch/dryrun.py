"""Dry run (the port of ``repro.launch.dryrun``): for every (architecture x
input shape) cell, run the real step function on meta tensors laid out
over the production mesh (nothing is allocated), and persist its roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b \\
        --shape train_4k --mesh single [--hardware h100_sxm]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --hardware h100_sxm --network-bytes-per-s 50e9

The port has no compiler, so each number is the port's own reckoning:

* **argument / output / alias bytes per device**: every meta argument's
  (and output's) shard shape under its spec (``launch.specs``) times its
  itemsize -- the reference's ``memory_analysis`` counts the same
  per-device shapes. An output takes its argument's spec where the step
  updated the argument in place (the train step's params and optimizer
  state, the decode step's cache: those bytes alias), the cache's
  layout for a prefill's cache, and ``("batch", "model")`` for logits.
* **flops per device**: ``torch.utils.flop_counter.FlopCounterMode``'s
  total over the whole step at the global batch (forward, backward with
  the recomputation of remat ``"full"``: the dot products, as the
  reference's ``hlo_dot_flops`` counts them), over the mesh's size.
* **temp bytes**: the port's own working set, not a compiler's: the
  peak, over the step run at *one rank's* batch (the global batch over
  the batch axes), of the bytes of the storages its operations allocate
  and that are alive at once (:class:`LiveBytes`: each new storage is
  counted when an operation returns it and uncounted when it is freed;
  the arguments are not counted). Nothing holds it to the reference's.
* **result bytes**: the bytes of every operation's outputs over the step
  at the global batch, over the mesh's size.
* **the collective term**: reckoned from the layout's specs, not
  compiled (:func:`layout_collectives`), priced with
  ``roofline.trace.collective_link``.

The JSON a cell writes has the reference's keys. ``lower_s`` is the time
to build the cell and run the step at the global batch, ``compile_s`` the
time of the second run, at one rank's batch (there is no compile step).
``xla_flops`` and ``xla_bytes`` are 0: no other tool counts the program.
``fits_hbm`` holds the peak (temp + arguments + outputs - aliased)
against the memory of the card the report is for: ``report.detect()`` on
the card, or ``H100_SXM`` when the caller passes it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
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
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, all_cells, cells_for
from repro_torch.launch import specs as specs_mod
from repro_torch.models.layers import torch_dtype
from repro_torch.models import sharding
from repro_torch.models.sharding import resolve
from repro_torch.roofline.report import H100_SXM, build_report, detect
from repro_torch.roofline.trace import Analysis, collective_link
from repro_torch.train.train_step import TrainConfig

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


# -- the collective term -------------------------------------------------------

def _group(entry, mesh):
    """The axes of a spec entry that split (size > 1)."""
    return tuple(a for a in specs_mod.axes(entry) if mesh.shape[a] > 1)


class _Tally:
    def __init__(self, mesh):
        self.mesh, self.ana = mesh, Analysis()

    def add(self, kind: str, axes, result_bytes: float, times: float = 1.0):
        n = specs_mod.ways(axes, self.mesh)
        if n <= 1 or times <= 0:
            return
        link = collective_link(kind, n, result_bytes) * times
        a = self.ana
        a.collective_counts[kind] = a.collective_counts.get(kind, 0.0) + times
        a.collective_bytes_by_kind[kind] = (
            a.collective_bytes_by_kind.get(kind, 0.0) + link)
        if "pod" in axes:
            a.dcn_collective_bytes += link
        else:
            a.ici_collective_bytes += link


def layout_collectives(cell) -> Analysis:
    """The collectives of one step under the cell's layout, per device,
    reckoned from its specs (no compiled program to read them from):

    * **parameters** sharded over the FSDP group (the axes of a spec's
      ``data`` entries): one all-gather of each to its model-shard size
      for the forward of every microbatch, and in training one more for
      the recomputation of remat ``"full"`` and one reduce-scatter of its
      gradient per microbatch;
    * **gradients** of parameters replicated over some batch axes: one
      all-reduce of the shard per microbatch over those axes (across
      pods, the network);
    * **tensor parallelism** (the ``tp`` layout shards every layer's
      weights over ``model``): for every layer, an all-gather and a
      reduce-scatter of its activations (one microbatch's rows on one
      batch shard, sequence by width, in the compute dtype) around its
      mixer and its MLP, per pass -- the forward, and in training the
      recomputation and the backward. An MoE layer adds two all-to-alls
      of its routed rows per pass.

    Each is priced with ``trace.collective_link``; a group holding the
    ``pod`` axis is link bytes across the network between nodes. The
    reference's compiled program may fuse, hoist or drop some of these,
    so the two counts differ (ROADMAP C states the ratios)."""
    mesh, cfg, shape = cell.mesh, cell.cfg, cell.shape
    tally = _Tally(mesh)
    train = shape.kind == "train"
    mb = cell.microbatches
    batch_axes = _group(resolve("batch", mesh, cell.layout), mesh)
    params, pspecs = cell.args[0], cell.specs[0]
    for p, spec in zip(tree_mod.leaves(params),
                       specs_mod.spec_leaves(pspecs)):
        shard = specs_mod.shard_bytes(p, spec, mesh)
        used = {a for entry in spec for a in _group(entry, mesh)}
        fsdp = tuple(a for a in batch_axes if a in used)
        gathered = shard * specs_mod.ways(fsdp, mesh)
        tally.add("all-gather", fsdp, gathered, mb * (2 if train else 1))
        if train:
            tally.add("reduce-scatter", fsdp, shard, mb)
            tally.add("all-reduce", tuple(a for a in batch_axes
                                          if a not in used), shard, mb)
    model = _group("model", mesh) if cell.layout == "tp" else ()
    if model:
        bways = specs_mod.ways(batch_axes, mesh)
        rows = shape.global_batch // (1 if shape.global_batch % bways
                                      else bways) // mb
        length = 1 if shape.kind == "decode" else shape.seq_len
        act = (max(rows, 1) * length * cfg.d_model
               * torch_dtype(cfg.dtype).itemsize)
        passes = 3 * mb if train else 1
        per_layer = 2 if cfg.d_ff or cfg.n_experts else 1
        n = specs_mod.ways(model, mesh)
        times = cfg.n_layers * per_layer * passes
        tally.add("all-gather", model, act, times)
        tally.add("reduce-scatter", model, act / n, times)
        if cfg.n_experts:
            routed = act * max(cfg.top_k, 1)
            tally.add("all-to-all", model, routed,
                      2 * cfg.n_layers * passes)
    return tally.ana


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


def _rank_cell(cell):
    """The cell at one rank's batch (the global batch over the batch
    axes it shards over), with the same microbatches and config."""
    bspec = sharding.divisible_spec(
        ("batch",), (cell.shape.global_batch,), cell.mesh, cell.layout)[0]
    shape = dataclasses.replace(cell.shape, global_batch=(
        cell.shape.global_batch // specs_mod.ways(bspec, cell.mesh)))
    tc = None
    if shape.kind == "train":
        tc = TrainConfig(microbatches=math.gcd(cell.microbatches,
                                               shape.global_batch),
                         remat="full")
    return specs_mod.build_cell(cell.arch, shape, cell.mesh, tc, cell.cfg,
                                cell.layout)


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
    rank = _rank_cell(cell)
    live = LiveBytes()
    with live:
        rank.lower()
    t_compile = time.time() - t0 - t_lower

    arg = sum(specs_mod.tree_bytes(a, s, mesh)
              for a, s in zip(cell.args, cell.specs))
    out = lowered.outputs
    out_bytes = specs_mod.tree_bytes(list(out), list(_out_specs(cell, out)),
                                     mesh)
    alias = _aliased(cell, out)
    temp = live.peak
    peak = float(temp + arg + out_bytes - alias)
    ana = layout_collectives(cell)
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
        print(f"  collectives (from the layout): {rep.collective_counts} "
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
