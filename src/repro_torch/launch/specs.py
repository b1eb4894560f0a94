"""Abstract inputs for every (architecture x input shape) cell (the port of
``repro.launch.specs``): meta tensors, each with its spec beside it. The
dry run (``launch.dryrun``) runs each cell's step on them; no device
memory is ever allocated for the full configs.

A spec is the port's tuple of ``models.sharding.param_specs``: one entry
per dim, an axis name, a tuple of axis names or None. The layout rules
are the JAX package's (``models.sharding``), so a cell's per-device
shapes are the ones the reference's compiled program takes.

The reference stacks each run of layers into one array with leading
(n_periods[, run_len]) dims and its rules may shard that stacking dim
(a 1-d leaf stacked to 2-d falls under "FSDP on the leading dim"). The
port keeps one dict per layer, so the cell's parameter arguments are the
reference's *stacked* meta tensors with the reference's specs, and the
step runs on per-layer views of them (:func:`stacked_params`): the
per-device argument bytes are the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch import tree as tree_mod
from repro_torch.launch.shapes import SHAPES, ShapeSpec
from repro_torch.models import (cache_spec, forward, init_cache,
                                make_positions, param_spec, sharding)
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (cache_specs, divisible_spec,
                                         param_specs, set_mesh, shard_shape,
                                         ways)
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig, make_train_step

PyTree = Any
META = torch.device("meta")


def axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (a name, a tuple of names or
    None)."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def shard_bytes(t: torch.Tensor, spec, mesh) -> int:
    return math.prod(shard_shape(tuple(t.shape), spec, mesh)) \
        * t.element_size()


def tree_bytes(tree: PyTree, specs: PyTree, mesh) -> int:
    """Per-device bytes of a tree of tensors under its tree of specs."""
    return sum(shard_bytes(t, s, mesh) for t, s in
               zip(tree_mod.leaves(tree), spec_leaves(specs)))


def spec_leaves(specs: PyTree) -> List[tuple]:
    """A spec tree's specs in flattening order (a spec is a tuple, so it
    is a leaf here, not a node)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _opt_shardings(params_shardings: PyTree, mesh) -> PyTree:
    return {"m": params_shardings, "v": params_shardings, "step": ()}


def default_microbatches(cfg: ModelConfig, shape: ShapeSpec, mesh) -> int:
    """Per-microbatch global batch of 32 sequences at 4k (activation
    memory; see DESIGN.md Sec. 6); 16 for >50B-param models -- but never
    below the batch-sharding ways (microbatches must still shard over
    pod x data)."""
    if shape.kind != "train":
        return 1
    ways = mesh.shape["data"] * mesh.shape.get("pod", 1)
    per_mb = 16 if cfg.param_count() > 50e9 else 32
    per_mb = max(per_mb, ways)
    return max(shape.global_batch // per_mb, 1)


# -- the reference's stacked layer layout -------------------------------------

def _layer_groups(cfg: ModelConfig) -> Dict[str, List[List[int]]]:
    """The reference's stacked layer arrays: ``"scan/<run>"`` and
    ``"rem/<run>"``, each with the port's layer indices of its rows --
    [[i]] per period for a run of one layer, [[i, ...]] (period, run)
    for a longer one."""
    groups: Dict[str, List[List[int]]] = {}
    i = 0
    runs = cfg.runs()
    for _ in range(cfg.n_full_periods):
        for r, (_, rlen) in enumerate(runs):
            groups.setdefault(f"scan/{r}", []).append(list(range(i, i + rlen)))
            i += rlen
    for r, (_, rlen) in enumerate(cfg.remainder_runs()):
        groups[f"rem/{r}"] = [list(range(i, i + rlen))]
        i += rlen
    if i != cfg.n_layers:
        raise ValueError(f"{i} stacked layers for {cfg.n_layers}")
    return groups


def _lead(name: str, rows: List[List[int]]):
    """The leading dims the reference gives a stacked group."""
    run_len = len(rows[0])
    if name.startswith("scan/"):
        return (len(rows),) if run_len == 1 else (len(rows), run_len)
    return () if run_len == 1 else (run_len,)


def stacked_params(params: PyTree, cfg: ModelConfig) -> PyTree:
    """The port's params (layers a list) as the reference's tree: the
    layers of each run stacked in one tensor with leading (n_periods[,
    run_len]) dims, ``layers/scan/<run>`` and ``layers/rem/<run>`` (meta
    tensors in, meta tensors out)."""
    out = {k: v for k, v in params.items() if k != "layers"}
    layers: Dict[str, Dict[str, Any]] = {"scan": {}, "rem": {}}
    for name, rows in _layer_groups(cfg).items():
        lead = _lead(name, rows)
        part, run = name.split("/")
        layers[part][run] = tree_mod.map(
            lambda *xs: torch.stack(xs).reshape(lead + tuple(xs[0].shape)),
            *(params["layers"][i] for row in rows for i in row))
    out["layers"] = {k: v for k, v in layers.items() if v}
    return out


def _views(name: str, rows: List[List[int]], sub: PyTree):
    """(layer index, its per-layer view of the stacked tree ``sub``) for
    each layer of the group ``name``."""
    part = name.split("/")[0]
    lead = _lead(name, rows)
    for p, row in enumerate(rows):
        for j, i in enumerate(row):
            index = (p, j)[:len(lead)] if part == "scan" else (j,)[
                :len(lead)]
            yield i, tree_mod.map(lambda x: x[index], sub)


def per_layer_views(stacked: PyTree, cfg: ModelConfig) -> PyTree:
    """The port's params as views of :func:`stacked_params`' tensors: an
    in-place update of a view updates the stacked argument."""
    out = {k: v for k, v in stacked.items() if k != "layers"}
    out["layers"] = [None] * cfg.n_layers
    for name, rows in _layer_groups(cfg).items():
        part, run = name.split("/")
        for i, view in _views(name, rows, stacked["layers"][part][run]):
            out["layers"][i] = view
    return out


def layer_shards(stacked: PyTree, specs: PyTree, cfg: ModelConfig, grid
                 ) -> Tuple[PyTree, PyTree]:
    """This rank's shards of :func:`stacked_params` under ``specs`` as the
    port's per-layer params and their spec tree (``forward``'s
    ``specs``): a stacking dim cut over an axis is all-gathered first
    (the reference's rules cut the stacked dim of a 1-d leaf), every
    other dim stays as it comes."""
    out = {k: v for k, v in stacked.items() if k != "layers"}
    out_specs = {k: v for k, v in specs.items() if k != "layers"}
    out["layers"] = [None] * cfg.n_layers
    out_specs["layers"] = [None] * cfg.n_layers
    for name, rows in _layer_groups(cfg).items():
        part, run = name.split("/")
        n = len(_lead(name, rows))
        spec_t = specs["layers"][part][run]
        sub = tree_mod.map(
            lambda x, sp: sharding.unshard_leaf(x, tuple(sp[:n]), grid),
            stacked["layers"][part][run], spec_t)
        for i, view in _views(name, rows, sub):
            out["layers"][i] = view
            out_specs["layers"][i] = _map_specs(lambda sp: tuple(sp[n:]),
                                                spec_t)
    return out, out_specs


# -- cells ---------------------------------------------------------------------

@dataclasses.dataclass
class Lowered:
    """What the dry run reads of one step run on the meta arguments:
    ``flops`` (``FlopCounterMode``'s total, the whole mesh's) and the
    outputs."""

    flops: float
    outputs: Any


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    cfg: ModelConfig
    fn: Callable
    args: Tuple            # meta tensors (trees), laid out by ``specs``
    donate: Tuple[int, ...]
    microbatches: int = 1
    specs: Tuple = ()      # one spec tree per argument
    mesh: Any = None
    layout: str = "tp"
    tc: Optional[TrainConfig] = None   # a train cell's

    def lower(self) -> Lowered:
        """Run ``fn`` on the meta arguments under ``FlopCounterMode``: the
        counterpart of lowering, with no compiler to call."""
        from torch.utils.flop_counter import FlopCounterMode
        counter = FlopCounterMode(display=False)
        with counter:
            out = self.fn(*self.args)
        return Lowered(float(counter.get_total_flops()), out)


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    dt = torch.bfloat16 if x.is_floating_point() else x.dtype
    return torch.empty(x.shape, dtype=dt, device=META)


def _serve_param_sds(params_abs, pshard, mesh,
                     cfg: Optional[ModelConfig] = None):
    """Serving params: bf16 (no f32 master / optimizer state at inference)
    and -- when the TP-sharded weights fit comfortably -- replicated over
    the data axis instead of FSDP, killing the per-layer parameter
    all-gathers that otherwise dominate the decode collective term.
    Returns (params, specs)."""
    p16 = tree_mod.map(_to_bf16, params_abs)
    bytes_per_model_shard = sum(
        a.numel() * a.element_size() for a in tree_mod.leaves(p16)
    ) / mesh.shape["model"]
    # the reference's 2.5 GB replication threshold; MoE archs keep FSDP:
    # their expert tables dwarf the per-token active weights
    is_moe = cfg is not None and cfg.n_experts > 0
    if bytes_per_model_shard <= 2.5e9 and not is_moe:
        def drop_data(spec):
            return tuple(None if r == "data" or (isinstance(r, tuple)
                                                 and "data" in r) else r
                         for r in spec)
        pshard = _map_specs(drop_data, pshard)
    return p16, pshard


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v) for v in specs]
    return fn(specs)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def build_cell(arch: str, shape_name, mesh,
               tc: Optional[TrainConfig] = None,
               cfg_override: Optional[ModelConfig] = None,
               layout: str = "tp") -> Cell:
    """The cell of ``arch`` at the shape ``shape_name`` names in
    :data:`SHAPES` (or a :class:`ShapeSpec` of the caller's) on ``mesh``."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    cfg = cfg_override or configs.get(arch)
    params_abs = stacked_params(param_spec(cfg), cfg)
    pshard = param_specs(params_abs, mesh, layout)
    batch_spec = divisible_spec(("batch", None),
                                (shape.global_batch, shape.seq_len), mesh,
                                layout)

    def stepped(fn, pspecs):
        """``fn`` on the per-layer views of the stacked parameters and
        their specs, under the mesh: on a grid of ranks the arguments are
        this rank's shards under the cell's specs (:func:`layer_shards`)."""
        def run(params, *rest):
            with set_mesh(mesh, layout):
                grid = sharding.bound_grid()
                if grid is None:
                    return fn(per_layer_views(params, cfg), None, *rest)
                return fn(*layer_shards(params, pspecs, cfg, grid), *rest)
        return run

    if shape.kind == "train":
        mb = default_microbatches(cfg, shape, mesh)
        tc = tc or TrainConfig(microbatches=mb, remat="full")
        if tc.bf16_params:
            opt_abs = adamw.init(params_abs, keep_master=True)
            params_abs = tree_mod.map(_to_bf16, params_abs)
            opt_sh = _opt_shardings(pshard, mesh)
            opt_sh["master"] = pshard
        else:
            opt_abs = adamw.init(params_abs)
            opt_sh = _opt_shardings(pshard, mesh)
        batch = {"tokens": _meta((shape.global_batch, shape.seq_len),
                                 torch.int32),
                 "labels": _meta((shape.global_batch, shape.seq_len),
                                 torch.int32)}
        step = _meta((), torch.int32)
        ts = make_train_step(cfg, tc)

        def fn(params, opt_state, batch, step):
            opt = {k: v if k == "step" else per_layer_views(v, cfg)
                   for k, v in opt_state.items()}
            with set_mesh(mesh, layout):
                metrics = ts(per_layer_views(params, cfg), opt, batch,
                             step)[2]
            return params, opt_state, metrics

        return Cell(arch, shape, cfg, fn,
                    (params_abs, opt_abs, batch, step), donate=(0, 1),
                    microbatches=tc.microbatches,
                    specs=(pshard, opt_sh, {"tokens": batch_spec,
                                            "labels": batch_spec}, ()),
                    mesh=mesh, layout=layout, tc=tc)

    params_sds, pshard = _serve_param_sds(params_abs, pshard, mesh, cfg)
    if shape.kind == "prefill":
        tokens = _meta((shape.global_batch, shape.seq_len), torch.int32)
        cache_abs0 = cache_spec(cfg, shape.global_batch, shape.seq_len)
        cache_bytes0 = sum(a.numel() * a.element_size()
                           for a in tree_mod.leaves(cache_abs0)) / mesh.size
        if cache_bytes0 > 2.5e9 and cfg.kv_cache_dtype != "int8":
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")

        def prefill(params, specs, tokens):
            cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                               device=tokens.device)
            pos = make_positions(tokens, cfg)
            logits, cache, _ = forward(params, tokens, pos, cfg,
                                       cache=cache, specs=specs)
            return logits[:, -1], cache

        return Cell(arch, shape, cfg, stepped(prefill, pshard),
                    (params_sds, tokens),
                    donate=(), specs=(pshard, batch_spec), mesh=mesh,
                    layout=layout)

    # decode: one new token against a seq_len cache. If the bf16 cache
    # alone would eat most of a device's memory budget, serve with the
    # int8-quantized cache (2x saving; the reference's rule)
    cache_abs = cache_spec(cfg, shape.global_batch, shape.seq_len)
    cache_bytes = sum(a.numel() * a.element_size()
                      for a in tree_mod.leaves(cache_abs)) / mesh.size
    if cache_bytes > 2.5e9 and cfg.kv_cache_dtype != "int8":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        cache_abs = cache_spec(cfg, shape.global_batch, shape.seq_len)
    cache_sh = cache_specs(cache_abs, mesh)
    token = _meta((shape.global_batch, 1), torch.int32)
    tok_spec = divisible_spec(("batch", None), (shape.global_batch, 1),
                              mesh)
    positions = _meta((shape.global_batch,), torch.int32)
    pos_spec = divisible_spec(("batch",), (shape.global_batch,), mesh)

    def decode(params, specs, token, positions, cache):
        pos = positions[:, None]
        if cfg.mrope_sections is not None:
            pos = pos[:, None, :].expand(token.shape[0], 3, 1)
        logits, cache, _ = forward(params, token, pos, cfg, cache=cache,
                                   specs=specs)
        return logits[:, 0], cache

    return Cell(arch, shape, cfg, stepped(decode, pshard),
                (params_sds, token, positions, cache_abs), donate=(3,),
                specs=(pshard, tok_spec, pos_spec, cache_sh), mesh=mesh,
                layout=layout)


def input_specs(arch: str, shape_name: str, mesh) -> Tuple:
    """The (fn, args) pair the dry run runs: fn is the step
    (train_step / prefill_step / decode_step) and the arguments are
    meta tensors, allocation-free stand-ins laid out by the cell's
    ``specs``."""
    cell = build_cell(arch, shape_name, mesh)
    return cell.fn, cell.args
