"""Mesh-aware sharding rules (the port of ``repro.models.sharding``) and
the collectives that carry them out on a mesh of ranks.

``set_mesh(mesh)`` installs a mesh for the duration of a ``with`` block;
``resolve``, ``spec`` and ``param_specs`` map *logical* dim names onto its
axes exactly as the JAX package does, so a launcher can lay out a run with
the same rules. A mesh is the port's :class:`repro_torch.core.mesh.Mesh`
or :class:`~repro_torch.core.mesh.MeshGrid`, or any object with
``axis_names`` (else the keys of ``shape``) and a ``shape`` mapping axis
names to sizes.

Logical dims:
    "batch"  -> ("pod", "data") when the mesh has a pod axis else ("data",)
    "data"   -> FSDP/ZeRO axis
    "model"  -> tensor/expert-parallel axis
    None     -> replicated

Layouts:
    "tp"   (default) -- Megatron-style: TP+SP over "model", FSDP over
           "data", batch over (pod, data).
    "fsdp" -- ZeRO-3 only: no tensor parallelism; batch shards over every
           axis (pod, data, model) and parameters FSDP over (data, model).

A spec is a tuple with one entry per dim (an axis name, a tuple of axis
names, or None); ``spec`` with no mesh is ``()``, as ``PartitionSpec()``.

Running on a mesh. The JAX package writes the layout as annotations
(``constrain``) and GSPMD inserts the collectives. The port has no such
compiler: ``constrain`` returns its tensor unchanged, and the layers call
the layout's collectives explicitly, each a no-op where no
:class:`MeshGrid` of more than one rank is bound (so one process computes
exactly what it computed before):

* a param leaf is held as this rank's shard of the full leaf under its
  spec (:func:`shard`, :func:`unshard`); its FSDP dims (every sharded dim
  but a "model" one) are all-gathered where a layer uses it
  (:func:`gather_params`), and the gather's backward sums the gradient
  over those ranks in rank order and keeps this rank's slice (a
  reduce-scatter): FSDP;
* under "tp" with a model axis of M > 1 (:func:`model_axis`) the
  residual stream holds L / M tokens (sequence parallel): a mixer or MLP
  gathers the sequence first (:func:`seq_gather`) and reduce-scatters its
  row-parallel partial sums after (:func:`seq_scatter`); the embedding is
  a masked lookup of this rank's vocab rows reduce-scattered the same way,
  and the logits are this rank's vocab slice, reduced over ``model`` by
  the loss (:func:`all_sum`, :func:`all_max`);
* attention runs this rank's heads, or every head where the heads do not
  split over ``model`` (``models.layers``);
* the other mixers split as ``param_specs`` cuts their weights
  (``models.rglru``, ``models.ssd``, ``models.moe``): the RG-LRU and the
  SSD run on this rank's channels or heads, the MoE on this rank's
  experts (expert parallel), each handing the block a row-parallel
  partial sum to reduce-scatter;
* every reduction is an all-gather followed by a sum in rank order, so a
  replicated result is bit-equal on every rank; each names to the mesh
  the collective it stands for (``Mesh.all_gather``'s ``kind``: a
  reduce-scatter, an all-reduce), so the records of
  ``roofline.record()`` price it as that collective.

Prefill and decode with a cache (layout "tp" only). A cache on a grid is
a :class:`GridCache`: each leaf this rank's shard under
:func:`cache_specs`, the JAX package's serving layout (batch over
``data``; the KV cache's length over ``model``, so MQA's one kv head need
not split; the SSD's and RG-LRU's states by channels or heads), made by
``models.init_cache`` under the bound grid or by :func:`shard_cache`.
Where the prompt's length splits over ``model`` the stream is sequence
parallel as in training; where it does not (decode's one token, an odd
prompt) the sequence runs whole on every rank of ``model``
(:func:`seq_axis` is None): the mixers' and MLPs' row-parallel partial
sums are summed over ``model`` (:func:`all_sum`) in place of the
reduce-scatter, and so is the embedding's lookup.

Two gradient traps of tensor parallelism, and the ops that avoid them:

* a sum over ``model`` whose result every rank goes on to use for its own
  part (the SSD's gated RMSNorm: the mean square over the whole
  ``d_inner`` from each rank's channels) needs the gradient summed over
  ``model`` too (:func:`all_reduce`); :func:`all_sum` passes it through
  unchanged, which is right only where what follows is replicated (the
  loss);
* anything every rank of ``model`` computes the same from the gathered
  sequence sends the same gradient from every rank, and the sum over
  ``model`` (``seq_gather``'s backward, or the step's sum of a replicated
  leaf's gradient) counts it M times: such a term is taken over this
  rank's L / M tokens and the partials are summed (the MoE's load-balance
  loss).
"""
from __future__ import annotations

import contextlib
import types
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch import tree as tree_mod

# process-wide, not thread-local: the autograd engine runs a CUDA
# backward -- and so a checkpointed block's recompute, with its
# collectives -- on a thread of its own, which must see the bound mesh
_state = types.SimpleNamespace()


def _current_mesh():
    return getattr(_state, "mesh", None)


def _current_layout() -> str:
    return getattr(_state, "layout", "tp")


def current_layout() -> str:
    """The bound layout ("tp" unless ``set_mesh`` said otherwise)."""
    return _current_layout()


@contextlib.contextmanager
def set_mesh(mesh, layout: str = "tp"):
    prev = _current_mesh()
    prev_layout = _current_layout()
    _state.mesh = mesh
    _state.layout = layout
    try:
        yield
    finally:
        _state.mesh = prev
        _state.layout = prev_layout


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "axis_names", None)
    return tuple(mesh.shape) if names is None else tuple(names)


def resolve(dim: Optional[str], mesh, layout: Optional[str] = None):
    layout = layout or _current_layout()
    if dim is None:
        return None
    if dim == "batch":
        axes = ("pod",) if "pod" in _axis_names(mesh) else ()
        axes += ("data",)
        if layout == "fsdp":
            axes += ("model",)
        return axes
    if layout == "fsdp":
        if dim == "model":
            return None                    # no tensor parallelism
        if dim == "data":
            return ("data", "model")       # ZeRO over both axes
    return dim


def spec(*dims: Optional[str], mesh=None) -> tuple:
    mesh = mesh or _current_mesh()
    if mesh is None:
        return ()
    return tuple(resolve(d, mesh) for d in dims)


def constrain(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """Sharding constraint by logical dim names: ``x`` itself (the layers
    call the layout's collectives explicitly; see the module
    docstring)."""
    if len(dims) > x.dim():
        raise ValueError(f"{len(dims)} dims named for a {x.dim()}-d tensor")
    return x


# ---------------------------------------------------------------------------
# Parameter sharding rules
# ---------------------------------------------------------------------------

def _rule_for(path: Tuple[str, ...], shape: Tuple[int, ...]) -> Tuple:
    """Map a param path to logical dims. FSDP ("data") on one large dim, TP
    ("model") on the head/ff/vocab/expert dim."""
    name = "/".join(path)
    nd = len(shape)

    def lead(*dims):
        """Pad with None for stacked leading dims."""
        return (None,) * (nd - len(dims)) + tuple(dims)

    if name.endswith("/b") or "norm" in name or name.endswith("scale"):
        return (None,) * nd
    if "embed/table" in name or "lm_head/table" in name:
        return lead("model", "data")                     # vocab TP, d FSDP
    if "experts" in name:
        # (E, d, ff) or (E, ff, d)
        if "w_out" in name:
            return lead("model", None, "data")           # EP on E
        return lead("model", "data", None)
    if "router" in name:
        return lead("data", None)
    if any(s in name for s in ("wq/w", "wk/w", "wv/w", "w_gate/w", "w_in/w",
                               "in_proj/w", "w_x/w", "w_a/w", "w_i/w")):
        return lead("data", "model")                     # col-parallel
    if any(s in name for s in ("wo/w", "w_out/w", "out_proj/w")):
        return lead("model", "data")                     # row-parallel
    if "conv_w" in name:
        return lead(None, "model")
    if name.endswith("Lambda") or "A_log" in name or name.endswith("/D") \
            or "dt_bias" in name:
        return lead("model") if nd >= 1 else ()
    if nd >= 2:
        return lead("data", None)
    return (None,) * nd


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params: Any, mesh, layout: Optional[str] = None):
    """Spec tree matching ``params`` (nested dicts and lists whose leaves
    have a ``shape``); dims that do not divide the mesh axis fall back to
    replicated."""
    layout = layout or _current_layout()

    def one(path, leaf):
        shape = tuple(leaf.shape)
        dims = _rule_for(path, shape)
        fixed = []
        for d, size in zip(dims, shape):
            r = resolve(d, mesh, layout)
            ax = (r,) if isinstance(r, str) else (r or ())
            total = 1
            for nm in ax:
                total *= mesh.shape[nm]
            fixed.append(d if size % max(total, 1) == 0 else None)
        return tuple(resolve(d, mesh, layout) for d in fixed)

    return _map_with_path(one, params)


# ---------------------------------------------------------------------------
# Cache sharding rule
# ---------------------------------------------------------------------------

def ways(entry, mesh) -> int:
    """How many ways one spec entry (an axis name, a tuple of them or
    None) cuts its dim."""
    names = (entry,) if isinstance(entry, str) else tuple(entry or ())
    out = 1
    for nm in names:
        out *= mesh.shape[nm]
    return out


def divisible_spec(dims, shape, mesh, layout: str = "tp") -> tuple:
    """The spec of logical ``dims`` on ``shape``: a dim that is cut fewer
    than two ways, or that its axes do not divide, stays whole."""
    fixed = []
    for d, size in zip(dims, shape):
        r = resolve(d, mesh, layout)
        total = ways(r, mesh)
        fixed.append(r if total > 1 and size % total == 0 else None)
    return tuple(fixed)


def shard_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The per-rank shape of a ``shape`` laid out by ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for n, entry in zip(shape, spec):
        w = ways(entry, mesh)
        if n % w:
            raise ValueError(f"dim {n} does not split {w} ways ({spec})")
        out.append(n // w)
    return tuple(out)


# the cache leaves' logical dims, by leaf name, on their trailing dims
_CACHE_DIMS = {
    "k": ("data", "model", None, None),          # (B, S, KV, hd)
    "v": ("data", "model", None, None),
    "k_scale": ("data", "model", None),          # (B, S, KV)
    "v_scale": ("data", "model", None),
    "pos": ("data", "model"),                    # (B, S)
    "conv": ("data", None, "model"),             # (B, K - 1, C)
    "ssm": ("data", "model", None, None),        # (B, H, hd, N)
    "h": ("data", "model"),                      # (B, W)
}


def cache_specs(cache, mesh):
    """The spec tree of a (full) cache: KV caches batch over ``data`` and
    *length over model* (the flash-decode layout: it works for MQA, whose
    heads cannot split); the SSD's and RG-LRU's states batch over
    ``data`` and heads / channels over ``model``. A dim its axis does not
    divide stays whole (:func:`divisible_spec`)."""

    def one(path, leaf):
        nd = len(leaf.shape)
        d = _CACHE_DIMS.get(path[-1], ())
        d = (None,) * (nd - len(d)) + d
        return divisible_spec(d, leaf.shape, mesh)

    return _map_with_path(one, list(cache) if isinstance(cache, list)
                          else cache)


class GridCache(list):
    """A cache on a grid of ranks: one dict per layer, as ``init_cache``
    gives it, each leaf this rank's shard under ``specs`` (the
    :func:`cache_specs` of the full cache, which tell the layers whether
    a KV cache's length is cut)."""

    def __init__(self, layers=(), specs=None):
        super().__init__(layers)
        self.specs = specs


def length_cut(cache, i: int) -> bool:
    """Whether layer ``i``'s KV cache has its length cut over ``model``;
    raises for a cache on a tensor-parallel grid that is not a
    :class:`GridCache`."""
    specs = getattr(cache, "specs", None)
    if specs is None:
        raise ValueError("a cache under tensor parallelism is a "
                         "sharding.GridCache: made by init_cache under the "
                         "bound grid, or by shard_cache")
    pos = specs[i].get("pos")
    return pos is not None and pos[1] is not None


def shard_cache(cache, grid=None) -> "GridCache":
    """This rank's shard of every leaf of the full ``cache`` under
    :func:`cache_specs`."""
    grid = grid or bound_grid()
    specs = cache_specs(cache, grid)
    return GridCache(shard(list(cache), specs, grid), specs)


def unshard_cache(cache: "GridCache", grid=None) -> list:
    """The full cache from every rank's shards (collective: every rank
    calls it)."""
    return unshard(list(cache), cache.specs, grid or bound_grid())


# ---------------------------------------------------------------------------
# Running on a mesh of ranks
# ---------------------------------------------------------------------------

def bound_grid():
    """The bound mesh if it is a grid of ranks (``MeshGrid``) with more
    than one rank, else None."""
    mesh = _current_mesh()
    if mesh is None or getattr(mesh, "world", None) is None \
            or mesh.world.size == 1:
        return None
    return mesh


def axis_of(grid, entry):
    """The ``core.mesh.Mesh`` of a spec entry: one axis by name, the
    grid's axes jointly (``world``), or any other run of them in the
    grid's order (``grid.joint``, e.g. ("pod", "data"))."""
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    if len(names) == 1:
        return grid.axes[names[0]]
    if names == tuple(grid.axis_names):
        return grid.world
    joint = grid.joint.get(names)
    if joint is None:
        raise ValueError(f"axes {names} are not a run of the grid's "
                         f"{grid.axis_names}")
    return joint


def model_axis():
    """The tensor-parallel axis: ``model`` under "tp" with more than one
    rank on it, else None."""
    grid = bound_grid()
    if grid is None or _current_layout() != "tp":
        return None
    ax = grid.axes.get("model")
    return ax if ax is not None and ax.size > 1 else None


def batch_axis():
    """The axis the batch rows are split over (``resolve("batch")``), or
    None without a grid."""
    grid = bound_grid()
    return None if grid is None else axis_of(grid, resolve("batch", grid))


def batch_rows(batch: int, microbatches: int = 1):
    """This rank's rows of a global batch of ``batch`` rows taken in
    ``microbatches`` microbatches: rank d of D holds rows d B / (D n) ..
    (d + 1) B / (D n) of each microbatch (rows i B / n .. (i + 1) B / n),
    in microbatch order, so that the i-th of its own microbatches is its
    share of the global i-th. A slice where the rows are contiguous, else
    a list of row indices."""
    ax = batch_axis()
    if ax is None:
        return slice(0, batch)
    if batch % (ax.size * microbatches):
        raise ValueError(f"batch {batch} does not split over {ax.size} "
                         f"ranks in {microbatches} microbatches")
    n = batch // (ax.size * microbatches)
    if microbatches == 1:
        return slice(ax.rank * n, (ax.rank + 1) * n)
    per_mb = batch // microbatches
    return [i * per_mb + ax.rank * n + j for i in range(microbatches)
            for j in range(n)]


def check_model(cfg, model_ways: int, seq_len: Optional[int] = None,
                layout: str = "tp") -> None:
    """Raise ValueError where ``cfg`` cannot run with tensor parallelism
    over ``model_ways`` ranks, naming the width that does not split: a
    dense MLP's ``d_ff``, the padded vocab, the sequence (``seq_len``;
    None where it runs whole on every rank, as a forward with a cache
    runs a length that does not split), the SSD heads (``ssm_nheads``)
    and the RG-LRU width (``lru_width``). Attention heads that do not
    split run whole on every rank (``models.layers``), and experts that
    do not split stay whole on every rank (``param_specs``)."""
    if layout != "tp" or model_ways == 1:
        return
    kinds = set(cfg.pattern)
    attn = bool(kinds & {"attn", "local"})
    dense_mlp = cfg.d_ff > 0 and (
        (attn and not cfg.n_experts) or "rglru" in kinds)
    for what, n in (("d_ff", cfg.d_ff if dense_mlp else None),
                    ("ssm_nheads", cfg.ssm_nheads if "ssd" in kinds
                     else None),
                    ("lru_width", cfg.lru_width if "rglru" in kinds
                     else None),
                    ("padded vocab", cfg.vocab_padded),
                    ("sequence", seq_len)):
        if n is not None and n % model_ways:
            raise ValueError(f"{cfg.name}: {what} {n} does not split over "
                             f"a model axis of {model_ways}")


# -- collectives with their gradients -----------------------------------------

def _cat(stacked: torch.Tensor, dim: int) -> torch.Tensor:
    """(n, *shape) -> the n pieces concatenated along ``dim``."""
    return torch.cat(stacked.unbind(0), dim)


def _reduce_slice(ax, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` summed in rank order, this rank's slice along
    ``dim`` (a reduce-scatter)."""
    n = x.shape[dim] // ax.size
    got = ax.all_gather(x, kind="reduce-scatter")
    return got.narrow(dim + 1, ax.rank * n, n).sum(0)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _cat(ax.all_gather(x), dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_slice(ctx.ax, g, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _reduce_slice(ax, x, dim)

    @staticmethod
    def backward(ctx, g):
        return _cat(ctx.ax.all_gather(g), ctx.dim), None, None


class _AllSum(torch.autograd.Function):
    """Forward the sum over the axis; backward the gradient unchanged:
    what follows is replicated over the axis, so each rank's gradient is
    already the whole one for its own summand."""

    @staticmethod
    def forward(ctx, x, ax):
        return ax.all_gather(x, kind="all-reduce").sum(0)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    """Forward the sum over the axis; backward the gradient summed over
    it too: every rank goes on with the sum for its own part, so each
    summand reaches every rank's loss term."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return ax.all_gather(x, kind="all-reduce").sum(0)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.all_gather(g, kind="all-reduce").sum(0), None


def gather(x: torch.Tensor, ax, dim: int) -> torch.Tensor:
    """All-gather ``x`` over ``ax`` along ``dim``; the gradient is summed
    over ``ax`` and sliced back (reduce-scatter)."""
    return _Gather.apply(x, ax, dim % x.dim())


def scatter(x: torch.Tensor, ax, dim: int) -> torch.Tensor:
    """Sum the partial ``x`` over ``ax`` and keep this rank's slice along
    ``dim`` (reduce-scatter); the gradient is all-gathered."""
    return _Scatter.apply(x, ax, dim % x.dim())


def all_sum(x: torch.Tensor, ax) -> torch.Tensor:
    return _AllSum.apply(x, ax)


def all_reduce(x: torch.Tensor, ax) -> torch.Tensor:
    """The sum of ``x`` over ``ax`` where each rank uses it for a part of
    its own (the gradient is summed over ``ax`` as well)."""
    return _AllReduce.apply(x, ax)


def all_max(x: torch.Tensor, ax) -> torch.Tensor:
    """The elementwise max over ``ax`` (no gradient)."""
    return ax.all_gather(x.detach(), kind="all-reduce").amax(0)


@contextlib.contextmanager
def whole_sequence(whole: bool = True):
    """Within the block the residual stream holds the whole sequence on
    every rank of ``model`` (``forward`` with a cache whose length does
    not split), not L / M tokens."""
    prev = getattr(_state, "whole", False)
    _state.whole = whole
    try:
        yield
    finally:
        _state.whole = prev


def seq_axis():
    """The axis the residual stream's sequence is cut over: the model
    axis under sequence parallelism, None without tensor parallelism or
    where the sequence runs whole (:func:`whole_sequence`)."""
    return None if getattr(_state, "whole", False) else model_axis()


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """(B, L / M, ...) -> (B, L, ...) under sequence parallelism, else
    ``x``."""
    ax = seq_axis()
    return x if ax is None else gather(x, ax, 1)


def seq_scatter(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel layer's partial (B, L, ...) -> the sum's (B, L / M,
    ...) in ``dtype`` under sequence parallelism, the whole sum (B, L,
    ...) where the sequence runs whole, else ``x``."""
    ax = model_axis()
    if ax is None:
        return x
    if seq_axis() is None:
        return all_sum(x, ax).to(dtype)
    return scatter(x, ax, 1).to(dtype)


def local_slice(x: torch.Tensor, n: int) -> torch.Tensor:
    """This model rank's ``n`` entries of the last dim of a leaf that is
    replicated over ``model`` but used beside column-parallel outputs of
    width ``n`` (a bias); ``x`` itself where it is ``n`` wide."""
    if x.shape[-1] == n:
        return x
    ax = model_axis()
    return x.narrow(-1, ax.rank * n, n)


# -- param trees ---------------------------------------------------------------

def _sharded_dims(spec_: tuple, fsdp_only: bool):
    """(dim, entry) of each sharded dim; with ``fsdp_only`` without the
    tensor-parallel ("model") ones, which stay local."""
    return [(d, e) for d, e in enumerate(spec_) if e is not None
            and not (fsdp_only and e == "model")]


def shard_leaf(x: torch.Tensor, spec_: tuple, grid) -> torch.Tensor:
    """This rank's slice of the full ``x`` (a view): along a dim sharded
    over several axes, the first is the major one."""
    for dim, entry in _sharded_dims(spec_, False):
        ax = axis_of(grid, entry)
        n = x.shape[dim] // ax.size
        x = x.narrow(dim, ax.rank * n, n)
    return x


def _specs_leaves(tree, specs):
    """``specs``' leaves (tuples) beside ``tree``'s."""
    flat, sp = tree_mod.leaves(tree), spec_leaves(specs)
    if len(sp) != len(flat):
        raise ValueError(f"{len(sp)} specs for {len(flat)} leaves")
    return flat, sp


def spec_leaves(specs) -> list:
    """A spec tree's specs in flattening order: a spec is a tuple, so the
    tree's nodes are dicts and lists only."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def cut_axes(spec_: tuple, fsdp_only: bool = False) -> set:
    """The axis names a leaf is cut over; with ``fsdp_only`` the ones its
    FSDP dims are cut over (not a tensor-parallel "model" dim)."""
    return {a for _, e in _sharded_dims(spec_, fsdp_only)
            for a in ((e,) if isinstance(e, str) else e)}


def shard(tree, specs, grid=None):
    """This rank's shard of every leaf of the full ``tree`` under
    ``specs`` (contiguous copies, so the full leaves can be freed); the
    tree itself without a grid."""
    grid = grid or bound_grid()
    if grid is None:
        return tree
    flat, sp = _specs_leaves(tree, specs)
    return tree_mod.unflatten(tree, [shard_leaf(x, s, grid).clone()
                                     for x, s in zip(flat, sp)])


def unshard_leaf(x: torch.Tensor, spec_: tuple, grid=None) -> torch.Tensor:
    """The full leaf from every rank's shard ``x`` (collective: every
    rank calls it)."""
    grid = grid or bound_grid()
    # the innermost entry of the cut first: the last cut, the first undone
    for dim, entry in reversed(_sharded_dims(spec_, False)):
        ax = axis_of(grid, entry)
        if ax.size > 1:
            x = _cat(ax.all_gather(x), dim)
    return x


def unshard(tree, specs, grid=None, to=None):
    """The full tree from every rank's shards, leaf by leaf (moved to
    ``to`` as each is gathered, so one full leaf at a time stays on the
    shards' device); the tree itself without a grid."""
    grid = grid or bound_grid()
    if grid is None:
        return tree
    flat, sp = _specs_leaves(tree, specs)
    out = []
    for x, s in zip(flat, sp):
        full = unshard_leaf(x, s, grid)
        out.append(full if to is None else full.to(to))
    return tree_mod.unflatten(tree, out)


def gather_params(tree, specs):
    """``tree`` (this rank's shards) with every FSDP dim gathered, the
    tensor-parallel ones kept local; the gradient comes back
    reduce-scattered. ``tree`` itself without a grid or specs."""
    grid = bound_grid()
    if grid is None or specs is None:
        return tree
    flat, sp = _specs_leaves(tree, specs)
    out = []
    for x, s in zip(flat, sp):
        for dim, entry in reversed(_sharded_dims(s, True)):
            ax = axis_of(grid, entry)
            if ax.size > 1:
                x = gather(x, ax, dim)
        out.append(x)
    return tree_mod.unflatten(tree, out)
