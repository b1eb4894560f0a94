"""Mesh-aware sharding rules (the port of ``repro.models.sharding``).

``set_mesh(mesh)`` installs a mesh for the duration of a ``with`` block;
``resolve``, ``spec`` and ``param_specs`` map *logical* dim names onto its
axes exactly as the JAX package does, so a launcher can lay out a run with
the same rules. A mesh is the port's :class:`repro_torch.core.mesh.Mesh`
or any object with ``axis_names`` (else the keys of ``shape``) and a
``shape`` mapping axis names to sizes.

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
``constrain`` returns its tensor unchanged: the port has no compiler that
places tensors by annotation, and each rank of a ``Mesh`` runs the whole
model, so on one card and on a mesh alike there is nothing to constrain.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Tuple

import torch

_state = threading.local()


def _current_mesh():
    return getattr(_state, "mesh", None)


def _current_layout() -> str:
    return getattr(_state, "layout", "tp")


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
    """Sharding constraint by logical dim names: ``x`` itself (see the
    module docstring)."""
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
