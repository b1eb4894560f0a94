"""Clustering-backend dispatch layer (the port of ``repro.core.backend``).

Every hot path of the pipeline -- Round 1's local solves, D^z seeding,
sensitivities and the final coreset solve, for k-means and k-median -- and
the serving tier reduce to four primitive ops over a (possibly weighted,
possibly site-batched) point set:

* ``min_dist_argmin(points, centers)``
    ``(..., n, d), (..., k, d) -> (min_d2 (..., n) f32, argmin (..., n) i32)``
* ``min_dist_argmin_batched(queries, centers)``
    ``(T, m, d), (T, k, d) -> ((T, m) f32, (T, m) i32)``: tenant t's
    queries against tenant t's centres only (the serving tier's fused
    dispatch; DESIGN.md Sec. 13)
* ``lloyd_stats(points, centers, weights)``
    ``(..., n, d), (..., k, d), (..., n) -> (sums (..., k, d) f32,
    counts (..., k) f32, cost (...) f32)``
* ``weiszfeld_stats(points, centers, weights)``
    ``(..., n, d), (..., k, d), (..., n) -> (nums (..., k, d) f32,
    denoms (..., k) f32, cost (...) f32)`` (the k-median step; DESIGN.md
    Sec. 10)

A leading site axis is served by one call (one kernel launch), which is
what ``jax.vmap`` over sites made of the JAX package's ``pallas_call``.
:func:`query_assignments` and :func:`query_assignments_batched` are the
serving entry points on top of them.

Registered backends:

* ``"torch"`` -- the plain PyTorch versions (:mod:`repro_torch.kernels.ref`),
  dense (n, k) distances, on whatever device the tensors are;
* ``"cuda"``  -- the hand-written CUDA kernels through
  :mod:`repro_torch.kernels.ops` (their plain versions for CPU tensors).

Selection precedence: explicit argument (name or instance) > ambient
default set by :func:`use_backend` > auto-detection from the data's device
(``"cuda"`` for CUDA tensors, ``"torch"`` for CPU tensors).

Entry points place their inputs with :func:`resolve_device`: on the GPU
unless the caller asks for the CPU, and never on the CPU by accident.
"""
from __future__ import annotations

import threading
from typing import (Dict, Optional, Protocol, Tuple, Union,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core import objective as objective_mod
from repro_torch.core.objective import ObjectiveLike
from repro_torch.kernels import ops, ref

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.
    With no GPU and no explicit device this raises instead of quietly
    running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` (numpy array, tensor or number) as a tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    return torch.as_tensor(x, device=device)


@runtime_checkable
class ClusteringBackend(Protocol):
    """The primitive ops every numerical path dispatches through."""

    name: str

    def min_dist_argmin(self, points: torch.Tensor, centers: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        ...

    def min_dist_argmin_batched(self, queries: torch.Tensor,
                                centers: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        ...

    def lloyd_stats(self, points: torch.Tensor, centers: torch.Tensor,
                    weights: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        ...

    def weiszfeld_stats(self, points: torch.Tensor, centers: torch.Tensor,
                        weights: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        ...


BackendLike = Union[str, ClusteringBackend, None]


class TorchBackend:
    """Dense plain-PyTorch formulation d^2 = |p|^2 + |c|^2 - 2 p.c."""

    name = "torch"

    def min_dist_argmin(self, points, centers):
        return ref.min_dist_argmin_ref(points, centers)

    def min_dist_argmin_batched(self, queries, centers):
        return ref.min_dist_argmin_batched_ref(queries, centers)

    def lloyd_stats(self, points, centers, weights=None):
        return ref.lloyd_stats_ref(points, centers, weights)

    def weiszfeld_stats(self, points, centers, weights=None):
        return ref.weiszfeld_stats_ref(points, centers, weights)


class CudaBackend:
    """The hand-written CUDA kernels (plain versions for CPU tensors)."""

    name = "cuda"

    def min_dist_argmin(self, points, centers):
        return ops.min_dist_argmin(points, centers)

    def min_dist_argmin_batched(self, queries, centers):
        return ops.min_dist_argmin_batched(queries, centers)

    def lloyd_stats(self, points, centers, weights=None):
        return ops.lloyd_stats(points, centers, weights)

    def weiszfeld_stats(self, points, centers, weights=None):
        return ops.weiszfeld_stats(points, centers, weights)


_REGISTRY: Dict[str, ClusteringBackend] = {}
_local = threading.local()


def register_backend(backend: ClusteringBackend, name: Optional[str] = None
                     ) -> ClusteringBackend:
    """Add a backend instance to the registry (overriding a name is
    allowed here, explicitly)."""
    _REGISTRY[name or backend.name] = backend
    return backend


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_backend(TorchBackend())
register_backend(CudaBackend())


def _auto_name(device: DeviceLike) -> str:
    """The kernels for CUDA data; the plain versions for CPU data."""
    return "cuda" if torch.device(device or "cpu").type == "cuda" else "torch"


def default_backend_name(device: DeviceLike = None) -> str:
    name = getattr(_local, "default", None)
    return name if name is not None else _auto_name(device)


def resolve_name(backend: BackendLike, device: DeviceLike = None) -> str:
    """Resolve a selection to a registry name; ``None`` is the ambient
    default, or else the auto-detected backend for data on ``device``."""
    if backend is None:
        return default_backend_name(device)
    if isinstance(backend, str):
        if backend not in _REGISTRY:
            raise KeyError(
                f"unknown clustering backend {backend!r}; "
                f"available: {available_backends()}")
        return backend
    name = getattr(backend, "name", None)
    if not name:
        raise TypeError(f"backend must be a name or ClusteringBackend, got "
                        f"{type(backend).__name__}")
    existing = _REGISTRY.get(name)
    if existing is None:
        register_backend(backend, name)
    elif existing is not backend:
        # never silently shadow: a second instance under a registered name
        # would be resolved to the first one and silently ignored
        raise ValueError(
            f"a different backend is already registered as {name!r}; give "
            f"this instance a unique .name or call register_backend() "
            f"explicitly to override")
    return name


def get_backend(backend: BackendLike = None, device: DeviceLike = None
                ) -> ClusteringBackend:
    """Resolve a selection to a backend instance."""
    if backend is not None and not isinstance(backend, str):
        resolve_name(backend)  # validate + register
        return backend
    return _REGISTRY[resolve_name(backend, device)]


def query_assignments(points, centers, objective: ObjectiveLike = "kmeans",
                      backend: BackendLike = None, device: DeviceLike = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest centre and distance per query point, ``(n, d), (k, d) ->
    (assign (n,) i32, dist (n,) f32)``: one ``min_dist_argmin`` pass, the
    distance in the objective's metric (squared for k-means, euclidean
    for k-median)."""
    dev = resolve_device(device)
    points, centers = as_tensor(points, dev), as_tensor(centers, dev)
    d2, assign = get_backend(backend, dev).min_dist_argmin(points, centers)
    return assign, objective_mod.get_objective(objective).clamped_cost(d2)


def query_assignments_batched(queries, centers, center_mask=None,
                              objective: ObjectiveLike = "kmeans",
                              backend: BackendLike = None,
                              device: DeviceLike = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked tenants, ``(T, m, d), (T, k, d)[, (T, k) bool] -> (assign
    (T, m) i32, dist (T, m) f32)`` in one dispatch (one launch of the
    batched kernel on the card): the multi-tenant serving hot path of
    :mod:`repro_torch.serve.cluster` (DESIGN.md Sec. 13).

    Masking contract: ragged tenants are stacked into the common buffer
    and described by ``center_mask`` (True = live row). Masked rows are
    replaced with ``CENTER_SENTINEL`` here, before dispatch, the same way
    for every backend, so they never win and every backend sees the same
    operands. Padded query rows are the caller's to slice off."""
    dev = resolve_device(device)
    queries, centers = as_tensor(queries, dev), as_tensor(centers, dev)
    if center_mask is not None:
        mask = as_tensor(center_mask, dev)
        centers = torch.where(mask.unsqueeze(-1), centers,
                              ref.CENTER_SENTINEL)
    d2, assign = get_backend(backend, dev).min_dist_argmin_batched(queries,
                                                                   centers)
    return assign, objective_mod.get_objective(objective).clamped_cost(d2)


_UNSET = object()


class use_backend:
    """Set the ambient default backend.

    Works both as a plain call (``use_backend("torch")`` -- sticky) and as
    a context manager (restores the previous default on exit)::

        with use_backend("torch"):
            lloyd(points, centers)          # runs the plain versions

    The restorable mutation lives in ``__enter__``, not ``__init__``: each
    entry captures the default *at entry time* and restores exactly that on
    exit, so a stored instance can be (re-)entered later -- even nested
    inside other contexts -- without restoring a stale snapshot. The
    ``__init__`` sticky set (the plain-call contract) records the
    pre-construction default; the first entry immediately following
    construction consumes it, so ``with use_backend(...)`` restores the
    default from *before* the expression ran. ``__exit__`` without a
    matching ``__enter__`` is a no-op.
    """

    def __init__(self, backend: BackendLike):
        self._name = resolve_name(backend)
        self._pending = getattr(_local, "default", None)
        self._stack = []
        _local.default = self._name

    def __enter__(self) -> ClusteringBackend:
        cur = getattr(_local, "default", None)
        if self._pending is not _UNSET and cur == self._name:
            prev = self._pending
        else:
            prev = cur
        self._pending = _UNSET
        self._stack.append(prev)
        _local.default = self._name
        return get_backend(self._name)

    def __exit__(self, *exc) -> bool:
        if self._stack:
            _local.default = self._stack.pop()
        return False
