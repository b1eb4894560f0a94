"""Centralized *weighted* clustering primitives (the port of
``repro.core.clustering``).

Used by Round 1's local solves (Algorithm 1) and by the final solve on the
coreset (Algorithm 2). Every function supports per-point weights -- the
coreset is a signed weighted instance. The hot loops dispatch through the
backend registry (:mod:`repro_torch.core.backend`) and the objective
registry (:mod:`repro_torch.core.objective`).

The batched helpers (``_kmeans_pp_init``, ``_lloyd``) carry a leading site
axis written out -- the JAX package runs them under ``jax.vmap`` -- so each
seeding or Lloyd step is one backend call (one kernel launch) for all
sites. Keys are explicit :mod:`repro_torch.core.prng` keys, batched the
same way. The public functions place their inputs with
:func:`~repro_torch.core.backend.resolve_device`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import objective as objective_mod
from repro_torch.core import prng
from repro_torch.core.backend import BackendLike, DeviceLike, as_tensor
from repro_torch.core.objective import ObjectiveLike

_TINY = 1e-30


def _inputs(device: DeviceLike, points, *rest):
    """Resolve the device and place ``points`` and the optional ``rest``
    (``None`` passes through) on it."""
    dev = backend_mod.resolve_device(device)
    out = [as_tensor(points, dev)]
    out += [None if x is None else as_tensor(x, dev) for x in rest]
    return dev, out


def min_dist_argmin(points, centers, backend: BackendLike = None,
                    device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min squared distance and argmin center per point, via the dispatch
    layer (leading site axis optional)."""
    dev, (points, centers) = _inputs(device, points, centers)
    return backend_mod.get_backend(backend, dev).min_dist_argmin(points,
                                                                 centers)


def lloyd_stats(points, centers, weights=None, backend: BackendLike = None,
                device: DeviceLike = None):
    """Fused weighted Lloyd statistics (sums, counts, cost) via the
    dispatch layer."""
    dev, (points, centers, weights) = _inputs(device, points, centers,
                                              weights)
    return backend_mod.get_backend(backend, dev).lloyd_stats(
        points, centers, weights)


def cost(points, centers, weights=None, objective: ObjectiveLike = "kmeans",
         backend: BackendLike = None, device: DeviceLike = None
         ) -> torch.Tensor:
    """Weighted clustering cost: sum_p w_p d(p, X)^z (per site when the
    inputs carry a leading site axis)."""
    dev, (points, centers, weights) = _inputs(device, points, centers,
                                              weights)
    obj = objective_mod.get_objective(objective)
    per_point, _ = obj.costs(backend_mod.get_backend(backend, dev), points,
                             centers, weights)
    if weights is not None:
        per_point = per_point * weights
    return per_point.sum(-1)


def point_costs(points, centers, objective: ObjectiveLike = "kmeans",
                backend: BackendLike = None, weights=None,
                device: DeviceLike = None):
    """Per-point (unweighted) cost to the nearest center, and the
    assignment."""
    dev, (points, centers, weights) = _inputs(device, points, centers,
                                              weights)
    obj = objective_mod.get_objective(objective)
    return obj.costs(backend_mod.get_backend(backend, dev), points, centers,
                     weights)


def _masked_choice(keys: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
    """Categorical draw proportional to ``mass`` (one per key), row 0 when
    the total mass is zero -- a fully masked site, or every remaining point
    on a chosen center, must draw deterministically, not by accident of
    the key."""
    idx = prng.categorical(keys, torch.log(mass + _TINY))
    return torch.where(mass.sum(-1) > 0.0, idx, 0)


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (S, n, d), idx (S,) -> (S, d)."""
    return points[torch.arange(points.shape[0], device=points.device), idx]


def _kmeans_pp_init(keys: torch.Tensor, points: torch.Tensor,
                    weights: torch.Tensor, k: int, obj, b) -> torch.Tensor:
    """D^z seeding for S sites at once: keys (S, 2), points (S, n, d),
    weights (S, n) -> centers (S, k, d)."""
    S, n, d = points.shape
    w = torch.clamp_min(weights, 0.0)

    def dist_to(c):
        # D^z of every point to one candidate center per site
        return obj.clamped_cost(b.min_dist_argmin(points, c[:, None, :])[0])

    split = prng.split(keys)
    key, k0 = split[:, 0], split[:, 1]
    first = _masked_choice(k0, w)
    centers = points.new_zeros((S, k, d))
    c = _gather_rows(points, first)
    centers[:, 0] = c
    mind = dist_to(c)
    for i in range(1, k):
        split = prng.split(key)
        key, ki = split[:, 0], split[:, 1]
        c = _gather_rows(points, _masked_choice(ki, obj.seeding(w, mind)))
        centers[:, i] = c
        mind = torch.minimum(mind, dist_to(c))
    return centers


def _ones(points: torch.Tensor) -> torch.Tensor:
    return points.new_ones(points.shape[:-1])


def kmeans_pp_init(key, points, k: int, weights=None,
                   objective: ObjectiveLike = "kmeans",
                   backend: BackendLike = None,
                   device: DeviceLike = None) -> torch.Tensor:
    """D^z seeding (k-means++ for z = 2, k-median++ for z = 1) with
    optional weights: weight-0 padding is never selected. ``key`` is a (2,)
    key; returns (k, d)."""
    dev, (points, weights, key) = _inputs(device, points, weights, key)
    w = _ones(points) if weights is None else weights
    obj = objective_mod.get_objective(objective)
    return _kmeans_pp_init(key[None], points[None], w[None], k, obj,
                           backend_mod.get_backend(backend, dev))[0]


def _lloyd(points: torch.Tensor, centers: torch.Tensor,
           weights: torch.Tensor, iters: int, obj, b
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` center updates (the JAX package's ``lax.scan``); returns
    (centers, cost history (..., iters))."""
    hist = []
    for _ in range(iters):
        centers, c = obj.update(b, points, weights, centers)
        hist.append(c)
    return centers, torch.stack(hist, -1)


def lloyd(points, centers, weights=None, iters: int = 10,
          objective: ObjectiveLike = "kmeans", backend: BackendLike = None,
          device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted center-update iterations in the objective's metric (Lloyd
    steps for k-means, fused Weiszfeld passes for k-median). Returns
    (centers, cost_history (iters,)).

    Handles negative weights (signed coreset measures): clusters whose
    total weight is <= eps keep their previous center."""
    dev, (points, centers, weights) = _inputs(device, points, centers,
                                              weights)
    w = _ones(points) if weights is None else weights
    return _lloyd(points, centers, w, iters,
                  objective_mod.get_objective(objective),
                  backend_mod.get_backend(backend, dev))


def solve(key, points, k: int, weights=None, lloyd_iters: int = 10,
          objective: ObjectiveLike = "kmeans", restarts: int = 1,
          backend: BackendLike = None, device: DeviceLike = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Constant-approximation solver: D^z seeding + Lloyd (k-means) or
    Weiszfeld (k-median) refinement, best of ``restarts`` seedings by the
    objective's own cost (the first on ties). This is ``A_alpha`` of
    Algorithm 2 and the centralized baseline. Returns (centers (k, d),
    cost)."""
    dev, (points, weights, key) = _inputs(device, points, weights, key)
    obj = objective_mod.get_objective(objective)
    b = backend_mod.get_backend(backend, dev)
    w = _ones(points) if weights is None else weights

    def one(ki):
        centers = _kmeans_pp_init(ki[None], points[None], w[None], k, obj,
                                  b)[0]
        centers, _ = _lloyd(points, centers, w, lloyd_iters, obj, b)
        per_point, _ = obj.costs(b, points, centers, weights)
        if weights is not None:
            per_point = per_point * weights
        return centers, per_point.sum()

    if restarts == 1:
        return one(key)
    runs = [one(ki) for ki in prng.split(key, restarts)]
    costs = torch.stack([c for _, c in runs])
    best = int(torch.argmin(costs))
    return runs[best]
