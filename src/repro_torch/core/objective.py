"""Clustering objectives (the port of ``repro.core.objective``).

An :class:`Objective` is the per-point cost and center-update contract the
coreset recipe needs, as a frozen descriptor whose hooks take the
descriptor first; the registry maps canonical names to instances. Every
hook is shape-generic over a leading site axis.

The registry holds the paper's two objectives, ``"kmeans"`` (z = 2: Lloyd
steps on the fused ``lloyd_stats``) and ``"kmedian"`` (z = 1: fused
Weiszfeld passes on ``weiszfeld_stats``). The JAX package's other
objectives (``"kmeans_trimmed(<t>)"``, ``"power(<z>)"``) are not ported yet
and raise a clear error instead of mis-dispatching.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional, Tuple, Union

import torch

_EPS = 1e-12

# Weiszfeld refinement passes per k-median update step (the fused
# assign + refine composition of DESIGN.md Sec. 10)
WEISZFELD_ITERS = 4


def _pow_point_cost(obj: "Objective", d2: torch.Tensor) -> torch.Tensor:
    """d2 -> per-point cost in the (k, z) metric: d2 itself for z = 2,
    ``sqrt(d2)`` for z = 1 -- exact, never a ``pow``."""
    return d2 if obj.power_z == 2.0 else torch.sqrt(d2)


def _plain_point_costs(obj, b, points, centers, weights):
    d2, assign = b.min_dist_argmin(points, centers)
    return obj.point_cost(obj, d2), assign


def _ratio_or_keep(nums, denoms, centers) -> torch.Tensor:
    """``nums / denoms`` per cluster; clusters with ``denoms <= eps`` keep
    their centre (signed coreset weights can leave a cluster with no mass)."""
    keep = denoms > _EPS
    new = nums / torch.where(keep, denoms, 1.0).unsqueeze(-1)
    new = torch.where(keep.unsqueeze(-1), new, centers.float())
    return new.to(centers.dtype)


def _kmeans_update_stats(obj, b, points, weights, centers
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One weighted Lloyd step: a single fused statistics pass through the
    backend's ``lloyd_stats``; clusters with total weight <= eps keep their
    previous center."""
    sums, counts, c = b.lloyd_stats(points, centers, weights)
    return _ratio_or_keep(sums, counts, centers), c


def _weiszfeld_update_stats(obj, b, points, weights, centers
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One weighted k-median step: ``WEISZFELD_ITERS`` fused passes through
    the backend's ``weiszfeld_stats``, each assigning every point to its
    nearest centre and taking one Weiszfeld step per cluster (both
    non-increasing in k-median cost). Clusters with ``denoms <= eps`` keep
    their centre. The cost returned is the first pass's: the signed
    assignment cost at the incoming centres, as the k-means step's."""

    def wstep(y):
        nums, denoms, c = b.weiszfeld_stats(points, y, weights)
        return _ratio_or_keep(nums, denoms, y), c

    new, c = wstep(centers)
    for _ in range(1, WEISZFELD_ITERS):
        new = wstep(new)[0]
    return new, c


def _plain_sensitivities(obj, b, points, centers, weights):
    """The paper's m_p = |w_p| * cost(p, B), weights passed through."""
    c, assign = obj.point_costs(obj, b, points, centers, weights)
    return weights.abs() * c, assign, weights


def _plain_seeding_mass(obj, w, mind):
    return w * mind


@dataclasses.dataclass(frozen=True)
class Objective:
    """A registered (k, z) clustering objective (frozen and hashable).
    ``power_z`` is 2 (k-means) or 1 (k-median); the update defaults to the
    fused step of that z."""

    name: str
    power_z: float = 2.0
    point_cost: Callable = _pow_point_cost
    update_stats: Optional[Callable] = None
    point_costs: Callable = _plain_point_costs
    sensitivity_rule: Callable = _plain_sensitivities
    seeding_mass: Callable = _plain_seeding_mass

    def __post_init__(self):
        if self.power_z not in (1.0, 2.0):
            raise ValueError(f"power_z {self.power_z} is not yet ported to "
                             f"repro_torch (z = 1 or 2)")
        if self.update_stats is None:
            upd = (_kmeans_update_stats if self.power_z == 2.0
                   else _weiszfeld_update_stats)
            object.__setattr__(self, "update_stats", upd)

    def per_point_cost(self, d2: torch.Tensor) -> torch.Tensor:
        """Raw metric map d2 -> cost (no clamp: backend distances are
        non-negative by contract)."""
        return self.point_cost(self, d2)

    def clamped_cost(self, d2: torch.Tensor) -> torch.Tensor:
        """Metric map with a defensive clamp for z != 2: ``d2`` unchanged
        for z = 2, ``point_cost(max(d2, 0))`` otherwise -- the formula of
        the reference's seeding and query paths."""
        if self.power_z == 2.0:
            return d2
        return self.point_cost(self, torch.clamp_min(d2, 0.0))

    def costs(self, b, points, centers, weights=None):
        """Per-point costs + assignments via backend ``b``."""
        return self.point_costs(self, b, points, centers, weights)

    def update(self, b, points, weights, centers):
        """One center-update pass: (new_centers, cost-at-incoming)."""
        return self.update_stats(self, b, points, weights, centers)

    def sensitivities(self, b, points, centers, weights):
        """(m, assign, w_eff): sampling masses, assignments, effective
        weights."""
        return self.sensitivity_rule(self, b, points, centers, weights)

    def seeding(self, w, mind):
        """Seeding mass of one k-means++ step."""
        return self.seeding_mass(self, w, mind)


_REGISTRY: Dict[str, Objective] = {}

ObjectiveLike = Union[str, Objective, None]


def register_objective(obj: Objective) -> Objective:
    """Add an objective; shadowing a name with a different one raises."""
    existing = _REGISTRY.get(obj.name)
    if existing is not None and existing != obj:
        raise ValueError(
            f"a different objective is already registered as {obj.name!r}; "
            f"give this instance a unique name")
    _REGISTRY[obj.name] = obj
    return obj


def available_objectives() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


KMEANS = register_objective(Objective(name="kmeans", power_z=2.0))
KMEDIAN = register_objective(Objective(name="kmedian", power_z=1.0))

# objectives of the JAX package this port does not carry yet
_NOT_PORTED = re.compile(r"^(kmeans_trimmed\(.*\)|power\(.*\))$")


def resolve_name(objective: ObjectiveLike) -> str:
    """Resolve a selection (name, instance, or ``None`` for k-means) to a
    registry name; unknown and not-yet-ported names raise ValueError."""
    if objective is None:
        return KMEANS.name
    if isinstance(objective, Objective):
        return register_objective(objective).name
    if not isinstance(objective, str):
        raise TypeError(f"objective must be a name or Objective, got "
                        f"{type(objective).__name__}")
    if objective in _REGISTRY:
        return objective
    if _NOT_PORTED.match(objective):
        raise ValueError(
            f"objective {objective!r} is not yet ported to repro_torch; "
            f"ported objectives: {', '.join(available_objectives())}")
    raise ValueError(
        f"unknown objective {objective!r}; known objectives: "
        f"{', '.join(available_objectives())}")


def get_objective(objective: ObjectiveLike = None) -> Objective:
    if isinstance(objective, Objective):
        register_objective(objective)
        return objective
    return _REGISTRY[resolve_name(objective)]
