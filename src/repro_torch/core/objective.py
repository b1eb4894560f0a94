"""Clustering objectives (the port of ``repro.core.objective``).

An :class:`Objective` is the per-point cost and center-update contract the
coreset recipe needs, as a frozen descriptor whose hooks take the
descriptor first; the registry maps canonical names to instances. Every
hook is shape-generic over a leading site axis.

This slice registers ``"kmeans"``. The JAX package's other objectives
(``"kmedian"``, ``"kmeans_trimmed(<t>)"``, ``"power(<z>)"``) are not ported
yet and raise a clear error instead of mis-dispatching.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Tuple, Union

import torch

_EPS = 1e-12


def _identity_point_cost(obj: "Objective", d2: torch.Tensor) -> torch.Tensor:
    """d2 -> per-point cost: the squared distance itself for k-means."""
    return d2


def _plain_point_costs(obj, b, points, centers, weights):
    d2, assign = b.min_dist_argmin(points, centers)
    return obj.point_cost(obj, d2), assign


def _kmeans_update_stats(obj, b, points, weights, centers
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One weighted Lloyd step: a single fused statistics pass through the
    backend's ``lloyd_stats``; clusters with total weight <= eps keep their
    previous center."""
    sums, counts, c = b.lloyd_stats(points, centers, weights)
    keep = counts > _EPS
    new = sums / torch.where(keep, counts, 1.0).unsqueeze(-1)
    new = torch.where(keep.unsqueeze(-1), new, centers.float())
    return new.to(centers.dtype), c


def _plain_sensitivities(obj, b, points, centers, weights):
    """The paper's m_p = |w_p| * cost(p, B), weights passed through."""
    c, assign = obj.point_costs(obj, b, points, centers, weights)
    return weights.abs() * c, assign, weights


def _plain_seeding_mass(obj, w, mind):
    return w * mind


@dataclasses.dataclass(frozen=True)
class Objective:
    """A registered clustering objective (frozen and hashable)."""

    name: str
    point_cost: Callable = _identity_point_cost
    update_stats: Callable = _kmeans_update_stats
    point_costs: Callable = _plain_point_costs
    sensitivity_rule: Callable = _plain_sensitivities
    seeding_mass: Callable = _plain_seeding_mass

    def per_point_cost(self, d2: torch.Tensor) -> torch.Tensor:
        return self.point_cost(self, d2)

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


KMEANS = register_objective(Objective(name="kmeans"))

# objectives of the JAX package this port does not carry yet
_NOT_PORTED = re.compile(r"^(kmedian|kmeans_trimmed\(.*\)|power\(.*\))$")


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
