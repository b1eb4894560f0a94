"""Clustering objectives (the port of ``repro.core.objective``).

An :class:`Objective` is the per-point cost and center-update contract the
coreset recipe needs, as a frozen descriptor whose hooks take the
descriptor first; the registry maps canonical names to instances. Every
hook is shape-generic over a leading site axis.

Registered objectives:

* ``"kmeans"`` (z = 2): Lloyd steps on the fused ``lloyd_stats``;
* ``"kmedian"`` (z = 1): fused Weiszfeld passes on ``weiszfeld_stats``;
* ``"kmeans_trimmed(<t>)"``: trimmed k-means -- cost, update, seeding mass
  and sensitivities exclude the ``t`` largest-residual live points (an
  integer count, or a fraction in (0, 1) of the live slots); its update is
  two fused passes, ``min_dist_argmin`` then ``lloyd_stats`` with the
  trimmed weights zeroed;
* ``"power(<z>)"``: the (k, z) power cost ``dist^z``; z = 1 and z = 2 take
  the fused k-median / k-means steps, other z an IRLS step (one
  ``min_dist_argmin`` pass and a one-hot product).

Parametrized names round-trip: ``kmeans_trimmed(16)`` registers itself
under ``"kmeans_trimmed(16)"``, and resolving that string re-derives the
instance through its factory.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels.ref import WEISZFELD_ETA2

_EPS = 1e-12

# Weiszfeld refinement passes per k-median update step (the fused
# assign + refine composition of DESIGN.md Sec. 10)
WEISZFELD_ITERS = 4


# -- trimming (shared by the trimmed hooks) -----------------------------------

def resolve_trim_count(obj: "Objective", live_count: torch.Tensor
                       ) -> torch.Tensor:
    """The number of points a trimmed instance excludes, per site (int32):
    an integer ``t_outliers`` is an absolute count, a float in (0, 1) a
    fraction of the live (weight-carrying) slots, rounded half up in
    float32. Clamped to ``[0, live_count]``."""
    t = obj.t_outliers
    live = live_count.to(torch.int32)
    if isinstance(t, float) and 0.0 < t < 1.0:
        te = torch.floor(t * live.to(torch.float32) + 0.5).to(torch.int32)
    else:
        te = torch.full_like(live, int(t))
    return torch.minimum(torch.clamp_min(te, 0), live)


def trim_mask(obj: "Objective", resid: torch.Tensor,
              weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Keep-mask (..., n) bool: False exactly on the ``t`` largest-residual
    live slots (``weights != 0``) of each site. Rank-based, as the
    reference's double ``argsort``: exactly ``t`` points are trimmed under
    ties, the lower index ranking first. JAX sorts floats after mapping
    -0.0 to 0.0 and every NaN to one positive NaN, so a stable torch sort
    of the values themselves (equal zeros keep index order, NaN last) is
    the same order."""
    live = (torch.ones_like(resid, dtype=torch.bool) if weights is None
            else weights != 0.0)
    t_eff = resolve_trim_count(obj, live.sum(-1))
    # descending residual order with dead slots last
    order = torch.argsort(torch.where(live, -resid, torch.inf), dim=-1,
                          stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device
                                ).expand_as(order))
    return rank >= t_eff.unsqueeze(-1)


# -- hook implementations (module-level: instances built from the same
# parameters compare and hash equal) ----------------------------------------

def _pow_point_cost(obj: "Objective", d2: torch.Tensor) -> torch.Tensor:
    """d2 -> per-point cost in the (k, z) metric: d2 itself for z = 2,
    ``sqrt(d2)`` for z = 1 (exact, never a ``pow``), else
    ``max(d2, 0)^(z/2)``."""
    z = obj.power_z
    if z == 2.0:
        return d2
    if z == 1.0:
        return torch.sqrt(d2)
    return torch.pow(torch.clamp_min(d2, 0.0), 0.5 * z)


def _plain_point_costs(obj, b, points, centers, weights):
    d2, assign = b.min_dist_argmin(points, centers)
    return obj.point_cost(obj, d2), assign


def _trimmed_point_costs(obj, b, points, centers, weights):
    """Per-point costs with the top-``t`` residual live points zeroed: one
    fused assignment pass and an (n,)-shaped rank."""
    d2, assign = b.min_dist_argmin(points, centers)
    keep = trim_mask(obj, d2, weights)
    return torch.where(keep, obj.point_cost(obj, d2), 0.0), assign


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


def _power_update_stats(obj, b, points, weights, centers
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic (k, z) IRLS step: one fused assignment pass, then the
    weighted mean with per-point mass ``max(w, 0) (d2 + eta^2)^((z-2)/2)``
    (a one-hot product, as the reference computes it outside any kernel).
    The cost is the signed, unsmoothed ``sum w d2^(z/2)`` at the incoming
    centres."""
    d2, assign = b.min_dist_argmin(points, centers)
    p = points.float()
    w = weights.float()
    cost = (w * obj.point_cost(obj, d2)).sum(-1)
    iw = torch.clamp_min(w, 0.0) * torch.pow(d2 + WEISZFELD_ETA2,
                                             0.5 * (obj.power_z - 2.0))
    oh = torch.nn.functional.one_hot(assign.long(), centers.shape[-2]).to(
        torch.float32) * iw.unsqueeze(-1)
    nums = oh.transpose(-1, -2) @ p
    return _ratio_or_keep(nums, oh.sum(-2), centers), cost


def _trimmed_update_stats(obj, b, points, weights, centers
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One trimmed Lloyd step, two fused passes: ``min_dist_argmin`` ranks
    the top-``t`` residuals, then ``lloyd_stats`` runs with those points'
    weights zeroed (out of the sums, the counts and the cost alike)."""
    d2, _ = b.min_dist_argmin(points, centers)
    keep = trim_mask(obj, d2, weights)
    sums, counts, c = b.lloyd_stats(points, centers,
                                    torch.where(keep, weights, 0.0))
    return _ratio_or_keep(sums, counts, centers), c


def _plain_sensitivities(obj, b, points, centers, weights):
    """The paper's m_p = |w_p| * cost(p, B), weights passed through."""
    c, assign = obj.point_costs(obj, b, points, centers, weights)
    return weights.abs() * c, assign, weights


def _trimmed_sensitivities(obj, b, points, centers, weights):
    """Trimmed sampling masses: the top-``t`` residual points carry zero
    mass and zero effective weight, so they are never sampled and their
    mass does not land on their centre's weight either."""
    d2, assign = b.min_dist_argmin(points, centers)
    keep = trim_mask(obj, d2, weights)
    w_eff = torch.where(keep, weights, 0.0)
    return w_eff.abs() * obj.point_cost(obj, d2), assign, w_eff


def _plain_seeding_mass(obj, w, mind):
    return w * mind


def _trimmed_seeding_mass(obj, w, mind):
    """D^2 seeding mass with the current top-``t`` residuals zeroed, so
    seeds avoid far-field outliers."""
    keep = trim_mask(obj, mind, w)
    return w * torch.where(keep, mind, 0.0)


def _plain_validate(obj) -> None:
    if not obj.power_z > 0.0:
        raise ValueError(f"objective power_z must be > 0, got "
                         f"{obj.power_z}")
    if obj.t_outliers:
        raise ValueError(f"objective {obj.name!r} does not support "
                         f"t_outliers (use kmeans_trimmed)")


def _trimmed_validate(obj) -> None:
    t = obj.t_outliers
    bad = (t < 0 or (isinstance(t, float)
                     and not (0.0 < t < 1.0) and t != 0.0))
    if bad:
        raise ValueError(
            f"t_outliers must be a non-negative integer count or a "
            f"fraction in (0, 1), got {t!r}")


@dataclasses.dataclass(frozen=True)
class Objective:
    """A registered (k, z) clustering objective (frozen and hashable). The
    update defaults to the fused step of z = 2 or z = 1 and to the IRLS
    step for any other z."""

    name: str
    power_z: float = 2.0
    t_outliers: Union[int, float] = 0
    point_cost: Callable = _pow_point_cost
    update_stats: Optional[Callable] = None
    point_costs: Callable = _plain_point_costs
    sensitivity_rule: Callable = _plain_sensitivities
    seeding_mass: Callable = _plain_seeding_mass
    validate: Callable = _plain_validate

    def __post_init__(self):
        if self.update_stats is None:
            upd = (_kmeans_update_stats if self.power_z == 2.0 else
                   _weiszfeld_update_stats if self.power_z == 1.0 else
                   _power_update_stats)
            object.__setattr__(self, "update_stats", upd)
        self.validate(self)

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


def _canonical_count(t: Union[int, float]) -> Union[int, float]:
    """16.0 and 16 are the same trim budget; fold to int so the factory
    cache and the registered name agree."""
    if isinstance(t, float) and t.is_integer() and not 0.0 < t < 1.0:
        return int(t)
    return t


@functools.lru_cache(maxsize=None)
def _kmeans_trimmed(t: Union[int, float]) -> Objective:
    return register_objective(Objective(
        name=f"kmeans_trimmed({t:g})", power_z=2.0, t_outliers=t,
        update_stats=_trimmed_update_stats,
        point_costs=_trimmed_point_costs,
        sensitivity_rule=_trimmed_sensitivities,
        seeding_mass=_trimmed_seeding_mass,
        validate=_trimmed_validate))


def kmeans_trimmed(t_outliers: Union[int, float]) -> Objective:
    """Trimmed outlier-robust k-means, registered as
    ``kmeans_trimmed(<t>)``."""
    return _kmeans_trimmed(_canonical_count(t_outliers))


@functools.lru_cache(maxsize=None)
def _power(z: float) -> Objective:
    return register_objective(Objective(name=f"power({z:g})", power_z=z))


def power_objective(z: float) -> Objective:
    """The (k, z) power-cost objective ``dist^z``, registered as
    ``power(<z>)``."""
    return _power(float(z))


_PARAM_NAME = re.compile(
    r"^(?P<factory>[a-z][a-z0-9_]*)\((?P<arg>[-+]?[0-9.eE+-]+)\)$")

_FACTORIES: Dict[str, Callable] = {
    "kmeans_trimmed": kmeans_trimmed,
    "power": power_objective,
}


def _parse_number(s: str) -> Union[int, float]:
    try:
        return int(s)
    except ValueError:
        return float(s)


def _resolve_parametrized(name: str) -> Optional[Objective]:
    m = _PARAM_NAME.match(name)
    if m is None:
        return None
    factory = _FACTORIES.get(m.group("factory"))
    if factory is None:
        return None
    try:
        obj = factory(_parse_number(m.group("arg")))
    except ValueError:
        return None
    # only round-trips resolve: "kmeans_trimmed(2.0)" must not alias the
    # canonical "kmeans_trimmed(2)"
    return obj if obj.name == name else None


def resolve_name(objective: ObjectiveLike) -> str:
    """Resolve a selection (name, instance, or ``None`` for k-means) to a
    registry name; unknown names raise ValueError."""
    if objective is None:
        return KMEANS.name
    if isinstance(objective, Objective):
        return register_objective(objective).name
    if not isinstance(objective, str):
        raise TypeError(f"objective must be a name or Objective, got "
                        f"{type(objective).__name__}")
    if objective in _REGISTRY:
        return objective
    obj = _resolve_parametrized(objective)
    if obj is not None:
        return obj.name
    raise ValueError(
        f"unknown objective {objective!r}; known objectives: "
        f"{', '.join(available_objectives())} (plus parametrized "
        f"'kmeans_trimmed(<t>)' / 'power(<z>)')")


def get_objective(objective: ObjectiveLike = None) -> Objective:
    if isinstance(objective, Objective):
        register_objective(objective)
        return objective
    return _REGISTRY[resolve_name(objective)]
