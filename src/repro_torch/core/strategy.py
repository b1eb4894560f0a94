"""Coreset round protocols (the port of ``repro.core.strategy``).

A :class:`CoresetStrategy` is Algorithm 1's two-round choreography -- local
solve, scalar exchange, proportional allocation, local sample -- as a
frozen descriptor whose hooks take the descriptor first. Engines own the
transport; strategies own the protocol.

Registered strategies:

* ``"algorithm1"`` -- the paper's protocol: sampling mass ``m_p = |w_p|
  cost(p, B_i)``, one scalar exchanged per site, largest-remainder
  cost-proportional allocation, and the global-total weight formula;
* ``"cohen_addad"`` -- the refined two-term sensitivity ``s_p = m_p /
  cost(P_i, B_i) + |w_p| / W(cluster(p))`` (cost share plus inverse
  cluster mass), with the same two rounds and byte cost as
  ``"algorithm1"``; the exchanged scalar is the per-site total of ``s``;
* ``"mapreduce"`` -- one shuffle, no scalar exchange: the budget splits
  uniformly by largest remainder (derivable at every site) and each site
  builds a standalone coreset of its own data, normalized by its own
  sensitivity total and its own ``t_i``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import prng

_TINY = 1e-30

class Round1State(NamedTuple):
    """Per-site output of Round 1's local stage (all site-major)."""

    centers: torch.Tensor      # (n_sites, k, d)
    m: torch.Tensor            # (n_sites, M)
    assign: torch.Tensor       # (n_sites, M)
    local_costs: torch.Tensor  # (n_sites,)
    w_eff: torch.Tensor        # (n_sites, M)


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """Declared shape of the Round-1 exchange: each site contributes
    ``unit_scalars`` scalars that must reach every allocator."""

    unit_scalars: float = 1.0


def _split_keys(strat: "CoresetStrategy", key: torch.Tensor,
                n_sites: int) -> torch.Tensor:
    """The all-site key table: ``split(key, 2 n)`` reshaped to
    ``(n, 2, 2)`` -- column 0 drives Round 1, column 1 Round 2, for every
    site."""
    return prng.split(key, n_sites * 2).reshape(n_sites, 2, 2)


def _alg1_local_summary(strat, keys, site_points, w_site, *, k, objective,
                        lloyd_iters, backend) -> Round1State:
    from repro_torch.core.coreset import round1_local_solves
    return Round1State(*round1_local_solves(
        keys, site_points, w_site, k=k, objective=objective,
        lloyd_iters=lloyd_iters, backend=backend))


def _refined_sensitivities(m: torch.Tensor, assign: torch.Tensor,
                           w_eff: torch.Tensor, k: int) -> torch.Tensor:
    """The two-term (1+eps) sensitivity bound from the plain masses, per
    site: each point's share of the local cost plus its share of its
    cluster's mass; zero-mass (padding, trimmed-out) slots keep exactly
    zero. The cluster masses are one-hot sums (a fixed reduction order;
    atomic scatter-adds on the GPU are not deterministic), and the cost
    total is summed in the reference's order."""
    from repro_torch.core.coreset import _windowed_sum
    aw = w_eff.abs()
    oh = torch.nn.functional.one_hot(assign.long(), k).to(aw.dtype)
    cluster_mass = (aw.unsqueeze(-1) * oh).sum(-2)
    total = _windowed_sum(m).unsqueeze(-1)
    s = (m / torch.clamp_min(total, _TINY)
         + aw / torch.clamp_min(cluster_mass.gather(-1, assign.long()),
                                _TINY))
    return torch.where(aw > 0.0, s, 0.0)


def _cohen_addad_local_summary(strat, keys, site_points, w_site, *, k,
                               objective, lloyd_iters, backend
                               ) -> Round1State:
    from repro_torch.core.coreset import round1_local_solves
    centers, m, assign, _, w_eff = round1_local_solves(
        keys, site_points, w_site, k=k, objective=objective,
        lloyd_iters=lloyd_iters, backend=backend)
    s = _refined_sensitivities(m, assign, w_eff, k)
    return Round1State(centers, s, assign, strat.site_total(s), w_eff)


def _scalar_exchange(strat) -> Optional[ExchangeSpec]:
    return ExchangeSpec(unit_scalars=1.0)


def _no_exchange(strat) -> Optional[ExchangeSpec]:
    return None


def _proportional_allocate(strat, costs: torch.Tensor, t: int):
    from repro_torch.core.coreset import proportional_allocation
    return proportional_allocation(costs, t)


def _uniform_allocate(strat, costs: torch.Tensor, t: int):
    """Largest remainder over uniform shares: derivable at every site from
    ``n_sites`` and ``t`` alone (``costs`` gives only its length)."""
    from repro_torch.core.coreset import proportional_allocation
    return proportional_allocation(torch.ones_like(costs), t)


def _local_contribution(strat, keys, site_points, r1: Round1State, t_i,
                        totals, *, k, t, t_buffer, clip_negative):
    """Every site's portion: ``totals`` is the sensitivity total each site
    received (the global one, or its own when no exchange ran) and the
    sample weights divide by the strategy's ``sample_t_total``."""
    from repro_torch.core.coreset import _round2_portions
    return _round2_portions(keys, site_points, r1.m, r1.w_eff, r1.assign,
                            r1.centers, t_i, totals,
                            strat.sample_t_total(t, t_i), k, t_buffer,
                            clip_negative)


def _flatten_assemble(strat, points: torch.Tensor, weights: torch.Tensor):
    from repro_torch.core.coreset import Coreset
    return Coreset(points=points.reshape(-1, points.shape[-1]),
                   weights=weights.reshape(-1))


def _plain_site_sensitivities(strat, pts, centers, w, *, objective,
                              backend):
    from repro_torch.core.coreset import sensitivities
    return sensitivities(pts, centers, w, objective=objective,
                         backend=backend)


def _refined_site_sensitivities(strat, pts, centers, w, *, objective,
                                backend):
    from repro_torch.core.coreset import sensitivities
    m, assign, w_eff = sensitivities(pts, centers, w, objective=objective,
                                     backend=backend)
    return (_refined_sensitivities(m, assign, w_eff, centers.shape[-2]),
            assign, w_eff)


def _plain_site_total(strat, m: torch.Tensor) -> torch.Tensor:
    """A site's Round-1 scalar: the sum of its sampling masses."""
    return m.sum(-1)


def _windowed_site_total(strat, m: torch.Tensor) -> torch.Tensor:
    """The refined totals are 1 + each site's number of non-empty clusters
    up to rounding, so the allocation's ranking rests on the last bits:
    sum in the reference's order."""
    from repro_torch.core.coreset import _windowed_sum
    return _windowed_sum(m)


def _global_t_total(strat, t: int, t_i: torch.Tensor) -> torch.Tensor:
    """Exchanging strategies normalize the sample weights by the global
    budget ``t``, per site."""
    return torch.full(t_i.shape, float(t), device=t_i.device)


def _own_t_total(strat, t: Optional[int], t_i: torch.Tensor
                 ) -> torch.Tensor:
    """Single-shuffle strategies normalize by each site's own ``t_i`` (the
    budget ``t`` is not used)."""
    return t_i.to(torch.float32)


def _no_validate(strat) -> None:
    pass


@dataclasses.dataclass(frozen=True)
class CoresetStrategy:
    """A registered distributed-coreset round protocol. ``validate`` runs
    on the new descriptor at construction and raises to reject it."""

    name: str
    derive_keys_fn: Callable = _split_keys
    local_summary_fn: Callable = _alg1_local_summary
    exchange_spec_fn: Callable = _scalar_exchange
    allocate_fn: Callable = _proportional_allocate
    local_contribution_fn: Callable = _local_contribution
    assemble_fn: Callable = _flatten_assemble
    site_sensitivities_fn: Callable = _plain_site_sensitivities
    site_total_fn: Callable = _plain_site_total
    sample_t_total_fn: Callable = _global_t_total
    validate: Callable = _no_validate

    def __post_init__(self):
        self.validate(self)

    def keys(self, key: torch.Tensor, n_sites: int) -> torch.Tensor:
        """The all-site ``(n_sites, 2, 2)`` Round-1/Round-2 key table."""
        return self.derive_keys_fn(self, key, n_sites)

    def summary(self, keys, site_points, w_site, *, k: int, objective: str,
                lloyd_iters: int, backend: str) -> Round1State:
        """Round 1's local stage over all sites."""
        return self.local_summary_fn(self, keys, site_points, w_site, k=k,
                                     objective=objective,
                                     lloyd_iters=lloyd_iters,
                                     backend=backend)

    def exchange_spec(self) -> Optional[ExchangeSpec]:
        """The declared Round-1 exchange (``None``: no exchange round)."""
        return self.exchange_spec_fn(self)

    @property
    def needs_exchange(self) -> bool:
        return self.exchange_spec() is not None

    def allocate(self, costs: torch.Tensor, t: int) -> torch.Tensor:
        """Split the budget: ``sum == t`` exactly."""
        return self.allocate_fn(self, costs, t)

    def contribute(self, keys, site_points, r1: Round1State, t_i, totals, *,
                   k: int, t: int, t_buffer: int, clip_negative: bool):
        """Round 2's local stage: the site-batched portions."""
        return self.local_contribution_fn(
            self, keys, site_points, r1, t_i, totals, k=k, t=t,
            t_buffer=t_buffer, clip_negative=clip_negative)

    def assemble(self, points, weights):
        """Stitch moved portions into one flat coreset."""
        return self.assemble_fn(self, points, weights)

    def site_sensitivities(self, pts, centers, w, *, objective: str,
                           backend: str):
        """The sampling-mass rule on one site's (or a site batch's)
        instance: ``(m, assign, w_eff)``."""
        return self.site_sensitivities_fn(self, pts, centers, w,
                                          objective=objective,
                                          backend=backend)

    def site_total(self, m: torch.Tensor) -> torch.Tensor:
        """A site's (or a site batch's) Round-1 scalar from its sampling
        masses ``m`` (..., M), summed as :meth:`summary` sums it."""
        return self.site_total_fn(self, m)

    def local_totals(self, local_costs: torch.Tensor) -> torch.Tensor:
        """The per-site ``totals`` :meth:`contribute` takes when no exchange
        round runs: each site's own scalar."""
        return local_costs

    def sample_t_total(self, t: Optional[int], t_i: torch.Tensor
                       ) -> torch.Tensor:
        """The per-site ``t_total`` of the sample-weight formula: the global
        ``t`` for exchanging strategies, each site's own ``t_i`` for
        single-shuffle ones."""
        return self.sample_t_total_fn(self, t, t_i)


_REGISTRY: Dict[str, CoresetStrategy] = {}

StrategyLike = Union[str, CoresetStrategy, None]

def register_strategy(strat: CoresetStrategy) -> CoresetStrategy:
    """Add a strategy; shadowing a name with a different one raises."""
    existing = _REGISTRY.get(strat.name)
    if existing is not None and existing != strat:
        raise ValueError(
            f"a different strategy is already registered as "
            f"{strat.name!r}; give this instance a unique name")
    _REGISTRY[strat.name] = strat
    return strat


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


ALGORITHM1 = register_strategy(CoresetStrategy(name="algorithm1"))

COHEN_ADDAD = register_strategy(CoresetStrategy(
    name="cohen_addad",
    local_summary_fn=_cohen_addad_local_summary,
    site_sensitivities_fn=_refined_site_sensitivities,
    site_total_fn=_windowed_site_total))

MAPREDUCE = register_strategy(CoresetStrategy(
    name="mapreduce",
    exchange_spec_fn=_no_exchange,
    allocate_fn=_uniform_allocate,
    sample_t_total_fn=_own_t_total))


def resolve_name(strategy: StrategyLike) -> str:
    """Resolve a selection (name, instance, or ``None`` for Algorithm 1)
    to a registry name; unknown names raise ValueError."""
    if strategy is None:
        return ALGORITHM1.name
    if isinstance(strategy, CoresetStrategy):
        return register_strategy(strategy).name
    if not isinstance(strategy, str):
        raise TypeError(f"strategy must be a name or CoresetStrategy, got "
                        f"{type(strategy).__name__}")
    if strategy in _REGISTRY:
        return strategy
    raise ValueError(
        f"unknown strategy {strategy!r}; known strategies: "
        f"{', '.join(available_strategies())}")


def get_strategy(strategy: StrategyLike = None) -> CoresetStrategy:
    if isinstance(strategy, CoresetStrategy):
        register_strategy(strategy)
        return strategy
    return _REGISTRY[resolve_name(strategy)]
