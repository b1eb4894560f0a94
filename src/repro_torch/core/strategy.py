"""Coreset round protocols (the port of ``repro.core.strategy``).

A :class:`CoresetStrategy` is Algorithm 1's two-round choreography -- local
solve, scalar exchange, proportional allocation, local sample -- as a
frozen descriptor whose hooks take the descriptor first. Engines own the
transport; strategies own the protocol.

This slice registers ``"algorithm1"``, the paper's protocol. The JAX
package's ``"cohen_addad"`` and ``"mapreduce"`` are not ported yet and
raise a clear error.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import prng


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


def _scalar_exchange(strat) -> Optional[ExchangeSpec]:
    return ExchangeSpec(unit_scalars=1.0)


def _proportional_allocate(strat, costs: torch.Tensor, t: int):
    from repro_torch.core.coreset import proportional_allocation
    return proportional_allocation(costs, t)


def _alg1_local_contribution(strat, keys, site_points, r1: Round1State,
                             t_i, totals, *, k, t, t_buffer, clip_negative):
    from repro_torch.core.coreset import round2_local_samples
    return round2_local_samples(
        keys, site_points, r1.m, r1.w_eff, r1.assign, r1.centers, t_i,
        totals, k=k, t=t, t_buffer=t_buffer, clip_negative=clip_negative)


@dataclasses.dataclass(frozen=True)
class CoresetStrategy:
    """A registered distributed-coreset round protocol."""

    name: str
    derive_keys_fn: Callable = _split_keys
    local_summary_fn: Callable = _alg1_local_summary
    exchange_spec_fn: Callable = _scalar_exchange
    allocate_fn: Callable = _proportional_allocate
    local_contribution_fn: Callable = _alg1_local_contribution

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
        return self.exchange_spec_fn(self)

    def allocate(self, costs: torch.Tensor, t: int) -> torch.Tensor:
        """Split the budget: ``sum == t`` exactly."""
        return self.allocate_fn(self, costs, t)

    def contribute(self, keys, site_points, r1: Round1State, t_i, totals, *,
                   k: int, t: int, t_buffer: int, clip_negative: bool):
        """Round 2's local stage: the site-batched portions."""
        return self.local_contribution_fn(
            self, keys, site_points, r1, t_i, totals, k=k, t=t,
            t_buffer=t_buffer, clip_negative=clip_negative)


_REGISTRY: Dict[str, CoresetStrategy] = {}

StrategyLike = Union[str, CoresetStrategy, None]

# strategies of the JAX package this port does not carry yet
_NOT_PORTED = ("cohen_addad", "mapreduce")


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


def resolve_name(strategy: StrategyLike) -> str:
    """Resolve a selection (name, instance, or ``None`` for Algorithm 1)
    to a registry name; unknown and not-yet-ported names raise
    ValueError."""
    if strategy is None:
        return ALGORITHM1.name
    if isinstance(strategy, CoresetStrategy):
        return register_strategy(strategy).name
    if not isinstance(strategy, str):
        raise TypeError(f"strategy must be a name or CoresetStrategy, got "
                        f"{type(strategy).__name__}")
    if strategy in _REGISTRY:
        return strategy
    if strategy in _NOT_PORTED:
        raise ValueError(
            f"strategy {strategy!r} is not yet ported to repro_torch; "
            f"ported strategies: {', '.join(available_strategies())}")
    raise ValueError(
        f"unknown strategy {strategy!r}; known strategies: "
        f"{', '.join(available_strategies())}")


def get_strategy(strategy: StrategyLike = None) -> CoresetStrategy:
    if isinstance(strategy, CoresetStrategy):
        register_strategy(strategy)
        return strategy
    return _REGISTRY[resolve_name(strategy)]
