"""Algorithm 2 -- distributed clustering, end to end (the port of the host
simulation paths of ``repro.core.distributed``).

* :func:`graph_distributed_kmeans` -- Algorithm 2 over an arbitrary
  ``Graph``: Round 1 floods the n local-cost scalars, Round 2 floods the n
  local portions, and every node solves the same weighted instance. The
  :class:`CommLedger` is the analytic Theorem-2 accounting.
  ``routing="bfs"`` runs the Theorem-3 tree protocol on a BFS spanning tree
  instead.
* :func:`distributed_kmeans_tree` -- the same over a rooted spanning tree
  (Theorem 3 accounting: everything moves O(h) edges).

This slice ports ``engine="sim"``. The JAX package's executed-schedule,
asynchronous and SPMD engines are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import clustering
from repro_torch.core import objective as objective_mod
from repro_torch.core import prng
from repro_torch.core import strategy as strategy_mod
from repro_torch.core.backend import BackendLike, DeviceLike, as_tensor
from repro_torch.core.comm import (CommLedger, flood_cost,
                                   flood_portions_cost,
                                   tree_allocation_cost,
                                   tree_broadcast_cost, tree_up_cost)
from repro_torch.core.coreset import Coreset, _phase, distributed_coreset
from repro_torch.core.objective import ObjectiveLike
from repro_torch.core.strategy import StrategyLike
from repro_torch.core.topology import Graph, SpanningTree, spanning_tree


@dataclasses.dataclass
class ClusteringResult:
    centers: torch.Tensor
    coreset: Coreset
    ledger: CommLedger
    local_costs: torch.Tensor


def _solve_on_coreset(key: torch.Tensor, cs: Coreset, k: int,
                      objective: str, lloyd_iters: int,
                      backend: BackendLike = None) -> torch.Tensor:
    """Algorithm 2's final solve on the (fixed-slot, signed) coreset:
    seeding on max(w, 0), Lloyd on the signed weights."""
    obj = objective_mod.get_objective(objective)
    b = backend_mod.get_backend(backend, cs.points.device)
    centers = clustering._kmeans_pp_init(
        key[None], cs.points[None], torch.clamp_min(cs.weights, 0.0)[None],
        k, obj, b)[0]
    centers, _ = clustering._lloyd(cs.points, centers, cs.weights,
                                   lloyd_iters, obj, b)
    return centers


def _check_engine(engine: str) -> None:
    if engine in ("exec", "async"):
        raise ValueError(f"engine {engine!r} is not yet ported to "
                         f"repro_torch; use engine='sim'")
    if engine != "sim":
        raise ValueError(f"unknown engine {engine!r}: expected 'sim'")


def _coreset_and_solve(key, site_points, site_mask, k, t, objective,
                       lloyd_iters, backend, strategy, device, phase_times):
    """The shared sim body: Round 1 + Round 2 over all sites, then the
    solve on the flattened coreset, with the same key split as the JAX
    package."""
    dev = backend_mod.resolve_device(device)
    key = as_tensor(key, dev)
    backend = backend_mod.resolve_name(backend, dev)
    k1, k2 = prng.split(key)
    dc = distributed_coreset(k1, site_points, site_mask, k, t,
                             objective=objective, lloyd_iters=lloyd_iters,
                             backend=backend, strategy=strategy, device=dev,
                             phase_times=phase_times)
    cs = dc.flatten()
    with _phase(phase_times, "solve", dev):
        centers = _solve_on_coreset(k2, cs, k, objective, lloyd_iters,
                                    backend)
    return dc, cs, centers


def graph_distributed_kmeans(
    key,
    site_points,
    site_mask,
    k: int,
    t: int,
    graph: Graph,
    objective: ObjectiveLike = "kmeans",
    lloyd_iters: int = 8,
    backend: BackendLike = None,
    engine: str = "sim",
    routing: str = "flood",
    root: int = 0,
    strategy: StrategyLike = None,
    device: DeviceLike = None,
    phase_times: Optional[dict] = None,
) -> ClusteringResult:
    """Algorithm 2 on a general graph. With ``routing="flood"`` Round 1
    floods n scalars (2mn messages) and Round 2 floods the n local portions
    (2m * sum_i |D_i| points); every node then solves the identical
    weighted instance. ``routing="bfs"`` restricts communication to a BFS
    spanning tree rooted at ``root`` and runs the Theorem-3 tree protocol
    -- same math, same centers, but the ledger prices only tree edges.

    Runs on ``device`` (CUDA unless the caller asks for the CPU).
    ``phase_times``, when a dict, receives the wall seconds of
    ``"round1"``, ``"round2"`` and ``"solve"``."""
    objective = objective_mod.resolve_name(objective)
    strategy = strategy_mod.resolve_name(strategy)
    strat = strategy_mod.get_strategy(strategy)
    _check_engine(engine)
    if routing == "bfs" or routing == "min_cost":
        tree = spanning_tree(graph, root=root, routing=routing)
        return distributed_kmeans_tree(key, site_points, site_mask, k, t,
                                       tree, objective=objective,
                                       lloyd_iters=lloyd_iters,
                                       backend=backend, engine=engine,
                                       strategy=strategy, device=device,
                                       phase_times=phase_times)
    if routing != "flood":
        raise ValueError(f"unknown routing {routing!r}: expected "
                         f"'flood'|'bfs'")
    dc, cs, centers = _coreset_and_solve(
        key, site_points, site_mask, k, t, objective, lloyd_iters, backend,
        strategy, device, phase_times)
    d = cs.points.shape[-1]
    spec = strat.exchange_spec()
    ledger = flood_cost(graph, n_messages=graph.n,
                        unit_scalars=spec.unit_scalars).tag("round1")
    ledger = ledger.add(flood_portions_cost(graph, dc.t_i.cpu().numpy(), k,
                                            d).tag("round2"))
    return ClusteringResult(centers, cs, ledger, dc.local_costs)


# the original name stays as an alias (the sim path was the only mode once)
distributed_kmeans = graph_distributed_kmeans


def distributed_kmeans_tree(
    key,
    site_points,
    site_mask,
    k: int,
    t: int,
    tree: SpanningTree,
    objective: ObjectiveLike = "kmeans",
    lloyd_iters: int = 8,
    backend: BackendLike = None,
    engine: str = "sim",
    strategy: StrategyLike = None,
    device: DeviceLike = None,
    phase_times: Optional[dict] = None,
) -> ClusteringResult:
    """Algorithm 2 restricted to a rooted tree (Theorem 3): the raw cost
    scalars are gathered to the root along parent edges, the root replays
    the exact largest-remainder allocation and scatters each site's share
    back down its path plus broadcasts the cost total; portions travel
    depth(v) edges to the root, and the solution (k points) is broadcast
    back. Arguments as :func:`graph_distributed_kmeans`."""
    objective = objective_mod.resolve_name(objective)
    strategy = strategy_mod.resolve_name(strategy)
    _check_engine(engine)
    dc, cs, centers = _coreset_and_solve(
        key, site_points, site_mask, k, t, objective, lloyd_iters, backend,
        strategy, device, phase_times)
    d = cs.points.shape[-1]
    t_i = [float(x) for x in dc.t_i.cpu().numpy()]
    per_node = [t_i[v] + k for v in range(tree.n)]
    up = tree_up_cost(tree, per_node, dim=d).tag("round2_gather")
    ledger = tree_allocation_cost(tree).tag("round1").add(up)
    ledger = ledger.add(tree_broadcast_cost(tree, unit_points=float(k),
                                            dim=d).tag("round2_broadcast"))
    return ClusteringResult(centers, cs, ledger, dc.local_costs)
