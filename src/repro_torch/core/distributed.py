"""Algorithm 2 -- distributed clustering, end to end (the port of the host
paths of ``repro.core.distributed``).

* :func:`graph_distributed_kmeans` -- Algorithm 2 over an arbitrary
  ``Graph``: Round 1 floods the n local-cost scalars, Round 2 floods the n
  local portions, and every node solves the same weighted instance.
  ``engine="sim"`` computes the rounds globally and prices them with the
  analytic Theorem-2 :class:`CommLedger`; ``engine="exec"`` routes the
  identical math through the topology execution engine
  (:mod:`repro_torch.core.message_passing`): the scalars and portions move
  edge by edge, every node ends holding the bit-identical global coreset,
  and the ledger is *measured* from the executed schedule (it equals the
  analytic one exactly). ``routing="bfs"`` / ``"min_cost"`` runs the
  Theorem-3 tree protocol on a BFS / min-cost (Prim) spanning tree
  instead; a single-shuffle strategy (``"mapreduce"``) has no flood and
  takes the BFS tree.
* :func:`distributed_kmeans_tree` -- the same over a rooted spanning tree
  (Theorem 3 accounting: everything moves O(h) edges), with the same
  ``engine="sim"|"exec"`` choice (gather / scatter / broadcast schedules).

* :func:`spmd_distributed_kmeans` -- the SPMD mesh path: one rank per
  device of a mesh axis (:mod:`repro_torch.core.mesh`), each holding one
  merged site; exactly two gathers (the Round-1 cost scalars, the Round-2
  portions) under ``collectives="all_gather"``, ``"neighbor_rounds"`` or
  ``"torus_2d"``, bit-identical across the three.

``engine="async"`` (or a ``faults=`` plan under ``engine="exec"``) runs
the flood's two rounds on the asynchronous WAN runtime
(:mod:`repro_torch.wan`): the coreset is restricted to the surviving sites
and equals the restricted oracle's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import clustering
from repro_torch.core import mesh as mesh_mod
from repro_torch.core import objective as objective_mod
from repro_torch.core import prng
from repro_torch.core import strategy as strategy_mod
from repro_torch.core.backend import BackendLike, DeviceLike, as_tensor
from repro_torch.core.comm import (CommLedger, flood_cost,
                                   flood_portions_cost,
                                   tree_allocation_cost,
                                   tree_broadcast_cost, tree_up_cost)
from repro_torch.core.coreset import (Coreset, _phase, _sample_and_weight,
                                      _windowed_sum, distributed_coreset)
from repro_torch.core.mesh import Mesh
from repro_torch.core.message_passing import (ExecResult, GossipSchedule,
                                              TreeSchedule, collective_hops,
                                              flood_exec, gossip_schedule,
                                              neighbor_rounds_gather,
                                              pack_payload,
                                              torus_mesh_shape,
                                              torus_rounds_gather,
                                              tree_broadcast_exec,
                                              tree_gather_exec,
                                              tree_scatter_exec,
                                              unpack_payload)
from repro_torch.core.objective import ObjectiveLike
from repro_torch.core.strategy import StrategyLike
from repro_torch.core.topology import Graph, SpanningTree, spanning_tree
from repro_torch.roofline import trace as _trace


@dataclasses.dataclass
class ExecDetail:
    """Per-node state after the executed communication rounds -- the
    verification surface for engine-vs-simulation parity tests.

    Graph engine: ``node_points``/``node_weights`` are every node's
    assembled global coreset (n, n*S, d) / (n, n*S) (views of the relayed
    tables) and ``node_alloc`` the (n, n) allocation vector each node
    computed from its received scalars (all rows bit-identical). Tree
    engine: ``node_centers`` (n, k, d) holds the solution every node
    received from the root's broadcast and ``node_alloc`` the (n,) per-node
    allocations delivered by the scatter. ``node_totals`` is the global
    cost total as known at each node."""

    node_points: Optional[torch.Tensor] = None
    node_weights: Optional[torch.Tensor] = None
    node_centers: Optional[torch.Tensor] = None
    node_alloc: Optional[torch.Tensor] = None
    node_totals: Optional[torch.Tensor] = None
    rounds: Dict[str, ExecResult] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ClusteringResult:
    centers: torch.Tensor
    coreset: Coreset
    ledger: CommLedger
    local_costs: torch.Tensor
    exec_detail: Optional[ExecDetail] = None


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
    """Reject engines other than the synchronous two."""
    if engine not in ("sim", "exec"):
        raise ValueError(f"unknown engine {engine!r}: expected "
                         f"'sim'|'exec'")


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
    faults=None,
    wan_mode: Optional[str] = None,
    wan_seed: int = 0,
    wan_p: float = 0.5,
    strategy: StrategyLike = None,
    device: DeviceLike = None,
    phase_times: Optional[dict] = None,
) -> ClusteringResult:
    """Algorithm 2 on a general graph. With ``routing="flood"`` Round 1
    floods n scalars (2mn messages) and Round 2 floods the n local portions
    (2m * sum_i |D_i| points); every node then solves the identical
    weighted instance. ``routing="bfs"`` / ``"min_cost"`` restricts
    communication to a spanning tree rooted at ``root`` (hop-minimal BFS or
    Prim over the link costs) and runs the Theorem-3 tree protocol -- same
    math, same centers, but the ledger prices only tree edges. A strategy
    with no exchange round (``"mapreduce"``) never floods: ``"flood"``
    takes the BFS tree.

    ``engine="sim"`` computes the rounds globally and prices them with the
    analytic ledger; ``engine="exec"`` executes them on a compiled
    :class:`GossipSchedule` (or tree schedule) -- same local stages, same
    keys, so the result is bit-identical, but the scalars and portions move
    edge by edge, the ledger is measured from the schedule, and
    ``exec_detail`` holds every node's state.

    ``engine="async"`` routes both rounds through the WAN runtime
    (:mod:`repro_torch.wan.runtime`): asynchronous activation
    (``wan_mode``: ``"clock"`` default, or ``"random"``/``"full"``;
    ``wan_seed`` / ``wan_p`` parameterize it) and an optional ``faults=``
    :class:`~repro_torch.wan.faults.FaultPlan`. Passing ``faults`` with
    ``engine="exec"`` runs the synchronous schedule under the fault plan
    (WAN mode ``"full"``). Either way the allocation and coreset are
    restricted to surviving sites and the returned centers are
    bit-identical to the sim oracle restricted to the survivors
    (:func:`repro_torch.wan.runtime.restricted_sim_coreset`); the measured
    ledger carries the ``staleness`` axis. Flood routing only.

    Runs on ``device`` (CUDA unless the caller asks for the CPU).
    ``phase_times``, when a dict, receives the wall seconds of
    ``"round1"``, ``"round2"`` and ``"solve"``."""
    objective = objective_mod.resolve_name(objective)
    strategy = strategy_mod.resolve_name(strategy)
    strat = strategy_mod.get_strategy(strategy)
    if faults is not None or engine == "async":
        if routing != "flood":
            raise ValueError(f"faulty/async runs support routing='flood' "
                             f"only, got {routing!r}")
        if engine not in ("exec", "async"):
            raise ValueError(f"faults require engine='exec'|'async', got "
                             f"{engine!r} (the fault-free sim oracle is "
                             f"repro_torch.wan.runtime."
                             f"restricted_sim_coreset)")
        mode = wan_mode if wan_mode is not None else (
            "full" if engine == "exec" else "clock")
        return _graph_async(key, site_points, site_mask, k, t, graph,
                            objective, lloyd_iters, backend, mode=mode,
                            faults=faults, seed=wan_seed, p=wan_p,
                            strategy=strategy, device=device,
                            phase_times=phase_times)
    _check_engine(engine)
    if not strat.needs_exchange and routing == "flood":
        # single-shuffle strategies never flood: with no scalar round, the
        # portions move map -> shuffle -> reduce along a BFS tree
        routing = "bfs"
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
                         f"'flood'|'bfs'|'min_cost'")
    if engine == "exec":
        return _graph_exec(key, site_points, site_mask, k, t, graph,
                           objective, lloyd_iters, backend, strategy, device,
                           phase_times)
    dc, cs, centers = _coreset_and_solve(
        key, site_points, site_mask, k, t, objective, lloyd_iters, backend,
        strategy, device, phase_times)
    d = cs.points.shape[-1]
    spec = strat.exchange_spec()
    with _trace.scope("ledger"):
        ledger = flood_cost(graph, n_messages=graph.n,
                            unit_scalars=spec.unit_scalars).tag("round1")
        ledger = ledger.add(flood_portions_cost(
            graph, dc.t_i.cpu().numpy(), k, d).tag("round2"))
    return ClusteringResult(centers, cs, ledger, dc.local_costs)


# the original name stays as an alias (the sim path was the only mode once)
distributed_kmeans = graph_distributed_kmeans


def _exec_inputs(key, site_points, site_mask, n_nodes, backend, device):
    """Place an exec run's inputs: (device, key, site points, site weights
    from the mask, backend name)."""
    dev = backend_mod.resolve_device(device)
    site_points = as_tensor(site_points, dev)
    if n_nodes != site_points.shape[0]:
        raise ValueError(f"the topology has {n_nodes} nodes for "
                         f"{site_points.shape[0]} sites")
    w_site = as_tensor(site_mask, dev).to(site_points.dtype)
    return (dev, as_tensor(key, dev), site_points, w_site,
            backend_mod.resolve_name(backend, dev))


def exec_algorithm1_rounds(
    sched: GossipSchedule,
    key: torch.Tensor,
    site_points: torch.Tensor,
    w_site: torch.Tensor,
    k: int,
    t: int,
    t_buffer: int,
    objective: str,
    lloyd_iters: int,
    clip_negative: bool,
    backend: str,
    strategy: StrategyLike = None,
    phase_times: Optional[dict] = None,
) -> Tuple[ExecDetail, torch.Tensor]:
    """A strategy's two rounds with the communication *executed* on a
    gossip schedule. Same descriptor hooks and key derivation as
    ``distributed_coreset``, so every node's assembled coreset is
    bit-identical to the host path's; the ``ExecDetail`` ledgers are
    measured per transmission. Exchange strategies only: a single-shuffle
    strategy has no scalar round to flood, so it routes to the tree
    protocol instead (:func:`graph_distributed_kmeans` reroutes).
    ``phase_times``, when a dict, receives the wall seconds of
    ``"round1"`` (local solves, the scalar flood, every node's allocation)
    and ``"round2"`` (samples, the portions flood). Returns (detail,
    local_costs)."""
    strat = strategy_mod.get_strategy(strategy)
    if not strat.needs_exchange:
        raise ValueError(
            f"strategy {strat.name!r} has no exchange round; the gossip "
            f"flood engine only runs exchange strategies (single-shuffle "
            f"strategies run the tree protocol)")
    n_sites, _, d = site_points.shape
    dev = site_points.device
    keys = strat.keys(key, n_sites)

    with _phase(phase_times, "round1", dev):
        r1 = strat.summary(keys[:, 0], site_points, w_site, k=k,
                           objective=objective, lloyd_iters=lloyd_iters,
                           backend=backend)
        local_costs = r1.local_costs
        # -- Round 1 executed: flood the n exchange scalars -----------------
        spec = strat.exchange_spec()
        cost_tables, r1x = flood_exec(sched, local_costs[:, None],
                                      unit_scalars=spec.unit_scalars)
        costs_at = cost_tables[:, :, 0]                    # (node, origin)
        # every node replays the allocation on its own received copy
        node_alloc = torch.stack([strat.allocate(costs_at[v], t)
                                  for v in range(n_sites)])
        t_i = node_alloc.diagonal().clone()    # node v uses its own share
        node_totals = _windowed_sum(costs_at)

    with _phase(phase_times, "round2", dev):
        portions = strat.contribute(
            keys[:, 1], site_points, r1, t_i, node_totals, k=k, t=t,
            t_buffer=t_buffer, clip_negative=clip_negative)
        # -- Round 2 executed: flood the fixed-size local portions ----------
        payload = pack_payload(portions.points, portions.weights)
        with _trace.scope("ledger"):
            unit_pts = (t_i.cpu().numpy() + k).astype(np.float64)
        port_tables, r2 = flood_exec(sched, payload, unit_points=unit_pts,
                                     dim=d)
    slots = payload.shape[1]
    node_pts, node_w = unpack_payload(port_tables)
    detail = ExecDetail(
        node_points=node_pts.view(n_sites, n_sites * slots, d),
        node_weights=node_w.view(n_sites, n_sites * slots),
        node_alloc=node_alloc, node_totals=node_totals,
        rounds={"round1": r1x, "round2": r2})
    return detail, local_costs


def _graph_exec(key, site_points, site_mask, k, t, graph, objective,
                lloyd_iters, backend, strategy, device,
                phase_times) -> ClusteringResult:
    """Execute Algorithm 2's communication on a compiled gossip schedule.

    Identical math to the sim path stage for stage (same key derivation,
    same stage functions), but the n Round-1 scalars and the n Round-2
    portions move through executed flood rounds: every node ends holding
    bit-identical copies of all n cost scalars (from which it replays the
    exact largest-remainder allocation locally) and of the global coreset.
    The returned ledger is measured per transmission."""
    dev, key, site_points, w_site, backend = _exec_inputs(
        key, site_points, site_mask, graph.n, backend, device)
    sched = gossip_schedule(graph)
    k1, k2 = prng.split(key)
    detail, local_costs = exec_algorithm1_rounds(
        sched, k1, site_points, w_site, k, t, t_buffer=t,
        objective=objective, lloyd_iters=lloyd_iters, clip_negative=False,
        backend=backend, strategy=strategy, phase_times=phase_times)

    # every node holds the identical instance; solve it once (node 0's
    # copy, laid out as the sim path's coreset)
    cs = Coreset(detail.node_points[0].contiguous(),
                 detail.node_weights[0].contiguous())
    with _phase(phase_times, "solve", dev):
        centers = _solve_on_coreset(k2, cs, k, objective, lloyd_iters,
                                    backend)
    ledger = detail.rounds["round1"].ledger.tag("round1").add(
        detail.rounds["round2"].ledger.tag("round2"))
    return ClusteringResult(centers, cs, ledger, local_costs,
                            exec_detail=detail)


def _graph_async(key, site_points, site_mask, k, t, graph, objective,
                 lloyd_iters, backend, mode, faults, seed, p,
                 strategy: StrategyLike = None, device: DeviceLike = None,
                 phase_times: Optional[dict] = None) -> ClusteringResult:
    """Execute Algorithm 2's communication on the asynchronous WAN runtime
    (imported lazily -- :mod:`repro_torch.wan` layers on this module).

    Every *surviving* node assembles the bit-identical survivor-restricted
    coreset; the solve uses the first survivor's copy with the same final
    key split as every other engine, so on a trivial fault plan the
    centers equal the synchronous paths' bit-for-bit, and under faults
    they equal the restricted sim oracle's. ``exec_detail`` holds the
    :class:`repro_torch.wan.runtime.AsyncDetail` (survivor-indexed)."""
    from repro_torch.wan.runtime import async_algorithm1_rounds

    dev, key, site_points, w_site, backend = _exec_inputs(
        key, site_points, site_mask, graph.n, backend, device)
    k1, k2 = prng.split(key)
    detail, local_costs = async_algorithm1_rounds(
        graph, k1, site_points, w_site, k, t, t_buffer=t,
        objective=objective, lloyd_iters=lloyd_iters, clip_negative=False,
        backend=backend, mode=mode, faults=faults, seed=seed, p=p,
        strategy=strategy, phase_times=phase_times)

    cs = Coreset(detail.node_points[0].contiguous(),
                 detail.node_weights[0].contiguous())
    with _phase(phase_times, "solve", dev):
        centers = _solve_on_coreset(k2, cs, k, objective, lloyd_iters,
                                    backend)
    ledger = detail.rounds["round2"].ledger.tag("round2")
    if "round1" in detail.rounds:   # single-shuffle strategies skip it
        ledger = detail.rounds["round1"].ledger.tag("round1").add(ledger)
    return ClusteringResult(centers, cs, ledger, local_costs,
                            exec_detail=detail)


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
    strat = strategy_mod.get_strategy(strategy)
    _check_engine(engine)
    if engine == "exec":
        return _tree_exec(key, site_points, site_mask, k, t, tree, objective,
                          lloyd_iters, backend, strategy, device,
                          phase_times)
    dc, cs, centers = _coreset_and_solve(
        key, site_points, site_mask, k, t, objective, lloyd_iters, backend,
        strategy, device, phase_times)
    d = cs.points.shape[-1]
    with _trace.scope("ledger"):
        t_i = [float(x) for x in dc.t_i.cpu().numpy()]
        per_node = [t_i[v] + k for v in range(tree.n)]
        up = tree_up_cost(tree, per_node, dim=d).tag("round2_gather")
        if strat.needs_exchange:
            ledger = tree_allocation_cost(tree).tag("round1").add(up)
        else:
            # single shuffle: no scalar round, no allocation traffic
            ledger = up
        ledger = ledger.add(tree_broadcast_cost(
            tree, unit_points=float(k), dim=d).tag("round2_broadcast"))
    return ClusteringResult(centers, cs, ledger, dc.local_costs)


def exec_algorithm1_tree_rounds(
    sched: TreeSchedule,
    key: torch.Tensor,
    site_points: torch.Tensor,
    w_site: torch.Tensor,
    k: int,
    t: int,
    t_buffer: int,
    objective: str,
    lloyd_iters: int,
    clip_negative: bool,
    backend: str,
    strategy: StrategyLike = None,
    phase_times: Optional[dict] = None,
):
    """A strategy's two rounds with the communication *executed* on a tree
    schedule. For exchange strategies: gather the raw Round-1 scalars to
    the root, replay the strategy's exact allocation there, scatter each
    site's share down its subtree path, broadcast the total; gather the
    fixed-size Round-2 portions to the root. Single-shuffle strategies
    skip the Round-1 gather/scatter/broadcast entirely -- every site
    derives the identical uniform split locally and normalizes by its own
    scalar -- so the only traffic is the portions gather. Same descriptor
    hooks and key derivation as ``distributed_coreset``, so the root's
    assembled table is bit-identical to the host path's coreset.
    ``phase_times`` as in :func:`exec_algorithm1_rounds`. Returns
    ``(root_points, root_weights, t_i, node_totals, rounds, local_costs)``
    where ``rounds`` maps phase label to the measured
    :class:`ExecResult`."""
    strat = strategy_mod.get_strategy(strategy)
    n_sites, _, d = site_points.shape
    dev = site_points.device
    keys = strat.keys(key, n_sites)

    with _phase(phase_times, "round1", dev):
        r1 = strat.summary(keys[:, 0], site_points, w_site, k=k,
                           objective=objective, lloyd_iters=lloyd_iters,
                           backend=backend)
        local_costs = r1.local_costs
        if strat.needs_exchange:
            # -- Round 1 executed: scalars up, allocations + total down ------
            spec = strat.exchange_spec()
            root_costs, r1a = tree_gather_exec(
                sched, local_costs[:, None], unit_scalars=spec.unit_scalars)
            t_root = strat.allocate(root_costs[:, 0], t)
            total = _windowed_sum(root_costs[:, 0])
            own_t, r1b = tree_scatter_exec(sched, t_root[:, None],
                                           unit_scalars=1.0)
            node_totals, r1c = tree_broadcast_exec(sched, total[None],
                                                   unit_scalars=1.0)
            t_i = own_t[:, 0]
            totals = node_totals[:, 0]
            rounds = {"round1_gather": r1a, "round1_scatter": r1b,
                      "round1_broadcast": r1c}
        else:
            # no Round-1 traffic at all: the split is locally derivable and
            # each site's weight formula uses its own scalar
            t_i = strat.allocate(local_costs, t)
            totals = strat.local_totals(local_costs)
            rounds = {}

    with _phase(phase_times, "round2", dev):
        portions = strat.contribute(
            keys[:, 1], site_points, r1, t_i, totals, k=k, t=t,
            t_buffer=t_buffer, clip_negative=clip_negative)
        # -- Round 2 executed: portions up -----------------------------------
        payload = pack_payload(portions.points, portions.weights)
        with _trace.scope("ledger"):
            unit_pts = (t_i.cpu().numpy() + k).astype(np.float64)
        root_table, r2a = tree_gather_exec(sched, payload,
                                           unit_points=unit_pts, dim=d)
    root_pts, root_w = unpack_payload(root_table)
    rounds["round2_gather"] = r2a
    return (root_pts, root_w, t_i, totals, rounds, local_costs)


def _tree_exec(key, site_points, site_mask, k, t, tree, objective,
               lloyd_iters, backend, strategy, device,
               phase_times) -> ClusteringResult:
    """Execute Algorithm 2's communication on a compiled tree schedule:
    the Round-1/Round-2 tree protocol of
    :func:`exec_algorithm1_tree_rounds`, then solve at the root and
    broadcast the k centers. Bit-identical to the sim path; measured
    ledger."""
    dev, key, site_points, w_site, backend = _exec_inputs(
        key, site_points, site_mask, tree.n, backend, device)
    d = site_points.shape[-1]
    sched = TreeSchedule.from_tree(tree)
    k1, k2 = prng.split(key)
    root_pts, root_w, t_i, node_totals, rounds, local_costs = \
        exec_algorithm1_tree_rounds(
            sched, k1, site_points, w_site, k, t, t_buffer=t,
            objective=objective, lloyd_iters=lloyd_iters,
            clip_negative=False, backend=backend, strategy=strategy,
            phase_times=phase_times)

    # the root's table, laid out as the sim path's coreset
    cs = Coreset(root_pts.reshape(-1, d).contiguous(),
                 root_w.reshape(-1).contiguous())
    with _phase(phase_times, "solve", dev):
        centers = _solve_on_coreset(k2, cs, k, objective, lloyd_iters,
                                    backend)
    with _phase(phase_times, "round2", dev):
        node_centers, r2b = tree_broadcast_exec(sched, centers,
                                                unit_points=float(k), dim=d)
    rounds = dict(rounds, round2_broadcast=r2b)

    if "round1_gather" in rounds:
        ledger = (rounds["round1_gather"].ledger
                  .add(rounds["round1_scatter"].ledger)
                  .add(rounds["round1_broadcast"].ledger).tag("round1")
                  .add(rounds["round2_gather"].ledger.tag("round2_gather")))
    else:   # single-shuffle strategies have no Round-1 phases
        ledger = rounds["round2_gather"].ledger.tag("round2_gather")
    ledger = ledger.add(r2b.ledger.tag("round2_broadcast"))
    detail = ExecDetail(node_centers=node_centers, node_alloc=t_i,
                        node_totals=node_totals, rounds=rounds)
    return ClusteringResult(centers, cs, ledger, local_costs,
                            exec_detail=detail)


# ---------------------------------------------------------------------------
# SPMD / mesh path (production): one rank per device of a mesh axis
# ---------------------------------------------------------------------------

COLLECTIVES = ("all_gather", "neighbor_rounds", "torus_2d")


def spmd_distributed_kmeans_fn(
    axis_name: str,
    axis_size: int,
    k: int,
    t: int,
    t_buffer: int,
    objective: ObjectiveLike = "kmeans",
    lloyd_iters: int = 8,
    final_lloyd_iters: int = 10,
    backend: BackendLike = None,
    collectives: str = "all_gather",
    strategy: StrategyLike = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
):
    """Build the per-rank function of Algorithm 1 + 2 on a mesh axis:
    ``per_device(key, pts, mask, phase_times=None) -> (centers (k, d),
    local_cost (1,), t_local (1,))``, run inside ``with mesh:`` on every
    rank of ``axis_name``.

    Each rank holds one site's (M, d) shard and mask (the mesh wrapper
    merges several site blocks per rank into one). Cross-rank traffic is
    exactly one gather of the ``axis_size`` Round-1 cost scalars and one
    gather of the fixed-size local portions (Round 2): the paper's
    protocol on collectives. ``collectives`` picks the schedule:
    ``"all_gather"`` (one collective of the group), ``"neighbor_rounds"``
    (the ring of Algorithm 3,
    :func:`~repro_torch.core.message_passing.neighbor_rounds_gather`) or
    ``"torus_2d"`` (a row phase then a column phase on an (R, C) folding,
    :func:`~repro_torch.core.message_passing.torus_rounds_gather`;
    ``mesh_shape`` defaults to the most-square folding). Every schedule
    relays each buffer's bytes unchanged and the consumer code is the
    same, so the three give bit-identical results. The cost total is
    reduced from the gathered vector, never by a ring sum, whose order
    would differ from rank to rank.

    Gathering the scalars lets every rank run the exact largest-remainder
    allocation of the host path, so ``sum_i t_i == t`` here too; ``t_local``
    is not clamped to ``t_buffer`` (the draws are truncated at the buffer
    while the weight formula keeps the full allocation), as on the host.

    ``phase_times``, when a dict, receives the walls (s) of ``"round1"``
    (the local solve and sensitivities), ``"round1_gather"`` (the scalar
    gather and the allocation), ``"sample"``, ``"round2_gather"`` and
    ``"solve"``, and ``"round1_gather_bytes"`` / ``"round2_gather_bytes"``:
    the bytes this rank received in each round's gathers."""
    objective = objective_mod.resolve_name(objective)
    strat = strategy_mod.get_strategy(strategy_mod.resolve_name(strategy))
    if collectives not in COLLECTIVES:
        raise ValueError(f"unknown collectives {collectives!r}: expected "
                         f"'all_gather'|'neighbor_rounds'|'torus_2d'")
    if collectives == "torus_2d":
        mesh_shape = (torus_mesh_shape(axis_size) if mesh_shape is None
                      else tuple(mesh_shape))
        if mesh_shape[0] * mesh_shape[1] != axis_size:
            raise ValueError(f"mesh_shape {mesh_shape} does not tile "
                             f"axis_size {axis_size}")
    elif mesh_shape is not None:
        raise ValueError("mesh_shape is only meaningful with "
                         "collectives='torus_2d'")
    obj = objective_mod.get_objective(objective)

    def gather(x: torch.Tensor, times: Optional[dict], phase: str
               ) -> torch.Tensor:
        if collectives == "all_gather":
            out = mesh_mod.axis(axis_name).all_gather(x)
        elif collectives == "torus_2d":
            out = torus_rounds_gather(x, axis_name, mesh_shape)
        else:
            out = neighbor_rounds_gather(x, axis_name, axis_size)
        if times is not None:
            name = f"{phase}_bytes"
            times[name] = times.get(name, 0) + out.nbytes - x.nbytes
        return out

    def per_device(key: torch.Tensor, pts: torch.Tensor, mask: torch.Tensor,
                   phase_times: Optional[dict] = None):
        dev = pts.device
        bname = backend_mod.resolve_name(backend, dev)
        b = backend_mod.get_backend(bname, dev)
        w = mask.to(pts.dtype)
        site = mesh_mod.axis_index(axis_name)
        ki = prng.fold_in(key, site)
        k_solve, k_sample = prng.split(ki)

        # Round 1: local solve + single-scalar communication
        with _phase(phase_times, "round1", dev):
            centers = clustering._kmeans_pp_init(k_solve[None], pts[None],
                                                 w[None], k, obj, b)[0]
            centers, _ = clustering._lloyd(pts, centers, w, lloyd_iters,
                                           obj, b)
            m, assign, w_eff = strat.site_sensitivities(
                pts, centers, w, objective=objective, backend=bname)
            local_cost = _windowed_sum(m)
        with _phase(phase_times, "round1_gather", dev):
            if strat.needs_exchange:
                all_costs = gather(local_cost, phase_times, "round1_gather")
                total_cost = _windowed_sum(all_costs)
                # the host path's exact largest-remainder allocation,
                # replicated on every rank
                t_all = strat.allocate(all_costs, t)
                t_local = t_all[site]
                t_total = t_all.sum().to(pts.dtype)       # == t exactly
            else:
                # single shuffle: the uniform split is derivable on every
                # rank, and the standalone weight formula uses the local
                # scalar and share
                t_all = strat.allocate(pts.new_ones((axis_size,)), t)
                t_local = t_all[site]
                total_cost = local_cost
                t_total = t_local.to(pts.dtype)

        with _phase(phase_times, "sample", dev):
            sampled, w_s, w_b = _sample_and_weight(
                k_sample[None], pts[None], m[None], w_eff[None],
                assign[None], k, t_local[None], t_buffer,
                total_cost[None], t_total[None])
            portion_pts = torch.cat([sampled[0], centers], dim=0)
            portion_w = torch.cat([w_s[0], w_b[0]], dim=0)

        # Round 2: share the fixed-size portions
        with _phase(phase_times, "round2_gather", dev):
            cs_pts = gather(portion_pts, phase_times, "round2_gather")
            cs_w = gather(portion_w, phase_times, "round2_gather")
        cs_pts = cs_pts.reshape(-1, pts.shape[-1])
        cs_w = cs_w.reshape(-1)

        # every rank solves the identical weighted instance (replicated)
        with _phase(phase_times, "solve", dev):
            k_final = prng.fold_in(key, 0)
            fc = clustering._kmeans_pp_init(
                k_final[None], cs_pts[None],
                torch.clamp_min(cs_w, 0.0)[None], k, obj, b)[0]
            fc, _ = clustering._lloyd(cs_pts, fc, cs_w, final_lloyd_iters,
                                      obj, b)
        return fc, local_cost[None], t_local[None]

    return per_device


def spmd_distributed_kmeans(
    mesh: Mesh,
    axis_name: str,
    key,
    site_points,   # (n_sites, M, d): every rank passes the global arrays
    site_mask,
    k: int,
    t: int,
    t_buffer: Optional[int] = None,
    objective: ObjectiveLike = "kmeans",
    lloyd_iters: int = 8,
    backend: BackendLike = None,
    collectives: str = "all_gather",
    strategy: StrategyLike = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
    device: DeviceLike = None,
    phase_times: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the SPMD path on this rank of ``mesh`` (call it on every rank,
    e.g. through :func:`repro_torch.core.mesh.launch`). Returns (centers
    (k, d), local_costs (axis_size,), t_i (axis_size,)) on every rank;
    ``t_i`` are the per-site sample allocations, ``sum(t_i) == t`` exactly.

    Each rank moves only its block of ``n_sites / axis_size`` sites to its
    device and merges them into one site, so ``axis_size`` sites take part
    in the allocation; the default ``t_buffer`` is therefore sized off
    ``axis_size`` (``max(4 t // axis_size, 64)``). The outputs are
    gathered after the protocol's two rounds (the reference's
    ``out_specs``), which is one more collective outside the protocol.

    ``device`` is the rank's device and must be the mesh's (the default).
    ``phase_times``, when a dict, receives what
    :func:`spmd_distributed_kmeans_fn` records, plus the wall and bytes of
    ``"output_gather"``, ``"hops"`` (sequential hops of one gather,
    :func:`~repro_torch.core.message_passing.collective_hops`),
    ``"gathers"`` (gathers in the protocol) and ``"staged_bytes"`` (bytes
    the call staged through host memory, both ways)."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis {axis_name!r} is not the mesh's axis "
                         f"{mesh.axis_name!r}")
    dev = mesh.device if device is None else torch.device(device)
    if dev != mesh.device:
        raise ValueError(f"device {dev} is not the mesh's device "
                         f"{mesh.device}")
    n_sites = site_points.shape[0]
    axis_size = mesh.shape[axis_name]
    if n_sites % axis_size:
        raise ValueError(f"n_sites={n_sites} must divide over {axis_name}="
                         f"{axis_size}")
    t_buffer = t_buffer if t_buffer is not None else max(
        4 * t // max(axis_size, 1), 64)
    fn = spmd_distributed_kmeans_fn(axis_name, axis_size, k, t, t_buffer,
                                    objective, lloyd_iters, backend=backend,
                                    collectives=collectives,
                                    strategy=strategy, mesh_shape=mesh_shape)
    block = n_sites // axis_size
    lo = mesh.rank * block
    d = site_points.shape[-1]
    pts = as_tensor(site_points[lo:lo + block], dev).reshape(-1, d)
    mask = as_tensor(site_mask[lo:lo + block], dev).reshape(-1)
    staged0 = mesh.staged_bytes
    with mesh:
        centers, local_cost, t_local = fn(as_tensor(key, dev), pts, mask,
                                          phase_times=phase_times)
        with _phase(phase_times, "output_gather", dev):
            local_costs = mesh.all_gather(local_cost).reshape(-1)
            t_i = mesh.all_gather(t_local).reshape(-1)
    if phase_times is not None:
        phase_times["output_gather_bytes"] = (
            local_costs.nbytes + t_i.nbytes
            - local_cost.nbytes - t_local.nbytes)
        phase_times["hops"] = collective_hops(collectives, axis_size,
                                              mesh_shape)
        exchange = strategy_mod.get_strategy(strategy).needs_exchange
        phase_times["gathers"] = 3 if exchange else 2
        phase_times["staged_bytes"] = mesh.staged_bytes - staged0
    return centers, local_costs, t_i
