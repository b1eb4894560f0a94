"""Batched stream ingestion: the single-site state and the distributed mode
(the port of ``repro.stream.ingest``).

:class:`StreamState` wraps one :class:`~repro_torch.stream.tree.CoresetTree`
behind a ``push(batch)`` of any size: points collect in a host pending
buffer and go to the tree in fixed ``batch_size`` chunks. ``summary()`` is
any-time: the tree's summary plus the pending tail as raw weight-1 points.

:class:`DistributedStream` is the topology mode: every node of a
:class:`~repro_torch.core.topology.Graph` runs its own tree over its local
arrivals (no communication), and :meth:`DistributedStream.aggregate` runs
one round of **Algorithm 1 over the per-site tree summaries** -- each
site's summary is its weighted local instance -- so every node ends the
round holding the same global coreset and centers. Each round's
communication is one :class:`~repro_torch.core.comm.CommLedger` phase,
``stream_round_<r>``. ``transport="tree"`` (``routing="bfs"`` or
``"min_cost"``) swaps the floods for a spanning-tree gather and broadcast;
``engine="exec"`` moves the payloads through the topology execution
engine, bit-identical to ``engine="sim"`` with a measured ledger;
``engine="async"`` (or a ``faults=`` plan) floods them on the asynchronous
WAN runtime (:mod:`repro_torch.wan`), restricted to the surviving sites.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import clustering
from repro_torch.core import objective as objective_mod
from repro_torch.core import prng
from repro_torch.core import strategy as strategy_mod
from repro_torch.core.backend import DeviceLike, as_tensor
from repro_torch.core.comm import (CommLedger, flood_cost,
                                   flood_portions_cost, link_cost_of,
                                   tree_allocation_cost, tree_broadcast_cost,
                                   tree_gather_cost, tree_up_cost)
from repro_torch.core.coreset import Coreset, distributed_coreset
from repro_torch.core.distributed import (exec_algorithm1_rounds,
                                          exec_algorithm1_tree_rounds)
from repro_torch.core.message_passing import (GossipSchedule, TreeSchedule,
                                              flood_exec, gossip_schedule,
                                              pack_payload,
                                              tree_broadcast_exec,
                                              tree_gather_exec,
                                              unpack_payload)
from repro_torch.core.strategy import StrategyLike
from repro_torch.core.topology import Graph, SpanningTree, spanning_tree
from repro_torch.stream.tree import CoresetTree, TreeConfig


class StreamState:
    """Single-site ingestion state: ``push`` batches of any size,
    ``summary`` at any time. Runs on ``device`` (CUDA unless the caller
    asks for the CPU)."""

    def __init__(self, config: TreeConfig, key=None,
                 device: DeviceLike = None):
        self.tree = CoresetTree(config, key=key, device=device)
        self._pending = np.zeros((0, config.d), np.float32)
        self.n_pushed = 0

    @property
    def config(self) -> TreeConfig:
        return self.tree.config

    @property
    def device(self) -> torch.device:
        return self.tree.device

    def push(self, batch) -> None:
        """Ingest ``(n, d)`` points, any n: full ``batch_size`` chunks go to
        the tree, the remainder stays pending until the next push."""
        if isinstance(batch, torch.Tensor):
            batch = batch.detach().cpu().numpy()
        batch = np.asarray(batch, np.float32)
        if batch.ndim != 2 or batch.shape[1] != self.config.d:
            raise ValueError(f"expected (n, {self.config.d}) points, got "
                             f"{batch.shape}")
        self.n_pushed += batch.shape[0]
        buf = np.concatenate([self._pending, batch])
        bs = self.config.batch_size
        n_full = buf.shape[0] // bs
        for i in range(n_full):
            self.tree.push(buf[i * bs:(i + 1) * bs])
        self._pending = buf[n_full * bs:]

    def pending(self) -> int:
        return int(self._pending.shape[0])

    def summary(self, include_pending: bool = True) -> Coreset:
        """Any-time weighted summary of everything pushed. With
        ``include_pending`` the sub-batch tail rides along as raw weight-1
        points padded to one batch slot (the shape stays constant)."""
        s = self.tree.summary()
        if not include_pending:
            return s
        bs = self.config.batch_size
        tail = np.zeros((bs, self.config.d), np.float32)
        w = np.zeros((bs,), np.float32)
        n_p = self.pending()
        tail[:n_p] = self._pending
        w[:n_p] = 1.0
        return Coreset.concat(s, Coreset(points=as_tensor(tail, self.device),
                                         weights=as_tensor(w, self.device)))

    def total_weight(self) -> float:
        return self.tree.total_weight + float(self.pending())


@dataclasses.dataclass
class AggregateResult:
    """One aggregation round: the global summary every node holds after it,
    the centers solved from it, and the round's metered communication
    (also added to the stream's cumulative ledger). ``local_costs`` are the
    Round-1 scalars of a resample round, ``None`` for a union round."""

    coreset: Coreset
    centers: torch.Tensor
    ledger: CommLedger
    local_costs: Optional[torch.Tensor]


class DistributedStream:
    """Per-site coreset trees over a communication graph, and periodic
    Algorithm-1 aggregation rounds with full ledger accounting. Runs on
    ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, graph: Graph, config: TreeConfig, key=None,
                 device: DeviceLike = None):
        self.device = backend_mod.resolve_device(device)
        key = (prng.PRNGKey(0, device=self.device) if key is None
               else as_tensor(key, self.device))
        self.graph = graph
        # freeze the ambient backend now, as the per-site trees do, and
        # resolve the objective (unknown names fail before any push)
        self.config = dataclasses.replace(
            config,
            backend=backend_mod.resolve_name(config.backend, self.device),
            objective=objective_mod.resolve_name(config.objective))
        self.sites: List[StreamState] = [
            StreamState(config, key=prng.fold_in(key, i), device=self.device)
            for i in range(graph.n)
        ]
        self._agg_key = prng.fold_in(key, graph.n)
        self._schedule: Optional[GossipSchedule] = None   # built lazily
        self._trees: dict = {}     # (routing, root) -> (tree, TreeSchedule)
        self.ledger = CommLedger()
        self.rounds = 0

    def push(self, site: int, batch) -> None:
        """Local arrival at one node: costs no communication."""
        site = int(site)
        if not 0 <= site < self.graph.n:
            raise ValueError(f"site index {site} out of range for a "
                             f"{self.graph.n}-node topology")
        self.sites[site].push(batch)

    def push_all(self, site_batches) -> None:
        """One arrival per node (length-n sequence of (n_i, d) arrays)."""
        if len(site_batches) != self.graph.n:
            raise ValueError(f"expected {self.graph.n} site batches")
        for i, b in enumerate(site_batches):
            self.push(i, b)

    def total_weight(self) -> float:
        return sum(s.total_weight() for s in self.sites)

    def _tree_schedule(self, routing: str, root: int):
        """The spanning tree and its compiled schedule for a tree round
        (built once per (routing, root))."""
        key = (routing, int(root))
        if key not in self._trees:
            tree = spanning_tree(self.graph, root=root, routing=routing)
            self._trees[key] = (tree, TreeSchedule.from_tree(tree))
        return self._trees[key]

    def aggregate(self, k: int, t: int, lloyd_iters: int = 8,
                  clip_negative: bool = False,
                  mode: str = "auto", restarts: int = 3,
                  engine: str = "sim", transport: str = "flood",
                  routing: str = "bfs", root: int = 0,
                  faults=None, wan_mode: Optional[str] = None,
                  wan_seed: Optional[int] = None,
                  wan_p: float = 0.5,
                  strategy: StrategyLike = None) -> AggregateResult:
        """Run one aggregation round over the current per-site summaries
        (each ``levels * slot + batch_size`` points, vacant slots weight 0).

        * ``mode="resample"`` -- Algorithm 1 over the summaries: Round 1
          moves the n local-cost scalars, Round 2 the n sampled portions
          (t + nk points).
        * ``mode="union"`` -- move the summaries themselves: exact (the
          union of coresets is a coreset of the union), and better whenever
          their total effective size is at most the t + nk points of a
          resample round.
        * ``mode="auto"`` picks union exactly in that regime.

        ``engine="sim"`` computes the round globally with the analytic
        ledger; ``engine="exec"`` moves the summaries, scalars and
        portions through the topology execution engine (one gossip
        schedule per stream), every node assembles the bit-identical
        result, and the ledger is measured (equal to the analytic one;
        vacant slots ride along but carry weight 0 and are not metered).
        ``transport="tree"`` gathers to ``root`` along a spanning tree
        (``routing="bfs"`` or ``"min_cost"``) and broadcasts the assembled
        coreset back: the same result, a ledger over tree edges only.

        ``engine="async"`` (or a ``faults=``
        :class:`~repro_torch.wan.faults.FaultPlan` with either engine) runs
        the round's floods on the asynchronous WAN runtime (flood transport
        only): ``wan_mode`` picks the activation schedule (``"clock"``
        default for async, ``"full"`` when faults ride on
        ``engine="exec"``), ``wan_seed`` defaults to the round counter so
        successive rounds draw fresh schedules, and the round's ledger
        carries the measured ``staleness`` axis. The round result is the
        *survivor-restricted* aggregate: every surviving node ends holding
        the bit-identical coreset over surviving sites.

        The round's ledger is tagged ``stream_round_<r>`` and added to
        ``self.ledger``."""
        cfg = self.config
        g = self.graph
        if engine not in ("sim", "exec", "async"):
            raise ValueError(f"unknown engine {engine!r}: expected "
                             f"'sim'|'exec'|'async'")
        if transport not in ("flood", "tree"):
            raise ValueError(f"unknown transport {transport!r}: expected "
                             f"'flood'|'tree'")
        strategy = strategy_mod.resolve_name(strategy)
        strat = strategy_mod.get_strategy(strategy)
        use_wan = engine == "async" or faults is not None
        if not strat.needs_exchange and transport == "flood" and not use_wan:
            # single-shuffle strategies never flood on synchronous rounds:
            # map -> shuffle -> reduce along the spanning tree instead
            transport = "tree"
        if use_wan:
            if transport != "flood":
                raise ValueError(f"faulty/async rounds support "
                                 f"transport='flood' only, got {transport!r}")
            if engine == "sim":
                raise ValueError("faults require engine='exec'|'async'")
            wan_mode = wan_mode if wan_mode is not None else (
                "full" if engine == "exec" else "clock")
            wan_seed = self.rounds if wan_seed is None else wan_seed
        tree: Optional[SpanningTree] = None
        tsched: Optional[TreeSchedule] = None
        if transport == "tree":
            tree, tsched = self._tree_schedule(routing, root)
        elif engine == "exec" and self._schedule is None:
            self._schedule = gossip_schedule(g)
        summaries = [s.summary() for s in self.sites]
        sp = torch.stack([c.points for c in summaries])     # (n, S, d)
        sw = torch.stack([c.weights for c in summaries])    # (n, S)
        self._agg_key, kr = prng.split(self._agg_key)
        k1, k2 = prng.split(kr)

        if mode != "resample":
            # one host read for the whole round (resample never needs it)
            sum_eff = int((sw != 0.0).sum())
        if mode == "auto":
            mode = "union" if sum_eff <= t + g.n * k else "resample"

        dev = self.device
        if mode == "union":
            local_costs = None
            eff = (sw != 0.0).sum(1).cpu().numpy().astype(np.float64)
            if use_wan:
                from repro_torch.wan.faults import FaultPlan
                from repro_torch.wan.runtime import wan_flood_exec
                plan = faults if faults is not None else FaultPlan()
                payload = pack_payload(sp, sw)
                tables, rr = wan_flood_exec(g, payload, mode=wan_mode,
                                            faults=plan, unit_points=eff,
                                            dim=cfg.d, seed=wan_seed,
                                            p=wan_p)
                surv = plan.surviving_nodes(g.n)
                pts0, w0 = unpack_payload(tables[int(surv[0])][
                    torch.as_tensor(surv, device=tables.device)])
                cs = Coreset(points=pts0.reshape(-1, cfg.d),
                             weights=w0.reshape(-1))
                round_ledger = rr.ledger
            elif transport == "tree" and engine == "exec":
                payload = pack_payload(sp, sw)
                root_table, gr = tree_gather_exec(tsched, payload,
                                                  unit_points=eff, dim=cfg.d)
                _, br = tree_broadcast_exec(tsched, root_table,
                                            unit_points=float(sum_eff),
                                            dim=cfg.d)
                pts0, w0 = unpack_payload(root_table)
                cs = Coreset(points=pts0.reshape(-1, cfg.d),
                             weights=w0.reshape(-1))
                round_ledger = gr.ledger.add(br.ledger)
            elif transport == "tree":
                cs = Coreset.concat(*summaries)
                round_ledger = tree_gather_cost(
                    tree, unit_points_per_node=eff, dim=cfg.d)
                round_ledger = round_ledger.add(tree_broadcast_cost(
                    tree, unit_points=float(sum_eff), dim=cfg.d))
            elif engine == "exec":
                payload = pack_payload(sp, sw)
                tables, rr = flood_exec(self._schedule, payload,
                                        unit_points=eff, dim=cfg.d)
                pts0, w0 = unpack_payload(tables[0])
                cs = Coreset(points=pts0.reshape(-1, cfg.d),
                             weights=w0.reshape(-1))
                round_ledger = rr.ledger
            else:
                cs = Coreset.concat(*summaries)
                # per-origin link pricing, term for term the engine's
                # measured sum
                w_pm = float(g.weighted_degrees().sum())
                round_ledger = CommLedger(
                    points=2.0 * g.m * float(sum_eff),
                    messages=2.0 * g.m * g.n, dim=cfg.d,
                    link_cost=link_cost_of(np.full(g.n, w_pm),
                                           unit_points=eff, dim=cfg.d))
        elif mode == "resample":
            if use_wan:
                from repro_torch.wan.runtime import async_algorithm1_rounds
                detail, local_costs = async_algorithm1_rounds(
                    g, k1, sp, sw, k, t, t_buffer=t,
                    objective=cfg.objective, lloyd_iters=lloyd_iters,
                    clip_negative=clip_negative, backend=cfg.backend,
                    mode=wan_mode, faults=faults, seed=wan_seed, p=wan_p,
                    strategy=strategy)
                cs = Coreset(points=detail.node_points[0],
                             weights=detail.node_weights[0])
                round_ledger = detail.rounds["round2"].ledger
                if "round1" in detail.rounds:
                    round_ledger = detail.rounds["round1"].ledger.add(
                        round_ledger)
            elif transport == "tree" and engine == "exec":
                root_pts, root_w, t_i, _, rounds, local_costs = \
                    exec_algorithm1_tree_rounds(
                        tsched, k1, sp, sw, k, t, t_buffer=t,
                        objective=cfg.objective, lloyd_iters=lloyd_iters,
                        clip_negative=clip_negative, backend=cfg.backend,
                        strategy=strategy)
                table = pack_payload(root_pts, root_w)
                unit_b = float(t_i.cpu().numpy().astype(np.float64).sum()) \
                    + g.n * k
                _, br = tree_broadcast_exec(tsched, table,
                                            unit_points=unit_b, dim=cfg.d)
                cs = Coreset(points=root_pts.reshape(-1, cfg.d),
                             weights=root_w.reshape(-1))
                if "round1_gather" in rounds:
                    round_ledger = (rounds["round1_gather"].ledger
                                    .add(rounds["round1_scatter"].ledger)
                                    .add(rounds["round1_broadcast"].ledger)
                                    .add(rounds["round2_gather"].ledger)
                                    .add(br.ledger))
                else:   # single shuffle: no Round-1 phases at all
                    round_ledger = rounds["round2_gather"].ledger.add(
                        br.ledger)
            elif transport == "tree":
                dc = distributed_coreset(k1, sp, sw != 0.0, k, t,
                                         objective=cfg.objective,
                                         lloyd_iters=lloyd_iters,
                                         clip_negative=clip_negative,
                                         backend=cfg.backend, site_weights=sw,
                                         strategy=strategy, device=dev)
                cs = dc.flatten()
                local_costs = dc.local_costs
                t_i = dc.t_i.cpu().numpy().astype(np.float64)
                up = tree_up_cost(tree, t_i + k, dim=cfg.d)
                if strat.needs_exchange:
                    round_ledger = tree_allocation_cost(tree).add(up)
                else:   # the uniform split is derived locally: no traffic
                    round_ledger = up
                round_ledger = round_ledger.add(tree_broadcast_cost(
                    tree, unit_points=float(t_i.sum()) + g.n * k,
                    dim=cfg.d))
            elif engine == "exec":
                detail, local_costs = exec_algorithm1_rounds(
                    self._schedule, k1, sp, sw, k, t, t_buffer=t,
                    objective=cfg.objective, lloyd_iters=lloyd_iters,
                    clip_negative=clip_negative, backend=cfg.backend,
                    strategy=strategy)
                cs = Coreset(points=detail.node_points[0],
                             weights=detail.node_weights[0])
                round_ledger = detail.rounds["round1"].ledger.add(
                    detail.rounds["round2"].ledger)
            else:
                dc = distributed_coreset(k1, sp, sw != 0.0, k, t,
                                         objective=cfg.objective,
                                         lloyd_iters=lloyd_iters,
                                         clip_negative=clip_negative,
                                         backend=cfg.backend, site_weights=sw,
                                         strategy=strategy, device=dev)
                cs = dc.flatten()
                local_costs = dc.local_costs
                round_ledger = flood_cost(g, n_messages=g.n, unit_scalars=1.0)
                round_ledger = round_ledger.add(
                    flood_portions_cost(g, dc.t_i.cpu().numpy(), k, cfg.d))
        else:
            raise ValueError(f"unknown aggregate mode {mode!r}")

        # solve on the non-negative part of the signed measure: optimizing
        # against negative mass admits spurious minima, and twice-resampled
        # summaries carry much cancellation; restarts for the same reason
        w_solve = torch.clamp_min(cs.weights, 0.0)
        centers, _ = clustering.solve(k2, cs.points, k, weights=w_solve,
                                      lloyd_iters=lloyd_iters,
                                      objective=cfg.objective,
                                      restarts=restarts, backend=cfg.backend,
                                      device=dev)

        round_ledger = round_ledger.tag(f"stream_round_{self.rounds}")
        self.ledger = self.ledger.add(round_ledger)
        self.rounds += 1
        return AggregateResult(coreset=cs, centers=centers,
                               ledger=round_ledger, local_costs=local_costs)
