"""The asynchronous WAN flood runtime and the faulty Algorithm-1 rounds (the
port of ``repro.wan.runtime``).

:func:`wan_flood_exec` executes Algorithm 3 under an asynchronous
activation schedule and a :class:`~repro_torch.wan.faults.FaultPlan`, one
round after another on the payload's device. The protocol is **send-once
relay**: each directed out-slot ``(v, i)`` keeps per-origin state
``sent[v, i, o]`` and transmits origin ``o``'s payload at the first live
round after ``v`` learns it; receivers overwrite on first receipt, never
sum, so every copy anywhere is a bit-exact relay of the origin's payload
and duplicate deliveries are idempotent by construction (the quiescence
checker still verifies it empirically). Fault and activation masks are
dense per-round boolean inputs built on the host
(:mod:`repro_torch.wan.schedules`), shipped to the device once per
attempt, so a faulty run is bit-reproducible from ``(plan, mode, seed)``.

The measured :class:`~repro_torch.core.comm.CommLedger` carries the
``staleness`` axis: node ``v``'s *completion round* is the first round
after which it knows every tracked (surviving) origin, its sync baseline
is its eccentricity in the lossless timetable ``Graph.distances()``, and
``staleness_v`` is the excess. The ledger records the mean over surviving
nodes; per-round sub-ledgers are filed as ``wan_round_###`` phases. The
per-round transmit cubes come to the host once, at the end, and are priced
in float64 numpy with the reference's expressions, so every axis and every
phase equals the reference's exactly.

Quiescence bounds (certified in :mod:`repro_torch.wan.quiesce`): with a
connected surviving subgraph of diameter ``D'`` and churn horizon ``H``,
mode ``"full"`` completes by round ``H + D'`` and quiesces one round
later; mode ``"clock"`` multiplies the per-hop latency by the maximum edge
period; mode ``"random"`` has no deterministic bound and doubles its
(prefix-stable) round budget until the pending count hits zero.

:func:`async_algorithm1_rounds` runs the paper's Algorithm 1 with both
communication rounds under this runtime, restricting the allocation and
the assembled coreset to *surviving* origins -- which is what makes the
result bit-identical to :func:`restricted_sim_coreset`, the oracle run on
the surviving sites alone.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import strategy as strategy_mod
from repro_torch.core.backend import DeviceLike, as_tensor
from repro_torch.core.comm import CommLedger
from repro_torch.core.coreset import _phase, _windowed_sum
from repro_torch.core.message_passing import (Units, _placed, _receive,
                                              _units_ledger, pack_payload,
                                              unpack_payload)
from repro_torch.core.strategy import Round1State, StrategyLike
from repro_torch.core.topology import Graph, diameter
from repro_torch.wan.faults import FaultPlan
from repro_torch.wan.schedules import (WanSchedule, liveness_masks,
                                       wan_schedule)

_MAX_ROUNDS = 4096


@dataclasses.dataclass
class WanExecResult:
    """Outcome of one asynchronous flood.

    ``rounds`` is the executed round count; ``rounds_to_complete`` the
    first round after which every surviving node knew every tracked
    origin; ``rounds_to_quiesce`` the first round after which no
    send-once obligation remained on any usable slot (all traffic ever
    after is zero). ``completion``/``staleness`` are per-node (staleness
    is 0 for non-surviving nodes); ``ledger.staleness`` is the surviving
    mean. ``known`` is the final (node, origin) knowledge table."""

    rounds: int
    rounds_to_complete: int
    rounds_to_quiesce: int
    ledger: CommLedger
    per_round_transmissions: List[int]
    completion: np.ndarray
    staleness: np.ndarray
    known: np.ndarray
    mode: str
    wall_s: float = 0.0


def _wan_flood_rounds(ws: WanSchedule, flat: torch.Tensor, live, dup,
                      track, usable):
    """Run ``live.shape[0]`` asynchronous rounds of send-once relay on
    ``flat``'s device.

    State: ``known`` (n, n) node x origin knowledge, ``sent``
    (n, max_deg, n) per-out-slot send-once flags, ``table`` (n, n, F)
    relayed payload copies. Each round a slot transmits every known,
    not-yet-sent origin if ``live``; ``dup`` forces re-transmission of
    already-sent origins (metered, delivered, idempotent). The receive
    side reads the *sender's* transmit decisions through ``in_slot`` (the
    sender-side slot of each in-edge), so directed graphs relay along the
    links. A new copy comes from the first delivering in-slot and is
    written in place into the rows that learn it, by the synchronous
    engine's receive step (``message_passing._receive``).
    Returns the table, ``known``, and the stacked per-round transmit cubes,
    per-node tracked-completion flags and outstanding send-once counts over
    the ``usable`` steady-state slots (zero == quiesced)."""
    base = ws.base
    n, dev = base.n, flat.device
    in_nb = torch.as_tensor(base.in_neighbors, dtype=torch.int64,
                            device=dev)
    in_mask = torch.as_tensor(base.in_neighbor_mask, device=dev)[:, :, None]
    in_slot = torch.as_tensor(ws.in_slot, dtype=torch.int64, device=dev)
    live = torch.as_tensor(live, device=dev)[..., None]    # (R, n, deg, 1)
    dup = torch.as_tensor(dup, device=dev)[..., None]
    not_track = ~torch.as_tensor(track, device=dev)[None, :]
    usable = torch.as_tensor(usable, device=dev)[:, :, None]
    rank = torch.arange(in_nb.shape[1], 0, -1, device=dev)
    diag = torch.arange(n, device=dev)
    table = flat.new_zeros((n, n, flat.shape[1]))
    table[diag, diag] = flat
    known = torch.eye(n, dtype=torch.bool, device=dev)
    sent = torch.zeros((n, live.shape[2], n), dtype=torch.bool, device=dev)
    xmits, done, pending = [], [], []
    for r in range(live.shape[0]):
        want = known[:, None, :] & ~sent & live[r]
        xmit = want | (sent & live[r] & dup[r])
        new = _receive(table, known, xmit[in_nb, in_slot] & in_mask, in_nb,
                       rank)
        known = known | new
        sent = sent | want
        pending.append((known[:, None, :] & ~sent & usable).sum())
        done.append((known | not_track).all(1))
        xmits.append(xmit)
    return (table, known, torch.stack(xmits), torch.stack(done),
            torch.stack(pending))


def _round_budget(ws: WanSchedule, mode: str, plan: FaultPlan,
                  d_surv: int) -> int:
    """Deterministic round bound (+1 flush slack) for full/clock modes;
    the starting guess for random mode."""
    h = plan.horizon()
    if mode == "clock":
        return h + ws.max_period * (d_surv + 2)
    return h + d_surv + 2


def wan_flood_exec(graph: Graph, payload, mode: str = "full",
                   faults: Optional[FaultPlan] = None,
                   unit_scalars: Units = 0.0, unit_points: Units = 0.0,
                   dim: int = 0, seed: int = 0, p: float = 0.5,
                   max_rounds: int = _MAX_ROUNDS
                   ) -> Tuple[torch.Tensor, WanExecResult]:
    """Execute Algorithm 3 asynchronously under faults.

    Same payload/units contract as
    :func:`~repro_torch.core.message_passing.flood_exec` (the rounds run on
    the payload tensor's device); tracked origins are the plan's survivors
    (all nodes on a trivial plan), and the run raises if the surviving
    subgraph is disconnected or the tracked flood fails to complete within
    the round budget (random mode doubles its prefix-stable budget up to
    ``max_rounds`` first, rerunning from round 0). Returns the relay table
    over *all* nodes -- restrict to surviving rows/origins before consuming
    it; dead origins' columns are whatever partially spread before
    death."""
    plan = faults if faults is not None else FaultPlan()
    ws = wan_schedule(graph)
    t0 = time.perf_counter()
    payload = _placed(payload)
    if payload.shape[0] != graph.n:
        raise ValueError(f"payload must be origin-indexed: got leading dim "
                         f"{payload.shape[0]} for a {graph.n}-node graph")
    surv = plan.surviving_nodes(graph.n)
    sub, _ = plan.surviving_graph(graph)
    try:
        d_surv = diameter(sub)
    except ValueError as e:
        raise ValueError(f"fault plan disconnects the surviving subgraph "
                         f"({e}); no quiescence bound exists") from e
    track = np.zeros(graph.n, bool)
    track[surv] = True

    trailing = tuple(payload.shape[1:])
    flat = payload.reshape(graph.n, -1)
    n_rounds = max(1, _round_budget(ws, mode, plan, d_surv))
    while True:
        live, dup, usable = liveness_masks(ws, mode, n_rounds, plan,
                                           seed=seed, p=p)
        table, known, xmits, done, pending = _wan_flood_rounds(
            ws, flat, live, dup, track, usable)
        pending_np = pending.cpu().numpy()
        done_np = done.cpu().numpy()
        quiesced = bool(pending_np[-1] == 0)
        complete = bool(done_np[-1][surv].all())   # the dead owe nothing
        if complete and quiesced:
            break
        if mode == "random" and n_rounds < max_rounds:
            n_rounds = min(2 * n_rounds, max_rounds)   # prefix-stable
            continue
        raise RuntimeError(
            f"wan flood did not {'complete' if not complete else 'quiesce'} "
            f"in {n_rounds} rounds (mode={mode!r}, horizon="
            f"{plan.horizon()}, surviving diameter={d_surv})")

    known_np = known.cpu().numpy()
    xmits_np = xmits.cpu().numpy()               # (rounds, n, deg, n) bool

    # per-node completion round (0 if a node starts complete, e.g. n == 1)
    init_done = (np.eye(graph.n, dtype=bool) | ~track[None, :]).all(axis=1)
    completion = np.empty(graph.n, np.int64)
    for v in range(graph.n):
        if init_done[v]:
            completion[v] = 0
        else:
            hits = np.nonzero(done_np[:, v])[0]
            completion[v] = int(hits[0]) + 1 if hits.size else n_rounds + 1
    rounds_to_complete = int(completion[surv].max()) if surv.size else 0
    q_hits = np.nonzero(pending_np == 0)[0]
    rounds_to_quiesce = int(q_hits[0]) + 1 if q_hits.size else n_rounds

    # staleness vs the synchronous lossless timetable on the full graph
    dist = graph.distances()
    ecc = np.zeros(graph.n, np.int64)
    for v in range(graph.n):
        dv = dist[surv, v]
        ecc[v] = int(dv.max()) if (dv >= 0).all() else 0
    staleness = np.where(track, np.maximum(0, completion - ecc), 0)

    # ledger: totals from the summed counts (canonical float64 pricing),
    # per-round sub-ledgers filed as phases up to quiescence
    nc = np.asarray(ws.base.neighbor_costs, np.float64)
    counts = xmits_np.astype(np.int64)
    total = counts.sum(axis=0)                   # (n, deg, n)
    per_origin = total.sum(axis=(0, 1)).astype(np.float64)
    per_origin_link = (total.astype(np.float64)
                       * nc[:, :, None]).sum(axis=(0, 1))
    ledger = _units_ledger(per_origin, unit_scalars, unit_points, dim,
                           count_all_messages=True,
                           per_origin_link=per_origin_link)
    phases: Dict[str, CommLedger] = {}
    per_round_tx = []
    for r in range(n_rounds):
        cr = counts[r]
        tx = int(cr.sum())
        per_round_tx.append(tx)
        if r < rounds_to_quiesce:
            po = cr.sum(axis=(0, 1)).astype(np.float64)
            pl = (cr.astype(np.float64) * nc[:, :, None]).sum(axis=(0, 1))
            phases[f"wan_round_{r:03d}"] = _units_ledger(
                po, unit_scalars, unit_points, dim,
                count_all_messages=True, per_origin_link=pl)
    mean_stale = float(staleness[surv].mean()) if surv.size else 0.0
    ledger = dataclasses.replace(ledger, staleness=mean_stale,
                                 phases=phases)

    res = WanExecResult(rounds=n_rounds,
                        rounds_to_complete=rounds_to_complete,
                        rounds_to_quiesce=rounds_to_quiesce,
                        ledger=ledger, per_round_transmissions=per_round_tx,
                        completion=completion, staleness=staleness,
                        known=known_np, mode=mode,
                        wall_s=time.perf_counter() - t0)
    return table.reshape((graph.n, graph.n) + trailing), res


# ---------------------------------------------------------------------------
# Algorithm 1 under faults + the restricted sim oracle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AsyncDetail:
    """Per-node state after the faulty executed rounds, restricted to
    surviving origins: the async counterpart of
    :class:`~repro_torch.core.distributed.ExecDetail`. ``surviving`` maps
    the compact survivor axis back to original node ids; ``node_points`` /
    ``node_weights`` are each *surviving* node's assembled coreset over
    surviving origins (rows bit-identical across survivors)."""

    surviving: np.ndarray
    node_points: torch.Tensor
    node_weights: torch.Tensor
    node_alloc: torch.Tensor
    node_totals: torch.Tensor
    rounds: Dict[str, WanExecResult]


def _restrict(table: torch.Tensor, surv: np.ndarray) -> torch.Tensor:
    """``table[surv][:, surv]``: surviving rows and origins (the table
    itself when every node survives)."""
    if surv.size == table.shape[0]:
        return table
    idx = torch.as_tensor(surv, device=table.device)
    return table[idx][:, idx]


def async_algorithm1_rounds(
    graph: Graph,
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
    mode: str = "clock",
    faults: Optional[FaultPlan] = None,
    seed: int = 0,
    p: float = 0.5,
    strategy: StrategyLike = None,
    phase_times: Optional[dict] = None,
) -> Tuple[AsyncDetail, torch.Tensor]:
    """A strategy's two rounds executed on the WAN runtime, on
    ``site_points``' device. Identical key derivation and descriptor hooks
    as the synchronous exec path (the strategy's all-site key table spans
    *every* site, dead or not -- per-site stages are independent, which is
    what keeps survivor-site values bit-identical however many peers die);
    the allocation and the assembled coreset are restricted to surviving
    origins in ascending id order, matching :func:`restricted_sim_coreset`
    bit-for-bit. Every surviving node replays the allocation on its own
    received copy of the scalars, and sums them in the reference's order.
    Single-shuffle strategies skip the Round-1 scalar flood entirely:
    survivors each derive the identical uniform split over the survivor
    set locally and normalize by their own scalar, so the only WAN
    traffic is the portions flood. ``phase_times``, when a dict, receives
    the wall seconds of ``"round1"`` and ``"round2"``. Returns ``(detail,
    local_costs)``."""
    plan = faults if faults is not None else FaultPlan()
    strat = strategy_mod.get_strategy(strategy)
    n_sites, _, d = site_points.shape
    if graph.n != n_sites:
        raise ValueError(f"graph has {graph.n} nodes for {n_sites} sites")
    dev = site_points.device
    surv = plan.surviving_nodes(n_sites)
    n_surv = int(surv.size)
    surv_t = torch.as_tensor(surv, device=dev)
    keys = strat.keys(key, n_sites)

    with _phase(phase_times, "round1", dev):
        r1 = strat.summary(keys[:, 0], site_points, w_site, k=k,
                           objective=objective, lloyd_iters=lloyd_iters,
                           backend=backend)
        local_costs = r1.local_costs
        if strat.needs_exchange:
            # -- Round 1: flood the exchange scalars under faults ----------
            spec = strat.exchange_spec()
            cost_tables, r1x = wan_flood_exec(
                graph, local_costs[:, None], mode=mode, faults=plan,
                unit_scalars=spec.unit_scalars, seed=seed, p=p)
            # every surviving node holds bit-identical copies of every
            # surviving origin's scalar; each replays the strategy's exact
            # allocation over the survivor set (dead origins' partial
            # payloads are discarded)
            costs_at = _restrict(cost_tables, surv)[:, :, 0]   # (n', n')
            node_alloc = torch.stack([strat.allocate(costs_at[v], t)
                                      for v in range(n_surv)])
            t_i = node_alloc.diagonal().clone()    # own share, (n',)
            node_totals = _windowed_sum(costs_at)
            rounds = {"round1": r1x}
        else:
            # no scalar flood: every survivor derives the identical uniform
            # split over the survivor set from (n', t) alone
            t_i = strat.allocate(local_costs[surv_t], t)
            node_alloc = t_i[None, :].repeat(n_surv, 1)
            node_totals = strat.local_totals(local_costs[surv_t])
            rounds = {}

    with _phase(phase_times, "round2", dev):
        sub = Round1State(r1.centers[surv_t], r1.m[surv_t],
                          r1.assign[surv_t], local_costs[surv_t],
                          r1.w_eff[surv_t])
        portions = strat.contribute(
            keys[surv_t, 1], site_points[surv_t], sub, t_i, node_totals,
            k=k, t=t, t_buffer=t_buffer, clip_negative=clip_negative)
        # -- Round 2: flood the portions (dead origin slots carry zeros;
        # they are never assembled) ------------------------------------------
        slots = portions.points.shape[1]
        payload = site_points.new_zeros((n_sites, slots, d + 1))
        payload[surv_t] = pack_payload(portions.points, portions.weights)
        unit_pts = np.zeros(n_sites, np.float64)
        unit_pts[surv] = t_i.cpu().numpy().astype(np.float64) + k
        port_tables, r2 = wan_flood_exec(graph, payload, mode=mode,
                                         faults=plan, unit_points=unit_pts,
                                         dim=d, seed=seed + 1, p=p)
    node_pts, node_w = unpack_payload(_restrict(port_tables, surv))
    rounds["round2"] = r2
    detail = AsyncDetail(
        surviving=surv,
        node_points=node_pts.reshape(n_surv, n_surv * slots, d),
        node_weights=node_w.reshape(n_surv, n_surv * slots),
        node_alloc=node_alloc, node_totals=node_totals,
        rounds=rounds)
    return detail, local_costs


def restricted_sim_coreset(
    key,
    site_points,
    site_mask,
    k: int,
    t: int,
    t_buffer: int,
    objective: str,
    lloyd_iters: int,
    clip_negative: bool,
    backend,
    surviving: np.ndarray,
    strategy: StrategyLike = None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The oracle the faulty exec path must reproduce bit-for-bit: the
    strategy's rounds computed globally, with allocation and coreset
    assembly restricted to the ``surviving`` sites (ascending original
    ids). Key derivation spans *all* sites -- survivors must use the same
    per-site keys they would in a fault-free run. Runs on ``device`` (CUDA
    unless the caller asks for the CPU). Returns ``(points, weights, t_i,
    local_costs)`` with the coreset as the survivors' portions concatenated
    in ascending id order."""
    dev = backend_mod.resolve_device(device)
    key = as_tensor(key, dev)
    site_points = as_tensor(site_points, dev)
    w_site = as_tensor(site_mask, dev).to(site_points.dtype)
    backend = backend_mod.resolve_name(backend, dev)
    strat = strategy_mod.get_strategy(strategy)
    n_sites, _, d = site_points.shape
    surviving = np.asarray(surviving, np.int64)
    surv_t = torch.as_tensor(surviving, device=dev)
    keys = strat.keys(key, n_sites)

    r1 = strat.summary(keys[:, 0], site_points, w_site, k=k,
                       objective=objective, lloyd_iters=lloyd_iters,
                       backend=backend)

    costs = r1.local_costs[surv_t]
    t_i = strat.allocate(costs, t)
    if strat.needs_exchange:
        total = _windowed_sum(costs)
        totals = torch.full((surviving.size,), 1.0, dtype=costs.dtype,
                            device=dev) * total
    else:
        totals = strat.local_totals(costs)

    sub = Round1State(r1.centers[surv_t], r1.m[surv_t], r1.assign[surv_t],
                      costs, r1.w_eff[surv_t])
    portions = strat.contribute(
        keys[surv_t, 1], site_points[surv_t], sub, t_i, totals,
        k=k, t=t, t_buffer=t_buffer, clip_negative=clip_negative)
    pts = portions.points.reshape(-1, d)
    w = portions.weights.reshape(-1)
    return pts, w, t_i, r1.local_costs
