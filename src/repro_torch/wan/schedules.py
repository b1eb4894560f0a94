"""Asynchronous activation schedules over the padded-neighbor tables (the
port of ``repro.wan.schedules``: host numpy, the same arrays as the
reference's).

The synchronous engine fires every edge every round. The WAN runtime
instead precomputes an ``(n_rounds, n, max_deg)`` boolean *liveness* cube
over the gossip schedule's out-slot layout -- slot ``(v, i)`` is the directed
transmission opportunity ``v -> neighbors[v, i]`` -- as the AND of

* an **activation** pattern (``mode``): ``"full"`` (every edge, every
  round -- the synchronous engine under faults), ``"random"`` (each round
  activates a seeded Bernoulli(p) subset of the *edges*; both directions
  of an undirected edge fire together), or ``"clock"`` (each edge fires
  on its own deterministic clock with period derived from its cost:
  ``period_e = max(1, round(cost_e / min_cost))``, phase seeded per edge
  -- expensive WAN links fire rarely, cheap rack links every round, which
  is what produces the staleness-vs-link-cost tradeoff);
* the **fault masks** of a :class:`~repro_torch.wan.faults.FaultPlan`: dropped
  edges never fire, and a slot is live only while *both* endpoints are
  up (a down node neither sends nor receives).

Every random draw is seeded ``(seed, round, salt)``, so the cube for
``2R`` rounds extends the cube for ``R`` rounds exactly -- the runtime's
double-until-quiescent loop replays history bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.message_passing import GossipSchedule, gossip_schedule
from repro_torch.core.topology import Graph
from repro_torch.wan.faults import FaultPlan

_RANDOM_SALT = 0xA5
_PHASE_SALT = 0xC1


@dataclasses.dataclass(frozen=True, eq=False)
class WanSchedule:
    """The gossip schedule plus the slot algebra the async round loop needs.

    ``slot_edge[v, i]`` maps out-slot ``(v, i)`` to its index in
    ``graph.edges`` (-1 on padding); ``in_slot[u, j]`` is the *sender's*
    out-slot index ``i`` with ``neighbors[in_neighbors[u, j], i] == u``,
    which is what lets the receive gather read the sender-side send-once
    state directly. ``periods`` are the per-edge clock periods."""

    graph: Graph
    base: GossipSchedule
    slot_edge: np.ndarray   # (n, max_deg) int32, -1 pad
    in_slot: np.ndarray     # (n, max_in) int32, 0 pad
    periods: np.ndarray     # (m,) int64

    @property
    def max_period(self) -> int:
        return int(self.periods.max()) if self.periods.size else 1


@functools.lru_cache(maxsize=128)
def wan_schedule(g: Graph) -> WanSchedule:
    base = gossip_schedule(g)
    edge_index = {}
    for idx, (i, j) in enumerate(g.edges):
        edge_index[(i, j)] = idx
        if not g.directed:
            edge_index[(j, i)] = idx
    slot_edge = np.full(base.neighbors.shape, -1, np.int32)
    for v in range(base.n):
        for i in range(base.neighbors.shape[1]):
            if base.neighbor_mask[v, i]:
                slot_edge[v, i] = edge_index[(v, int(base.neighbors[v, i]))]
    in_slot = np.zeros(base.in_neighbors.shape, np.int32)
    for u in range(base.n):
        for j in range(base.in_neighbors.shape[1]):
            if base.in_neighbor_mask[u, j]:
                s = int(base.in_neighbors[u, j])
                hits = np.nonzero((base.neighbors[s] == u)
                                  & base.neighbor_mask[s])[0]
                in_slot[u, j] = int(hits[0])   # an in-edge is some out-slot
    costs = np.asarray(g.costs, np.float64)
    pos = costs[costs > 0]
    if pos.size:
        periods = np.maximum(1, np.round(costs / pos.min())).astype(np.int64)
    else:
        periods = np.ones(max(g.m, 0), np.int64)
    return WanSchedule(graph=g, base=base, slot_edge=slot_edge,
                       in_slot=in_slot, periods=periods)


def _edge_to_slots(ws: WanSchedule, edge_mask: np.ndarray) -> np.ndarray:
    """Expand per-edge booleans (..., m) to per-out-slot (..., n, max_deg);
    padding slots come out False."""
    padded = np.concatenate([edge_mask,
                             np.zeros(edge_mask.shape[:-1] + (1,), bool)],
                            axis=-1)
    return padded[..., ws.slot_edge]


def activation_masks(ws: WanSchedule, mode: str, n_rounds: int,
                     seed: int = 0, p: float = 0.5) -> np.ndarray:
    """(n_rounds, n, max_deg) bool activation cube for ``mode`` (faults
    not yet applied). Prefix-stable in ``n_rounds`` for every mode."""
    m = ws.graph.m
    if mode == "full":
        edge = np.ones((n_rounds, m), bool)
    elif mode == "random":
        if not 0.0 < p <= 1.0:
            raise ValueError(f"random gossip needs 0 < p <= 1, got {p}")
        edge = np.empty((n_rounds, m), bool)
        for r in range(n_rounds):
            rng = np.random.default_rng((seed, r, _RANDOM_SALT))
            edge[r] = rng.random(m) < p
    elif mode == "clock":
        phase = np.random.default_rng((seed, _PHASE_SALT)).integers(
            0, ws.periods, size=m) if m else np.zeros(0, np.int64)
        r = np.arange(n_rounds)[:, None]
        edge = (r + phase[None, :]) % ws.periods[None, :] == 0
    else:
        raise ValueError(f"unknown wan mode {mode!r}: expected "
                         f"'full'|'random'|'clock'")
    return _edge_to_slots(ws, edge)


def liveness_masks(ws: WanSchedule, mode: str, n_rounds: int,
                   plan: FaultPlan, seed: int = 0, p: float = 0.5
                   ) -> tuple:
    """Compose activation with the fault plan.

    Returns ``(live, dup, usable)``: ``live`` and ``dup`` are
    ``(n_rounds, n, max_deg)`` per-round send / duplicate masks, and
    ``usable`` is the static ``(n, max_deg)`` steady-state slot mask
    (edge not dropped, both endpoints surviving) -- the slots over which
    send-once obligations must drain for the flood to quiesce."""
    base = ws.base
    n, max_deg = base.neighbors.shape
    alive_edges = np.ones(ws.graph.m, bool)
    if plan.drop:
        edge_set = set(ws.graph.edges)
        norm = set()
        for i, j in plan.drop:
            e = (i, j) if ws.graph.directed else (min(i, j), max(i, j))
            if e not in edge_set:
                raise ValueError(f"fault plan drops {(i, j)}, which is not "
                                 f"an edge of the graph")
            norm.add(e)
        for idx, e in enumerate(ws.graph.edges):
            if e in norm:
                alive_edges[idx] = False
    slot_alive = _edge_to_slots(ws, alive_edges) & base.neighbor_mask

    up = plan.node_up(n, n_rounds)                       # (rounds, n)
    peer_up = up[:, base.neighbors] & base.neighbor_mask[None]
    endpoints_up = up[:, :, None] & peer_up              # (rounds, n, deg)

    active = activation_masks(ws, mode, n_rounds, seed=seed, p=p)
    live = active & slot_alive[None] & endpoints_up
    dup = plan.dup_masks(n, max_deg, n_rounds) & live

    surv = np.zeros(n, bool)
    surv[plan.surviving_nodes(n)] = True
    usable = slot_alive & surv[:, None] & surv[base.neighbors]
    return live, dup, usable
