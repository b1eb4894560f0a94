"""Deterministic, seed-replayable fault model for the WAN runtime (the port
of ``repro.wan.faults``, numpy only: both packages draw the same plans and
masks from the same seeds).

A :class:`FaultPlan` is a frozen value object describing three failure
modes (DESIGN.md Sec. 14):

* **dropped links** -- edges that never carry a message (permanent);
* **node churn** -- a node goes down at a round boundary and rejoins at a
  later one (or never: ``rejoin < 0`` means permanently dead). A down
  node neither sends nor receives but keeps its local state; the fault
  model is crash-*pause*, not amnesia;
* **duplicated deliveries** -- with per-slot probability ``dup_rate`` a
  live link re-transmits payloads it has already delivered. Duplicates
  are metered as real traffic but must leave relay tables bit-unchanged
  (the idempotent-relay discipline the quiescence checker certifies).

Everything randomized is drawn from ``np.random.default_rng`` seeded by
``(seed, round, salt)``, so any round prefix replays identically however
many rounds the runtime ends up executing -- the property that lets the
random-gossip mode double its round budget until quiescence without
perturbing history. Plans are applied as precomputed boolean masks inside
the round loop, never as Python-side mutation.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.topology import Graph, drop_edges, induced_subgraph

_DUP_SALT = 0xD0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic failure scenario.

    ``drop``: edges (endpoint pairs, either orientation on undirected
    graphs) that are down for the whole run. ``churn``: ``(node, down,
    rejoin)`` triples -- the node is offline during rounds ``[down,
    rejoin)``; ``rejoin < 0`` marks it permanently dead (a non-survivor).
    Round indices are per executed flood: each flood the plan is applied
    to counts its own rounds from 0. ``dup_rate`` is the per-(slot,
    round) duplicate-delivery probability, drawn from ``seed``."""

    drop: Tuple[Tuple[int, int], ...] = ()
    churn: Tuple[Tuple[int, int, int], ...] = ()
    dup_rate: float = 0.0
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "drop",
                           tuple((int(i), int(j)) for i, j in self.drop))
        object.__setattr__(self, "churn",
                           tuple((int(v), int(a), int(b))
                                 for v, a, b in self.churn))
        seen = set()
        for v, down, rejoin in self.churn:
            if v in seen:
                raise ValueError(f"node {v} appears twice in churn")
            seen.add(v)
            if down < 0:
                raise ValueError(f"churn down round must be >= 0, got "
                                 f"{down} for node {v}")
            if 0 <= rejoin <= down:
                raise ValueError(f"churn rejoin {rejoin} must exceed down "
                                 f"{down} for node {v} (or be < 0: dead)")
        if not (0.0 <= float(self.dup_rate) < 1.0):
            raise ValueError(f"dup_rate must be in [0, 1), got "
                             f"{self.dup_rate}")

    @property
    def is_trivial(self) -> bool:
        return not self.drop and not self.churn and self.dup_rate == 0.0

    def dead_nodes(self) -> Tuple[int, ...]:
        """Nodes that never rejoin (excluded from every survivor set)."""
        return tuple(sorted(v for v, _, r in self.churn if r < 0))

    def surviving_nodes(self, n: int) -> np.ndarray:
        """Ascending original ids of nodes alive at the end of time."""
        dead = set(self.dead_nodes())
        surv = np.asarray([v for v in range(n) if v not in dead], np.int64)
        if surv.size == 0:
            raise ValueError("fault plan kills every node")
        return surv

    def horizon(self) -> int:
        """First round from which every surviving node is up for good.
        Dead-forever nodes do not extend it (they never come back); a
        plan with no rejoining churn has horizon 0."""
        return max((r for _, _, r in self.churn if r >= 0), default=0)

    def node_up(self, n: int, n_rounds: int) -> np.ndarray:
        """(n_rounds, n) bool: is node v up during round r."""
        up = np.ones((n_rounds, n), bool)
        for v, down, rejoin in self.churn:
            if not 0 <= v < n:
                raise ValueError(f"churn node {v} out of range for n={n}")
            end = n_rounds if rejoin < 0 else min(rejoin, n_rounds)
            up[down:end, v] = False
        return up

    def surviving_graph(self, g: Graph) -> Tuple[Graph, np.ndarray]:
        """The steady-state topology: ``g`` minus dropped links, induced
        on the surviving nodes. Returns ``(sub, index)`` (compact
        relabeling, ``index`` maps sub node -> original id). May be
        disconnected -- the quiescence checker treats that as
        uncertifiable rather than papering over it."""
        return induced_subgraph(drop_edges(g, self.drop),
                                self.surviving_nodes(g.n))

    def dup_masks(self, n: int, max_deg: int, n_rounds: int) -> np.ndarray:
        """(n_rounds, n, max_deg) bool: duplicate-delivery draws per
        out-slot per round, prefix-stable in ``n_rounds``."""
        if self.dup_rate == 0.0:
            return np.zeros((n_rounds, n, max_deg), bool)
        out = np.empty((n_rounds, n, max_deg), bool)
        for r in range(n_rounds):
            rng = np.random.default_rng((self.seed, r, _DUP_SALT))
            out[r] = rng.random((n, max_deg)) < self.dup_rate
        return out


def random_fault_plan(g: Graph, seed: int = 0, drop_frac: float = 0.0,
                      n_churn: int = 0, churn_window: Tuple[int, int] = (1, 4),
                      dead_frac: float = 0.0, dup_rate: float = 0.0,
                      max_tries: int = 64) -> FaultPlan:
    """Sample a :class:`FaultPlan` whose surviving subgraph is connected.

    ``drop_frac`` of the edges are dropped and ``n_churn`` nodes churn
    (each down from a random round in ``churn_window`` for a short
    outage; a ``dead_frac`` fraction of the churned nodes never rejoin).
    Rejection-samples up to ``max_tries`` seeds; if every candidate
    disconnects the survivors, the drop fraction is halved and sampling
    restarts -- the benchmark sweep needs *certifiable* plans, and a plan
    that partitions the graph has no quiescence bound to certify."""
    frac = float(drop_frac)
    for attempt in range(max_tries):
        rng = np.random.default_rng((seed, attempt))
        n_drop = int(round(frac * g.m))
        drop_idx = rng.choice(g.m, size=min(n_drop, g.m), replace=False)
        drops = tuple(g.edges[int(i)] for i in sorted(drop_idx))
        nodes = rng.choice(g.n, size=min(n_churn, g.n), replace=False)
        churn = []
        for c, v in enumerate(sorted(int(x) for x in nodes)):
            down = int(rng.integers(churn_window[0], churn_window[1] + 1))
            if rng.random() < dead_frac:
                churn.append((v, down, -1))
            else:
                churn.append((v, down, down + int(rng.integers(1, 4))))
        plan = FaultPlan(drop=drops, churn=tuple(churn),
                         dup_rate=dup_rate, seed=seed)
        try:
            sub, _ = plan.surviving_graph(g)
            if sub.distances().min() >= 0:
                return plan
        except ValueError:
            pass
        if attempt == max_tries // 2:
            frac /= 2.0
    raise RuntimeError(f"could not sample a connected-survivor fault plan "
                       f"for drop_frac={drop_frac} on a {g.n}-node graph")
