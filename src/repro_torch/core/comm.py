"""Communication-cost ledger (a numpy copy of ``repro.core.comm``; the
port keeps its own because importing ``repro.core`` imports JAX).

The paper measures communication in "number of points transmitted"; we keep
that unit (``points``) and also derive bytes (``(d+1) * 4`` bytes per weighted
point, ``4`` per scalar) so the LM-side roofline and the clustering-side
experiments share one currency. Every algorithm in ``repro.core`` returns a
``CommLedger`` alongside its result.

Heterogeneous links add a fourth axis, ``link_cost``: cost-weighted bytes.
Every transmission is priced by the edge it crosses -- a payload of ``b``
bytes over a link of cost ``c`` contributes ``c * b`` -- so WAN-vs-rack
deployments are no longer metered as if every hop were equal. On uniform
(unit) costs ``link_cost == bytes``, reproducing the pre-cost accounting
bit-exactly; :func:`link_cost_of` is the one canonical float64 summation
both the analytic helpers here and the engine's measured pricing share, so
analytic and measured ledgers agree bit-for-bit whenever costs and units
are integer-valued (DESIGN.md Sec. 12).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.topology import Graph, SpanningTree


@dataclasses.dataclass
class CommLedger:
    """Counts of transmitted units, with an optional per-phase breakdown.

    ``phases`` maps a phase label (e.g. ``"stream_round_3"``) to a
    totals-only sub-ledger; :meth:`tag` files an untagged ledger under a
    label, :meth:`add` merges breakdowns label-wise, and
    ``as_dict(by_phase=True)`` exposes them -- the streaming aggregation
    rounds report points/scalars/bytes per round this way.

    ``link_cost`` is the cost-weighted byte total over heterogeneous links
    (equals ``bytes`` on uniform unit costs); unlike ``bytes`` it is
    accumulated at pricing time, per transmission, because the per-edge
    cost is not recoverable from the unit totals.

    ``staleness`` is the asynchronous-runtime axis (DESIGN.md Sec. 14):
    mean rounds-behind of the nodes relative to the synchronous lossless
    engine on the same graph. A synchronous/analytic ledger is 0.0 by
    definition; the WAN runtime's measured ledgers fill it in. Unlike the
    traffic axes it is a *lag*, not a volume, so :meth:`add` combines it
    by max (the staleness of a multi-phase protocol is its worst phase),
    which keeps every existing volume identity untouched."""

    scalars: float = 0.0          # single float values (local costs)
    points: float = 0.0           # weighted d-dim points
    messages: float = 0.0         # individual edge transmissions
    dim: int = 0                  # point dimensionality (for bytes)
    link_cost: float = 0.0        # cost-weighted bytes (heterogeneous links)
    staleness: float = 0.0        # mean rounds-behind vs the sync engine
    phases: Dict[str, "CommLedger"] = dataclasses.field(default_factory=dict)

    def add(self, other: "CommLedger") -> "CommLedger":
        phases = {k: dataclasses.replace(v) for k, v in self.phases.items()}
        for name, sub in other.phases.items():
            phases[name] = (phases[name].add(sub) if name in phases
                            else dataclasses.replace(sub))
        return CommLedger(
            scalars=self.scalars + other.scalars,
            points=self.points + other.points,
            messages=self.messages + other.messages,
            dim=max(self.dim, other.dim),
            link_cost=self.link_cost + other.link_cost,
            staleness=max(self.staleness, other.staleness),
            phases=phases,
        )

    def tag(self, phase: str) -> "CommLedger":
        """Return a copy whose totals are also filed under ``phase``. Any
        existing breakdown is collapsed into the new label (a tagged ledger
        stays one level deep)."""
        totals = CommLedger(scalars=self.scalars, points=self.points,
                            messages=self.messages, dim=self.dim,
                            link_cost=self.link_cost,
                            staleness=self.staleness)
        return dataclasses.replace(totals, phases={phase: totals})

    @property
    def bytes(self) -> float:
        return 4.0 * self.scalars + 4.0 * (self.dim + 1) * self.points

    def as_dict(self, by_phase: bool = False) -> Dict[str, float]:
        out = {
            "scalars": self.scalars,
            "points": self.points,
            "messages": self.messages,
            "bytes": self.bytes,
            "link_cost": self.link_cost,
            "staleness": self.staleness,
        }
        if by_phase:
            out["phases"] = {name: sub.as_dict()
                             for name, sub in self.phases.items()}
        return out


def link_cost_of(per_origin_cost, unit_scalars=0.0, unit_points=0.0,
                 dim: int = 0) -> float:
    """Canonical cost-weighted-bytes summation.

    ``per_origin_cost[o]`` is the summed cost of every edge origin ``o``'s
    payload crossed; each origin contributes ``cost * (4*scalars +
    4*(dim+1)*points)``. Sequential float64 accumulation in origin order --
    shared by the analytic helpers and the engine's measured pricing so the
    two agree bit-for-bit (exactly so for integer-valued costs and units,
    which every shipped pipeline uses)."""
    per = np.asarray(per_origin_cost, np.float64).reshape(-1)
    us = np.broadcast_to(np.asarray(unit_scalars, np.float64), per.shape)
    up = np.broadcast_to(np.asarray(unit_points, np.float64), per.shape)
    total = 0.0
    for w, s, p in zip(per.tolist(), us.tolist(), up.tolist()):
        total += w * (4.0 * s + 4.0 * (dim + 1) * p)
    return float(total)


def flood_cost(g: Graph, n_messages: int, unit_points: float = 0.0,
               unit_scalars: float = 0.0, dim: int = 0) -> CommLedger:
    """Algorithm 3 on a general graph: every node forwards each of the
    ``n_messages`` distinct messages to all its neighbours exactly once
    => sum_v deg(v) = 2m transmissions per message (Theorem 2's O(m)
    factor; m on a directed graph, where only out-links forward). A flood
    has no routing freedom -- each message crosses *every* link -- so its
    cost-weighted price is the full weighted degree sum per message."""
    per_message = float(g.m if g.directed else 2 * g.m)
    w_per_message = float(g.weighted_degrees().sum())
    return CommLedger(
        scalars=per_message * n_messages * unit_scalars,
        points=per_message * n_messages * unit_points,
        messages=per_message * n_messages,
        dim=dim,
        link_cost=link_cost_of([w_per_message * n_messages],
                               unit_scalars, unit_points, dim),
    )


def flood_portions_cost(g: Graph, t_i, k: int, dim: int) -> CommLedger:
    """Analytic Round-2 flood ledger: n messages of per-site size
    ``t_i + k`` points, each crossing every link. The per-origin
    ``link_cost`` summation mirrors the engine's measured pricing term for
    term, so sim and exec agree bit-for-bit. Shared by the graph path of
    Algorithm 2 and the streaming resample rounds."""
    per_message = float(g.m if g.directed else 2 * g.m)
    w_per_message = float(g.weighted_degrees().sum())
    unit_pts = np.asarray(t_i, np.float64) + k
    return CommLedger(
        points=per_message * float(unit_pts.sum()),
        messages=per_message * g.n,
        dim=dim,
        link_cost=link_cost_of(np.full(g.n, w_per_message),
                               unit_points=unit_pts, dim=dim),
    )


def tree_gather_cost(tree: SpanningTree, unit_points_per_node=0.0,
                     unit_scalars_per_node=0.0, dim: int = 0) -> CommLedger:
    """Per-node payloads routed along parent edges to the root: node v's
    payload travels its ``depth(v)`` edges (Theorem 3's O(h) factor) and
    pays its root-path link costs (``path_costs``). By path symmetry the
    identical ledger prices the root *scattering* per-node payloads back
    down their subtree paths (the executed Round-1 allocation delivery;
    DESIGN.md Sec. 11). Units: scalar or per-node sequence; a node
    transmits (counts a message per hop) iff it has any positive unit."""

    def per_node(u):
        return [u] * tree.n if not hasattr(u, "__len__") else u

    up = per_node(unit_points_per_node)
    us = per_node(unit_scalars_per_node)
    pts = sum(tree.depth[v] * up[v] for v in range(tree.n))
    scl = sum(tree.depth[v] * us[v] for v in range(tree.n))
    msgs = sum(tree.depth[v] for v in range(tree.n)
               if up[v] > 0 or us[v] > 0)
    return CommLedger(scalars=float(scl), points=float(pts),
                      messages=float(msgs), dim=dim,
                      link_cost=link_cost_of(tree.path_costs(),
                                             np.asarray(us, np.float64),
                                             np.asarray(up, np.float64),
                                             dim))


def tree_up_cost(tree: SpanningTree, unit_points_per_node, dim: int = 0
                 ) -> CommLedger:
    """Each node's payload travels its depth edges up to the root
    (Theorem 3's O(h) factor). ``unit_points_per_node``: scalar or seq."""
    return tree_gather_cost(tree, unit_points_per_node=unit_points_per_node,
                            dim=dim)


def tree_broadcast_cost(tree: SpanningTree, unit_points: float = 0.0,
                        unit_scalars: float = 0.0, dim: int = 0) -> CommLedger:
    """Root sends one payload down every tree edge (n-1 transmissions,
    priced at the tree's total edge cost -- the quantity a min-cost
    spanning tree minimizes)."""
    edges = tree.n - 1
    return CommLedger(
        scalars=edges * unit_scalars,
        points=edges * unit_points,
        messages=float(edges),
        dim=dim,
        link_cost=link_cost_of([tree.edge_cost_total()], unit_scalars,
                               unit_points, dim),
    )


def tree_allocation_cost(tree: SpanningTree) -> CommLedger:
    """Analytic Round-1 ledger of the executable tree protocol: raw cost
    scalars up (gather), per-site allocations down (scatter), total down
    (broadcast). The scatter prices like the gather by path symmetry
    (DESIGN.md Sec. 11)."""
    ledger = tree_gather_cost(tree, unit_scalars_per_node=1.0)   # costs up
    ledger = ledger.add(tree_gather_cost(tree, unit_scalars_per_node=1.0))
    ledger = ledger.add(tree_broadcast_cost(tree, unit_scalars=1.0))
    return ledger
