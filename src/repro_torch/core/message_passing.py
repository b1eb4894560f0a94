"""Algorithm 3 -- Message-Passing on a general communication graph (the port
of the host simulation and the topology execution engine of
``repro.core.message_passing``).

1. :func:`flood` -- a host-level simulation over an arbitrary connected
   ``Graph``: each node initially knows one message and forwards every
   newly seen message to all neighbours exactly once. It verifies the
   O(mn) bound and gives exact per-edge message counts.

2. **The topology execution engine** (DESIGN.md Sec. 11):
   :class:`GossipSchedule` / :class:`TreeSchedule` compile a ``Graph`` /
   ``SpanningTree`` into static per-round schedules (padded neighbour-index
   arrays, per-level node lists), and :func:`flood_exec`,
   :func:`tree_gather_exec`, :func:`tree_scatter_exec`,
   :func:`tree_up_sum_exec` and :func:`tree_broadcast_exec` *execute* the
   rounds on the payload's device. Payloads move edge by edge, and only by
   indexing (gathers, ``index_select``, ``torch.cat``, index assignment), so
   every copy a node ends up holding is the origin's payload bit for bit.
   Each primitive returns a *measured* :class:`~repro_torch.core.comm
   .CommLedger`, counted from the executed transmissions and priced by the
   link each one crossed; it equals the analytic ``flood_cost`` /
   ``tree_*_cost`` ledger exactly (DESIGN.md Sec. 12).

3. **The SPMD collectives** of the mesh path (the JAX package's
   ``shard_map`` primitives): :func:`neighbor_rounds_gather` /
   :func:`neighbor_rounds_sum` on a ring of ``axis_size - 1`` hops and
   :func:`torus_rounds_gather` / :func:`torus_rounds_sum` on a 2-D
   (R, C) folding of the axis (:func:`torus_mesh_shape`,
   :func:`collective_hops`), run on every rank of a
   :class:`~repro_torch.core.mesh.Mesh` bound to the axis name. Gathers
   relay bytes; sums add ``acc + buf`` in the reference's hop order, so
   both equal the reference's bit for bit.

The round state stays on the device and is updated in place, on the rows
that change. A flood keeps the reference's dense (node, origin) table; a
tree gather keeps each origin's payload at the node that holds it, and a
hop copies it from the child's buffer into the parent's, so no node holds
an (n, n, F) table. The ledgers are numpy float64 on the host, from the
(node, origin) counters the rounds leave.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import mesh as mesh_mod
from repro_torch.core.backend import as_tensor
from repro_torch.core.comm import CommLedger, link_cost_of
from repro_torch.core.topology import (Graph, SpanningTree, diameter,
                                       spanning_tree)


@dataclasses.dataclass
class FloodResult:
    received: List[set]          # per node: set of message ids known
    rounds: int                  # synchronous rounds until quiescence
    transmissions: int           # total edge-messages sent
    per_round_transmissions: List[int]


def flood(g: Graph, payload_ids: Sequence[int] | None = None) -> FloodResult:
    """Synchronous simulation of Algorithm 3.

    Every node starts with its own message id; in each round, each node sends
    every message it learned in the previous round to all neighbours. A node
    never forwards the same message twice. Terminates when no new message is
    delivered anywhere (<= diameter rounds).
    """
    ids = list(payload_ids) if payload_ids is not None else list(range(g.n))
    adj = g.adjacency()
    known: List[set] = [{ids[v]} for v in range(g.n)]
    fresh: List[set] = [{ids[v]} for v in range(g.n)]
    transmissions = 0
    per_round: List[int] = []
    rounds = 0
    while any(fresh):
        sent_this_round = 0
        incoming: List[set] = [set() for _ in range(g.n)]
        for v in range(g.n):
            for msg in fresh[v]:
                for u in adj[v]:
                    incoming[u].add(msg)
                    sent_this_round += 1
        fresh = [incoming[v] - known[v] for v in range(g.n)]
        for v in range(g.n):
            known[v] |= fresh[v]
        transmissions += sent_this_round
        per_round.append(sent_this_round)
        rounds += 1
    return FloodResult(known, rounds, transmissions, per_round)


def flood_scalars(g: Graph, values: Sequence[float]
                  ) -> Tuple[List[Dict[int, float]], FloodResult]:
    """Flood real scalar payloads (the per-site costs of Algorithm 1 Round 1).

    Returns per-node {origin: value} tables plus the flood statistics.
    """
    if len(values) != g.n:
        raise ValueError(f"flood_scalars needs one value per node: got "
                         f"{len(values)} values for a {g.n}-node graph")
    res = flood(g)
    tables = [{origin: float(values[origin]) for origin in res.received[v]}
              for v in range(g.n)]
    return tables, res


# ---------------------------------------------------------------------------
# Topology execution engine: compiled schedules + executed message rounds
# ---------------------------------------------------------------------------

Units = Union[float, Sequence[float], np.ndarray]


@dataclasses.dataclass
class ExecResult:
    """Outcome of one executed communication primitive.

    ``rounds`` is the static schedule length that ran; for floods,
    ``rounds_to_complete`` is the first round after which every node knew
    every payload (<= diameter on a connected graph -- the schedule runs one
    extra round so the final fresh messages are forwarded, which is what
    makes the measured transmission count equal the analytic 2mn).
    ``ledger`` is *measured*: every scalar/point/message was counted from an
    executed transmission, never from a formula.

    ``wall_s`` is the host wall-clock time the primitive spent (schedule
    execution + ledger pricing, excluding schedule compilation, which is
    cached per graph); it is excluded from every ledger-parity identity."""

    rounds: int
    rounds_to_complete: int
    ledger: CommLedger
    per_round_transmissions: List[int]
    wall_s: float = 0.0


def pack_payload(points: torch.Tensor, weights: torch.Tensor
                 ) -> torch.Tensor:
    """Pack weighted points into an engine payload: ``(..., S, d)`` points +
    ``(..., S)`` weights -> ``(..., S, d+1)`` with the weight as the
    trailing column; :func:`unpack_payload` is its inverse."""
    return torch.cat([points, weights.unsqueeze(-1)], dim=-1)


def unpack_payload(table: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_payload`: ``(..., S, d+1)`` ->
    ``((..., S, d), (..., S))``, both views of ``table``."""
    return table[..., :-1], table[..., -1]


def _units_ledger(per_origin_msgs: np.ndarray, unit_scalars: Units,
                  unit_points: Units, dim: int,
                  count_all_messages: bool,
                  per_origin_link: np.ndarray | None = None) -> CommLedger:
    """Price measured per-origin transmission counts. ``count_all_messages``
    distinguishes flooding (a message id is forwarded whether or not it
    carries metered payload; analytic ``flood_cost`` counts all 2mn) from
    tree routing (only payload-carrying origins move; analytic
    ``tree_up_cost`` counts only unit>0 nodes). ``per_origin_link`` is the
    measured per-origin *edge-cost* total (the sum of link costs each
    origin's payload crossed); defaults to the hop counts, i.e. uniform
    unit links."""
    per = np.asarray(per_origin_msgs, np.float64)
    us = np.broadcast_to(np.asarray(unit_scalars, np.float64), per.shape)
    up = np.broadcast_to(np.asarray(unit_points, np.float64), per.shape)
    if count_all_messages or not (us + np.abs(up)).any():
        msgs = float(per.sum())
    else:
        msgs = float(per[(us + np.abs(up)) > 0].sum())
    link = per if per_origin_link is None else per_origin_link
    return CommLedger(scalars=float((per * us).sum()),
                      points=float((per * up).sum()),
                      messages=msgs, dim=dim,
                      link_cost=link_cost_of(link, us, up, dim))


def _placed(x) -> torch.Tensor:
    """A tensor stays on its device (the rounds run there); anything else
    goes to the default device of
    :func:`~repro_torch.core.backend.resolve_device` (CUDA)."""
    if isinstance(x, torch.Tensor):
        return x
    return as_tensor(x, backend_mod.resolve_device())


@dataclasses.dataclass(frozen=True, eq=False)
class GossipSchedule:
    """Static flood schedule for a connected :class:`Graph`: padded
    neighbour-index arrays (from ``adjacency()``) plus the round count to
    quiescence. Compile once per graph, execute many times. Carries the
    graph's per-link costs (``neighbor_costs`` aligned with ``neighbors``,
    plus the per-node ``weighted_degrees``) so executed floods are priced
    per edge crossed."""

    n: int
    m: int
    n_rounds: int               # diameter + 1: last fresh set still forwards
    neighbors: np.ndarray       # (n, max_deg) int32 out-neighbors, 0-padded
    neighbor_mask: np.ndarray   # (n, max_deg) bool
    degrees: np.ndarray         # (n,) int32 out-degrees (send pricing)
    neighbor_costs: np.ndarray  # (n, max_deg) float64, padded with 0
    weighted_degrees: np.ndarray  # (n,) float64 (== Graph.weighted_degrees)
    in_neighbors: np.ndarray    # (n, max_in) int32: the receive gather side
    in_neighbor_mask: np.ndarray  # (n, max_in) bool (== out side undirected)

    @classmethod
    def from_graph(cls, g: Graph) -> "GossipSchedule":
        adj, adjc = g.adjacency(), g.adjacency_costs()
        max_deg = max((len(a) for a in adj), default=0)
        if g.n > 1 and min(len(a) for a in adj) == 0:
            raise ValueError("graph is not connected (isolated node)")
        max_deg = max(max_deg, 1)
        nb = np.zeros((g.n, max_deg), np.int32)
        mask = np.zeros((g.n, max_deg), bool)
        nc = np.zeros((g.n, max_deg), np.float64)
        for v, (a, cs) in enumerate(zip(adj, adjc)):
            nb[v, :len(a)] = a
            mask[v, :len(a)] = True
            nc[v, :len(a)] = cs
        if g.directed:
            # a node *receives* along its in-links; sends meter out-links
            in_adj: list = [[] for _ in range(g.n)]
            for i, j in g.edges:
                in_adj[j].append(i)
            max_in = max(1, max(len(a) for a in in_adj))
            in_nb = np.zeros((g.n, max_in), np.int32)
            in_mask = np.zeros((g.n, max_in), bool)
            for v, a in enumerate(in_adj):
                in_nb[v, :len(a)] = a
                in_mask[v, :len(a)] = True
        else:
            in_nb, in_mask = nb, mask
        return cls(n=g.n, m=g.m, n_rounds=diameter(g) + 1, neighbors=nb,
                   neighbor_mask=mask,
                   degrees=mask.sum(axis=1).astype(np.int32),
                   neighbor_costs=nc,
                   weighted_degrees=np.asarray(g.weighted_degrees()),
                   in_neighbors=in_nb, in_neighbor_mask=in_mask)


@functools.lru_cache(maxsize=128)
def gossip_schedule(g: Graph) -> GossipSchedule:
    """Cached :meth:`GossipSchedule.from_graph`: ``Graph`` is a frozen
    (hashable) dataclass, so identical graphs -- directed and
    cost-annotated ones included -- compile their tables once per process.
    The returned schedule is shared; treat it as read-only."""
    return GossipSchedule.from_graph(g)


def _receive(table: torch.Tensor, known: torch.Tensor, deliv: torch.Tensor,
             in_nb: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """The receive step of one relay round, shared by the synchronous flood
    and the asynchronous one (``repro_torch.wan.runtime``).

    ``deliv`` (n, max_in, n) flags, per node and in-slot, the origins that
    slot delivers this round; ``in_nb`` (n, max_in) names the sending node
    of each slot and ``rank`` (max_in,) decreases along the slots. Every
    (node, origin) pair that is delivered and not yet ``known`` takes the
    copy of its first delivering slot (the lowest, picked by the unique
    rank, not by a tie-break), written into ``table`` in place: the rows
    written did not know the origin and the rows read did, so no read sees
    a write of its round. The indices of the new pairs are read back to
    the host (one read per round). Returns the (n, n) flags of the new
    pairs."""
    first = (deliv.to(torch.int64) * rank[:, None]).argmax(1)
    src = in_nb.gather(1, first)                           # (n, n) node ids
    new = deliv.any(1) & ~known
    v, o = new.nonzero(as_tuple=True)
    table[v, o] = table[src[v, o], o]
    return new


def _flood_exec_rounds(sched: GossipSchedule, flat: torch.Tensor):
    """Execute ``sched.n_rounds`` synchronous flood rounds on ``flat``'s
    device.

    State: ``known``/``fresh`` (n, n) bool tables (node x origin) and
    ``table`` (n, n, F) payload copies. Each round every node relays the
    payloads it learned last round to all its out-neighbours -- the receive
    side gathers over *in*-neighbours (the out side on undirected graphs),
    which keeps a directed flood moving along the links. A new copy is
    taken from the first fresh-holding in-neighbour and written into the
    receiving rows in place (:func:`_receive`), so every copy is a
    bit-exact relay.
    ``fwd[v, o]`` counts how often node v forwarded origin o's message
    (once each on a connected graph). Returns the table, ``known``, the
    per-round sends, ``fwd`` and the per-round completion flags."""
    n, dev = sched.n, flat.device
    in_nb = torch.as_tensor(sched.in_neighbors, dtype=torch.int64,
                            device=dev)
    in_mask = torch.as_tensor(sched.in_neighbor_mask, device=dev)
    out_deg = torch.as_tensor(sched.degrees, dtype=torch.int64, device=dev)
    rank = torch.arange(in_nb.shape[1], 0, -1, device=dev)
    diag = torch.arange(n, device=dev)
    table = flat.new_zeros((n, n, flat.shape[1]))
    table[diag, diag] = flat
    known = torch.eye(n, dtype=torch.bool, device=dev)
    fresh = known
    fwd = torch.zeros((n, n), dtype=torch.int32, device=dev)
    sends, complete = [], []
    for _ in range(sched.n_rounds):
        # transmissions this round: each fresh holder sends on every out-link
        sends.append((fresh.sum(1) * out_deg).sum())
        fwd += fresh.to(torch.int32)
        new = _receive(table, known, fresh[in_nb] & in_mask[:, :, None],
                       in_nb, rank)
        known = known | new
        fresh = new
        complete.append(known.all())
    return table, known, torch.stack(sends), fwd, torch.stack(complete)


def flood_exec(schedule: Union[GossipSchedule, Graph], payload,
               unit_scalars: Units = 0.0, unit_points: Units = 0.0,
               dim: int = 0) -> Tuple[torch.Tensor, ExecResult]:
    """Execute Algorithm 3 on a compiled gossip schedule.

    ``payload``: (n, ...) origin-indexed -- node v starts knowing only
    ``payload[v]``. Returns ``(tables, result)`` where ``tables[v, o]`` is
    node v's relayed copy of origin o's payload (on a connected graph every
    node ends holding all n payloads, bit-identical to the originals).

    ``unit_scalars`` / ``unit_points`` price each *transmission* of origin
    o's message (scalar, or (n,) per-origin -- Round 2 portions have
    per-site sizes ``t_i + k``); the returned ledger is measured from the
    executed schedule and equals the analytic
    ``flood_cost(g, n_messages=n, ...)`` exactly. The rounds run on the
    payload's device.
    """
    if isinstance(schedule, Graph):
        schedule = gossip_schedule(schedule)
    payload = _placed(payload)
    if payload.shape[0] != schedule.n:
        raise ValueError(f"payload must be origin-indexed: got leading dim "
                         f"{payload.shape[0]} for a {schedule.n}-node graph")
    t0 = time.perf_counter()
    trailing = tuple(payload.shape[1:])
    flat = payload.reshape(schedule.n, -1)
    table, known, sends, fwd, complete = _flood_exec_rounds(schedule, flat)
    if not bool(known.all()):
        raise RuntimeError("flood did not complete: graph disconnected?")
    flags = complete.cpu().numpy()
    done = int(np.argmax(flags)) + 1 if flags.any() else schedule.n_rounds
    if schedule.n == 1:
        done = 0
    # price the measured (node, origin) forward counts: hop counts with the
    # node's degree, link costs with its weighted degree (each forward is
    # one transmission per incident link)
    fwd_np = fwd.cpu().numpy().astype(np.int64)
    deg = np.asarray(schedule.degrees, np.int64)
    per_origin = (fwd_np * deg[:, None]).sum(axis=0)
    wdeg = np.asarray(schedule.weighted_degrees, np.float64)
    per_origin_link = np.asarray(
        [float((fwd_np[:, o].astype(np.float64) * wdeg).sum())
         for o in range(schedule.n)], np.float64)
    ledger = _units_ledger(per_origin, unit_scalars, unit_points,
                           dim, count_all_messages=True,
                           per_origin_link=per_origin_link)
    res = ExecResult(rounds=schedule.n_rounds, rounds_to_complete=done,
                     ledger=ledger,
                     per_round_transmissions=[int(s) for s in
                                              sends.cpu().tolist()],
                     wall_s=time.perf_counter() - t0)
    return table.reshape((schedule.n, schedule.n) + trailing), res


@dataclasses.dataclass(frozen=True, eq=False)
class TreeSchedule:
    """Static per-level schedule for a rooted :class:`SpanningTree`:
    ``levels[l]`` are the nodes at depth ``l+1`` (ascending node id),
    ``subtree`` the per-node descendant masks that route scatter payloads.
    The up passes iterate levels deepest-first (a node transmits only after
    all its children have), the down passes shallowest-first."""

    n: int
    root: int
    height: int
    parent: np.ndarray      # (n,) int32; parent[root] == root (self-loop)
    depth: np.ndarray       # (n,) int32
    levels: np.ndarray      # (height, width) int32, padded with root
    level_mask: np.ndarray  # (height, width) bool
    subtree: np.ndarray     # (n, n) bool; subtree[v, o]: o in subtree of v
    parent_cost: np.ndarray  # (n,) float64; cost of v's parent link (0 @root)

    @classmethod
    def from_tree(cls, tree: SpanningTree) -> "TreeSchedule":
        depth = np.asarray(tree.depth, np.int32)
        parent = np.asarray(tree.parent, np.int32).copy()
        parent[tree.root] = tree.root
        height = tree.height
        by_level = [[] for _ in range(height)]
        for v in range(tree.n):
            if depth[v] > 0:
                by_level[depth[v] - 1].append(v)
        width = max((len(l) for l in by_level), default=1)
        width = max(width, 1)
        levels = np.full((height, width), tree.root, np.int32)
        mask = np.zeros((height, width), bool)
        for l, nodes in enumerate(by_level):
            levels[l, :len(nodes)] = nodes
            mask[l, :len(nodes)] = True
        sub = np.eye(tree.n, dtype=bool)
        for v in tree.bottom_up_order():
            if tree.parent[v] >= 0:
                sub[tree.parent[v]] |= sub[v]
        return cls(n=tree.n, root=tree.root, height=height, parent=parent,
                   depth=depth, levels=levels, level_mask=mask, subtree=sub,
                   parent_cost=np.asarray(tree.parent_costs()))

    @classmethod
    def from_graph(cls, g: Graph, root: int = 0,
                   routing: str = "bfs") -> "TreeSchedule":
        """Compile a tree schedule straight from a graph under a routing
        policy (``"bfs"`` hop-minimal | ``"min_cost"`` Prim)."""
        return cls.from_tree(spanning_tree(g, root=root, routing=routing))

    def level_nodes(self, l: int) -> List[int]:
        """The live nodes of level ``l`` (depth ``l + 1``), in slot order."""
        return [int(v) for v in self.levels[l][self.level_mask[l]]]


@functools.lru_cache(maxsize=128)
def tree_schedule(g: Graph, root: int = 0,
                  routing: str = "bfs") -> TreeSchedule:
    """Cached :meth:`TreeSchedule.from_graph` (same contract as
    :func:`gossip_schedule`: one compile per (graph, root, routing))."""
    return TreeSchedule.from_graph(g, root=root, routing=routing)


def _path_link_costs(schedule: TreeSchedule,
                     hop_counts: np.ndarray) -> np.ndarray:
    """Measured per-origin link-cost totals for a gather/scatter: origin o
    moved ``hop_counts[o]`` edges along its root path; price them with the
    schedule's parent costs, deepest edge first (the same float64 order
    ``SpanningTree.path_costs`` accumulates in, so measured == analytic
    bit-for-bit for fully-routed origins)."""
    pc = np.asarray(schedule.parent_cost, np.float64)
    parent = np.asarray(schedule.parent, np.int64)
    out = np.zeros(schedule.n, np.float64)
    for o in range(schedule.n):
        acc, v = 0.0, o
        for _ in range(int(hop_counts[o])):
            acc += float(pc[v])
            v = int(parent[v])
        out[o] = acc
    return out


def _level_edge_cost_total(schedule: TreeSchedule) -> float:
    """Total scheduled-edge cost, accumulated level-major / ascending node
    id -- the same float64 order ``SpanningTree.edge_cost_total`` uses, so
    executed broadcast / up-sum pricing equals the analytic
    ``tree_broadcast_cost`` bit-for-bit."""
    total = 0.0
    pc = np.asarray(schedule.parent_cost, np.float64)
    for l in range(schedule.height):
        for w in range(schedule.levels.shape[1]):
            if schedule.level_mask[l, w]:
                total += float(pc[schedule.levels[l, w]])
    return total


def _level_order(schedule: TreeSchedule, bottom_up: bool) -> List[int]:
    """Level indices in execution order: deepest first for the up passes,
    shallowest first for the down passes."""
    order = list(range(schedule.height))
    return order[::-1] if bottom_up else order


def _tree_result(schedule: TreeSchedule, hops: np.ndarray, unit_scalars,
                 unit_points, dim: int, t0: float) -> ExecResult:
    """The ExecResult of a gather or scatter from its measured (round,
    origin) hop counts."""
    per_origin = hops.sum(axis=0)
    ledger = _units_ledger(per_origin, unit_scalars, unit_points, dim,
                           count_all_messages=False,
                           per_origin_link=_path_link_costs(schedule,
                                                            per_origin))
    return ExecResult(rounds=schedule.height,
                      rounds_to_complete=schedule.height, ledger=ledger,
                      per_round_transmissions=[int(x) for x in
                                               hops.sum(axis=1)],
                      wall_s=time.perf_counter() - t0)


def tree_gather_exec(schedule: TreeSchedule, payload,
                     unit_scalars: Units = 0.0, unit_points: Units = 0.0,
                     dim: int = 0) -> Tuple[torch.Tensor, ExecResult]:
    """Route every node's payload up to the root (up-concat): origin o's
    copy travels ``depth(o)`` edges. Returns the root's origin-ordered
    table ``(n, ...)`` (bit-identical to ``payload``) and the measured
    ledger (equals ``tree_up_cost(tree, units)``).

    Each node holds only the payloads that sit at it: its own and those
    its children have sent. In each level (deepest first) every node of
    the level sends what it holds to its parent, which copies its own rows
    and its children's into one new buffer; the sender's buffer is freed.
    So each origin's payload lives at one node at a time, and the root's
    table is the only (n, F) result."""
    payload = _placed(payload)
    if payload.shape[0] != schedule.n:
        raise ValueError(f"payload must be origin-indexed: got leading dim "
                         f"{payload.shape[0]} for a {schedule.n}-node tree")
    t0 = time.perf_counter()
    n, dev = schedule.n, payload.device
    trailing = tuple(payload.shape[1:])
    flat = payload.reshape(n, -1)
    held = {v: ([v], flat[v:v + 1]) for v in range(n)}
    hops = np.zeros((schedule.height, n), np.int64)
    for r, l in enumerate(_level_order(schedule, bottom_up=True)):
        arriving: Dict[int, list] = {}
        for v in schedule.level_nodes(l):
            origins, rows = held.pop(v)
            hops[r, origins] += 1
            arriving.setdefault(int(schedule.parent[v]), []).append(
                (origins, rows))
        for p, parts in arriving.items():
            origins, rows = held[p]
            held[p] = (origins + [o for os, _ in parts for o in os],
                       torch.cat([rows] + [rs for _, rs in parts]))
    origins, rows = held[schedule.root]
    table = flat.new_empty(flat.shape)
    table[torch.as_tensor(origins, device=dev)] = rows
    res = _tree_result(schedule, hops, unit_scalars, unit_points, dim, t0)
    return table.reshape((n,) + trailing), res


def tree_scatter_exec(schedule: TreeSchedule, root_values,
                      unit_scalars: Units = 0.0, unit_points: Units = 0.0,
                      dim: int = 0) -> Tuple[torch.Tensor, ExecResult]:
    """Route per-origin values from the root back down: entry o travels the
    root->o path (``depth(o)`` edges; at each hop a parent forwards to each
    child exactly the entries for that child's subtree). Returns each node's
    own entry ``(n, ...)`` and the measured ledger (symmetric to
    :func:`tree_gather_exec`)."""
    root_values = _placed(root_values)
    if root_values.shape[0] != schedule.n:
        raise ValueError(f"root_values must be origin-indexed: got leading "
                         f"dim {root_values.shape[0]} for a {schedule.n}-"
                         f"node tree")
    t0 = time.perf_counter()
    n, dev = schedule.n, root_values.device
    trailing = tuple(root_values.shape[1:])
    flat = root_values.reshape(n, -1)
    # each node's received entries: (origins in ascending id, their rows)
    held = {schedule.root: (np.arange(n), flat)}
    hops = np.zeros((schedule.height, n), np.int64)
    for r, l in enumerate(_level_order(schedule, bottom_up=False)):
        for v in schedule.level_nodes(l):
            origins, rows = held[int(schedule.parent[v])]
            want = schedule.subtree[v, origins]
            hops[r, origins[want]] += 1
            held[v] = (origins[want], rows.index_select(
                0, torch.as_tensor(np.flatnonzero(want), device=dev)))
    own = torch.cat([held[v][1][int(np.searchsorted(held[v][0], v))][None]
                     for v in range(n)])
    res = _tree_result(schedule, hops, unit_scalars, unit_points, dim, t0)
    return own.reshape((n,) + trailing), res


def _slot_rounds(schedule: TreeSchedule, l: int) -> Tuple[np.ndarray, ...]:
    """Level ``l``'s slots split into rounds of distinct parents: slot w
    goes into round r when r earlier slots share its parent (padding slots
    have the root for parent). Applying the rounds in turn adds every
    parent's contributions in ascending slot order, the order of the
    reference's scatter-add on the CPU."""
    seen: Dict[int, int] = {}
    rank = []
    for v in schedule.levels[l]:
        p = int(schedule.parent[v])
        rank.append(seen.get(p, 0))
        seen[p] = rank[-1] + 1
    rank = np.asarray(rank)
    return tuple(np.flatnonzero(rank == r) for r in range(rank.max() + 1))


def tree_up_sum_exec(schedule: TreeSchedule, values, broadcast: bool = True,
                     unit_scalars: Units = 0.0, unit_points: Units = 0.0,
                     dim: int = 0) -> Tuple[torch.Tensor, ExecResult]:
    """Up-*sum*: each node sends one aggregated payload to its parent after
    hearing from all children (n-1 fixed-size transmissions); with
    ``broadcast`` the root's total is then sent down every edge (n-1 more),
    so every node ends holding the global sum. ``unit_*`` price one
    transmission (the aggregate has the same size everywhere).

    A parent adds its children's payloads one at a time in ascending slot
    order (never with atomic adds), so the sums are the same bits on every
    run and device. The tree-structured order differs from a flat sum in
    float, so exact-replay protocols (the distributed Round-1 allocation)
    route the raw scalars via gather/scatter instead and use this
    primitive only where a sum is the final answer."""
    values = _placed(values)
    if values.shape[0] != schedule.n:
        raise ValueError(f"values must be node-indexed: got leading dim "
                         f"{values.shape[0]} for a {schedule.n}-node tree")
    t0 = time.perf_counter()
    dev = values.device
    trailing = tuple(values.shape[1:])
    acc = values.reshape(schedule.n, -1).clone()
    up_sends = []
    for l in _level_order(schedule, bottom_up=True):
        nodes = torch.as_tensor(schedule.levels[l], dtype=torch.int64,
                                device=dev)
        par = torch.as_tensor(schedule.parent[schedule.levels[l]],
                              dtype=torch.int64, device=dev)
        live = torch.as_tensor(schedule.level_mask[l], device=dev)
        contrib = torch.where(live[:, None], acc[nodes],
                              acc.new_zeros(()))
        for slots in _slot_rounds(schedule, l):
            sel = torch.as_tensor(slots, device=dev)
            to = par[sel]
            acc[to] = acc[to] + contrib[sel]
        up_sends.append(int(schedule.level_mask[l].sum()))
    total = acc[schedule.root]
    sends = sum(up_sends)
    w_sends = _level_edge_cost_total(schedule) if sends else 0.0
    per_round = list(up_sends)
    if broadcast:
        out, bres = tree_broadcast_exec(schedule, total,
                                        unit_scalars=unit_scalars,
                                        unit_points=unit_points, dim=dim)
        sends_total = sends + int(bres.ledger.messages)
        w_sends = w_sends + (_level_edge_cost_total(schedule)
                             if bres.ledger.messages else 0.0)
        per_round = per_round + bres.per_round_transmissions
    else:
        out = total.expand((schedule.n,) + tuple(total.shape))
        sends_total = sends
    ledger = _units_ledger(np.asarray([sends_total], np.float64),
                           unit_scalars, unit_points, dim,
                           count_all_messages=False,
                           per_origin_link=np.asarray([w_sends], np.float64))
    res = ExecResult(rounds=schedule.height * (2 if broadcast else 1),
                     rounds_to_complete=schedule.height, ledger=ledger,
                     per_round_transmissions=per_round,
                     wall_s=time.perf_counter() - t0)
    return out.reshape((schedule.n,) + trailing), res


def tree_broadcast_exec(schedule: TreeSchedule, value,
                        unit_scalars: Units = 0.0, unit_points: Units = 0.0,
                        dim: int = 0) -> Tuple[torch.Tensor, ExecResult]:
    """Root sends one payload down every tree edge, level by level (n-1
    transmissions). Returns every node's (bit-identical) copy ``(n, ...)``
    and the measured ledger (equals ``tree_broadcast_cost``)."""
    value = _placed(value)
    t0 = time.perf_counter()
    dev = value.device
    flat = value.reshape(-1)
    vals = flat.new_zeros((schedule.n, flat.shape[0]))
    vals[schedule.root] = flat
    sends = []
    for l in _level_order(schedule, bottom_up=False):
        nodes = schedule.level_nodes(l)
        vals[torch.as_tensor(nodes, device=dev)] = vals[torch.as_tensor(
            schedule.parent[nodes], dtype=torch.int64, device=dev)]
        sends.append(len(nodes))
    n_sends = sum(sends)
    w_sends = _level_edge_cost_total(schedule) if n_sends else 0.0
    ledger = _units_ledger(np.asarray([n_sends], np.float64), unit_scalars,
                           unit_points, dim, count_all_messages=False,
                           per_origin_link=np.asarray([w_sends], np.float64))
    res = ExecResult(rounds=schedule.height,
                     rounds_to_complete=schedule.height, ledger=ledger,
                     per_round_transmissions=sends,
                     wall_s=time.perf_counter() - t0)
    return vals.reshape((schedule.n,) + tuple(value.shape)), res


# ---------------------------------------------------------------------------
# SPMD ring + 2-D torus collectives (over a bound mesh axis)
# ---------------------------------------------------------------------------

def _check_axis_size(axis_name: str, axis_size: int, fn: str) -> None:
    """Fail loudly when the caller's ``axis_size`` disagrees with the size
    of the group bound to ``axis_name``: the ring / torus schedules are
    built from the *claimed* size, so a mismatch would address phantom
    ranks."""
    if axis_size < 1:
        raise ValueError(f"{fn}: axis_size must be >= 1, got {axis_size}")
    actual = mesh_mod.axis(axis_name).size
    if actual != axis_size:
        raise ValueError(
            f"{fn}: axis_size={axis_size} disagrees with the actual size "
            f"{actual} of mesh axis {axis_name!r}; the ring schedule would "
            "be silently wrong")


def _ring(x: torch.Tensor, mesh, perm, hops: int):
    """``hops`` hops of the single-hop permutation ``perm`` (``(src, dst)``
    pairs of axis indices, ``jax.lax.ppermute``'s): at each hop every rank
    sends its current buffer to its ``dst`` and receives its ``src``'s.
    Yields ``(j, buf)``: the buffer received at hop ``j`` (1-based), which
    came from ``j`` places back along the ring."""
    dst = dict(perm)[mesh.rank]
    src = {d: s for s, d in perm}[mesh.rank]
    buf = x
    for j in range(1, hops + 1):
        buf = mesh.hop(buf, dst, src)
        yield j, buf


def _ring_sum(x: torch.Tensor, mesh, perm, hops: int) -> torch.Tensor:
    """``acc + buf`` after each hop (the reference's order: this rank's
    value, then the previous one's, and so on)."""
    acc = x
    for _, buf in _ring(x, mesh, perm, hops):
        acc = acc + buf
    return acc


def _ring_gather(x: torch.Tensor, mesh, perm, width: int, pos: int
                 ) -> torch.Tensor:
    """``(width, *x.shape)``: the ``width`` buffers of the ring through
    this rank (at position ``pos``) in ring order, each a relay of its
    origin's bytes."""
    out = x.new_empty((width,) + tuple(x.shape))
    out[pos] = x
    for j, buf in _ring(x, mesh, perm, width - 1):
        out[(pos - j) % width] = buf
    return out


def _ring_perm(axis_size: int):
    return [(i, (i + 1) % axis_size) for i in range(axis_size)]


def neighbor_rounds_sum(x: torch.Tensor, axis_name: str,
                        axis_size: int) -> torch.Tensor:
    """Global sum via ring neighbour exchanges only (Algorithm 3 on a
    physical ring): after ``axis_size - 1`` hops each rank has accumulated
    every rank's value, adding in the hop order -- so the float total is
    the JAX package's bit for bit and the same on every repeat, but it may
    differ from an all-reduce in the last ulps. Run inside ``with mesh:``
    over ``axis_name``."""
    _check_axis_size(axis_name, axis_size, "neighbor_rounds_sum")
    return _ring_sum(x, mesh_mod.axis(axis_name), _ring_perm(axis_size),
                     axis_size - 1)


def neighbor_rounds_gather(x: torch.Tensor, axis_name: str,
                           axis_size: int) -> torch.Tensor:
    """All-gather via ring neighbour exchanges (Algorithm 3 Round 2 on a
    physical ring): ``(axis_size, *x.shape)`` on every rank, every slot a
    pure relay of its origin's bytes, so the result equals an all-gather
    bit for bit."""
    _check_axis_size(axis_name, axis_size, "neighbor_rounds_gather")
    mesh = mesh_mod.axis(axis_name)
    return _ring_gather(x, mesh, _ring_perm(axis_size), axis_size,
                        mesh.rank)


def torus_mesh_shape(axis_size: int) -> Tuple[int, int]:
    """Most-square (R, C) factorization of ``axis_size`` (R <= C): the
    default ``mesh_shape`` of ``collectives="torus_2d"``, which minimizes
    (R - 1) + (C - 1) hops over the 2-D foldings of a flat axis. Prime
    sizes degenerate to (1, axis_size), the ring."""
    if axis_size < 1:
        raise ValueError(f"axis_size must be >= 1, got {axis_size}")
    r = int(np.sqrt(axis_size))
    while axis_size % r:
        r -= 1
    return r, axis_size // r


def _torus_perms(axis_name: str, mesh_shape: Tuple[int, int], fn: str):
    """Validate (R, C) against the mesh axis and return the two single-hop
    permutations in row-major flat indexing i = r * C + c: the row phase
    (r, c) -> (r, (c+1) % C) and the column phase (r, c) -> ((r+1) % R,
    c), each as ``(src, dst)`` pairs."""
    R, C = mesh_shape
    if R < 1 or C < 1:
        raise ValueError(f"{fn}: mesh_shape must be positive, got "
                         f"{mesh_shape}")
    _check_axis_size(axis_name, R * C, fn)
    row_perm = [(r * C + c, r * C + (c + 1) % C)
                for r in range(R) for c in range(C)]
    col_perm = [(r * C + c, ((r + 1) % R) * C + c)
                for r in range(R) for c in range(C)]
    return row_perm, col_perm


def torus_rounds_gather(x: torch.Tensor, axis_name: str,
                        mesh_shape: Tuple[int, int]) -> torch.Tensor:
    """All-gather on a 2-D torus folding of the flat axis: (C - 1) row-ring
    hops gather each rank's row of C buffers, then (R - 1) column-ring hops
    gather the rows -- (R - 1) + (C - 1) sequential hops instead of the
    ring's R C - 1. Returns ``(R * C, *x.shape)`` in flat row-major order,
    bit-equal to an all-gather (every slot a pure relay)."""
    R, C = mesh_shape
    row_perm, col_perm = _torus_perms(axis_name, mesh_shape,
                                      "torus_rounds_gather")
    mesh = mesh_mod.axis(axis_name)
    r, c = divmod(mesh.rank, C)
    row = _ring_gather(x, mesh, row_perm, C, c)
    # (R, C, ...) row-major == flat order i = r * C + c
    return _ring_gather(row, mesh, col_perm, R, r).reshape(
        (R * C,) + tuple(x.shape))


def torus_rounds_sum(x: torch.Tensor, axis_name: str,
                     mesh_shape: Tuple[int, int]) -> torch.Tensor:
    """Global sum on a 2-D torus folding: row-ring partial sums in C - 1
    hops, then the column ring over the row totals in R - 1 hops, each
    ``acc + buf`` in hop order (the JAX package's float total bit for bit;
    it may differ from the 1-D ring's in the last ulps)."""
    R, C = mesh_shape
    row_perm, col_perm = _torus_perms(axis_name, mesh_shape,
                                      "torus_rounds_sum")
    mesh = mesh_mod.axis(axis_name)
    return _ring_sum(_ring_sum(x, mesh, row_perm, C - 1), mesh, col_perm,
                     R - 1)


def collective_hops(collectives: str, axis_size: int,
                    mesh_shape: Optional[Tuple[int, int]] = None) -> int:
    """Sequential hop depth of one gather under each schedule:
    ``all_gather`` counts at the ring depth axis_size - 1, as
    ``neighbor_rounds``; ``torus_2d`` is (R - 1) + (C - 1)."""
    if collectives in ("all_gather", "neighbor_rounds"):
        return axis_size - 1
    if collectives == "torus_2d":
        R, C = (torus_mesh_shape(axis_size) if mesh_shape is None
                else mesh_shape)
        if R * C != axis_size:
            raise ValueError(f"mesh_shape {mesh_shape} does not tile "
                             f"axis_size {axis_size}")
        return (R - 1) + (C - 1)
    raise ValueError(f"unknown collectives mode: {collectives!r}")
