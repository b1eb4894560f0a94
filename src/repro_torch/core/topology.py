"""Communication-graph topologies (a numpy copy of the parts of
``repro.core.topology`` the port's main path uses).

Host-side orchestration data, never on the device. Graphs are a validated
sorted edge list plus ``n``, with optional per-link costs; helpers derive
cached adjacency lists, degrees and BFS spanning trees. Generators: the
paper's Erdos-Renyi G(n, p) and the 2-D grid.

The port keeps its own copy because ``import repro.core.topology`` runs
``repro/core/__init__.py``, which imports JAX.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np

@dataclasses.dataclass(frozen=True)
class Graph:
    """A communication graph: ``n`` nodes and a sorted edge list.

    ``edges`` are ``(i, j)`` pairs with ``i < j`` (undirected, the default)
    or ordered ``(src, dst)`` pairs (``directed=True``). ``edge_costs``
    optionally prices each link (aligned with ``edges``); ``None`` means the
    uniform unit cost the paper assumes, and every ledger then reproduces
    the unweighted accounting bit-exactly. Malformed edge lists
    (self-loops, out-of-range endpoints, unsorted/duplicate edges, negative
    or non-finite costs) raise at construction.

    ``adjacency()`` / ``adjacency_costs()`` / ``degrees()`` /
    ``weighted_degrees()`` are cached on the frozen instance -- the
    returned containers are shared, so treat them as read-only.
    """

    n: int
    edges: Tuple[Tuple[int, int], ...]
    edge_costs: Optional[Tuple[float, ...]] = None
    directed: bool = False

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"graph needs n >= 1 node, got n={self.n}")
        edges = tuple((int(i), int(j)) for i, j in self.edges)
        object.__setattr__(self, "edges", edges)
        prev = None
        for e in edges:
            i, j = e
            if i == j:
                raise ValueError(f"self-loop edge {e} is not allowed")
            if not (0 <= i < self.n and 0 <= j < self.n):
                raise ValueError(f"edge {e} out of range for n={self.n} "
                                 f"nodes")
            if not self.directed and i > j:
                raise ValueError(f"undirected edge {e} must be stored as "
                                 f"(min, max): expected {(j, i)}")
            if prev is not None and e <= prev:
                kind = "duplicate" if e == prev else "unsorted"
                raise ValueError(f"{kind} edge {e} after {prev}: the edge "
                                 f"list must be strictly sorted")
            prev = e
        if self.edge_costs is not None:
            costs = tuple(float(c) for c in self.edge_costs)
            object.__setattr__(self, "edge_costs", costs)
            if len(costs) != len(edges):
                raise ValueError(f"edge_costs has {len(costs)} entries for "
                                 f"{len(edges)} edges")
            for e, c in zip(edges, costs):
                if not math.isfinite(c) or c < 0.0:
                    raise ValueError(f"edge {e} has invalid cost {c!r}: "
                                     f"costs must be finite and >= 0")

    @property
    def m(self) -> int:
        return len(self.edges)

    @property
    def costs(self) -> Tuple[float, ...]:
        """Per-edge costs aligned with ``edges`` (uniform 1.0 when unset)."""
        return self.edge_costs if self.edge_costs is not None \
            else (1.0,) * self.m

    @functools.cached_property
    def _adj(self) -> Tuple[Tuple[Tuple[int, ...], ...],
                            Tuple[Tuple[float, ...], ...]]:
        nbrs: List[List[int]] = [[] for _ in range(self.n)]
        cost: List[List[float]] = [[] for _ in range(self.n)]
        for (i, j), c in zip(self.edges, self.costs):
            nbrs[i].append(j)
            cost[i].append(c)
            if not self.directed:
                nbrs[j].append(i)
                cost[j].append(c)
        return (tuple(tuple(a) for a in nbrs),
                tuple(tuple(c) for c in cost))

    def adjacency(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-node (out-)neighbour lists; cached, read-only."""
        return self._adj[0]

    def adjacency_costs(self) -> Tuple[Tuple[float, ...], ...]:
        """Per-node link costs aligned with :meth:`adjacency`."""
        return self._adj[1]

    @functools.cached_property
    def _degrees(self) -> np.ndarray:
        deg = np.asarray([len(a) for a in self.adjacency()], np.int64)
        deg.setflags(write=False)
        return deg

    def degrees(self) -> np.ndarray:
        """(Out-)degrees; cached, read-only."""
        return self._degrees

    @functools.cached_property
    def _weighted_degrees(self) -> np.ndarray:
        # sequential float64 accumulation in adjacency order: the canonical
        # summation the ledgers price with (DESIGN.md Sec. 12)
        wd = np.asarray([float(sum(cs)) for cs in self.adjacency_costs()],
                        np.float64)
        wd.setflags(write=False)
        return wd

    def weighted_degrees(self) -> np.ndarray:
        """Per-node sums of incident (out-)link costs; cached, read-only.
        Equals ``degrees()`` on uniform costs; sums to ``2m`` (undirected)
        or ``m`` (directed) there."""
        return self._weighted_degrees


def _components(n: int, edges) -> List[List[int]]:
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in edges:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
    comps: dict = {}
    for v in range(n):
        comps.setdefault(find(v), []).append(v)
    return list(comps.values())


def _connect(rng: np.random.Generator, n: int, edges: set) -> set:
    """Add random edges between components until connected."""
    comps = _components(n, edges)
    while len(comps) > 1:
        a = rng.choice(comps[0])
        b = rng.choice(comps[1])
        edges.add((min(a, b), max(a, b)))
        comps = _components(n, edges)
    return edges


def erdos_renyi(n: int, p: float = 0.3, seed: int = 0) -> Graph:
    """G(n, p), forced connected by bridging components (paper Sec. 5)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    edges = {(i, j) for i in range(n) for j in range(i + 1, n) if mask[i, j]}
    edges = _connect(rng, n, edges)
    return Graph(n, tuple(sorted(edges)))



def grid(rows: int, cols: int) -> Graph:
    """rows x cols 2D grid graph (diameter Theta(sqrt(n)))."""
    edges = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                edges.append((v, v + 1))
            if r + 1 < rows:
                edges.append((v, v + cols))
    return Graph(rows * cols, tuple(sorted(edges)))


@dataclasses.dataclass(frozen=True)
class SpanningTree:
    """A rooted spanning tree, optionally cost-annotated.

    ``parent_cost[v]`` is the cost of v's parent link (0.0 at the root;
    ``None`` means uniform unit links, the pre-cost behavior).
    :meth:`path_costs` / :meth:`edge_cost_total` are the two pricing axes
    the ledgers consume (DESIGN.md Sec. 12): a gathered/scattered payload
    pays its root-path cost, a broadcast payload pays every tree edge
    once."""

    n: int
    root: int
    parent: Tuple[int, ...]   # parent[root] == -1
    depth: Tuple[int, ...]
    parent_cost: Optional[Tuple[float, ...]] = None

    @property
    def height(self) -> int:
        return int(max(self.depth))

    @functools.cached_property
    def _pc64(self) -> np.ndarray:
        pc = (np.ones(self.n, np.float64) if self.parent_cost is None
              else np.asarray(self.parent_cost, np.float64))
        pc = pc.copy()
        pc[self.root] = 0.0
        pc.setflags(write=False)
        return pc

    @functools.cached_property
    def _path_costs(self) -> np.ndarray:
        # accumulate each root path deepest-edge-first: the same float64
        # order the executed gather/scatter rounds are priced in, so the
        # analytic and measured ledgers agree bit-for-bit
        pc = self._pc64
        out = np.zeros(self.n, np.float64)
        for v in range(self.n):
            acc, u = 0.0, v
            while self.parent[u] >= 0:
                acc += float(pc[u])
                u = self.parent[u]
            out[v] = acc
        out.setflags(write=False)
        return out

    def path_costs(self) -> np.ndarray:
        """Cost of each node's path to the root (== ``depth`` when
        uniform); cached, read-only."""
        return self._path_costs

    @functools.cached_property
    def _edge_cost_total(self) -> float:
        # level-major, ascending node id within a level: the order the
        # executed broadcast prices its transmissions in
        pc = self._pc64
        total = 0.0
        for v in sorted(range(self.n), key=lambda u: (self.depth[u], u)):
            if self.parent[v] >= 0:
                total += float(pc[v])
        return total

    def edge_cost_total(self) -> float:
        """Sum of tree-edge costs (== ``n - 1`` when uniform); cached."""
        return self._edge_cost_total


def bfs_spanning_tree(g: Graph, root: int = 0) -> SpanningTree:
    """Breadth-first spanning tree (the paper restricts Zhang et al. to a BFS
    tree from a uniformly random root). Parent links carry the graph's edge
    costs so tree ledgers price heterogeneous links correctly."""
    if g.directed:
        raise ValueError("spanning trees need an undirected graph (tree "
                         "protocols route both up and down each link)")
    adj, adjc = g.adjacency(), g.adjacency_costs()
    parent = [-2] * g.n
    pcost = [0.0] * g.n
    depth = [0] * g.n
    parent[root] = -1
    frontier = [root]
    while frontier:
        nxt = []
        for v in frontier:
            for u, c in zip(adj[v], adjc[v]):
                if parent[u] == -2:
                    parent[u] = v
                    pcost[u] = c
                    depth[u] = depth[v] + 1
                    nxt.append(u)
        frontier = nxt
    if any(p == -2 for p in parent):
        raise ValueError("graph is not connected")
    return SpanningTree(g.n, root, tuple(parent), tuple(depth), tuple(pcost))


def spanning_tree(g: Graph, root: int = 0,
                  routing: str = "bfs") -> SpanningTree:
    """Build a spanning tree under a routing policy: ``"bfs"`` minimizes
    hop depth. ``"min_cost"`` (Prim over link costs) is not ported yet."""
    if routing == "bfs":
        return bfs_spanning_tree(g, root=root)
    if routing == "min_cost":
        raise ValueError("routing 'min_cost' is not yet ported to "
                         "repro_torch; use 'bfs'")
    raise ValueError(f"unknown routing {routing!r}: expected 'bfs'")
