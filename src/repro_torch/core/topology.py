"""Communication-graph topologies (a numpy copy of
``repro.core.topology``).

Host-side orchestration data, never on the device. Graphs are a validated
sorted edge list plus ``n``; edges carry optional per-link **costs** (the
heterogeneous-link contract, DESIGN.md Sec. 12) and the graph can be
directed. Helpers derive cached adjacency lists, degrees, BFS and min-cost
(Prim) spanning trees, and diameters. Generators: Erdos-Renyi G(n, p)
(paper: p=0.3), 2D grid and torus, Barabasi-Albert preferential
attachment, ring, star, and ``wan_clusters`` (cheap intra-rack cliques
joined by expensive cross-rack links); ``heterogeneous`` re-prices any
generator's edges through a cost function.

The port keeps its own copy because ``import repro.core.topology`` runs
``repro/core/__init__.py``, which imports JAX. Every function here returns
what the reference's returns, bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import math
from typing import Callable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """A communication graph: ``n`` nodes and a sorted edge list.

    ``edges`` are ``(i, j)`` pairs with ``i < j`` (undirected, the default)
    or ordered ``(src, dst)`` pairs (``directed=True``). ``edge_costs``
    optionally prices each link (aligned with ``edges``); ``None`` means the
    uniform unit cost the paper assumes, and every ledger then reproduces
    the unweighted accounting bit-exactly. Validation happens at
    construction: malformed edge lists (self-loops, out-of-range endpoints,
    unsorted/duplicate edges, negative or non-finite costs) used to corrupt
    schedules silently; now they raise immediately.

    ``adjacency()`` / ``adjacency_costs()`` / ``degrees()`` /
    ``weighted_degrees()`` are cached on the frozen instance (schedule
    construction used to rebuild adjacency on every aggregate round) -- the
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

    @property
    def is_uniform_cost(self) -> bool:
        """True iff every link prices at the paper's unit cost."""
        return self.edge_costs is None or all(c == 1.0 for c in
                                              self.edge_costs)

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

    @functools.cached_property
    def _cost_map(self) -> dict:
        cm = {}
        for (i, j), c in zip(self.edges, self.costs):
            cm[(i, j)] = c
            if not self.directed:
                cm[(j, i)] = c
        return cm

    def cost_of(self, i: int, j: int) -> float:
        """Cost of the (directed) link i -> j; KeyError if absent."""
        return self._cost_map[(i, j)]

    @functools.cached_property
    def _distances(self) -> np.ndarray:
        d = all_pairs_distances(self)
        d.setflags(write=False)
        return d

    def distances(self) -> np.ndarray:
        """(n, n) hop-count matrix ``dist[s, v]`` (directed distances on a
        directed graph; -1 for unreachable pairs); cached, read-only. This
        is the synchronous-flood timetable: origin ``s``'s payload reaches
        node ``v`` in exactly ``dist[s, v]`` lossless rounds, which is the
        baseline the WAN runtime's staleness axis is metered against."""
        return self._distances


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


def ring(n: int) -> Graph:
    """Cycle graph 0-1-...-(n-1)-0 (diameter floor(n/2)); n=2 degenerates to
    a single edge. The physical-ICI analogue of ``neighbor_rounds_*``."""
    if n < 2:
        raise ValueError("ring needs n >= 2")
    edges = {(i, i + 1) for i in range(n - 1)}
    edges.add((0, n - 1))
    return Graph(n, tuple(sorted(edges)))


def star(n: int) -> Graph:
    """Star with hub 0 (diameter 2): the paper's most centralized topology,
    the worst case for the 2m-per-message flood bound being tight."""
    if n < 2:
        raise ValueError("star needs n >= 2")
    return Graph(n, tuple((0, i) for i in range(1, n)))


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


def torus(rows: int, cols: int) -> Graph:
    """rows x cols 2-D torus: the grid plus row/column wraparound edges --
    the physical-ICI analogue of ``torus_rounds_gather``'s row-phase /
    column-phase ``ppermute`` schedule (node i = r * cols + c matches the
    collective's flat row-major device order). Diameter
    floor(rows/2) + floor(cols/2), vs the 1-D ring's floor(n/2).

    Wraparound edges degenerate gracefully: a dimension of 2 already has
    its wrap edge in the grid (kept single, as in ``ring(2)``), and a
    dimension of 1 contributes none (a 1 x C torus is the C-cycle)."""
    if rows * cols < 2:
        raise ValueError("torus needs rows * cols >= 2")
    edges = set()
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if cols > 1:
                w = r * cols + (c + 1) % cols
                edges.add((min(v, w), max(v, w)))
            if rows > 1:
                w = ((r + 1) % rows) * cols + c
                edges.add((min(v, w), max(v, w)))
    return Graph(rows * cols, tuple(sorted(edges)))


def preferential(n: int, m_attach: int = 2, seed: int = 0) -> Graph:
    """Barabasi-Albert preferential attachment: each new node attaches to
    ``m_attach`` existing nodes with probability proportional to degree."""
    rng = np.random.default_rng(seed)
    m0 = max(m_attach, 2)
    edges = {(i, j) for i in range(m0) for j in range(i + 1, m0)}  # seed clique
    deg = np.zeros(n, dtype=np.float64)
    for i, j in edges:
        deg[i] += 1
        deg[j] += 1
    for v in range(m0, n):
        probs = deg[:v] / deg[:v].sum()
        targets = rng.choice(v, size=min(m_attach, v), replace=False, p=probs)
        for t in targets:
            edges.add((min(v, int(t)), max(v, int(t))))
            deg[v] += 1
            deg[t] += 1
    return Graph(n, tuple(sorted(edges)))


def wan_clusters(n_racks: int, rack_size: int, intra_cost: float = 1.0,
                 cross_cost: float = 16.0, cross_links: int = 2,
                 seed: int = 0) -> Graph:
    """Two-tier WAN topology: racks of cheap links joined by expensive ones.

    Each rack is a clique of ``rack_size`` nodes on ``intra_cost`` links
    (rack ``r`` owns nodes ``r*rack_size .. (r+1)*rack_size - 1``); every
    pair of racks is joined by ``cross_links`` links of ``cross_cost``
    between random endpoints, chosen so the far-side endpoints are distinct
    (up to ``rack_size``). That endpoint spread is what makes hop-count
    (BFS) routing pay: a BFS tree enters a remote rack through *every*
    cross link whose far endpoint it reaches at the shallower depth, while
    a min-cost tree pays for exactly one cross link per rack it attaches.
    Defaults keep costs integer-valued so ledger identities are bit-exact
    (DESIGN.md Sec. 12)."""
    if n_racks < 1 or rack_size < 1:
        raise ValueError(f"wan_clusters needs n_racks >= 1 and rack_size >= "
                         f"1, got {n_racks} x {rack_size}")
    if n_racks > 1 and cross_links < 1:
        raise ValueError("wan_clusters needs cross_links >= 1 to connect "
                         "racks")
    rng = np.random.default_rng(seed)
    cost = {}
    for r in range(n_racks):
        base = r * rack_size
        for a in range(rack_size):
            for b in range(a + 1, rack_size):
                cost[(base + a, base + b)] = float(intra_cost)
    for ra in range(n_racks):
        for rb in range(ra + 1, n_racks):
            n_links = min(cross_links, rack_size)
            vs = rng.choice(rack_size, size=n_links, replace=False)
            us = rng.integers(0, rack_size, size=n_links)
            for u, v in zip(us, vs):
                e = (ra * rack_size + int(u), rb * rack_size + int(v))
                cost[e] = float(cross_cost)
    edges = tuple(sorted(cost))
    return Graph(n_racks * rack_size, edges,
                 edge_costs=tuple(cost[e] for e in edges))


def heterogeneous(g: Graph, cost_fn: Callable[[int, int], float]) -> Graph:
    """Re-price a generator's links: a copy of ``g`` whose ``edge_costs``
    are ``cost_fn(i, j)`` per edge (validated like any constructed graph).
    Composes with every existing generator, e.g.
    ``heterogeneous(grid(4, 4), lambda i, j: 8.0 if j - i > 1 else 1.0)``
    prices vertical grid links 8x the horizontal ones."""
    return Graph(g.n, g.edges,
                 edge_costs=tuple(float(cost_fn(i, j)) for i, j in g.edges),
                 directed=g.directed)


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

    def children(self) -> List[List[int]]:
        ch: List[List[int]] = [[] for _ in range(self.n)]
        for v, p in enumerate(self.parent):
            if p >= 0:
                ch[p].append(v)
        return ch

    def bottom_up_order(self) -> List[int]:
        """Leaves first, root last."""
        return sorted(range(self.n), key=lambda v: -self.depth[v])

    @functools.cached_property
    def _pc64(self) -> np.ndarray:
        pc = (np.ones(self.n, np.float64) if self.parent_cost is None
              else np.asarray(self.parent_cost, np.float64))
        pc = pc.copy()
        pc[self.root] = 0.0
        pc.setflags(write=False)
        return pc

    def parent_costs(self) -> np.ndarray:
        """float64 per-node parent-link costs (0 at root); cached."""
        return self._pc64

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


def mst_spanning_tree(g: Graph, root: int = 0) -> SpanningTree:
    """Min-cost spanning tree rooted at ``root``: Prim over ``edge_costs``.

    Ties break by discovery order (FIFO), so on uniform costs Prim explores
    in exactly the BFS frontier order and returns the *identical* tree --
    which is what keeps uniform-cost min-cost ledgers bit-compatible with
    the BFS ledgers (asserted in tests). On heterogeneous costs the tree
    minimizes the total edge cost (the broadcast / up-sum price), at the
    expense of possibly deeper paths (the gather price and the quiescence
    bound grow with tree height; DESIGN.md Sec. 12)."""
    if g.directed:
        raise ValueError("spanning trees need an undirected graph (tree "
                         "protocols route both up and down each link)")
    adj, adjc = g.adjacency(), g.adjacency_costs()
    parent = [-2] * g.n
    pcost = [0.0] * g.n
    depth = [0] * g.n
    parent[root] = -1
    heap: list = []
    seq = 0

    def push_edges(v: int) -> None:
        nonlocal seq
        for u, c in zip(adj[v], adjc[v]):
            if parent[u] == -2:
                heapq.heappush(heap, (c, seq, v, u))
                seq += 1

    push_edges(root)
    while heap:
        c, _, v, u = heapq.heappop(heap)
        if parent[u] != -2:
            continue
        parent[u] = v
        pcost[u] = c
        depth[u] = depth[v] + 1
        push_edges(u)
    if any(p == -2 for p in parent):
        raise ValueError("graph is not connected")
    return SpanningTree(g.n, root, tuple(parent), tuple(depth), tuple(pcost))


def spanning_tree(g: Graph, root: int = 0,
                  routing: str = "bfs") -> SpanningTree:
    """Build a spanning tree under a routing policy: ``"bfs"`` minimizes
    hop depth, ``"min_cost"`` minimizes total link cost (Prim). The two
    coincide (bit-exactly) on uniform costs."""
    if routing == "bfs":
        return bfs_spanning_tree(g, root=root)
    if routing == "min_cost":
        return mst_spanning_tree(g, root=root)
    raise ValueError(f"unknown routing {routing!r}: expected "
                     f"'bfs'|'min_cost'")


def all_pairs_distances(g: Graph) -> np.ndarray:
    """(n, n) hop-count matrix by n BFS passes (n is small in all
    experiments): ``dist[s, v]`` is the shortest path from s to v along
    (out-)links, -1 if unreachable. Prefer ``g.distances()`` (the cached
    accessor) over calling this directly."""
    adj = g.adjacency()
    out = np.full((g.n, g.n), -1, np.int64)
    for s in range(g.n):
        dist = out[s]
        dist[s] = 0
        frontier = [s]
        while frontier:
            nxt = []
            for v in frontier:
                for u in adj[v]:
                    if dist[u] < 0:
                        dist[u] = dist[v] + 1
                        nxt.append(u)
            frontier = nxt
    return out


def diameter(g: Graph) -> int:
    """Exact diameter from the cached distance matrix. Directed graphs use
    directed distances and must be strongly connected."""
    dist = g.distances()
    if dist.min() < 0:
        raise ValueError("graph is not connected" if not g.directed
                         else "directed graph is not strongly connected")
    return int(dist.max())


def drop_edges(g: Graph, dropped) -> Graph:
    """A copy of ``g`` with ``dropped`` edges removed (same node set).

    ``dropped`` is an iterable of endpoint pairs; undirected pairs may be
    given in either orientation. Unknown edges raise -- a fault plan that
    names a non-existent link is a bug, not a no-op. This is the
    *surviving graph* constructor of the WAN fault model (DESIGN.md
    Sec. 14); note the result may be disconnected, which ``diameter()`` /
    the quiescence checker will surface."""
    norm = set()
    for i, j in dropped:
        e = (int(i), int(j))
        if not g.directed:
            e = (min(e), max(e))
        if e not in g._cost_map and e not in set(g.edges):
            raise ValueError(f"cannot drop {tuple((int(i), int(j)))}: not an "
                             f"edge of the graph")
        norm.add(e)
    keep = [(e, c) for e, c in zip(g.edges, g.costs) if e not in norm]
    return Graph(g.n, tuple(e for e, _ in keep),
                 edge_costs=(None if g.edge_costs is None
                             else tuple(c for _, c in keep)),
                 directed=g.directed)


def induced_subgraph(g: Graph, keep_nodes) -> Tuple[Graph, np.ndarray]:
    """Subgraph induced on ``keep_nodes`` with compact relabeling.

    Returns ``(sub, index)`` where ``index`` lists the kept original node
    ids in ascending order and ``sub``'s node ``r`` is original node
    ``index[r]``. Edges touching a removed node are dropped (their costs
    ride along). Used to reason about the surviving topology once churned
    nodes are declared permanently dead."""
    index = np.asarray(sorted({int(v) for v in keep_nodes}), np.int64)
    if index.size == 0:
        raise ValueError("induced_subgraph needs at least one kept node")
    if index[0] < 0 or index[-1] >= g.n:
        raise ValueError(f"keep_nodes out of range for n={g.n}")
    relabel = {int(v): r for r, v in enumerate(index)}
    keep = [((relabel[i], relabel[j]), c)
            for (i, j), c in zip(g.edges, g.costs)
            if i in relabel and j in relabel]
    return Graph(len(index), tuple(e for e, _ in keep),
                 edge_costs=(None if g.edge_costs is None
                             else tuple(c for _, c in keep)),
                 directed=g.directed), index
