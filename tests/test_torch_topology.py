"""The port's topology module against the JAX package's: every generator at
several sizes and seeds, spanning trees under both routings, distances,
diameters, the cut-graph helpers and their errors, and the communication
ledgers on min-cost trees -- all exactly equal (numpy on both sides)."""
import numpy as np
import pytest

from repro.core import comm as jcomm
from repro.core import topology as jtopology
from repro_torch.core import comm, topology


def _vertical(i, j):
    return 8.0 if j - i > 1 else 1.0


def _by_sum(i, j):
    return float((i + j) % 5) + 0.5


GENERATORS = {
    "ring(2)": lambda m: m.ring(2),
    "ring(5)": lambda m: m.ring(5),
    "ring(17)": lambda m: m.ring(17),
    "star(2)": lambda m: m.star(2),
    "star(6)": lambda m: m.star(6),
    "star(30)": lambda m: m.star(30),
    "torus(1, 5)": lambda m: m.torus(1, 5),
    "torus(2, 2)": lambda m: m.torus(2, 2),
    "torus(3, 4)": lambda m: m.torus(3, 4),
    "torus(5, 5)": lambda m: m.torus(5, 5),
    "preferential(10, 2, 0)": lambda m: m.preferential(10, 2, seed=0),
    "preferential(25, 2, 1)": lambda m: m.preferential(25, 2, seed=1),
    "preferential(50, 3, 2)": lambda m: m.preferential(50, 3, seed=2),
    "preferential(100, 2, 0)": lambda m: m.preferential(100, 2, seed=0),
    "wan_clusters(1, 4)": lambda m: m.wan_clusters(1, 4),
    "wan_clusters(3, 4)": lambda m: m.wan_clusters(3, 4),
    "wan_clusters(10, 10)": lambda m: m.wan_clusters(10, 10),
    "wan_clusters(4, 5, x3, seed 2)": lambda m: m.wan_clusters(
        4, 5, intra_cost=2.0, cross_cost=9.0, cross_links=3, seed=2),
    "wan_clusters(6, 2, x4, seed 5)": lambda m: m.wan_clusters(
        6, 2, cross_links=4, seed=5),
    "heterogeneous(grid(4, 4))": lambda m: m.heterogeneous(m.grid(4, 4),
                                                           _vertical),
    "heterogeneous(ring(9))": lambda m: m.heterogeneous(m.ring(9), _by_sum),
    "heterogeneous(preferential(30))": lambda m: m.heterogeneous(
        m.preferential(30, 2, seed=3), _by_sum),
    "grid(10, 10)": lambda m: m.grid(10, 10),
    "erdos_renyi(25, 0.3, 2)": lambda m: m.erdos_renyi(25, 0.3, seed=2),
}


def _assert_graphs_equal(p, j):
    assert (p.n, p.edges, p.edge_costs, p.directed, p.m) == (
        j.n, j.edges, j.edge_costs, j.directed, j.m)
    assert p.costs == j.costs and p.is_uniform_cost == j.is_uniform_cost
    assert p.adjacency() == j.adjacency()
    assert p.adjacency_costs() == j.adjacency_costs()
    np.testing.assert_array_equal(p.degrees(), j.degrees())
    np.testing.assert_array_equal(p.weighted_degrees(), j.weighted_degrees())
    np.testing.assert_array_equal(p.distances(), j.distances())
    np.testing.assert_array_equal(topology.all_pairs_distances(p),
                                  jtopology.all_pairs_distances(j))
    for a, b in p.edges:
        assert p.cost_of(a, b) == j.cost_of(a, b)
        if not p.directed:
            assert p.cost_of(b, a) == j.cost_of(b, a)


def _assert_trees_equal(p, j):
    assert (p.n, p.root, p.parent, p.depth, p.parent_cost, p.height) == (
        j.n, j.root, j.parent, j.depth, j.parent_cost, j.height)
    assert p.children() == j.children()
    assert p.bottom_up_order() == j.bottom_up_order()
    np.testing.assert_array_equal(p.parent_costs(), j.parent_costs())
    np.testing.assert_array_equal(p.path_costs(), j.path_costs())
    assert p.edge_cost_total() == j.edge_cost_total()


def _ledgers(m, g, tree, t_i, k=5, d=10):
    """Every analytic ledger of the sim engine on ``g`` and ``tree``."""
    return [m.flood_cost(g, g.n, unit_scalars=1.0),
            m.flood_portions_cost(g, t_i, k, d),
            m.flood_cost(g, g.n, unit_points=float(k + 3), dim=d),
            m.tree_allocation_cost(tree),
            m.tree_up_cost(tree, list(t_i + float(k)), dim=d),
            m.tree_gather_cost(tree, unit_points_per_node=2.0, dim=d),
            m.tree_broadcast_cost(tree, unit_points=float(k), dim=d)]


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_reference(name):
    make = GENERATORS[name]
    p, j = make(topology), make(jtopology)
    _assert_graphs_equal(p, j)
    assert topology.diameter(p) == jtopology.diameter(j)


@pytest.mark.parametrize("routing", ["bfs", "min_cost"])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_spanning_trees_and_their_ledgers_match_reference(name, routing):
    """Both routings at the first and the last node as root: the trees,
    their cost axes and every ledger priced on them are equal exactly."""
    make = GENERATORS[name]
    p, j = make(topology), make(jtopology)
    t_i = np.random.default_rng(p.n).integers(0, 50, p.n)
    for root in sorted({0, p.n - 1}):
        tp = topology.spanning_tree(p, root=root, routing=routing)
        tj = jtopology.spanning_tree(j, root=root, routing=routing)
        _assert_trees_equal(tp, tj)
        for lp, lj in zip(_ledgers(comm, p, tp, t_i),
                          _ledgers(jcomm, j, tj, t_i)):
            assert lp.as_dict(by_phase=True) == lj.as_dict(by_phase=True)


@pytest.mark.parametrize("name", [n for n in sorted(GENERATORS)
                                  if not n.startswith(("wan", "hetero"))])
def test_min_cost_tree_is_the_bfs_tree_on_uniform_costs(name):
    g = GENERATORS[name](topology)
    assert g.is_uniform_cost
    for root in (0, g.n // 2):
        bfs = topology.bfs_spanning_tree(g, root=root)
        mst = topology.mst_spanning_tree(g, root=root)
        assert (mst.parent, mst.depth, mst.parent_cost) == (
            bfs.parent, bfs.depth, bfs.parent_cost)


def test_min_cost_tree_undercuts_bfs_on_wan_clusters():
    """On racks joined by expensive links, the min-cost tree pays for one
    cross link per rack and the BFS tree for more."""
    g = topology.wan_clusters(10, 10)
    bfs = topology.spanning_tree(g, routing="bfs")
    mst = topology.spanning_tree(g, routing="min_cost")
    assert mst.edge_cost_total() == 9 * 16.0 + 90 * 1.0
    assert mst.edge_cost_total() < bfs.edge_cost_total()
    assert (comm.tree_broadcast_cost(mst, unit_points=5.0, dim=3).link_cost
            < comm.tree_broadcast_cost(bfs, unit_points=5.0, dim=3).link_cost)


DROPS = [
    ("ring(5)", [(0, 1)]),
    ("ring(5)", [(4, 0), (2, 3)]),
    ("heterogeneous(grid(4, 4))", [(0, 4), (5, 6), (14, 15)]),
    ("wan_clusters(3, 4)", [(0, 1), (1, 0)]),
    ("star(6)", [(0, 1), (0, 2), (0, 3), (0, 4), (0, 5)]),
]


@pytest.mark.parametrize("name,dropped", DROPS)
def test_drop_edges_matches_reference(name, dropped):
    make = GENERATORS[name]
    p = topology.drop_edges(make(topology), dropped)
    j = jtopology.drop_edges(make(jtopology), dropped)
    _assert_graphs_equal(p, j)
    connected = j.distances().min() >= 0
    if connected:
        assert topology.diameter(p) == jtopology.diameter(j)
    else:
        with pytest.raises(ValueError, match="not connected"):
            topology.diameter(p)


KEEPS = [
    ("torus(3, 4)", [0, 1, 2, 5, 11]),
    ("wan_clusters(3, 4)", range(4, 12)),
    ("heterogeneous(ring(9))", [8, 3, 3, 0, 5]),
    ("preferential(25, 2, 1)", [7]),
]


@pytest.mark.parametrize("name,keep", KEEPS)
def test_induced_subgraph_matches_reference(name, keep):
    make = GENERATORS[name]
    p, ip = topology.induced_subgraph(make(topology), keep)
    j, ij = jtopology.induced_subgraph(make(jtopology), keep)
    np.testing.assert_array_equal(ip, ij)
    _assert_graphs_equal(p, j)


def test_directed_graph_helpers_match_reference():
    edges = ((0, 1), (1, 2), (2, 0), (2, 3))
    p = topology.Graph(4, edges, edge_costs=(1.0, 2.0, 3.0, 4.0),
                       directed=True)
    j = jtopology.Graph(4, edges, edge_costs=(1.0, 2.0, 3.0, 4.0),
                        directed=True)
    _assert_graphs_equal(p, j)
    _assert_graphs_equal(topology.drop_edges(p, [(2, 0)]),
                         jtopology.drop_edges(j, [(2, 0)]))
    with pytest.raises(ValueError, match="not an edge"):
        topology.drop_edges(p, [(1, 0)])
    with pytest.raises(ValueError, match="not strongly connected"):
        topology.diameter(p)
    for routing in ("bfs", "min_cost"):
        with pytest.raises(ValueError, match="undirected"):
            topology.spanning_tree(p, routing=routing)


ERRORS = [
    (lambda m: m.ring(1), "ring needs"),
    (lambda m: m.star(1), "star needs"),
    (lambda m: m.torus(1, 1), "torus needs"),
    (lambda m: m.wan_clusters(0, 4), "n_racks >= 1"),
    (lambda m: m.wan_clusters(3, 3, cross_links=0), "cross_links"),
    (lambda m: m.heterogeneous(m.ring(4), lambda i, j: -1.0),
     "invalid cost"),
    (lambda m: m.drop_edges(m.ring(5), [(0, 2)]), "not an edge"),
    (lambda m: m.induced_subgraph(m.ring(5), []), "at least one"),
    (lambda m: m.induced_subgraph(m.ring(5), [0, 5]), "out of range"),
    (lambda m: m.spanning_tree(m.ring(5), routing="nope"),
     "unknown routing"),
    (lambda m: m.mst_spanning_tree(m.Graph(4, ((0, 1), (2, 3)))),
     "not connected"),
    (lambda m: m.diameter(m.Graph(3, ((0, 1),))), "not connected"),
]


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_errors_match_reference(case):
    make, match = ERRORS[case]
    for module in (jtopology, topology):
        with pytest.raises(ValueError, match=match):
            make(module)
