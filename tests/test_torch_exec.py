"""The port's topology execution engine against the JAX package's
(``repro.core.message_passing`` and the ``engine="exec"`` paths of
``repro.core.distributed``): every case of ``tests/test_topology_exec.py``,
on the same 9-node generators and the same seeded sites, run through both
packages on the CPU.

The primitives get the same payloads in both packages, so their relayed
tables are held equal to the reference's exactly, and every field of their
``ExecResult`` but the wall time too. End to end, ``engine="exec"`` is held
bit for bit to the port's own ``engine="sim"`` (centres, coreset, every
node's copy), its measured ledger exactly to the analytic one and to the
reference's, its allocations and round profiles exactly to the
reference's, and its centres to the reference's within the pipeline
tests' 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdistributed
from repro.core import message_passing as jmp
from repro.core import topology as jtopology
from repro.core.partition import pad_partition, partition_indices
from repro_torch.core import comm, distributed, message_passing as mp
from repro_torch.core import prng, topology
from repro_torch.core.coreset import Coreset

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

KEY = prng.PRNGKey(0)
JKEY = jax.random.PRNGKey(0)

# every generator, all on 9 nodes (wan is the heterogeneous-link one:
# integer 1.0 / 16.0 costs); each builds the port's graph from `topology`
# and the reference's from `jtopology`
TOPOLOGIES = {
    "ring": lambda m: m.ring(9),
    "star": lambda m: m.star(9),
    "grid": lambda m: m.grid(3, 3),
    "er": lambda m: m.erdos_renyi(9, 0.3, seed=3),
    "preferential": lambda m: m.preferential(9, 2, seed=0),
    "wan": lambda m: m.wan_clusters(3, 3, cross_links=2, seed=0),
}

LEDGER_UNITS = ("scalars", "points", "messages", "link_cost")
# end-to-end centres against the reference's, relative to max |centre|
# (tests/test_torch_pipeline.py::test_centers_match_reference)
CENTER_RTOL = 1e-3


def _graphs(name):
    return TOPOLOGIES[name](topology), TOPOLOGIES[name](jtopology)


def _t(x) -> torch.Tensor:
    """A reference array as a tensor (for torch.equal)."""
    return torch.from_numpy(np.array(x))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _same_result(p, j):
    """Every ExecResult field but the wall time equal to the reference's."""
    assert (p.rounds, p.rounds_to_complete, p.per_round_transmissions) == (
        j.rounds, j.rounds_to_complete, j.per_round_transmissions)
    assert p.ledger.as_dict(by_phase=True) == j.ledger.as_dict(by_phase=True)
    assert p.ledger.dim == j.ledger.dim


def _rng_vals(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def site_data():
    rng = np.random.default_rng(0)
    k, d, n_sites = 3, 5, 9
    centers = 3.0 * rng.standard_normal((k, d))
    pts = np.concatenate(
        [centers[i] + 0.2 * rng.standard_normal((150, d)) for i in range(k)]
    ).astype(np.float32)
    idx = partition_indices(pts, n_sites, "weighted", seed=1)
    sp, sm = pad_partition(pts, idx)
    return sp, sm, k


def _both(site_data, fn, graph_pair, t, **kw):
    """``fn`` (``"graph_distributed_kmeans"`` or
    ``"distributed_kmeans_tree"``) in the port (CPU) and in the reference
    on the same sites: (port result, reference result)."""
    sp, sm, k = site_data
    p = getattr(distributed, fn)(KEY, sp, sm, k, t, graph_pair[0],
                                 device="cpu", **kw)
    j = getattr(jdistributed, fn)(JKEY, jnp.asarray(sp), jnp.asarray(sm), k,
                                  t, graph_pair[1], **kw)
    return p, j


def _assert_centres_near(p, j):
    ref = np.asarray(j)
    err = float(np.abs(p.numpy() - ref).max())
    assert err <= CENTER_RTOL * float(np.abs(ref).max()), err


# -- generators --------------------------------------------------------------

def test_ring_star_shapes():
    r = topology.ring(6)
    assert r.m == 6 and all(len(a) == 2 for a in r.adjacency())
    assert topology.diameter(r) == 3
    s = topology.star(6)
    assert s.m == 5 and topology.diameter(s) == 2
    assert len(s.adjacency()[0]) == 5
    assert (r.edges, s.edges) == (jtopology.ring(6).edges,
                                  jtopology.star(6).edges)
    with pytest.raises(ValueError):
        topology.ring(1)
    with pytest.raises(ValueError):
        topology.star(1)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_new_generators_flood_connected(name):
    g, jg = _graphs(name)
    res, jres = mp.flood(g), jmp.flood(jg)
    assert all(r == set(range(g.n)) for r in res.received)
    assert (res.received, res.rounds, res.transmissions,
            res.per_round_transmissions) == (
        jres.received, jres.rounds, jres.transmissions,
        jres.per_round_transmissions)
    vals = list(np.arange(g.n) * 0.5)
    tables, _ = mp.flood_scalars(g, vals)
    assert tables == jmp.flood_scalars(jg, vals)[0]


# -- flood_exec: delivery, quiescence, measured == analytic ------------------

@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_flood_exec_delivers_and_meters_exactly(name):
    g, jg = _graphs(name)
    vals = _rng_vals(1, (g.n, 3))
    tables, res = mp.flood_exec(g, torch.from_numpy(vals), unit_scalars=1.0)
    jtables, jres = jmp.flood_exec(jg, jnp.asarray(vals), unit_scalars=1.0)
    # every node holds every origin's payload, bit-identical, as in the
    # reference's tables
    assert torch.equal(tables, _t(jtables))
    for v in range(g.n):
        assert torch.equal(_bits(tables[v]), _bits(torch.from_numpy(vals)))
    _same_result(res, jres)
    # quiescence: knowledge complete within diameter rounds
    assert res.rounds_to_complete <= topology.diameter(g)
    assert res.rounds == topology.diameter(g) + 1
    # measured == analytic, exactly (link_cost included: every message
    # crosses every link, priced by the weighted degree sum)
    analytic = comm.flood_cost(g, n_messages=g.n, unit_scalars=1.0)
    assert res.ledger.scalars == analytic.scalars
    assert res.ledger.messages == analytic.messages == 2 * g.m * g.n
    assert res.ledger.link_cost == analytic.link_cost
    if g.is_uniform_cost:
        assert res.ledger.link_cost == res.ledger.bytes
    else:
        assert res.ledger.link_cost > res.ledger.bytes
    assert sum(res.per_round_transmissions) == 2 * g.m * g.n
    # executed profile matches the host simulation round for round
    assert res.per_round_transmissions == mp.flood(g).per_round_transmissions


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_flood_exec_per_origin_units(name):
    g, jg = _graphs(name)
    units = np.arange(g.n, dtype=np.float64)   # origin o ships o points
    _, res = mp.flood_exec(g, torch.zeros((g.n, 1)), unit_points=units,
                           dim=4)
    _, jres = jmp.flood_exec(jg, jnp.zeros((g.n, 1)), unit_points=units,
                             dim=4)
    _same_result(res, jres)
    analytic = comm.flood_cost(g, n_messages=1,
                               unit_points=float(units.sum()), dim=4)
    assert res.ledger.points == analytic.points == 2 * g.m * units.sum()
    assert res.ledger.dim == 4


def test_flood_exec_rejects_wrong_payload_length():
    g = topology.ring(5)
    with pytest.raises(ValueError):
        mp.flood_exec(g, torch.zeros((4, 1)))


def test_gossip_schedule_static_shapes():
    g = topology.star(7)
    sched = mp.GossipSchedule.from_graph(g)
    assert sched.neighbors.shape == (7, 6)       # hub degree pads everyone
    assert sched.neighbor_mask.sum() == 2 * g.m
    assert sched.n_rounds == topology.diameter(g) + 1
    jsched = jmp.GossipSchedule.from_graph(jtopology.star(7))
    for field in ("neighbors", "neighbor_mask", "degrees", "neighbor_costs",
                  "weighted_degrees", "in_neighbors", "in_neighbor_mask"):
        np.testing.assert_array_equal(getattr(sched, field),
                                      getattr(jsched, field))
    assert (sched.n, sched.m, sched.n_rounds) == (jsched.n, jsched.m,
                                                  jsched.n_rounds)


# -- tree primitives ---------------------------------------------------------

def _tree_scheds(name, routing="bfs"):
    g, jg = _graphs(name)
    tree = topology.spanning_tree(g, root=0, routing=routing)
    jtree = jtopology.spanning_tree(jg, root=0, routing=routing)
    return (g, tree, mp.TreeSchedule.from_tree(tree),
            jmp.TreeSchedule.from_tree(jtree))


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_tree_gather_scatter_roundtrip_and_ledger(name):
    g, tree, sched, jsched = _tree_scheds(name)
    for field in ("parent", "depth", "levels", "level_mask", "subtree",
                  "parent_cost"):
        np.testing.assert_array_equal(getattr(sched, field),
                                      getattr(jsched, field))
    vals = _rng_vals(2, (g.n, 2))
    root_table, gres = mp.tree_gather_exec(sched, torch.from_numpy(vals),
                                           unit_scalars=1.0)
    jroot, jgres = jmp.tree_gather_exec(jsched, jnp.asarray(vals),
                                        unit_scalars=1.0)
    assert torch.equal(root_table, torch.from_numpy(vals))
    assert torch.equal(root_table, _t(jroot))
    _same_result(gres, jgres)
    analytic = comm.tree_gather_cost(tree, unit_scalars_per_node=1.0)
    assert gres.ledger.scalars == analytic.scalars == sum(tree.depth)
    assert gres.ledger.messages == analytic.messages
    assert gres.ledger.link_cost == analytic.link_cost \
        == 4.0 * tree.path_costs().sum()

    own, sres = mp.tree_scatter_exec(sched, torch.from_numpy(vals),
                                     unit_scalars=1.0)
    jown, jsres = jmp.tree_scatter_exec(jsched, jnp.asarray(vals),
                                        unit_scalars=1.0)
    assert torch.equal(own, torch.from_numpy(vals))
    assert torch.equal(own, _t(jown))
    _same_result(sres, jsres)
    assert sres.ledger.scalars == analytic.scalars  # path symmetry
    assert sres.ledger.link_cost == analytic.link_cost


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_tree_up_sum_and_broadcast(name):
    g, tree, sched, jsched = _tree_scheds(name)
    vals = _rng_vals(3, (g.n, 2))
    totals, ures = mp.tree_up_sum_exec(sched, torch.from_numpy(vals),
                                       broadcast=True, unit_scalars=1.0)
    jtotals, jures = jmp.tree_up_sum_exec(jsched, jnp.asarray(vals),
                                          broadcast=True, unit_scalars=1.0)
    expect = vals.sum(axis=0)
    for v in range(g.n):
        np.testing.assert_allclose(totals[v].numpy(), expect, rtol=1e-5)
    # the parents add in the reference's order: the same bits
    assert torch.equal(_bits(totals), _bits(_t(jtotals)))
    _same_result(ures, jures)
    # up n-1 sends + broadcast n-1 sends, one scalar-unit each
    assert ures.ledger.scalars == 2.0 * (g.n - 1)
    assert ures.ledger.messages == 2.0 * (g.n - 1)

    payload = _rng_vals(4, (4, 2))
    out, bres = mp.tree_broadcast_exec(sched, torch.from_numpy(payload),
                                       unit_points=4.0, dim=2)
    jout, jbres = jmp.tree_broadcast_exec(jsched, jnp.asarray(payload),
                                          unit_points=4.0, dim=2)
    for v in range(g.n):
        assert torch.equal(out[v], torch.from_numpy(payload))
    assert torch.equal(out, _t(jout))
    _same_result(bres, jbres)
    analytic = comm.tree_broadcast_cost(tree, unit_points=4.0, dim=2)
    assert bres.ledger.points == analytic.points == 4.0 * (g.n - 1)
    assert bres.ledger.messages == analytic.messages == g.n - 1
    assert bres.ledger.link_cost == analytic.link_cost \
        == 4.0 * 3.0 * 4.0 * tree.edge_cost_total()


def test_tree_up_sum_exec_twice_identical_bits():
    """The up-sum adds several children into one parent per level; the
    parents add in ascending slot order (no atomic adds), so two runs give
    the same bits, and the reference's scatter-add gives them too. Values
    spread over six decades make the order visible in the last bits."""
    g, _, sched, jsched = _tree_scheds("preferential")
    rng = np.random.default_rng(11)
    vals = (rng.standard_normal((g.n, 5))
            * 10.0 ** rng.uniform(-3, 3, (g.n, 1))).astype(np.float32)
    a, ra = mp.tree_up_sum_exec(sched, torch.from_numpy(vals),
                                broadcast=False)
    b, rb = mp.tree_up_sum_exec(sched, torch.from_numpy(vals),
                                broadcast=False)
    assert torch.equal(_bits(a), _bits(b))
    j, rj = jmp.tree_up_sum_exec(jsched, jnp.asarray(vals), broadcast=False)
    assert torch.equal(_bits(a), _bits(_t(j)))
    _same_result(ra, rj)
    _same_result(rb, rj)


def test_relays_are_bit_copies():
    """Payloads move by indexing only: a -0.0, infinities and a NaN reach
    every node with the origin's bits through the flood, the tree gather,
    scatter and broadcast. (The reference's flood does the same; its tree
    gather adds each payload into a zero row, which returns -0.0 as +0.0,
    equal as a value.)"""
    g, _, sched, jsched = _tree_scheds("grid")
    vals = _rng_vals(5, (g.n, 3))
    vals[0, 0] = vals[2, 1] = -0.0
    vals[4, 0], vals[6, 2], vals[8, 0] = np.inf, -np.inf, np.nan
    payload = torch.from_numpy(vals)
    tables, _ = mp.flood_exec(g, payload)
    jtables, _ = jmp.flood_exec(_graphs("grid")[1], jnp.asarray(vals))
    assert torch.equal(_bits(tables), _bits(_t(jtables)))
    for v in range(g.n):
        assert torch.equal(_bits(tables[v]), _bits(payload))
    root, _ = mp.tree_gather_exec(sched, payload)
    assert torch.equal(_bits(root), _bits(payload))
    jroot = _t(jmp.tree_gather_exec(jsched, jnp.asarray(vals))[0])
    assert torch.equal(root.nan_to_num(), jroot.nan_to_num())
    own, _ = mp.tree_scatter_exec(sched, payload)
    assert torch.equal(_bits(own), _bits(payload))
    out, _ = mp.tree_broadcast_exec(sched, payload[4])
    for v in range(g.n):
        assert torch.equal(_bits(out[v]), _bits(payload[4]))


# -- Algorithm 2: engine == simulation, measured == analytic -----------------

def _assert_node_tables_match_reference(det, jdet):
    """Every node's assembled instance against the reference's: the same
    sampled points bit for bit, the same empty slots, the allocations and
    round profiles exactly, and the weights within the end-to-end 1e-3 of
    max |w| (they rest on Round 1's centres, which the packages round
    differently, and the centre weights W(P_b) - sum w_q cancel)."""
    assert torch.equal(det.node_points, _t(jdet.node_points))
    jw = np.asarray(jdet.node_weights)
    np.testing.assert_array_equal(det.node_weights.numpy() == 0, jw == 0)
    np.testing.assert_allclose(det.node_weights.numpy(), jw, rtol=0,
                               atol=CENTER_RTOL * np.abs(jw).max())
    assert torch.equal(det.node_alloc, _t(jdet.node_alloc))
    assert det.rounds.keys() == jdet.rounds.keys()
    for phase in det.rounds:
        _same_result(det.rounds[phase], jdet.rounds[phase])


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_graph_engine_matches_simulation(site_data, name):
    sp, sm, k = site_data
    g, jg = _graphs(name)
    t = 90
    sim = distributed.graph_distributed_kmeans(KEY, sp, sm, k, t, g,
                                               device="cpu")
    ex, jex = _both(site_data, "graph_distributed_kmeans", (g, jg), t,
                    engine="exec")
    # bit-identical centers and coreset
    assert torch.equal(sim.centers, ex.centers)
    assert torch.equal(sim.coreset.points, ex.coreset.points)
    assert torch.equal(sim.coreset.weights, ex.coreset.weights)
    # measured ledger == analytic ledger, exactly (all axes incl. link_cost)
    for unit in LEDGER_UNITS:
        assert getattr(ex.ledger, unit) == getattr(sim.ledger, unit), unit
    assert (ex.ledger.as_dict(by_phase=True)
            == jex.ledger.as_dict(by_phase=True))
    # every node assembled the identical global instance and allocation
    det = ex.exec_detail
    for v in range(g.n):
        assert torch.equal(det.node_points[v], det.node_points[0])
        assert torch.equal(det.node_weights[v], det.node_weights[0])
        assert torch.equal(det.node_alloc[v], det.node_alloc[0])
        assert torch.equal(det.node_totals[v], det.node_totals[0])
    assert int(det.node_alloc[0].sum()) == t
    # node_points are views of the relayed table, not copies
    assert det.node_points._base is not None
    _assert_node_tables_match_reference(det, jex.exec_detail)
    _assert_centres_near(ex.centers, jex.centers)


def test_graph_engine_every_node_solves_identically(site_data):
    """Every node, solving its own received copy, produces the same centers
    the engine reports."""
    sp, sm, k = site_data
    g, _ = _graphs("er")
    ex = distributed.graph_distributed_kmeans(KEY, sp, sm, k, 90, g,
                                              engine="exec", device="cpu")
    _, k2 = prng.split(KEY)
    det = ex.exec_detail
    for v in range(g.n):
        cs_v = Coreset(det.node_points[v].contiguous(),
                       det.node_weights[v].contiguous())
        centers_v = distributed._solve_on_coreset(k2, cs_v, k, "kmeans", 8)
        assert torch.equal(centers_v, ex.centers)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_tree_engine_matches_simulation(site_data, name):
    sp, sm, k = site_data
    g, jg = _graphs(name)
    trees = (topology.bfs_spanning_tree(g, root=0),
             jtopology.bfs_spanning_tree(jg, root=0))
    t = 90
    sim = distributed.distributed_kmeans_tree(KEY, sp, sm, k, t, trees[0],
                                              device="cpu")
    ex, jex = _both(site_data, "distributed_kmeans_tree", trees, t,
                    engine="exec")
    assert torch.equal(sim.centers, ex.centers)
    assert torch.equal(sim.coreset.points, ex.coreset.points)
    assert torch.equal(sim.coreset.weights, ex.coreset.weights)
    for unit in LEDGER_UNITS:
        assert getattr(ex.ledger, unit) == getattr(sim.ledger, unit), unit
    assert (ex.ledger.as_dict(by_phase=True)
            == jex.ledger.as_dict(by_phase=True))
    # the broadcast delivered the identical solution to every node
    det, jdet = ex.exec_detail, jex.exec_detail
    for v in range(g.n):
        assert torch.equal(det.node_centers[v], ex.centers)
    assert int(det.node_alloc.sum()) == t
    assert torch.equal(det.node_alloc, _t(jdet.node_alloc))
    assert det.rounds.keys() == jdet.rounds.keys()
    for phase in det.rounds:
        _same_result(det.rounds[phase], jdet.rounds[phase])
    _assert_centres_near(ex.centers, jex.centers)


@pytest.mark.parametrize("objective", ["kmeans", "kmedian"])
def test_engine_both_objectives(site_data, objective):
    sp, sm, k = site_data
    g, jg = _graphs("grid")
    kw = dict(objective=objective, lloyd_iters=4)
    sim = distributed.graph_distributed_kmeans(KEY, sp, sm, k, 60, g,
                                               device="cpu", **kw)
    ex, jex = _both(site_data, "graph_distributed_kmeans", (g, jg), 60,
                    engine="exec", **kw)
    assert torch.equal(sim.centers, ex.centers)
    _assert_centres_near(ex.centers, jex.centers)
    trees = (topology.bfs_spanning_tree(g, root=0),
             jtopology.bfs_spanning_tree(jg, root=0))
    sim_t = distributed.distributed_kmeans_tree(KEY, sp, sm, k, 60, trees[0],
                                                device="cpu", **kw)
    ex_t, jex_t = _both(site_data, "distributed_kmeans_tree", trees, 60,
                        engine="exec", **kw)
    assert torch.equal(sim_t.centers, ex_t.centers)
    _assert_centres_near(ex_t.centers, jex_t.centers)


@pytest.mark.parametrize("strategy,objective", [
    ("cohen_addad", "kmeans"), ("mapreduce", "kmeans"),
    ("algorithm1", "kmeans_trimmed(0.05)"), ("algorithm1", "power(3)")])
def test_engine_every_strategy_and_objective(site_data, strategy,
                                             objective):
    """The strategy and objective hooks run unchanged under the engine: the
    flood route (for mapreduce, which has no exchange round, the BFS tree
    it reroutes to) is bit-identical to sim and its measured ledger equals
    the reference's. The allocations equal the reference's, but for
    cohen_addad's within one sample (its site totals sit near integers, so
    a last bit of Round 1 moves a floor or a remainder award; ROADMAP
    C)."""
    sp, sm, k = site_data
    g, jg = _graphs("grid")
    kw = dict(strategy=strategy, objective=objective, lloyd_iters=4)
    sim = distributed.graph_distributed_kmeans(KEY, sp, sm, k, 60, g,
                                               device="cpu", **kw)
    ex, jex = _both(site_data, "graph_distributed_kmeans", (g, jg), 60,
                    engine="exec", **kw)
    assert torch.equal(sim.centers, ex.centers)
    assert torch.equal(sim.coreset.weights, ex.coreset.weights)
    assert (ex.ledger.as_dict(by_phase=True)
            == sim.ledger.as_dict(by_phase=True)
            == jex.ledger.as_dict(by_phase=True))
    alloc, jalloc = ex.exec_detail.node_alloc, _t(jex.exec_detail.node_alloc)
    assert int(alloc.sum()) == int(jalloc.sum())
    assert int((alloc - jalloc).abs().max()) <= (
        1 if strategy == "cohen_addad" else 0)


def test_unknown_engine_raises(site_data):
    sp, sm, k = site_data
    g, _ = _graphs("ring")
    with pytest.raises(ValueError):
        distributed.graph_distributed_kmeans(KEY, sp, sm, k, 30, g,
                                             engine="warp", device="cpu")
    with pytest.raises(ValueError):
        distributed.distributed_kmeans_tree(
            KEY, sp, sm, k, 30, topology.bfs_spanning_tree(g),
            engine="warp", device="cpu")


# -- heterogeneous links: weighted ledgers and min-cost routing ---------------

def _cost_fn(i, j):
    return 0.3 + 0.7 / (1 + i + j)


def test_tree_exec_weighted_ledgers_exact_on_noninteger_costs():
    """Tree gather/scatter/broadcast pricing is structurally identical to
    the analytic path-cost summation, so measured == analytic bit-for-bit
    even for arbitrary float costs (floods only guarantee that for
    integer-valued costs; DESIGN.md Sec. 12)."""
    g = topology.heterogeneous(topology.grid(3, 3), _cost_fn)
    jg = jtopology.heterogeneous(jtopology.grid(3, 3), _cost_fn)
    tree = topology.mst_spanning_tree(g)
    sched = mp.TreeSchedule.from_tree(tree)
    jsched = jmp.TreeSchedule.from_tree(jtopology.mst_spanning_tree(jg))
    vals = _rng_vals(7, (g.n, 2))
    units = np.arange(1.0, g.n + 1.0)
    _, gres = mp.tree_gather_exec(sched, torch.from_numpy(vals),
                                  unit_points=units, dim=2)
    analytic = comm.tree_gather_cost(tree, unit_points_per_node=units, dim=2)
    assert gres.ledger.link_cost == analytic.link_cost
    _same_result(gres, jmp.tree_gather_exec(jsched, jnp.asarray(vals),
                                            unit_points=units, dim=2)[1])
    _, sres = mp.tree_scatter_exec(sched, torch.from_numpy(vals),
                                   unit_points=units, dim=2)
    assert sres.ledger.link_cost == analytic.link_cost
    _same_result(sres, jmp.tree_scatter_exec(jsched, jnp.asarray(vals),
                                             unit_points=units, dim=2)[1])
    _, bres = mp.tree_broadcast_exec(sched, torch.from_numpy(vals[0]),
                                     unit_points=2.0, dim=2)
    assert bres.ledger.link_cost == \
        comm.tree_broadcast_cost(tree, unit_points=2.0, dim=2).link_cost
    _same_result(bres, jmp.tree_broadcast_exec(jsched, jnp.asarray(vals[0]),
                                               unit_points=2.0, dim=2)[1])


def test_flood_exec_weighted_per_origin_units():
    g, jg = _graphs("wan")
    units = np.arange(g.n, dtype=np.float64)
    _, res = mp.flood_exec(g, torch.zeros((g.n, 1)), unit_points=units,
                           dim=4)
    w = float(g.weighted_degrees().sum())
    # every message crosses every link: per-origin weighted price w * unit
    assert res.ledger.link_cost == 4.0 * 5.0 * w * units.sum()
    _same_result(res, jmp.flood_exec(jg, jnp.zeros((g.n, 1)),
                                     unit_points=units, dim=4)[1])


@pytest.mark.parametrize("engine", ["sim", "exec"])
def test_min_cost_routing_beats_bfs_on_wan(site_data, engine):
    """On wan_clusters, routing="min_cost" strictly lowers the cost-weighted
    bytes vs routing="bfs", with identical centers, and the measured exec
    ledger equals the analytic min-cost ledger exactly."""
    sp, sm, k = site_data
    wan = dict(cross_cost=16.0, cross_links=2, seed=0)
    g = topology.wan_clusters(3, 3, **wan)
    jg = jtopology.wan_clusters(3, 3, **wan)
    t = 90
    res = {}
    for r in ("bfs", "min_cost"):
        res[r], jres = _both(site_data, "graph_distributed_kmeans", (g, jg),
                             t, routing=r, engine=engine)
        assert (res[r].ledger.as_dict(by_phase=True)
                == jres.ledger.as_dict(by_phase=True))
    assert res["min_cost"].ledger.link_cost < res["bfs"].ledger.link_cost
    assert torch.equal(res["bfs"].centers, res["min_cost"].centers)
    if engine == "exec":
        for routing in ("bfs", "min_cost"):
            sim = distributed.graph_distributed_kmeans(
                KEY, sp, sm, k, t, g, routing=routing, device="cpu")
            assert torch.equal(sim.centers, res[routing].centers)
            for unit in LEDGER_UNITS:
                assert getattr(res[routing].ledger, unit) == \
                    getattr(sim.ledger, unit), (routing, unit)
    # the min-cost tree holds exactly n_racks - 1 cross links; BFS enters
    # remote racks through every shallow cross link it finds
    mst = topology.mst_spanning_tree(g)
    bfs = topology.bfs_spanning_tree(g)
    assert mst.edge_cost_total() < bfs.edge_cost_total()


def test_routing_knob_uniform_costs_match_bfs_exactly(site_data):
    """On a uniform-cost graph min-cost routing is the BFS tree, so the two
    routings produce bit-identical ledgers, on both engines."""
    sp, sm, k = site_data
    g, _ = _graphs("er")
    for engine in ("sim", "exec"):
        a = distributed.graph_distributed_kmeans(
            KEY, sp, sm, k, 90, g, routing="bfs", engine=engine,
            device="cpu")
        b = distributed.graph_distributed_kmeans(
            KEY, sp, sm, k, 90, g, routing="min_cost", engine=engine,
            device="cpu")
        assert a.ledger.as_dict() == b.ledger.as_dict()
        assert a.ledger.link_cost == a.ledger.bytes
        assert torch.equal(a.centers, b.centers)


def test_routing_matches_explicit_tree_protocol(site_data):
    """The routing knob is sugar for the tree protocol on a spanning tree
    of the graph: same centers, same ledger, on both engines."""
    sp, sm, k = site_data
    g, _ = _graphs("wan")
    tree = topology.mst_spanning_tree(g)
    for engine in ("sim", "exec"):
        via_knob = distributed.graph_distributed_kmeans(
            KEY, sp, sm, k, 90, g, routing="min_cost", engine=engine,
            device="cpu")
        direct = distributed.distributed_kmeans_tree(
            KEY, sp, sm, k, 90, tree, engine=engine, device="cpu")
        assert via_knob.ledger.as_dict() == direct.ledger.as_dict()
        assert torch.equal(via_knob.centers, direct.centers)


def test_unknown_routing_raises(site_data):
    sp, sm, k = site_data
    with pytest.raises(ValueError, match="unknown routing"):
        distributed.graph_distributed_kmeans(
            KEY, sp, sm, k, 30, _graphs("ring")[0], routing="warp",
            engine="exec", device="cpu")


def test_ledger_phase_breakdown_carries_link_cost(site_data):
    """Phase dicts expose the link_cost axis: every phase of an exec tree
    run prices its own transmissions (round1 scalars cheap, round2 points
    dominant), and phases decompose the total exactly."""
    ex, jex = _both(site_data, "graph_distributed_kmeans", _graphs("wan"),
                    90, routing="min_cost", engine="exec")
    d = ex.ledger.as_dict(by_phase=True)
    assert d == jex.ledger.as_dict(by_phase=True)
    assert set(d["phases"]) == {"round1", "round2_gather",
                                "round2_broadcast"}
    for sub in d["phases"].values():
        assert "link_cost" in sub
    assert sum(p["link_cost"] for p in d["phases"].values()) \
        == pytest.approx(d["link_cost"])
    assert sum(p["points"] for p in d["phases"].values()) == d["points"]


def test_flood_exec_directed_follows_link_directions():
    """On a directed graph the executed flood must move payloads along
    out-links (receive = in-neighbor gather), not the transpose graph: on
    this asymmetric strongly-connected digraph the transpose has a
    different per-round profile, so profile equality with the host
    simulation catches any direction flip."""
    edges = ((0, 1), (1, 2), (1, 3), (2, 0), (3, 2))
    g = topology.Graph(4, edges, directed=True)
    jg = jtopology.Graph(4, edges, directed=True)
    vals = _rng_vals(5, (g.n, 2))
    tables, res = mp.flood_exec(g, torch.from_numpy(vals), unit_scalars=1.0)
    jtables, jres = jmp.flood_exec(jg, jnp.asarray(vals), unit_scalars=1.0)
    for v in range(g.n):
        assert torch.equal(tables[v], torch.from_numpy(vals))
    assert torch.equal(tables, _t(jtables))
    _same_result(res, jres)
    assert res.per_round_transmissions == mp.flood(g).per_round_transmissions
    analytic = comm.flood_cost(g, n_messages=g.n, unit_scalars=1.0)
    # directed: each message crosses each one-way link once => m per message
    assert res.ledger.messages == analytic.messages == g.m * g.n
    assert res.ledger.scalars == analytic.scalars
    assert res.ledger.link_cost == analytic.link_cost
    assert res.rounds_to_complete <= topology.diameter(g)


def test_tree_schedule_from_graph_routing():
    """TreeSchedule.from_graph compiles the routed spanning tree directly:
    identical schedule state to from_tree(spanning_tree(...)) and to the
    reference's."""
    g = topology.wan_clusters(2, 3, cross_links=2, seed=1)
    jg = jtopology.wan_clusters(2, 3, cross_links=2, seed=1)
    for routing in ("bfs", "min_cost"):
        direct = mp.TreeSchedule.from_graph(g, root=0, routing=routing)
        via_tree = mp.TreeSchedule.from_tree(
            topology.spanning_tree(g, root=0, routing=routing))
        jdirect = jmp.TreeSchedule.from_graph(jg, root=0, routing=routing)
        for field in ("parent", "parent_cost", "levels"):
            np.testing.assert_array_equal(getattr(direct, field),
                                          getattr(via_tree, field))
            np.testing.assert_array_equal(getattr(direct, field),
                                          getattr(jdirect, field))


def test_directed_ring_relay_regression():
    """One-way ring: every node has exactly one out-slot and one in-edge;
    payloads travel n-1 hops *with* the arrows (this pins the degenerate
    max_deg == 1 layout)."""
    n = 6
    edges = tuple((i, (i + 1) % n) for i in range(n))
    g = topology.Graph(n, edges, directed=True)
    jg = jtopology.Graph(n, edges, directed=True)
    sched = mp.GossipSchedule.from_graph(g)
    assert sched.neighbors.shape == (n, 1) and sched.n_rounds >= n - 1
    np.testing.assert_array_equal(np.asarray(sched.in_neighbors)[:, 0],
                                  np.arange(-1, n - 1) % n)
    vals = torch.arange(n, dtype=torch.float32)[:, None] * 3.0 + 1.0
    tables, res = mp.flood_exec(g, vals, unit_scalars=1.0)
    for v in range(n):
        assert torch.equal(tables[v], vals)
    _same_result(res, jmp.flood_exec(jg, jnp.asarray(vals.numpy()),
                                     unit_scalars=1.0)[1])
    sim = mp.flood(g)
    m = min(len(res.per_round_transmissions),
            len(sim.per_round_transmissions))
    assert res.per_round_transmissions[:m] == \
        sim.per_round_transmissions[:m]
    assert res.rounds_to_complete == topology.diameter(g) == n - 1


def test_schedule_factories_cache_by_graph_value():
    """gossip_schedule / tree_schedule are lru-cached on the (hashable)
    Graph value: structurally equal graphs share one compiled schedule,
    different routings do not."""
    g1 = topology.wan_clusters(2, 3, cross_links=2, seed=1)
    g2 = topology.Graph(g1.n, g1.edges, edge_costs=g1.edge_costs,
                        directed=g1.directed)
    assert g1 == g2 and hash(g1) == hash(g2)
    assert mp.gossip_schedule(g1) is mp.gossip_schedule(g2)
    assert mp.tree_schedule(g1, root=0) is mp.tree_schedule(g2, root=0)
    assert mp.tree_schedule(g1, root=0, routing="bfs") is not \
        mp.tree_schedule(g1, root=0, routing="min_cost")
    d = topology.Graph(3, ((0, 1), (1, 2), (2, 0)), directed=True)
    assert mp.gossip_schedule(d) is mp.gossip_schedule(
        topology.Graph(3, ((0, 1), (1, 2), (2, 0)), directed=True))
