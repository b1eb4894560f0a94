"""The port's streaming subsystem (``repro_torch.stream``) against the JAX
package's (``repro.stream``): every case of ``tests/test_stream.py`` and
the service cases of ``tests/test_serve_cluster.py`` through both packages
on the same seeded streams, on the CPU.

What is exact: the synthetic streams (bit-equal arrays), tree occupancy and
per-level sizes, union rounds (raw points: the coreset bit for bit), every
round's ledger by phase (its totals depend on t and the topology only),
the service's counters and default keys, and -- within the port --
``engine="exec"`` against ``engine="sim"`` on both transports. What is
not: a reduce draws its samples from masses computed from Round-1 centres
that the two packages round differently, so a few slots land on another
point; those stages are held on their invariants (mass, shape, the
factor-2 bound against the offline pipeline) and on the reference's own
inputs where a stage takes them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import stream as jstream
from repro.core import coreset as jcoreset
from repro.core import topology as jtopology
from repro.data import synthetic as jsynthetic
from repro.serve import ClusterServeEngine as JEngine
from repro_torch.core import backend, clustering, coreset, prng, topology
from repro_torch.data import synthetic
from repro_torch.serve import ClusterServeEngine
from repro_torch.stream import (ClusterQueryService, CoresetTree,
                                DistributedStream, StreamState, TreeConfig)
from repro_torch.wan import FaultPlan

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

KEY = prng.PRNGKey(0)
JKEY = jax.random.PRNGKey(0)
CFG = TreeConfig(k=4, t=60, d=6, batch_size=200, levels=12)
JCFG = jstream.TreeConfig(k=4, t=60, d=6, batch_size=200, levels=12)
UNITS = ("scalars", "points", "messages", "bytes", "link_cost")


def _stream(n_batches, seed=0, batch=CFG.batch_size, d=CFG.d):
    return list(synthetic.drifting_mixture_stream(n_batches, batch, d=d,
                                                  k=4, seed=seed))


def _port_stream(**kw):
    return StreamState(CFG, device="cpu", **kw)


def _ledgers_equal(p, j):
    assert p.as_dict(by_phase=True) == j.as_dict(by_phase=True)


# -- the synthetic streams ----------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(d=10, k=5, drift=0.2, seed=3),
                                dict(batch_size=33, d=2, k=7, seed=9)])
def test_drifting_mixture_stream_bit_equal(kw):
    kw = dict(dict(n_batches=5, batch_size=120), **kw)
    for a, b in zip(synthetic.drifting_mixture_stream(**kw),
                    jsynthetic.drifting_mixture_stream(**kw)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(outlier_frac=0.2, seed=4),
                                dict(burst_every=3, outlier_scale=5.0),
                                dict(outlier_frac=0.0)])
def test_contaminated_stream_bit_equal(kw):
    kw = dict(dict(n_batches=6, batch_size=100, d=5), **kw)
    got = list(synthetic.contaminated_stream(**kw))
    want = list(jsynthetic.contaminated_stream(**kw))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="outlier_frac"):
        next(synthetic.contaminated_stream(1, 10, outlier_frac=1.5))


# -- Coreset.concat / compact / merge -----------------------------------------

def test_concat_preserves_weight_and_order():
    a = coreset.Coreset(points=torch.ones((3, 2)),
                        weights=torch.tensor([1., 0., 2.]))
    b = coreset.Coreset(points=torch.zeros((2, 2)),
                        weights=torch.tensor([-0.5, 3.]))
    u = coreset.Coreset.concat(a, b)
    assert u.size == 5
    np.testing.assert_array_equal(u.weights.numpy(), [1., 0., 2., -0.5, 3.])
    np.testing.assert_allclose(float(u.weights.sum()), 5.5)


def test_compact_moves_valid_slots_front_and_truncates():
    w = [0., 2., 0., 0., 1., 0., 3., 0., 0., 4.]
    cs = coreset.Coreset(points=torch.arange(10.)[:, None],
                         weights=torch.tensor(w))
    jcs = jcoreset.Coreset(points=jnp.arange(10.)[:, None],
                           weights=jnp.asarray(w)).compact(4)
    c = cs.compact(4)
    assert c.size == 4
    np.testing.assert_array_equal(c.weights.numpy(), np.asarray(jcs.weights))
    np.testing.assert_array_equal(c.points.numpy(), np.asarray(jcs.points))


def test_merge_coresets_preserves_total_weight():
    """On the reference's two child coresets: size t + k and the children's
    mass in both packages; the port's merge is its build_coreset on the
    union bit for bit; most slots hold the reference's points (the rest
    are draws that flip with the rounding of the Round-1 centres)."""
    pts = np.random.default_rng(0).standard_normal((500, 6)).astype(
        np.float32)
    a = jcoreset.build_coreset(JKEY, jnp.asarray(pts[:250]), k=4, t=60)
    b = jcoreset.build_coreset(jax.random.PRNGKey(1), jnp.asarray(pts[250:]),
                               k=4, t=60)
    jm = jcoreset.merge_coresets(jax.random.PRNGKey(2), a, b, k=4, t=60)
    pa, pb = (coreset.Coreset(torch.from_numpy(np.array(c.points)),
                              torch.from_numpy(np.array(c.weights)))
              for c in (a, b))
    m = coreset.merge_coresets(prng.PRNGKey(2), pa, pb, 4, 60, device="cpu")
    assert m.size == jm.size == 64
    np.testing.assert_allclose(float(m.weights.double().sum()), 500.0,
                               rtol=1e-4)
    np.testing.assert_allclose(float(jnp.sum(jm.weights)), 500.0, rtol=1e-4)
    u = coreset.Coreset.concat(pa, pb)
    again = coreset.build_coreset(prng.PRNGKey(2), u.points, 4, 60,
                                  weights=u.weights, device="cpu")
    assert torch.equal(m.points, again.points)
    assert torch.equal(m.weights, again.weights)
    same = (m.points.numpy() == np.asarray(jm.points)).all(1).mean()
    assert same >= 0.9, same


# -- tree invariants ------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """13 batches of the drifting stream through both packages' trees,
    with the occupancy after every push."""
    p, j = CoresetTree(CFG, device="cpu"), jstream.CoresetTree(JCFG)
    occ = []
    for b in _stream(13):
        p.push(b)
        j.push(jnp.asarray(b))
        occ.append((p.occupied_levels(), j.occupied_levels()))
    return p, j, occ


def test_tree_binary_counter_occupancy(trees):
    _, _, occ = trees
    for i, (a, b) in enumerate(occ, start=1):
        assert a == b == bin(i).count("1")


def test_tree_log_space_bound(trees):
    """The reference's bounds, its per-level sizes exactly, the mass, and
    the compacted view."""
    p, j, _ = trees
    n = 13 * CFG.batch_size
    max_levels = int(np.floor(np.log2(13))) + 1
    assert p.n_batches == 13 and p.total_weight == j.total_weight == n
    assert p.occupied_levels() <= max_levels
    assert p.max_summary_points() <= CFG.slot * max_levels
    assert int(p.summary().effective_size()) <= CFG.slot * max_levels
    assert p.bucket_sizes() == j.bucket_sizes()
    assert p.size == j.size and p.summary().points.shape == (p.size, CFG.d)
    np.testing.assert_allclose(float(p.summary().weights.double().sum()), n,
                               rtol=1e-4)
    compact = p.compact_summary()
    assert compact.size == p.max_summary_points()
    np.testing.assert_allclose(float(compact.weights.double().sum()), n,
                               rtol=1e-4)


def test_tree_overflow_keeps_memory_bounded():
    cfg = TreeConfig(k=4, t=60, d=6, batch_size=200, levels=2)
    tree = CoresetTree(cfg, device="cpu")
    jtree = jstream.CoresetTree(jstream.TreeConfig(k=4, t=60, d=6,
                                                   batch_size=200, levels=2))
    for b in _stream(9, seed=3):
        tree.push(b)
        jtree.push(jnp.asarray(b))
    assert tree.occupied_levels() == jtree.occupied_levels() <= 2
    assert tree.summary().points.shape == (2 * cfg.slot, cfg.d)
    np.testing.assert_allclose(float(tree.summary().weights.double().sum()),
                               9 * 200, rtol=1e-3)


def test_tree_small_batches_stored_raw_and_errors():
    """Batches no larger than a slot are stored raw (exact, as the
    reference); wrong shapes and zero levels raise; weighted pushes count
    their host mass."""
    cfg = TreeConfig(k=4, t=60, d=6, batch_size=50, levels=4)
    tree = CoresetTree(cfg, device="cpu")
    jtree = jstream.CoresetTree(jstream.TreeConfig(k=4, t=60, d=6,
                                                   batch_size=50, levels=4))
    b = _stream(1, batch=50)[0]
    w = np.linspace(0.5, 2.0, 50).astype(np.float32)
    tree.push(b, weights=w)
    jtree.push(jnp.asarray(b), weights=jnp.asarray(w))
    np.testing.assert_array_equal(tree.summary().points.numpy(),
                                  np.asarray(jtree.summary().points))
    np.testing.assert_array_equal(tree.summary().weights.numpy(),
                                  np.asarray(jtree.summary().weights))
    assert tree.total_weight == jtree.total_weight
    with pytest.raises(ValueError, match="batch shape"):
        tree.push(np.zeros((49, 6), np.float32))
    with pytest.raises(ValueError, match="level"):
        CoresetTree(TreeConfig(k=4, t=60, d=6, batch_size=50, levels=0),
                    device="cpu")


@settings(max_examples=8, deadline=None)
@given(n_batches=st.integers(1, 9), tail=st.integers(0, 199),
       seed=st.integers(0, 2**31 - 1))
def test_property_summary_weight_equals_ingested(n_batches, tail, seed):
    """For any stream length (a partial batch included), the summary's
    mass equals the number of points pushed, and the pending tail and
    total weight are the reference's."""
    stream = _port_stream(key=prng.PRNGKey(seed))
    jstate = jstream.StreamState(JCFG, key=jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal(
        (n_batches * CFG.batch_size + tail, CFG.d)).astype(np.float32)
    for part in (pts[:len(pts) // 2], pts[len(pts) // 2:]):
        stream.push(part)
        jstate.push(part)
    np.testing.assert_allclose(float(stream.summary().weights.double().sum()),
                               len(pts), rtol=1e-4)
    assert stream.pending() == jstate.pending() == tail
    assert stream.total_weight() == jstate.total_weight()
    assert stream.n_pushed == jstate.n_pushed == len(pts)
    assert stream.summary().size == jstate.summary().size


def test_streaming_cost_within_factor_of_offline():
    """In both packages, streaming k-means on the drifting mixture costs
    at most 2x the offline coreset pipeline at equal summary size."""
    batches = _stream(12, seed=7)
    full = np.concatenate(batches)
    ratios = {}
    for name, mod, key, dev in (("port", None, KEY, {"device": "cpu"}),
                                ("jax", jstream, JKEY, {})):
        if mod is None:
            s_state = _port_stream()
            solve, cost = clustering.solve, clustering.cost
            build = coreset.build_coreset
        else:
            from repro.core import clustering as jcl
            s_state = jstream.StreamState(JCFG)
            solve, cost, build = jcl.solve, jcl.cost, jcoreset.build_coreset
        for b in batches:
            s_state.push(b)
        s = s_state.summary()
        c_stream, _ = solve(key, s.points, CFG.k, weights=s.weights,
                            lloyd_iters=10, **dev)
        stream_cost = float(cost(full, c_stream, **dev))
        eff = int(s.effective_size())
        off = build(key, full, k=CFG.k, t=eff - CFG.k, **dev)
        c_off, _ = solve(key, off.points, CFG.k, weights=off.weights,
                         lloyd_iters=10, **dev)
        ratios[name] = stream_cost / float(cost(full, c_off, **dev))
    assert ratios["port"] <= 2.0 and ratios["jax"] <= 2.0, ratios


# -- distributed mode --------------------------------------------------------------

def _both_streams(g, jg, batches, push, **kw):
    """The same pushes into a port and a reference DistributedStream."""
    p = DistributedStream(g, CFG, device="cpu", **kw)
    jkw = {"key": jax.random.PRNGKey(int(kw["key"][1]))} if "key" in kw \
        else {}
    j = jstream.DistributedStream(jg, JCFG, **jkw)
    for site, b in push(batches):
        p.push(site, b)
        j.push(site, b)
    return p, j


def test_distributed_stream_rounds_and_phase_ledger():
    """Two resample rounds: each coreset carries the mass pushed, the
    centres are finite, and the cumulative ledger by phase equals the
    reference's exactly."""
    g, jg = topology.grid(2, 2), jtopology.grid(2, 2)
    p = DistributedStream(g, CFG, device="cpu")
    j = jstream.DistributedStream(jg, JCFG)
    batches = _stream(8, seed=11)
    for r in range(2):
        for i in range(g.n):
            p.push(i, batches[r * g.n + i])
            j.push(i, batches[r * g.n + i])
        res = p.aggregate(k=4, t=120, mode="resample")
        jres = j.aggregate(k=4, t=120, mode="resample")
        np.testing.assert_allclose(float(res.coreset.weights.double().sum()),
                                   p.total_weight(), rtol=1e-4)
        assert res.centers.shape == (4, CFG.d)
        assert bool(torch.isfinite(res.centers).all())
        _ledgers_equal(res.ledger, jres.ledger)
        np.testing.assert_allclose(res.local_costs.numpy(),
                                   np.asarray(jres.local_costs), rtol=0.05)
    d = p.ledger.as_dict(by_phase=True)
    assert set(d["phases"]) == {"stream_round_0", "stream_round_1"}
    assert d["phases"]["stream_round_0"]["scalars"] == 2.0 * g.m * g.n
    _ledgers_equal(p.ledger, j.ledger)


def test_distributed_stream_union_round_is_exact():
    """Tiny summaries: auto mode floods the union, which is the
    reference's coreset bit for bit (raw points), with its ledger and no
    Round-1 scalars."""
    g, jg = topology.grid(2, 2), jtopology.grid(2, 2)
    batches = _stream(4, seed=29)
    p, j = _both_streams(g, jg, batches,
                         lambda bs: [(i, bs[i][:100]) for i in range(4)])
    res = p.aggregate(k=4, t=600)
    jres = j.aggregate(k=4, t=600)
    assert res.local_costs is None and jres.local_costs is None
    np.testing.assert_array_equal(res.coreset.points.numpy(),
                                  np.asarray(jres.coreset.points))
    np.testing.assert_array_equal(res.coreset.weights.numpy(),
                                  np.asarray(jres.coreset.weights))
    d = res.ledger.as_dict(by_phase=True)
    assert d["scalars"] == 0.0
    assert d["phases"]["stream_round_0"]["points"] == 2.0 * g.m * 400
    _ledgers_equal(res.ledger, jres.ledger)
    w = res.coreset.weights.numpy()
    assert set(np.unique(w)) == {0.0, 1.0} and int((w == 1.0).sum()) == 400
    err = float(np.abs(res.centers.numpy() - np.asarray(jres.centers)).max())
    assert err <= 1e-3 * float(np.abs(np.asarray(jres.centers)).max()), err


def test_distributed_stream_uneven_sites():
    g, jg = topology.grid(2, 2), jtopology.grid(2, 2)
    batches = _stream(6, seed=13)
    p, j = _both_streams(g, jg, batches, lambda bs: [(0, b) for b in bs[:5]]
                         + [(1, bs[5][:50])])
    res = p.aggregate(k=4, t=100)
    jres = j.aggregate(k=4, t=100)
    assert bool(torch.isfinite(res.coreset.weights).all())
    np.testing.assert_allclose(float(res.coreset.weights.double().sum()),
                               p.total_weight(), rtol=1e-4)
    assert p.total_weight() == j.total_weight()
    _ledgers_equal(res.ledger, jres.ledger)


def test_distributed_stream_push_and_aggregate_errors():
    """Bad sites, engines, transports, routings and modes raise; so do the
    WAN runtime's rules, with the reference's messages: faults need
    engine='exec'|'async', and an async round needs the flood transport."""
    ds = DistributedStream(topology.grid(2, 2), CFG, device="cpu")
    batch = _stream(1, seed=31)[0]
    for site in (4, -1):
        with pytest.raises(ValueError, match="site index"):
            ds.push(site, batch)
    with pytest.raises(ValueError, match="expected 4 site batches"):
        ds.push_all([batch])
    ds.push(0, batch)
    for kw, match in (({"engine": "warp"}, "engine"),
                      ({"transport": "pigeon"}, "transport"),
                      ({"transport": "tree", "routing": "warp"}, "routing"),
                      ({"mode": "sideways"}, "mode"),
                      ({"engine": "async", "transport": "tree"},
                       "faulty/async rounds support transport='flood' "
                       "only, got 'tree'"),
                      ({"engine": "sim", "faults": FaultPlan(seed=0)},
                       r"faults require engine='exec'\|'async'")):
        with pytest.raises(ValueError, match=match):
            ds.aggregate(k=4, t=60, **kw)
    assert ds.rounds == 0


@pytest.fixture(scope="module")
def grid_streams():
    g, jg = topology.grid(2, 2), jtopology.grid(2, 2)
    batches = _stream(8, seed=37)
    return g, jg, batches


@pytest.mark.parametrize("mode", ["union", "resample"])
def test_distributed_stream_exec_engine_matches_sim(grid_streams, mode):
    """engine="exec" bit-identical to engine="sim" (coreset, centres),
    the measured round ledger equal to the analytic one and to the
    reference's, in the same phase bookkeeping."""
    g, jg, batches = grid_streams
    runs = {}
    for engine in ("sim", "exec"):
        p = _port_pushed(g, batches, 41)
        runs[engine] = (p, p.aggregate(k=4, t=120, mode=mode, engine=engine))
    j = jstream.DistributedStream(jg, JCFG, key=jax.random.PRNGKey(41))
    for i, b in enumerate(batches):
        j.push(i % 4, b)
    jres = j.aggregate(k=4, t=120, mode=mode)
    sim, ex = runs["sim"][1], runs["exec"][1]
    assert torch.equal(sim.coreset.points, ex.coreset.points)
    assert torch.equal(sim.coreset.weights, ex.coreset.weights)
    assert torch.equal(sim.centers, ex.centers)
    _ledgers_equal(ex.ledger, sim.ledger)
    _ledgers_equal(ex.ledger, jres.ledger)
    assert set(runs["exec"][0].ledger.as_dict(by_phase=True)["phases"]) == {
        "stream_round_0"}


def _port_pushed(g, batches, seed):
    p = DistributedStream(g, CFG, key=prng.PRNGKey(seed), device="cpu")
    for i, b in enumerate(batches):
        p.push(i % g.n, b)
    return p


@pytest.mark.parametrize("mode", ["union", "resample"])
@pytest.mark.parametrize("routing", ["bfs", "min_cost"])
def test_distributed_stream_tree_transport_matches_sim(mode, routing):
    """transport="tree" on wan_clusters(2, 2): exec bit-identical to sim
    under both routings, and the measured ledger -- link cost included --
    equal to the analytic one and to the reference's."""
    g = topology.wan_clusters(2, 2, cross_cost=16.0, cross_links=2, seed=3)
    jg = jtopology.wan_clusters(2, 2, cross_cost=16.0, cross_links=2, seed=3)
    batches = _stream(8, seed=53)
    res = {engine: _port_pushed(g, batches, 47).aggregate(
        k=4, t=120, mode=mode, transport="tree", routing=routing,
        engine=engine) for engine in ("sim", "exec")}
    j = jstream.DistributedStream(jg, JCFG, key=jax.random.PRNGKey(47))
    for i, b in enumerate(batches):
        j.push(i % jg.n, b)
    jres = j.aggregate(k=4, t=120, mode=mode, transport="tree",
                       routing=routing)
    assert torch.equal(res["sim"].coreset.points, res["exec"].coreset.points)
    assert torch.equal(res["sim"].coreset.weights,
                       res["exec"].coreset.weights)
    assert torch.equal(res["sim"].centers, res["exec"].centers)
    sim_d, ex_d = res["sim"].ledger.as_dict(), res["exec"].ledger.as_dict()
    for unit in UNITS:
        assert sim_d[unit] == ex_d[unit], (mode, unit, sim_d, ex_d)
    _ledgers_equal(res["exec"].ledger, jres.ledger)


def test_distributed_stream_tree_transport_cheaper_than_flood():
    """On WAN links a tree round is cheaper than the flood in link cost,
    and the min-cost tree cheaper than the BFS tree; each ledger is the
    reference's."""
    g = topology.wan_clusters(2, 3, cross_cost=16.0, cross_links=3, seed=0)
    jg = jtopology.wan_clusters(2, 3, cross_cost=16.0, cross_links=3, seed=0)
    ledgers = {}
    for transport, routing in [("flood", "bfs"), ("tree", "bfs"),
                               ("tree", "min_cost")]:
        p = _port_pushed(g, _stream(8, seed=61), 59)
        res = p.aggregate(k=4, t=120, mode="resample", transport=transport,
                          routing=routing)
        j = jstream.DistributedStream(jg, JCFG, key=jax.random.PRNGKey(59))
        for i, b in enumerate(_stream(8, seed=61)):
            j.push(i % jg.n, b)
        jres = j.aggregate(k=4, t=120, mode="resample", transport=transport,
                           routing=routing)
        _ledgers_equal(res.ledger, jres.ledger)
        ledgers[(transport, routing)] = res.ledger
    assert ledgers[("tree", "bfs")].link_cost \
        < ledgers[("flood", "bfs")].link_cost
    assert ledgers[("tree", "min_cost")].link_cost \
        < ledgers[("tree", "bfs")].link_cost


def test_distributed_stream_mapreduce_takes_the_tree():
    """A single-shuffle strategy never floods: its round runs on the BFS
    tree with no Round-1 traffic, exec equal to sim, the ledger the
    reference's."""
    g, jg = topology.grid(2, 2), jtopology.grid(2, 2)
    batches = _stream(8, seed=67)
    res = {e: _port_pushed(g, batches, 3).aggregate(
        k=4, t=120, mode="resample", engine=e, strategy="mapreduce")
        for e in ("sim", "exec")}
    j = jstream.DistributedStream(jg, JCFG, key=jax.random.PRNGKey(3))
    for i, b in enumerate(batches):
        j.push(i % 4, b)
    jres = j.aggregate(k=4, t=120, mode="resample", strategy="mapreduce")
    assert torch.equal(res["sim"].centers, res["exec"].centers)
    assert res["sim"].ledger.scalars == 0.0
    _ledgers_equal(res["exec"].ledger, jres.ledger)


# -- the query service -------------------------------------------------------

def _service(seed, n_batches=1, **kw):
    """A service on a stream fed the same batches as the reference test
    helpers (tests/test_serve_cluster.py's _stream_service)."""
    s = StreamState(CFG, key=prng.PRNGKey(seed), device="cpu")
    for b in _stream(n_batches, seed=seed):
        s.push(b)
    return ClusterQueryService(s, k=4, **kw)


def test_service_query_matches_direct_argmin():
    stream = _port_stream()
    for b in _stream(4, seed=17):
        stream.push(b)
    svc = ClusterQueryService(stream, k=4, staleness_frac=None,
                              backend="torch")
    q = _stream(1, seed=18)[0][:73]
    assign, dist = svc.query(q)
    assert assign.shape == (73,) and dist.shape == (73,)
    assert assign.dtype == torch.int32
    a, d2 = backend.query_assignments(q, svc.centers(), backend="torch",
                                      device="cpu")
    assert torch.equal(assign, a)
    np.testing.assert_allclose(dist.numpy(), d2.numpy(), rtol=1e-5)


def test_service_staleness_refresh_policy():
    """The reference's traffic, counter for counter in both packages."""
    stats = []
    for svc, push in ((lambda s: ClusterQueryService(s, k=4,
                                                     staleness_frac=0.5),
                       _port_stream()),
                      (lambda s: jstream.ClusterQueryService(
                          s, k=4, staleness_frac=0.5),
                       jstream.StreamState(JCFG))):
        stream = push
        stream.push(_stream(1, seed=19)[0])
        s = svc(stream)
        q = np.zeros((5, CFG.d), np.float32)
        seen = []
        s.query(q)
        seen.append(s.stats.n_refreshes)
        s.query(q)
        seen.append(s.stats.n_refreshes)
        s.push(_stream(1, seed=20)[0][:50])
        s.query(q)
        seen.append(s.stats.n_refreshes)
        for b in _stream(2, seed=21):
            s.push(b)
        s.query(q)
        seen.append(s.stats.n_refreshes)
        seen += [s.stats.n_batches, s.stats.n_queries,
                 s.stats.n_padded_queries, s.staleness()]
        stats.append(seen)
    assert stats[0] == stats[1] == [1, 1, 1, 2, 4, 20, 12, 0.0]


def test_service_query_load_histogram():
    svc = _service(23, backend="torch")
    q = _stream(1, seed=24)[0]
    load = svc.query_load(q)
    assert load.shape == (4,)
    np.testing.assert_allclose(float(load.sum()), len(q), rtol=1e-5)
    am, _ = backend.query_assignments(q, svc.centers(), device="cpu")
    np.testing.assert_array_equal(load.numpy(),
                                  np.bincount(am.numpy(), minlength=4))


@pytest.mark.parametrize("backend_name", ["torch", "torch_chunked"])
def test_service_empty_and_single_query_batches(backend_name):
    svc = _service(27, staleness_frac=None, backend=backend_name)
    a, dist = svc.query(np.zeros((0, CFG.d), np.float32))
    assert a.shape == (0,) and dist.shape == (0,)
    a, dist = svc.query([])
    assert a.shape == (0,) and dist.shape == (0,) and a.dtype == torch.int32
    assert svc.stats.n_refreshes == 0
    np.testing.assert_array_equal(
        svc.query_load(np.zeros((0, CFG.d), np.float32)).numpy(),
        np.zeros((4,), np.float32))
    a, dist = svc.query(np.zeros((CFG.d,), np.float32))
    assert a.shape == (1,) and dist.shape == (1,)
    for bad in (np.zeros((3, CFG.d + 1), np.float32),
                np.zeros((3, 0), np.float32),
                np.zeros((0, CFG.d + 5), np.float32)):
        with pytest.raises(ValueError, match="query points"):
            svc.query(bad)
    load = svc.query_load(np.zeros((3, CFG.d), np.float32),
                          weights=np.asarray([1., 2., 3.], np.float32))
    np.testing.assert_allclose(float(load.sum()), 6.0, rtol=1e-6)


def test_service_default_seeds_are_the_references():
    """Default keys fold the tenant id into PRNGKey(0), bit-equal to the
    reference's fold_in; two services differ, an explicit tenant id pins
    the key, an explicit key wins."""
    s1, s2 = _port_stream(), _port_stream()
    svc1 = ClusterQueryService(s1, k=4, staleness_frac=None)
    svc2 = ClusterQueryService(s2, k=4, staleness_frac=None)
    assert svc1.tenant_id != svc2.tenant_id
    for svc in (svc1, svc2):
        want = jax.random.fold_in(jax.random.PRNGKey(0), svc.tenant_id)
        np.testing.assert_array_equal(svc._key.numpy(),
                                      np.asarray(want).astype(np.int64))
    assert not torch.equal(svc1._key, svc2._key)
    assert not torch.equal(prng.split(svc1._key)[1],
                           prng.split(svc2._key)[1])
    svc3 = ClusterQueryService(s1, k=4, tenant_id=svc1.tenant_id)
    assert torch.equal(svc1._key, svc3._key)
    svc4 = ClusterQueryService(s1, k=4, key=prng.PRNGKey(7))
    assert torch.equal(svc4._key, prng.PRNGKey(7))


@pytest.mark.parametrize("backend_name", ["torch_chunked", "cuda"])
def test_service_backend_parity(backend_name):
    """Assignments agree across backends (on the CPU the cuda backend runs
    the kernels' plain versions)."""
    svc = _service(25, staleness_frac=None, backend="torch")
    centers = svc.refresh()
    q = _stream(1, seed=26)[0][:64]
    a_ref, d_ref = backend.query_assignments(q, centers, backend="torch",
                                             device="cpu")
    a, d = backend.query_assignments(q, centers, backend=backend_name,
                                     device="cpu")
    assert torch.equal(a, a_ref)
    np.testing.assert_allclose(d.numpy(), d_ref.numpy(), rtol=1e-5)


def test_engine_refresh_budget_amortizes_across_tenants():
    """Two services on one engine with refresh_budget=1, replayed on the
    reference's engine: the same refreshes, deferrals and tickets step
    by step."""
    seen = []
    for pkg in ("port", "jax"):
        if pkg == "port":
            eng = ClusterServeEngine(backend="torch", refresh_budget=1,
                                     device="cpu")
            mk = lambda sd, tid: _service(sd, staleness_frac=0.0,
                                          tenant_id=tid, engine=eng,
                                          backend="torch")
        else:
            eng = JEngine(backend="jnp", refresh_budget=1)

            def mk(sd, tid):
                s = jstream.StreamState(JCFG, key=jax.random.PRNGKey(sd))
                s.push(_stream(1, seed=sd)[0])
                return jstream.ClusterQueryService(
                    s, k=4, staleness_frac=0.0, tenant_id=tid, engine=eng,
                    backend="jnp")
        s1, s2 = mk(1, 101), mk(2, 102)
        t1 = eng.add_tenant(s1, k=4, d=CFG.d, tenant_id=101)
        t2 = eng.add_tenant(s2, k=4, d=CFG.d, tenant_id=102)
        q = np.zeros((5, CFG.d), np.float32)
        k1, k2 = eng.enqueue(t1, q), eng.enqueue(t2, q)
        log = [eng.step(), eng.stats.n_refreshes,
               eng.stats.n_deferred_refreshes, k1.done != k2.done]
        log += [eng.step(), k1.done and k2.done, eng.stats.n_refreshes]
        s1.push(np.zeros((10, CFG.d), np.float32))
        s2.push(np.zeros((10, CFG.d), np.float32))
        log += [s1.is_stale() and s2.is_stale()]
        k1, k2 = eng.enqueue(t1, q), eng.enqueue(t2, q)
        log += [eng.step(), k1.done and k2.done, eng.stats.n_refreshes,
                eng.stats.n_deferred_refreshes]
        seen.append(log)
    assert seen[0] == seen[1] == [5, 1, 1, True, 5, True, 2, True, 10, True,
                                  3, 2]


def test_service_delegation_matches_direct_and_counts_padding():
    svc = _service(3, staleness_frac=None, backend="torch")
    q = np.random.default_rng(9).standard_normal((73, CFG.d)).astype(
        np.float32)
    assign, dist = svc.query(q)
    a_s, d_s = backend.query_assignments(q, svc.centers(), backend="torch",
                                         device="cpu")
    assert torch.equal(assign, a_s)
    np.testing.assert_allclose(dist.numpy(), d_s.numpy(), rtol=1e-5,
                               atol=1e-6)
    stats = svc.stats.as_dict()
    assert stats["n_queries"] == 73
    assert stats["n_padded_queries"] == 128 - 73
    assert 0.0 < stats["padded_frac"] < 1.0
    assert stats["refresh_s"] > 0.0 and stats["assign_s"] > 0.0
    assert stats["n_refreshes"] == 1


def test_service_oversized_batch_chunks_instead_of_growing():
    svc = _service(4, staleness_frac=None, max_bucket=64, backend="torch")
    q = np.random.default_rng(11).standard_normal((200, CFG.d)).astype(
        np.float32)
    assign, _ = svc.query(q)
    assert assign.shape == (200,)
    a_s, _ = backend.query_assignments(q, svc.centers(), backend="torch",
                                       device="cpu")
    assert torch.equal(assign, a_s)
    assert {s[1] for s in svc._engine.compiled_shapes} <= {8, 16, 32, 64}
    np.testing.assert_allclose(float(svc.query_load(q).sum()), 200.0,
                               rtol=1e-5)
