"""Algorithm 1 and the streaming aggregation round on the port's WAN runtime
(``engine="async"``, ``faults=``), against the JAX package's: every case of
``tests/test_wan_distributed.py`` through both packages on the CPU.

Within the port everything is bit for bit: a fault-free asynchronous round
equals ``engine="exec"``, a faulty one the restricted oracle
(``restricted_sim_coreset`` + the final solve). Against the reference the
survivors, ``t_i``, every node's allocation and the ledgers by phase are
exact; coreset weights and centres are held to ``CENTER_RTOL`` (the local
solves round differently, so a sample can land elsewhere,
``tests/test_torch_exec.py``). Given the reference's Round-1 outputs
(carried across with ``interop``), the port's rounds reproduce the
reference's allocations, totals and assembled tables exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdistributed
from repro.core import topology as jtopology
from repro.core.partition import pad_partition, partition_indices
from repro.data import synthetic as jsynthetic
from repro.stream import DistributedStream as JStream
from repro.stream import TreeConfig as JTreeConfig
from repro.wan import faults as jfaults
from repro.wan import quiesce as jquiesce
from repro.wan import runtime as jruntime
from repro_torch import interop
from repro_torch.core import distributed, prng, strategy, topology
from repro_torch.core.coreset import Coreset, _windowed_sum
from repro_torch.data import synthetic
from repro_torch.stream import DistributedStream, TreeConfig
from repro_torch.wan import faults, quiesce, runtime

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

KEY = prng.PRNGKey(17)
JKEY = jax.random.PRNGKey(17)
UNITS = ("scalars", "points", "messages", "bytes", "link_cost")
CFG = TreeConfig(k=4, t=60, d=6, batch_size=200, levels=12)
JCFG = JTreeConfig(k=4, t=60, d=6, batch_size=200, levels=12)
# end-to-end centres and coreset weights against the reference's, relative
# to max |value| (tests/test_torch_exec.py)
CENTER_RTOL = 1e-3
FAULTY = dict(drop=((0, 1),), churn=((5, 1, 3), (9, 0, -1)), seed=3)


@pytest.fixture(scope="module")
def site_data():
    rng = np.random.default_rng(2)
    k, d, n_sites = 3, 5, 12
    centers = 3.0 * rng.standard_normal((k, d))
    pts = np.concatenate(
        [centers[i] + 0.2 * rng.standard_normal((140, d)) for i in range(k)]
    ).astype(np.float32)
    idx = partition_indices(pts, n_sites, "weighted", seed=1)
    sp, sm = pad_partition(pts, idx)
    return sp, sm, k


@pytest.fixture(scope="module")
def wan_graphs():
    return (topology.wan_clusters(3, 4, cross_links=2, seed=0),
            jtopology.wan_clusters(3, 4, cross_links=2, seed=0))


def _plans(**kw):
    return faults.FaultPlan(**kw), jfaults.FaultPlan(**kw)


def _near(p: torch.Tensor, j):
    ref = np.asarray(j)
    err = float(np.abs(p.numpy() - ref).max())
    assert err <= CENTER_RTOL * float(np.abs(ref).max()), err


def _run(site_data, graphs, t=48, plans=(None, None), **kw):
    """graph_distributed_kmeans in the port (CPU) and in the reference."""
    sp, sm, k = site_data
    p = distributed.graph_distributed_kmeans(KEY, sp, sm, k, t, graphs[0],
                                             faults=plans[0], device="cpu",
                                             **kw)
    j = jdistributed.graph_distributed_kmeans(
        JKEY, jnp.asarray(sp), jnp.asarray(sm), k, t, graphs[1],
        faults=plans[1], **kw)
    return p, j


def _same_as_reference(p, j):
    """Survivors, allocations, totals' layout and ledgers exact; coreset
    weights and centres near."""
    pd, jd = p.exec_detail, j.exec_detail
    assert np.array_equal(pd.surviving, jd.surviving)
    assert np.array_equal(pd.node_alloc.numpy(), np.asarray(jd.node_alloc))
    assert p.ledger.as_dict(by_phase=True) == j.ledger.as_dict(by_phase=True)
    assert set(pd.rounds) == set(jd.rounds)
    for name, r in pd.rounds.items():
        jr = jd.rounds[name]
        assert (r.rounds, r.rounds_to_complete, r.rounds_to_quiesce,
                r.per_round_transmissions) == (
            jr.rounds, jr.rounds_to_complete, jr.rounds_to_quiesce,
            jr.per_round_transmissions), name
        assert np.array_equal(r.staleness, jr.staleness), name
    assert p.coreset.points.shape == tuple(j.coreset.points.shape)
    _near(p.coreset.weights, j.coreset.weights)
    _near(p.centers, j.centers)


def _bit_equal(a, b):
    assert torch.equal(a.coreset.points, b.coreset.points)
    assert torch.equal(a.coreset.weights, b.coreset.weights)
    assert torch.equal(a.centers, b.centers)


# -- graph_distributed_kmeans ------------------------------------------------

def test_async_fault_free_full_mode_is_bit_identical_to_exec(site_data,
                                                             wan_graphs):
    sp, sm, k = site_data
    r_ex = distributed.graph_distributed_kmeans(KEY, sp, sm, k, 48,
                                                wan_graphs[0], engine="exec",
                                                device="cpu")
    r_as, j_as = _run(site_data, wan_graphs, engine="async", wan_mode="full")
    _bit_equal(r_ex, r_as)
    ed, ad = r_ex.ledger.as_dict(), r_as.ledger.as_dict()
    for u in UNITS:
        assert ed[u] == ad[u], u
    assert ad["staleness"] == 0.0
    assert torch.equal(r_ex.exec_detail.node_alloc,
                       r_as.exec_detail.node_alloc)
    _same_as_reference(r_as, j_as)


def test_async_clock_mode_same_result_with_staleness(site_data, wan_graphs):
    sp, sm, k = site_data
    r_ex = distributed.graph_distributed_kmeans(KEY, sp, sm, k, 48,
                                                wan_graphs[0], engine="exec",
                                                device="cpu")
    r_ck, j_ck = _run(site_data, wan_graphs, engine="async",
                      wan_mode="clock")
    _bit_equal(r_ex, r_ck)
    d = r_ck.ledger.as_dict()
    assert d["staleness"] > 0.0
    assert d["link_cost"] == r_ex.ledger.as_dict()["link_cost"]
    _same_as_reference(r_ck, j_ck)


@pytest.mark.parametrize("mode", ["full", "clock"])
def test_faulty_exec_certified_against_restricted_oracle(site_data,
                                                         wan_graphs, mode):
    sp, sm, k = site_data
    plan, jplan = _plans(**FAULTY)
    cert = quiesce.certify_quiescence(
        wan_graphs[0], plan, mode=mode, seed=4, check_clustering=True,
        key=KEY, site_points=sp, site_mask=sm, k=k, t=48, device="cpu")
    jcert = jquiesce.certify_quiescence(
        wan_graphs[1], jplan, mode=mode, seed=4, check_clustering=True,
        key=JKEY, site_points=jnp.asarray(sp), site_mask=jnp.asarray(sm),
        k=k, t=48)
    assert cert.ok and cert.centers_match is True, (mode, cert)
    assert dataclasses.asdict(cert) == dataclasses.asdict(jcert)


@pytest.mark.parametrize("engine,mode", [("exec", None), ("async", "clock"),
                                         ("async", "random")])
def test_faulty_round_coreset_spans_survivors_only(site_data, wan_graphs,
                                                   engine, mode):
    """Under a plan with a dead node, drops and churn, the port's run equals
    its restricted oracle bit for bit and the reference's run as stated."""
    sp, sm, k = site_data
    plans = _plans(**FAULTY) if mode else _plans(churn=((9, 0, -1),), seed=1)
    surv = plans[0].surviving_nodes(wan_graphs[0].n)
    res, jres = _run(site_data, wan_graphs, plans=plans, engine=engine,
                     wan_mode=mode, wan_seed=6)
    detail = res.exec_detail
    assert np.array_equal(detail.surviving, surv)
    assert detail.node_points.shape[0] == surv.size
    for v in range(surv.size):
        assert torch.equal(detail.node_points[v], detail.node_points[0])
        assert torch.equal(detail.node_weights[v], detail.node_weights[0])
    assert res.ledger.as_dict()["staleness"] >= 0.0
    k1, k2 = prng.split(KEY)
    pts, w, t_i, lc = runtime.restricted_sim_coreset(
        k1, sp, sm, k, 48, t_buffer=48, objective="kmeans", lloyd_iters=8,
        clip_negative=False, backend="torch", surviving=surv, device="cpu")
    assert torch.equal(res.coreset.points, pts)
    assert torch.equal(res.coreset.weights, w)
    assert torch.equal(detail.node_alloc[0], t_i)
    assert torch.equal(res.local_costs, lc)
    assert torch.equal(res.centers, distributed._solve_on_coreset(
        k2, Coreset(pts, w), k, "kmeans", 8, "torch"))
    _same_as_reference(res, jres)


@pytest.mark.parametrize("strat,objective", [("cohen_addad", "kmeans"),
                                             ("mapreduce", "kmeans"),
                                             ("algorithm1", "kmedian")])
def test_strategies_and_objectives_under_faults(site_data, wan_graphs,
                                                strat, objective):
    """Fault-free async full mode equals exec (mapreduce: the restricted
    oracle over every site, as it has no exec flood); a faulty clock run
    equals the restricted oracle; against the reference the ledgers by
    phase and the allocations are exact (cohen_addad's within one sample,
    ROADMAP C); mapreduce skips the Round-1 flood in both packages."""
    sp, sm, k = site_data
    g = wan_graphs[0]
    kw = dict(strategy=strat, objective=objective)
    plan = faults.FaultPlan(**FAULTY)
    k1, k2 = prng.split(KEY)
    for p, surv, extra in ((None, np.arange(g.n), dict(wan_mode="full")),
                           (plan, plan.surviving_nodes(g.n),
                            dict(wan_mode="clock", wan_seed=2))):
        res = distributed.graph_distributed_kmeans(
            KEY, sp, sm, k, 48, g, engine="async", faults=p, device="cpu",
            **kw, **extra)
        pts, w, t_i, _ = runtime.restricted_sim_coreset(
            k1, sp, sm, k, 48, 48, objective, 8, False, "torch", surv,
            strategy=strat, device="cpu")
        assert torch.equal(res.coreset.points, pts)
        assert torch.equal(res.coreset.weights, w)
        assert torch.equal(res.exec_detail.node_alloc[0], t_i)
        assert torch.equal(res.centers, distributed._solve_on_coreset(
            k2, Coreset(pts, w), k, objective, 8, "torch"))
        assert ("round1" in res.exec_detail.rounds) == (strat != "mapreduce")
    if strat != "mapreduce":
        r_ex = distributed.graph_distributed_kmeans(
            KEY, sp, sm, k, 48, g, engine="exec", device="cpu", **kw)
        r_as = distributed.graph_distributed_kmeans(
            KEY, sp, sm, k, 48, g, engine="async", wan_mode="full",
            device="cpu", **kw)
        _bit_equal(r_ex, r_as)
    jplan = jfaults.FaultPlan(**FAULTY)
    res, jres = _run(site_data, wan_graphs, plans=(plan, jplan),
                     engine="async", wan_mode="clock", wan_seed=2, **kw)
    assert res.ledger.as_dict(by_phase=True) == jres.ledger.as_dict(
        by_phase=True)
    ours = res.exec_detail.node_alloc.numpy()
    theirs = np.asarray(jres.exec_detail.node_alloc)
    if strat == "cohen_addad":
        # the refined totals sit near integers: t_i within one sample of
        # the reference's (tests/test_torch_strategies.py), sums exact
        assert np.abs(ours - theirs).max() <= 1
        assert np.array_equal(ours.sum(1), theirs.sum(1))
    else:
        assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("mode", ["full", "clock", "random"])
def test_rounds_given_the_references_round1_are_exact(site_data,
                                                      wan_graphs, mode):
    """The reference's Round-1 local costs carried across: the port's
    scalar flood, every node's allocation and total are the reference's;
    the reference's Round-2 portions carried across: the port's flood
    assembles the reference's coreset table bit for bit, with its ledger."""
    sp, sm, k = site_data
    g, jg = wan_graphs
    plan, jplan = _plans(**dict(FAULTY, dup_rate=0.2))
    surv = plan.surviving_nodes(g.n)
    jk1, _ = jax.random.split(JKEY)
    jdet, jlc = jruntime.async_algorithm1_rounds(
        jg, jk1, jnp.asarray(sp), jnp.asarray(sm).astype(jnp.float32), k,
        48, 48, "kmeans", 8, False, "jnp", mode=mode, faults=jplan, seed=3)
    # Round 1 from the reference's scalars
    tables, r1 = runtime.wan_flood_exec(
        g, interop.tensor(np.asarray(jlc), "cpu")[:, None], mode=mode,
        faults=plan, unit_scalars=1.0, seed=3)
    costs_at = tables[surv][:, surv, 0]
    alloc = torch.stack([strategy.get_strategy().allocate(c, 48)
                         for c in costs_at])
    assert np.array_equal(alloc.numpy(), np.asarray(jdet.node_alloc))
    assert np.array_equal(_windowed_sum(costs_at).numpy(),
                          np.asarray(jdet.node_totals))
    jr1 = jdet.rounds["round1"]
    assert r1.ledger.as_dict(by_phase=True) == jr1.ledger.as_dict(
        by_phase=True)
    # Round 2 from the reference's portions (survivor 0's assembled copy)
    n_s, slots = surv.size, jdet.node_points.shape[1] // surv.size
    pts = np.asarray(jdet.node_points[0]).reshape(n_s, slots, -1)
    w = np.asarray(jdet.node_weights[0]).reshape(n_s, slots)
    payload = np.zeros((g.n, slots, pts.shape[-1] + 1), np.float32)
    payload[surv] = np.concatenate([pts, w[..., None]], axis=-1)
    unit_pts = np.zeros(g.n)
    unit_pts[surv] = np.diagonal(np.asarray(jdet.node_alloc)) + k
    tables, r2 = runtime.wan_flood_exec(
        g, torch.from_numpy(payload), mode=mode, faults=plan,
        unit_points=unit_pts, dim=pts.shape[-1], seed=4)
    got = tables[surv][:, surv]
    assert np.array_equal(
        got[..., :-1].reshape(n_s, -1, pts.shape[-1]).numpy(),
        np.asarray(jdet.node_points))
    assert np.array_equal(got[..., -1].reshape(n_s, -1).numpy(),
                          np.asarray(jdet.node_weights))
    jr2 = jdet.rounds["round2"]
    assert r2.ledger.as_dict(by_phase=True) == jr2.ledger.as_dict(
        by_phase=True)
    assert r2.per_round_transmissions == jr2.per_round_transmissions


def test_faults_require_flood_routing(site_data, wan_graphs):
    sp, sm, k = site_data
    msgs = []
    for kw in (dict(engine="exec", routing="tree"),
               dict(engine="sim"), dict(engine="async", routing="bfs")):
        with pytest.raises(ValueError) as ours:
            distributed.graph_distributed_kmeans(
                KEY, sp, sm, k, 48, wan_graphs[0],
                faults=faults.FaultPlan(seed=0), device="cpu", **kw)
        with pytest.raises(ValueError) as theirs:
            jdistributed.graph_distributed_kmeans(
                JKEY, jnp.asarray(sp), jnp.asarray(sm), k, 48, wan_graphs[1],
                faults=jfaults.FaultPlan(seed=0), **kw)
        msgs.append(str(ours.value))
        assert str(ours.value) == str(theirs.value).replace(
            "repro.wan", "repro_torch.wan")
    assert "flood" in msgs[0] and "engine" in msgs[1]


# -- DistributedStream rounds ------------------------------------------------

def _feed(ds, batches):
    for i, b in enumerate(batches):
        ds.push(i % ds.graph.n, b)


def _streams(g, jg, seed, batches):
    ds = DistributedStream(g, CFG, key=prng.PRNGKey(seed), device="cpu")
    jds = JStream(jg, JCFG, key=jax.random.PRNGKey(seed))
    _feed(ds, batches)
    _feed(jds, batches)
    return ds, jds


@pytest.mark.parametrize("mode", ["union", "resample"])
def test_stream_async_round_matches_exec(mode):
    g, jg = topology.grid(2, 2), jtopology.grid(2, 2)
    batches = list(synthetic.drifting_mixture_stream(8, 200, d=6, k=4,
                                                     seed=37))
    ds_ex = DistributedStream(g, CFG, key=prng.PRNGKey(41), device="cpu")
    _feed(ds_ex, batches)
    ds_as, jds = _streams(g, jg, 41, batches)
    r_ex = ds_ex.aggregate(k=4, t=120, mode=mode, engine="exec")
    r_as = ds_as.aggregate(k=4, t=120, mode=mode, engine="async",
                           wan_mode="full", wan_seed=0)
    _bit_equal(r_ex, r_as)
    ed, ad = r_ex.ledger.as_dict(), r_as.ledger.as_dict()
    for u in UNITS:
        assert ed[u] == ad[u], (mode, u)
    jr = jds.aggregate(k=4, t=120, mode=mode, engine="async",
                       wan_mode="full", wan_seed=0)
    assert r_as.ledger.as_dict(by_phase=True) == jr.ledger.as_dict(
        by_phase=True)
    assert r_as.coreset.points.shape == tuple(jr.coreset.points.shape)


def test_stream_faulty_union_round_keeps_survivor_mass(wan_graphs):
    g, jg = wan_graphs
    batches = list(synthetic.contaminated_stream(
        12, 200, d=6, k=4, outlier_frac=0.05, burst_every=4, seed=5))
    ds, jds = _streams(g, jg, 5, batches)
    plan, jplan = _plans(**FAULTY)
    surv = plan.surviving_nodes(g.n)
    res = ds.aggregate(k=4, t=5000, mode="union", engine="async",
                       faults=plan)
    jres = jds.aggregate(k=4, t=5000, mode="union", engine="async",
                         faults=jplan)
    survivor_mass = sum(float(ds.sites[int(s)].summary().weights.sum())
                        for s in surv)
    np.testing.assert_allclose(float(res.coreset.weights.sum()),
                               survivor_mass, rtol=1e-5)
    assert res.ledger.as_dict(by_phase=True) == jres.ledger.as_dict(
        by_phase=True)
    assert res.ledger.as_dict()["staleness"] >= 0.0
    assert res.centers.shape == (4, CFG.d)


def test_stream_faulty_resample_round_runs_restricted(wan_graphs):
    g, jg = wan_graphs
    batches = list(synthetic.contaminated_stream(12, 200, d=6, k=4, seed=9))
    ds, jds = _streams(g, jg, 7, batches)
    plan, jplan = _plans(churn=((9, 0, -1),), seed=2)
    res = ds.aggregate(k=4, t=120, mode="resample", engine="exec",
                       faults=plan)
    jres = jds.aggregate(k=4, t=120, mode="resample", engine="exec",
                         faults=jplan)
    assert bool(torch.isfinite(res.coreset.points).all())
    assert res.centers.shape == (4, CFG.d)
    d = ds.ledger.as_dict(by_phase=True)
    assert "stream_round_0" in d["phases"]
    assert d == jds.ledger.as_dict(by_phase=True)
    assert res.coreset.points.shape == tuple(jres.coreset.points.shape)


def test_stream_wan_validation():
    g, jg = topology.grid(2, 2), jtopology.grid(2, 2)
    batch = next(iter(synthetic.drifting_mixture_stream(1, 200, d=6,
                                                        seed=1)))
    ds = DistributedStream(g, CFG, device="cpu")
    jds = JStream(jg, JCFG)
    ds.push(0, batch)
    jds.push(0, batch)
    for kw, match, plan in (
            (dict(engine="sim"), "engine", _plans(seed=0)),
            (dict(engine="async", transport="tree"), "flood", (None, None))):
        with pytest.raises(ValueError, match=match) as ours:
            ds.aggregate(k=4, t=60, faults=plan[0], **kw)
        with pytest.raises(ValueError) as theirs:
            jds.aggregate(k=4, t=60, faults=plan[1], **kw)
        assert str(ours.value) == str(theirs.value)
    assert ds.rounds == 0


# -- contaminated_stream itself ---------------------------------------------

def test_contaminated_stream_shares_inliers_with_base():
    clean = list(synthetic.drifting_mixture_stream(4, 100, d=5, seed=3))
    dirty = list(synthetic.contaminated_stream(4, 100, d=5,
                                               outlier_frac=0.1, seed=3))
    want = list(jsynthetic.contaminated_stream(4, 100, d=5,
                                               outlier_frac=0.1, seed=3))
    assert len(dirty) == 4
    for c, t, w in zip(clean, dirty, want):
        assert np.array_equal(t, w)
        assert t.shape == c.shape and t.dtype == np.float32
        changed = np.any(c != t, axis=1)
        assert changed.sum() == 10
        np.testing.assert_array_equal(c[~changed], t[~changed])
        assert np.linalg.norm(t[changed], axis=1).min() > 20.0


def test_contaminated_stream_burst_batches_are_fully_adversarial():
    dirty = list(synthetic.contaminated_stream(4, 50, d=5, outlier_frac=0.0,
                                               burst_every=2, seed=3))
    radii = [np.linalg.norm(b, axis=1) for b in dirty]
    assert radii[1].min() > 20.0 and radii[3].min() > 20.0
    assert radii[0].max() < 20.0 and radii[2].max() < 20.0
    with pytest.raises(ValueError, match="outlier_frac"):
        list(synthetic.contaminated_stream(1, 10, outlier_frac=1.5))
