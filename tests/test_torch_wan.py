"""The port's asynchronous WAN runtime (``repro_torch.wan``) against the JAX
package's (``repro.wan``): every case of ``tests/test_wan_runtime.py``
through both packages on the CPU, plus the pieces under them.

Everything here is exact: fault plans, activation / liveness / duplicate
masks and the slot algebra of the schedules are host numpy in both
packages; the relay tables are copies of the payload, so they are held bit
for bit (signed zeros, infinities and NaNs included); every
``WanExecResult`` field but the wall time, every ledger axis by phase,
every certificate field and every error message equal the reference's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topology as jtopology
from repro.wan import faults as jfaults
from repro.wan import quiesce as jquiesce
from repro.wan import runtime as jruntime
from repro.wan import schedules as jschedules
from repro_torch import interop
from repro_torch.core import message_passing as mp
from repro_torch.core import topology
from repro_torch.wan import faults, quiesce, runtime, schedules

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

UNITS = ("scalars", "points", "messages", "bytes", "link_cost")


def _payload(n, f=3):
    return (np.arange(n, dtype=np.float32)[:, None] * 10.0
            + np.arange(f, dtype=np.float32)[None, :])


def _graphs(build):
    return build(topology), build(jtopology)


def _plans(**kw):
    return faults.FaultPlan(**kw), jfaults.FaultPlan(**kw)


def _bits_equal(p: torch.Tensor, j) -> bool:
    """The port's table and the reference's, bit for bit."""
    a = p.contiguous().numpy()
    b = np.asarray(j)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.int32), b.view(np.int32)))


def _same_result(p, j):
    """Every WanExecResult field but the wall time equal to the
    reference's, the ledger by phase included."""
    assert (p.rounds, p.rounds_to_complete, p.rounds_to_quiesce, p.mode,
            p.per_round_transmissions) == (
        j.rounds, j.rounds_to_complete, j.rounds_to_quiesce, j.mode,
        j.per_round_transmissions)
    for f in ("completion", "staleness", "known"):
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert p.ledger.as_dict(by_phase=True) == j.ledger.as_dict(by_phase=True)
    assert p.ledger.dim == j.ledger.dim


def _flood(graphs, plans=(None, None), payload=None, **kw):
    """wan_flood_exec in both packages on the same payload: ((port table,
    port result), (reference table, reference result))."""
    g, jg = graphs
    pay = _payload(g.n) if payload is None else payload
    p = runtime.wan_flood_exec(g, torch.from_numpy(pay.copy()),
                               faults=plans[0], **kw)
    j = jruntime.wan_flood_exec(jg, jnp.asarray(pay), faults=plans[1], **kw)
    return p, j


def _both_equal(graphs, plans=(None, None), payload=None, **kw):
    (pt, pr), (jt, jr) = _flood(graphs, plans, payload, **kw)
    assert _bits_equal(pt, jt)
    _same_result(pr, jr)
    return (pt, pr), (jt, jr)


# -- fault-free equivalence with the synchronous engine ----------------------

def test_trivial_plan_full_mode_matches_sync_engine():
    graphs = _graphs(lambda m: m.grid(3, 3))
    g = graphs[0]
    pay = torch.from_numpy(_payload(g.n))
    sync_tables, sync_res = mp.flood_exec(g, pay, unit_scalars=1.0)
    (wan_tables, wan_res), _ = _both_equal(graphs, mode="full",
                                           unit_scalars=1.0)
    assert torch.equal(sync_tables, wan_tables)
    ns, nw = sync_res.per_round_transmissions, wan_res.per_round_transmissions
    m = min(len(ns), len(nw))
    assert ns[:m] == nw[:m]
    assert all(x == 0 for x in ns[m:] + nw[m:])
    sd, wd = sync_res.ledger.as_dict(), wan_res.ledger.as_dict()
    for u in UNITS:
        assert sd[u] == wd[u], u
    assert wd["staleness"] == 0.0
    assert wan_res.rounds_to_complete == topology.diameter(g)


def test_fault_free_quiesces_one_round_after_completion():
    (_, res), _ = _both_equal(_graphs(lambda m: m.ring(8)), mode="full")
    assert res.rounds_to_complete == 4
    assert res.rounds_to_quiesce <= res.rounds_to_complete + 1
    assert all(t == 0 for t in
               res.per_round_transmissions[res.rounds_to_quiesce:])


# -- faults: completion, quiescence, idempotence -----------------------------

FAULTY = dict(drop=((0, 1),), churn=((5, 1, 3), (9, 0, -1)), seed=3)


@pytest.fixture(scope="module")
def faulty_case():
    return (_graphs(lambda m: m.wan_clusters(3, 4, cross_links=2, seed=0)),
            _plans(**FAULTY))


def test_faulty_flood_completes_within_bound(faulty_case):
    graphs, plans = faulty_case
    g, plan = graphs[0], plans[0]
    sub, _ = plan.surviving_graph(g)
    surv = plan.surviving_nodes(g.n)
    (tables, res), _ = _both_equal(graphs, plans, mode="full")
    assert res.rounds_to_complete <= plan.horizon() + topology.diameter(sub)
    assert res.rounds_to_quiesce <= res.rounds
    pay = _payload(g.n)
    for v in surv:
        np.testing.assert_array_equal(tables[v].numpy()[surv], pay[surv])
    assert 9 not in surv


def test_duplicates_change_traffic_not_tables(faulty_case):
    graphs, plans = faulty_case
    surv = plans[0].surviving_nodes(graphs[0].n)
    (base, bres), _ = _both_equal(graphs, plans, mode="full")
    dups = tuple(dataclasses.replace(pl, dup_rate=0.4) for pl in plans)
    (dtab, dres), _ = _both_equal(graphs, dups, mode="full")
    assert dres.ledger.messages > bres.ledger.messages
    assert torch.equal(base[surv][:, surv], dtab[surv][:, surv])


def _raises_alike(fn, jfn, exc=ValueError):
    """Both packages raise ``exc`` with the same message."""
    with pytest.raises(exc) as ours:
        fn()
    with pytest.raises(exc) as theirs:
        jfn()
    assert str(ours.value) == str(theirs.value)
    return str(ours.value)


def test_disconnecting_plan_raises():
    g, jg = _graphs(lambda m: m.star(5))
    plan, jplan = _plans(churn=((0, 0, -1),))
    pay = _payload(5)
    msg = _raises_alike(
        lambda: runtime.wan_flood_exec(g, torch.from_numpy(pay),
                                       faults=plan),
        lambda: jruntime.wan_flood_exec(jg, jnp.asarray(pay), faults=jplan))
    assert "disconnect" in msg


def test_unknown_dropped_edge_raises():
    g, jg = _graphs(lambda m: m.ring(5))
    plan, jplan = _plans(drop=((0, 2),))
    pay = _payload(5)
    msg = _raises_alike(
        lambda: runtime.wan_flood_exec(g, torch.from_numpy(pay),
                                       faults=plan),
        lambda: jruntime.wan_flood_exec(jg, jnp.asarray(pay), faults=jplan))
    assert "not an edge" in msg


def test_runtime_and_plan_errors_are_the_references():
    g, jg = _graphs(lambda m: m.ring(5))
    bad = _payload(4)
    _raises_alike(lambda: runtime.wan_flood_exec(g, torch.from_numpy(bad)),
                  lambda: jruntime.wan_flood_exec(jg, jnp.asarray(bad)))
    ws, jws = schedules.wan_schedule(g), jschedules.wan_schedule(jg)
    _raises_alike(lambda: schedules.activation_masks(ws, "warp", 3),
                  lambda: jschedules.activation_masks(jws, "warp", 3))
    _raises_alike(lambda: schedules.activation_masks(ws, "random", 3, p=0.0),
                  lambda: jschedules.activation_masks(jws, "random", 3,
                                                      p=0.0))
    for kw in (dict(churn=((1, 0, 2), (1, 3, 4))), dict(churn=((1, -1, 2),)),
               dict(churn=((1, 3, 2),)), dict(dup_rate=1.0)):
        _raises_alike(lambda: faults.FaultPlan(**kw),
                      lambda: jfaults.FaultPlan(**kw))
    plan, jplan = _plans(churn=((7, 0, 2),))
    _raises_alike(lambda: plan.node_up(5, 3), lambda: jplan.node_up(5, 3))
    plan, jplan = _plans(churn=tuple((v, 0, -1) for v in range(5)))
    _raises_alike(lambda: plan.surviving_nodes(5),
                  lambda: jplan.surviving_nodes(5))


# -- per-edge clocks and staleness -------------------------------------------

def test_clock_mode_prices_slow_links_as_staleness():
    graphs = _graphs(lambda m: m.wan_clusters(3, 3, cross_links=2, seed=0))
    g = graphs[0]
    ws = schedules.wan_schedule(g)
    assert ws.max_period > 1
    (_, res), _ = _both_equal(graphs, mode="clock")
    assert res.ledger.staleness > 0.0
    assert res.rounds_to_complete <= ws.max_period * topology.diameter(g)
    assert res.ledger.staleness == pytest.approx(float(res.staleness.mean()))
    (_, uni), _ = _both_equal(_graphs(lambda m: m.grid(3, 3)), mode="clock")
    assert uni.ledger.staleness == 0.0


def test_ledger_round_phases_sum_to_totals():
    graphs = _graphs(lambda m: m.wan_clusters(3, 3, cross_links=2, seed=0))
    (_, res), _ = _both_equal(graphs, mode="clock", unit_scalars=1.0)
    d = res.ledger.as_dict(by_phase=True)
    assert all(name.startswith("wan_round_") for name in d["phases"])
    for u in ("scalars", "messages", "link_cost"):
        assert d[u] == pytest.approx(
            sum(p[u] for p in d["phases"].values()))
    assert "staleness" in d


@pytest.mark.parametrize("mode", ["full", "clock", "random"])
def test_per_origin_units_and_dim_price_alike(faulty_case, mode):
    """Per-origin point units with a dimension, on a plan with a dead
    origin and duplicates: the ledger by phase equals the reference's."""
    graphs, plans = faulty_case
    plans = tuple(dataclasses.replace(pl, dup_rate=0.2) for pl in plans)
    units = np.arange(graphs[0].n, dtype=np.float64) + 3.0
    _both_equal(graphs, plans, payload=_payload(graphs[0].n, 5), mode=mode,
                unit_points=units, dim=4, seed=5)


# -- randomized gossip -------------------------------------------------------

def test_random_mode_is_seed_deterministic():
    graphs = _graphs(lambda m: m.grid(3, 3))
    (t1, r1), _ = _both_equal(graphs, mode="random", seed=7, p=0.4)
    (t2, r2), _ = _both_equal(graphs, mode="random", seed=7, p=0.4)
    assert torch.equal(t1, t2)
    assert r1.per_round_transmissions == r2.per_round_transmissions
    assert r1.rounds_to_quiesce == r2.rounds_to_quiesce
    assert torch.equal(t1, torch.from_numpy(_payload(9))[None].expand(
        9, -1, -1))


def test_random_mode_budget_doubling_is_prefix_stable():
    graphs = _graphs(lambda m: m.ring(6))
    (_, res), _ = _both_equal(graphs, mode="random", seed=1, p=0.05)
    (_, direct), _ = _both_equal(graphs, mode="random", seed=1, p=0.05,
                                 max_rounds=res.rounds)
    assert res.per_round_transmissions == direct.per_round_transmissions
    assert res.rounds_to_complete == direct.rounds_to_complete


# -- relays are bit copies ---------------------------------------------------

@pytest.mark.parametrize("mode", ["full", "clock"])
def test_relays_copy_signed_zeros_infinities_and_nans(faulty_case, mode):
    graphs, plans = faulty_case
    n = graphs[0].n
    pay = _payload(n, 6)
    pay[:, 0] = -0.0
    pay[1::2, 1] = np.inf
    pay[::3, 2] = -np.inf
    pay[2::4, 3] = np.nan
    pay[:, 4] = np.frombuffer(np.arange(n, dtype=np.int32) + 0x7FC00001,
                              np.float32)          # NaNs with payload bits
    (pt, _), _ = _both_equal(graphs, plans, payload=pay, mode=mode)
    surv = plans[0].surviving_nodes(n)
    for v in surv:
        assert np.array_equal(pt[v].numpy()[surv].view(np.int32),
                              pay[surv].view(np.int32))


# -- plans, masks and schedules ---------------------------------------------

TOPOLOGIES = {
    "ring": lambda m: m.ring(9),
    "grid": lambda m: m.grid(3, 3),
    "wan": lambda m: m.wan_clusters(3, 3, cross_links=2, seed=0),
    "directed": lambda m: m.Graph(5, ((0, 1), (1, 2), (2, 0), (2, 3),
                                      (3, 4), (4, 0)),
                                  edge_costs=(1.0, 2.0, 3.0, 1.0, 4.0, 1.0),
                                  directed=True),
}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_schedules_and_masks_equal_the_references(name):
    g, jg = _graphs(TOPOLOGIES[name])
    ws, jws = schedules.wan_schedule(g), jschedules.wan_schedule(jg)
    for f in ("slot_edge", "in_slot", "periods"):
        a, b = getattr(ws, f), getattr(jws, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert ws.max_period == jws.max_period
    assert schedules.wan_schedule(g) is ws
    for mode in ("full", "random", "clock"):
        a = schedules.activation_masks(ws, mode, 12, seed=4, p=0.3)
        b = jschedules.activation_masks(jws, mode, 12, seed=4, p=0.3)
        assert a.dtype == b.dtype and np.array_equal(a, b), mode
        # prefix-stable: 5 rounds are the first 5 of 12
        assert np.array_equal(
            schedules.activation_masks(ws, mode, 5, seed=4, p=0.3), a[:5])
    plan, jplan = _plans(drop=(g.edges[0],), churn=((1, 2, 5), (3, 0, -1)),
                         dup_rate=0.3, seed=6)
    for mode in ("full", "random", "clock"):
        for a, b in zip(schedules.liveness_masks(ws, mode, 10, plan, seed=2),
                        jschedules.liveness_masks(jws, mode, 10, jplan,
                                                  seed=2)):
            assert a.dtype == b.dtype and np.array_equal(a, b), mode


@pytest.mark.parametrize("name", ["ring", "grid", "wan"])
def test_random_fault_plans_equal_the_references(name):
    g, jg = _graphs(TOPOLOGIES[name])
    for seed in range(4):
        kw = dict(seed=seed, drop_frac=0.2, n_churn=3, dead_frac=0.4,
                  dup_rate=0.1)
        plan = faults.random_fault_plan(g, **kw)
        jplan = jfaults.random_fault_plan(jg, **kw)
        assert (plan.drop, plan.churn, plan.dup_rate, plan.seed) == (
            jplan.drop, jplan.churn, jplan.dup_rate, jplan.seed)
        assert interop.fault_plan(jplan) == plan
        assert plan.dead_nodes() == jplan.dead_nodes()
        assert np.array_equal(plan.surviving_nodes(g.n),
                              jplan.surviving_nodes(g.n))
        assert plan.horizon() == jplan.horizon()
        assert np.array_equal(plan.node_up(g.n, 9), jplan.node_up(g.n, 9))
        assert np.array_equal(plan.dup_masks(g.n, 3, 7),
                              jplan.dup_masks(g.n, 3, 7))
        (sub, idx), (jsub, jidx) = (plan.surviving_graph(g),
                                    jplan.surviving_graph(jg))
        assert (sub.n, sub.edges, sub.costs) == (jsub.n, jsub.edges,
                                                 jsub.costs)
        assert np.array_equal(idx, jidx)
        assert plan.is_trivial == jplan.is_trivial


# -- certification -----------------------------------------------------------

def _same_certificate(g, jg, plan, jplan, **kw):
    cert = quiesce.certify_quiescence(g, plan, device="cpu", **kw)
    jcert = jquiesce.certify_quiescence(jg, jplan, **kw)
    assert dataclasses.asdict(cert) == dataclasses.asdict(jcert)
    assert cert.ok == jcert.ok
    return cert


@pytest.mark.parametrize("mode", ["full", "clock", "random"])
def test_certify_quiescence_modes(faulty_case, mode):
    (g, jg), (plan, jplan) = faulty_case
    cert = _same_certificate(g, jg, plan, jplan, mode=mode, seed=2)
    assert cert.ok, cert
    assert cert.quiesced and cert.duplicates_idempotent
    if mode != "random":
        assert cert.bound is not None
        assert cert.rounds_to_complete <= cert.bound


@pytest.mark.parametrize("topo", ["ring", "grid", "wan"])
def test_certify_generated_plans(topo):
    g, jg = _graphs({"ring": lambda m: m.ring(9),
                     "grid": lambda m: m.grid(3, 3),
                     "wan": lambda m: m.wan_clusters(3, 3, cross_links=2,
                                                     seed=0)}[topo])
    kw = dict(seed=11, drop_frac=0.15, n_churn=2, dead_frac=0.15,
              dup_rate=0.2)
    plan = faults.random_fault_plan(g, **kw)
    jplan = jfaults.random_fault_plan(jg, **kw)
    cert = _same_certificate(g, jg, plan, jplan, mode="full", seed=5)
    assert cert.ok, (topo, cert)


# the property case of the reference's test on 10 fixed draws of its
# strategy (seed, plan_seed in 0..10,000): outputs against the reference's
PROPERTY_DRAWS = [tuple(int(x) for x in r) for r in
                  np.random.default_rng(2024).integers(0, 10_001, (10, 2))]


@pytest.mark.parametrize("seed,plan_seed", PROPERTY_DRAWS)
def test_property_connected_survivors_match_the_reference(seed, plan_seed):
    g, jg = _graphs(lambda m: m.erdos_renyi(8, 0.35, seed=seed % 97))
    kw = dict(seed=plan_seed, drop_frac=0.2, n_churn=2, churn_window=(1, 4),
              dead_frac=0.2)
    plan = faults.random_fault_plan(g, **kw)
    jplan = jfaults.random_fault_plan(jg, **kw)
    assert interop.fault_plan(jplan) == plan
    (_, res), _ = _both_equal((g, jg), (plan, jplan), mode="full",
                              seed=seed)
    assert res.rounds_to_quiesce <= res.rounds
