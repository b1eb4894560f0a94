"""The port's Algorithm-1 stages against the JAX package's, one stage at a
time: the JAX stage's output is carried into the port with
:mod:`repro_torch.interop` and the next stage runs on both sides."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclustering
from repro.core import coreset as jcoreset
from repro.core import strategy as jstrategy
from repro.core.partition import pad_partition, partition_indices
from repro_torch import interop
from repro_torch.core import backend, clustering, coreset, objective, prng
from repro_torch.core import strategy

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

K = 5


@pytest.fixture(scope="module")
def sites():
    """The quickstart instance: 20,000 points in R^10, 9 weighted sites."""
    rng = np.random.default_rng(0)
    centers = 3.0 * rng.standard_normal((K, 10))
    data = np.concatenate(
        [c + 0.2 * rng.standard_normal((4000, 10)) for c in centers]
    ).astype(np.float32)
    sp, sm = pad_partition(data, partition_indices(data, 9, "weighted",
                                                   seed=1))
    return sp, sm


@pytest.fixture(scope="module")
def jax_round1(sites):
    """The JAX package's Round 1 on the quickstart sites (plain backend)."""
    sp, sm = sites
    keys = jstrategy.ALGORITHM1.keys(jax.random.PRNGKey(3), sp.shape[0])
    r1 = jcoreset.round1_local_solves(
        keys[:, 0], jnp.asarray(sp), jnp.asarray(sm, jnp.float32), k=K,
        objective="kmeans", lloyd_iters=5, backend="jnp")
    return keys, tuple(np.asarray(x) for x in r1)


# -- proportional allocation ----------------------------------------------------

def _alloc_both(costs, t):
    j = np.asarray(jcoreset.proportional_allocation(jnp.asarray(costs), t))
    p = coreset.proportional_allocation(torch.from_numpy(costs), t).numpy()
    return j, p


EDGE_CASES = [
    (np.zeros(7, np.float32), 100),
    (np.zeros(3, np.float32), 1000),
    (np.full(6, 2.5, np.float32), 99),
    (np.full(7, 2.5, np.float32), 101),
    (np.asarray([0.0, 0.0, 5.0, 0.0], np.float32), 64),
    (np.asarray([3e37, 2e37, 1e37], np.float32), 300),
    (np.full(4, 3.0e38, np.float32), 10),
    (np.asarray([1e-30, 2e-30, 5e-31], np.float32), 17),
]


@pytest.mark.parametrize("costs,t", EDGE_CASES)
def test_proportional_allocation_edge_cases_exact(costs, t):
    j, p = _alloc_both(costs, t)
    assert p.dtype == np.int32
    np.testing.assert_array_equal(p, j)
    assert p.sum() == t and (p >= 0).all()


def test_proportional_allocation_sweep_1e_minus30_to_1e38_exact():
    """tests/test_core_coreset.py's sign-safety sweep (2..16 sites, cost
    scales 1e-30..1e38), and 33, 100 and 128 sites, where XLA's CPU sum of
    the costs is windowed: the port's allocation equals the reference's
    exactly, sums to t and stays non-negative."""
    cases = itertools.product((2, 3, 7, 9, 16, 33, 100, 128),
                              (1, 10, 100, 512),
                              range(-30, 39, 4), (0, 1))
    for n_sites, t, log_scale, seed in cases:
        rng = np.random.default_rng(seed * 1000 + n_sites)
        costs = (rng.random(n_sites) * (10.0 ** log_scale)).astype(
            np.float32)
        j, p = _alloc_both(costs, t)
        np.testing.assert_array_equal(p, j, err_msg=str((costs, t)))
        assert p.sum() == t and (p >= 0).all()


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 64, 100, 128, 1000, 5000])
def test_windowed_sum_is_bit_equal_to_jnp_sum(n):
    """The allocation's total follows jnp.sum on the CPU bit for bit: left
    to right up to 32 elements, windows of 32 above (float32 vectors over
    eleven decades, several draws)."""
    for seed in range(8):
        rng = np.random.default_rng(10 * n + seed)
        x = (rng.random(n) * 10.0 ** rng.integers(-5, 6, n)).astype(
            np.float32)
        got = coreset._windowed_sum(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == ()
        assert np.float32(got) == np.float32(jnp.sum(jnp.asarray(x))), (
            n, seed)


def test_distributed_coreset_t_i_at_100_sites_equals_reference():
    """The paper's 100 sites (t = 15,000, as in its evaluation): the port's
    Round-1 costs, fed to the reference's allocation, give the port's t_i
    exactly, and the Round-2 total is jnp.sum's."""
    rng = np.random.default_rng(7)
    data = (rng.standard_normal((3000, 4)) * rng.random((3000, 1)) * 5
            ).astype(np.float32)
    sp, sm = pad_partition(data, partition_indices(data, 100, "weighted",
                                                   seed=2))
    t = 15000
    p = coreset.distributed_coreset(prng.PRNGKey(4), sp, sm, 3, t,
                                    t_buffer=512, lloyd_iters=2,
                                    device="cpu")
    costs = p.local_costs.numpy()
    assert costs.shape == (100,) and (costs >= 0).all()
    want = np.asarray(jcoreset.proportional_allocation(jnp.asarray(costs),
                                                       t))
    np.testing.assert_array_equal(p.t_i.numpy(), want)
    assert int(p.t_i.sum()) == t
    assert np.float32(coreset._windowed_sum(p.local_costs)) == np.float32(
        jnp.sum(jnp.asarray(costs)))


# -- sampling -------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 16, 17, 100, 2000, 20001])
def test_cumsum_is_bit_equal_to_jnp_cumsum(n):
    """The inverse-CDF draws need the reference's exact CDF: the port's
    prefix sum follows XLA's CPU scan order."""
    rng = np.random.default_rng(n)
    x = (rng.random((3, n)) ** 3 * 100).astype(np.float32)
    np.testing.assert_array_equal(
        coreset._cumsum(torch.from_numpy(x)).numpy(),
        np.asarray(jax.vmap(jnp.cumsum)(jnp.asarray(x))))


def test_weighted_choice_is_bit_equal():
    rng = np.random.default_rng(1)
    masses = (rng.random(5000) ** 4).astype(np.float32)
    masses[::7] = 0.0
    key = jax.random.PRNGKey(5)
    j = np.asarray(jcoreset.weighted_choice(key, jnp.asarray(masses), 777))
    p = coreset.weighted_choice(interop.key(np.asarray(key), "cpu"),
                                torch.from_numpy(masses), 777).numpy()
    np.testing.assert_array_equal(p, j)
    assert not np.isin(p, np.nonzero(masses == 0)[0]).any()


def test_seeding_is_bit_equal_across_sites(sites, jax_round1):
    """D^2 seeding for all sites at once (one backend call per step) draws
    the same seed rows as the reference's vmapped kmeans_pp_init."""
    sp, sm = sites
    keys, _ = jax_round1
    j = jax.vmap(lambda ki, p, w: jclustering.kmeans_pp_init(
        ki, p, K, weights=w, backend="jnp"))(
        keys[:, 0], jnp.asarray(sp), jnp.asarray(sm, jnp.float32))
    p = clustering._kmeans_pp_init(
        interop.key(np.asarray(keys[:, 0]), "cpu"), torch.from_numpy(sp),
        torch.from_numpy(sm).float(), K, objective.KMEANS,
        backend.get_backend("torch"))
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_round1_matches_reference(sites, jax_round1):
    """Round 1 over all sites: seeds equal, then Lloyd and sensitivities
    agree to float32 rounding. Local costs within 1e-4 relative: the two
    libraries sum distances in different orders, and a near-tie argmin in
    one site's Lloyd step can move its solution slightly."""
    sp, sm = sites
    keys, (c_j, m_j, a_j, lc_j, w_j) = jax_round1
    c, m, a, lc, w = coreset.round1_local_solves(
        interop.key(np.asarray(keys[:, 0]), "cpu"), torch.from_numpy(sp),
        torch.from_numpy(sm).float(), K, "kmeans", 5, "torch")
    np.testing.assert_allclose(lc.numpy(), lc_j, rtol=1e-4)
    np.testing.assert_allclose(c.numpy(), c_j, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(w.numpy(), w_j)
    assert (a.numpy() == a_j)[sm].mean() > 0.999


def test_round2_slot_by_slot_given_reference_round1(sites, jax_round1):
    """Round 2 on the JAX package's Round-1 state, carried across: every
    slot draws the same point (indices exact) and carries the same weight
    to float32 rounding (rtol 1e-5: the center weights are sums in another
    order)."""
    sp, sm = sites
    keys, (c_j, m_j, a_j, lc_j, w_j) = jax_round1
    t = 400
    t_i = jcoreset.proportional_allocation(jnp.asarray(lc_j), t)
    totals = jnp.broadcast_to(jnp.sum(jnp.asarray(lc_j)), (9,))
    ref = jcoreset.round2_local_samples(
        keys[:, 1], jnp.asarray(sp), jnp.asarray(m_j), jnp.asarray(w_j),
        jnp.asarray(a_j), jnp.asarray(c_j), t_i, totals, k=K, t=t,
        t_buffer=t, clip_negative=False)
    port = coreset.round2_local_samples(
        interop.key(np.asarray(keys[:, 1]), "cpu"), torch.from_numpy(sp),
        interop.tensor(m_j, "cpu"), interop.tensor(w_j, "cpu"),
        interop.tensor(a_j, "cpu"), interop.tensor(c_j, "cpu"),
        interop.tensor(np.asarray(t_i), "cpu"),
        interop.tensor(np.asarray(totals), "cpu"), K, t, t, False)
    np.testing.assert_array_equal(port.points.numpy(),
                                  np.asarray(ref.points))
    np.testing.assert_allclose(port.weights.numpy(), np.asarray(ref.weights),
                               rtol=1e-5, atol=1e-6)
    # exact zeros stay exact zeros (the fixed-slot layout)
    np.testing.assert_array_equal(port.weights.numpy() == 0,
                                  np.asarray(ref.weights) == 0)


def test_sample_and_weight_slot_by_slot(sites, jax_round1):
    """One site's draws and weights through the shared helper."""
    sp, _ = sites
    keys, (c_j, m_j, a_j, lc_j, w_j) = jax_round1
    s = 7
    tm = float(lc_j.sum())
    samp, w_s, w_b = jcoreset._sample_and_weight(
        keys[s, 1], jnp.asarray(sp[s]), jnp.asarray(m_j[s]),
        jnp.asarray(w_j[s]), jnp.asarray(a_j[s]), K, jnp.asarray(31), 64,
        jnp.asarray(tm, jnp.float32), jnp.asarray(400.0))
    p_samp, p_ws, p_wb = coreset._sample_and_weight(
        interop.key(np.asarray(keys[s:s + 1, 1]), "cpu"),
        torch.from_numpy(sp[s:s + 1]), interop.tensor(m_j[s:s + 1], "cpu"),
        interop.tensor(w_j[s:s + 1], "cpu"),
        interop.tensor(a_j[s:s + 1], "cpu"), K, torch.tensor([31]), 64,
        torch.tensor([tm], dtype=torch.float32), torch.tensor([400.0]))
    np.testing.assert_array_equal(p_samp[0].numpy(), np.asarray(samp))
    np.testing.assert_allclose(p_ws[0].numpy(), np.asarray(w_s), rtol=1e-5)
    np.testing.assert_allclose(p_wb[0].numpy(), np.asarray(w_b), rtol=1e-5,
                               atol=1e-3)
    assert int((p_ws[0] > 0).sum()) == 31


def test_distributed_coreset_allocation_and_weight_identity(sites):
    """t_i equals the reference's exactly and the coreset preserves the
    total weight |P| (the signed center weights cancel the samples)."""
    sp, sm = sites
    key = jax.random.PRNGKey(2)
    j = jcoreset.distributed_coreset(key, jnp.asarray(sp), jnp.asarray(sm),
                                     K, 300, backend="jnp")
    p = coreset.distributed_coreset(interop.key(np.asarray(key), "cpu"), sp,
                                    sm, K, 300, device="cpu")
    np.testing.assert_array_equal(p.t_i.numpy(), np.asarray(j.t_i))
    assert int(p.t_i.sum()) == 300
    assert abs(float(p.weights.double().sum()) - sm.sum()) < 0.5
    assert p.points.shape == (9, 300 + K, 10)


def test_distributed_coreset_carried_across_flattens_alike(sites):
    sp, sm = sites
    j = jcoreset.distributed_coreset(jax.random.PRNGKey(6), jnp.asarray(sp),
                                     jnp.asarray(sm), K, 100, backend="jnp")
    p = interop.distributed_coreset(np.asarray(j.points),
                                    np.asarray(j.weights), np.asarray(j.t_i),
                                    np.asarray(j.local_costs), "cpu")
    flat_j, flat_p = j.flatten(), p.flatten()
    np.testing.assert_array_equal(flat_p.points.numpy(),
                                  np.asarray(flat_j.points))
    np.testing.assert_array_equal(flat_p.weights.numpy(),
                                  np.asarray(flat_j.weights))
    assert p.t_i.dtype == torch.int32 and int(p.t_i.sum()) == 100


def test_public_primitives_match_reference(sites):
    """clustering.min_dist_argmin / lloyd_stats / point_costs / cost / lloyd
    on one site against the reference's (float32 tolerances of
    tests/test_kernels.py)."""
    sp, sm = sites
    pts, w = sp[0], sm[0].astype(np.float32)
    ctr = pts[:K]
    md, am = clustering.min_dist_argmin(pts, ctr, device="cpu")
    md_j, am_j = jclustering.min_dist_argmin(jnp.asarray(pts),
                                             jnp.asarray(ctr), backend="jnp")
    np.testing.assert_allclose(md.numpy(), np.asarray(md_j), rtol=1e-5,
                               atol=1e-4)
    pc, pa = clustering.point_costs(pts, ctr, device="cpu")
    np.testing.assert_array_equal(pc.numpy(), md.numpy())
    sums, counts, cost = clustering.lloyd_stats(pts, ctr, w, device="cpu")
    sums_j, counts_j, cost_j = jclustering.lloyd_stats(
        jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(w), backend="jnp")
    np.testing.assert_allclose(counts.numpy(), np.asarray(counts_j),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(
        float(clustering.cost(pts, ctr, w, device="cpu")),
        float(jclustering.cost(jnp.asarray(pts), jnp.asarray(ctr),
                               jnp.asarray(w), backend="jnp")), rtol=1e-5)
    c, hist = clustering.lloyd(pts, ctr, w, iters=3, device="cpu")
    c_j, hist_j = jclustering.lloyd(jnp.asarray(pts), jnp.asarray(ctr),
                                    jnp.asarray(w), iters=3, backend="jnp")
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(hist.numpy(), np.asarray(hist_j), rtol=1e-5)


def test_build_coreset_weight_identity():
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((600, 6)).astype(np.float32)
    cs = coreset.build_coreset(prng.PRNGKey(1), pts, 4, 50, device="cpu")
    assert cs.size == 54
    assert abs(float(cs.weights.double().sum()) - 600) < 0.05
    assert int(cs.effective_size()) <= 54


def test_coreset_concat_and_compact():
    a = coreset.Coreset(torch.ones(3, 2), torch.tensor([1.0, 0.0, 2.0]))
    b = coreset.Coreset(torch.zeros(2, 2), torch.tensor([0.0, 5.0]))
    u = coreset.Coreset.concat(a, b)
    assert u.size == 5 and float(u.weights.sum()) == 8.0
    c = u.compact(3)
    np.testing.assert_array_equal(c.weights.numpy(), [1.0, 2.0, 5.0])
    with pytest.raises(ValueError):
        coreset.Coreset.concat()


def test_unknown_strategy_and_objective_raise():
    """Unknown names raise; the ported strategies and parametrized
    objectives resolve."""
    assert strategy.resolve_name("mapreduce") == "mapreduce"
    assert strategy.resolve_name("cohen_addad") == "cohen_addad"
    with pytest.raises(ValueError, match="unknown strategy"):
        strategy.resolve_name("algorithm2")
    assert objective.resolve_name("power(3)") == "power(3)"
    assert objective.resolve_name("kmeans_trimmed(5)") == "kmeans_trimmed(5)"
    with pytest.raises(ValueError, match="unknown objective"):
        objective.resolve_name("kmeans ")
    with pytest.raises(ValueError, match="unknown objective"):
        objective.resolve_name("kmeans_trimmed(5.0)")
    assert objective.resolve_name(None) == "kmeans"
    assert strategy.resolve_name(None) == "algorithm1"
