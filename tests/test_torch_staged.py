"""The port's staged Round-1/Round-2 engine and the dispatch remainder
against the JAX package: every staged case of ``tests/test_collectives.py``
through both packages on the same seeded sites (6 weighted sites, k = 4,
d = 8), on the CPU.

In strict mode (``tol=0``, no buckets) the port's staged engine is held bit
for bit to the port's own lockstep ``distributed_coreset`` for every
strategy and objective, and its ``t_i`` to the reference's staged output
exactly (``cohen_addad`` within one sample: its refined totals sit near
integers, ROADMAP C). Its Round-1 scalars are held to the reference's
within ``tests/test_torch_coreset.py``'s 1e-4. Overlap mode (``tol > 0``,
site buckets) is held to the reference's overlap mode: the same bucket
lengths, passes per site and ``t_i``.

Strict parity is held at the reference test's sites (a 192-row pad). At
much larger sites the plain versions' batched matmuls on the CPU round by
batch size, so one site alone can differ in the last bits from the same
site inside the lockstep batch (ROADMAP C); the kernels compute every
site alone, and ``chip_smoke.py`` phase 9 holds strict mode on the card
at full width."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclustering
from repro.core import coreset as jcoreset
from repro.core.partition import pad_partition, partition_indices
from repro.kernels import ops as jops
from repro_torch.core import clustering, coreset, prng, strategy
from repro_torch.kernels import ops

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

KEY = prng.PRNGKey(0)
JKEY = jax.random.PRNGKey(0)
FIELDS = ("points", "weights", "t_i", "local_costs")
T = 200
STRATEGIES = ("algorithm1", "cohen_addad", "mapreduce")
OBJECTIVES = ("kmeans", "kmedian")


@pytest.fixture(scope="module")
def sites():
    """The reference staged tests' instance: 4 tight clusters of 150
    points in R^8 over 6 weighted sites."""
    rng = np.random.default_rng(0)
    k, d = 4, 8
    centers = 3.0 * rng.standard_normal((k, d))
    pts = np.concatenate(
        [centers[i] + 0.15 * rng.standard_normal((150, d)) for i in range(k)]
    ).astype(np.float32)
    idx = partition_indices(pts, 6, "weighted", seed=1)
    sp, sm = pad_partition(pts, idx)
    return pts, sp, sm, k


@pytest.fixture(scope="module")
def strict_runs(sites):
    """Per (strategy, objective): the port's lockstep and staged runs and
    the reference's staged run, all strict."""
    _, sp, sm, k = sites
    out = {}
    for strat in STRATEGIES:
        for obj in OBJECTIVES:
            base = coreset.distributed_coreset(KEY, sp, sm, k, T,
                                               objective=obj, strategy=strat,
                                               device="cpu")
            staged = coreset.staged_distributed_coreset(
                KEY, sp, sm, k, T, objective=obj, strategy=strat,
                device="cpu")
            ref = jcoreset.staged_distributed_coreset(
                JKEY, jnp.asarray(sp), jnp.asarray(sm), k, t=T,
                objective=obj, strategy=strat)
            out[strat, obj] = (base, staged, ref)
    return out


CASES = [(s, o) for s in STRATEGIES for o in OBJECTIVES]


@pytest.mark.parametrize("strat,obj", CASES, ids=[f"{s}-{o}" for s, o in
                                                  CASES])
def test_staged_strict_bit_parity(sites, strict_runs, strat, obj):
    """tol=0 and no buckets: every output field bit-identical to the
    port's lockstep path; every site solved at the lockstep pad with the
    lockstep pass count, and no convergence read."""
    _, sp, _, _ = sites
    base, (staged, detail), _ = strict_runs[strat, obj]
    for f in FIELDS:
        a, b = getattr(base, f), getattr(staged, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f"{f} differs"
    assert detail.site_lengths == (sp.shape[1],) * sp.shape[0]
    assert detail.iters_run.dtype == torch.int32
    assert (detail.iters_run == 5).all()
    assert detail.host_reads == 0
    assert detail.wall_round1_s > 0 and detail.wall_round2_s > 0
    assert detail.wall_total_s == detail.wall_round1_s + detail.wall_round2_s


@pytest.mark.parametrize("strat,obj", CASES, ids=[f"{s}-{o}" for s, o in
                                                  CASES])
def test_staged_strict_matches_reference_staged(sites, strict_runs, strat,
                                                obj):
    """Against the reference's staged engine: t_i exact (cohen_addad
    within one sample, summing to t), the Round-1 scalars within 1e-4,
    and both coresets carrying the data's mass."""
    pts, _, _, _ = sites
    _, (staged, detail), (ref, ref_detail) = strict_runs[strat, obj]
    t_p, t_j = staged.t_i.numpy(), np.asarray(ref.t_i)
    if strat == "cohen_addad":
        assert np.abs(t_p - t_j).max() <= 1 and t_p.sum() == t_j.sum() == T
    else:
        np.testing.assert_array_equal(t_p, t_j)
    np.testing.assert_allclose(staged.local_costs.numpy(),
                               np.asarray(ref.local_costs), rtol=1e-4)
    assert detail.site_lengths == ref_detail.site_lengths
    np.testing.assert_array_equal(detail.iters_run.numpy(),
                                  np.asarray(ref_detail.iters_run))
    np.testing.assert_allclose(float(staged.weights.double().sum()),
                               len(pts), rtol=1e-4)


@pytest.mark.parametrize("obj", OBJECTIVES)
def test_staged_overlap_mode_matches_reference(sites, obj):
    """tol=1e-3 with site buckets: deterministic across runs, sum t_i == t,
    the data's mass, the reference's bucket lengths, passes per site and
    t_i, each length a power of two or the lockstep pad, and a coreset
    whose solve stays within 1.3 of a centralized solve (the reference
    test's bound)."""
    pts, sp, sm, k = sites
    run = lambda: coreset.staged_distributed_coreset(
        KEY, sp, sm, k, T, objective=obj, tol=1e-3, site_buckets=True,
        device="cpu")
    cs1, d1 = run()
    cs2, d2 = run()
    for f in FIELDS:
        assert torch.equal(getattr(cs1, f), getattr(cs2, f)), f
    assert torch.equal(d1.iters_run, d2.iters_run)
    assert int(cs1.t_i.sum()) == T
    np.testing.assert_allclose(float(cs1.weights.double().sum()), len(pts),
                               rtol=1e-3)
    M = sp.shape[1]
    assert d1.site_lengths == ops.site_bucket_lengths(
        coreset._site_valid_lengths(sm.astype(np.float32)), M)
    for ln in d1.site_lengths:
        assert ln <= M and ((ln & (ln - 1)) == 0 or ln == M)
    assert (d1.iters_run <= 5).all()
    assert d1.host_reads == int(d1.iters_run.sum())
    jcs, jd = jcoreset.staged_distributed_coreset(
        JKEY, jnp.asarray(sp), jnp.asarray(sm), k, t=T, objective=obj,
        tol=1e-3, site_buckets=True)
    assert d1.site_lengths == jd.site_lengths
    np.testing.assert_array_equal(d1.iters_run.numpy(),
                                  np.asarray(jd.iters_run))
    np.testing.assert_array_equal(cs1.t_i.numpy(), np.asarray(jcs.t_i))
    flat = cs1.flatten()
    c, _ = clustering.solve(KEY, flat.points, k,
                            weights=torch.clamp_min(flat.weights, 0.0),
                            restarts=3, objective=obj, device="cpu")
    _, full = clustering.solve(KEY, pts, k, restarts=4, objective=obj,
                               device="cpu")
    ratio = float(clustering.cost(pts, c, objective=obj, device="cpu")
                  / full)
    assert ratio < 1.3, ratio


def test_staged_calls_the_site_sensitivities_hook(sites):
    """The strategy's per-site hooks serve the staged solves, once per
    site (the lockstep path batches all sites through ``summary``)."""
    _, sp, sm, k = sites
    calls = []
    strat = strategy.COHEN_ADDAD
    orig = strat.site_sensitivities_fn

    def counted(s, pts, centers, w, **kw):
        calls.append(tuple(pts.shape))
        return orig(s, pts, centers, w, **kw)

    object.__setattr__(strat, "site_sensitivities_fn", counted)
    try:
        coreset.staged_distributed_coreset(KEY, sp, sm, k, T,
                                           strategy="cohen_addad",
                                           device="cpu")
    finally:
        object.__setattr__(strat, "site_sensitivities_fn", orig)
    assert calls == [(1, sp.shape[1], sp.shape[2])] * sp.shape[0]


def test_staged_weighted_sites_and_clip(sites):
    """``site_weights`` replaces the mask and ``clip_negative`` clips the
    centre weights, as in the lockstep path, bit for bit."""
    _, sp, sm, k = sites
    rng = np.random.default_rng(5)
    sw = (sm * rng.uniform(0.5, 2.0, sm.shape)).astype(np.float32)
    kw = dict(site_weights=sw, clip_negative=True, t_buffer=T + 40,
              device="cpu")
    base = coreset.distributed_coreset(KEY, sp, sm, k, T, **kw)
    staged, _ = coreset.staged_distributed_coreset(KEY, sp, sm, k, T, **kw)
    for f in FIELDS:
        assert torch.equal(getattr(base, f), getattr(staged, f)), f
    assert staged.points.shape == (sp.shape[0], T + 40 + k, sp.shape[2])


# -- lloyd_converged ----------------------------------------------------------

def test_lloyd_converged_strict_matches_lloyd():
    """tol=0 is lloyd itself, bit for bit, with iters_run = iters; the
    centres match the reference's strict run to 1e-4."""
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((300, 5)).astype(np.float32)
    init = jclustering.kmeans_pp_init(JKEY, jnp.asarray(pts), 4)
    ref, _ = clustering.lloyd(pts, np.asarray(init), iters=6, device="cpu")
    out, iters_run = clustering.lloyd_converged(pts, np.asarray(init),
                                                iters=6, tol=0.0,
                                                device="cpu")
    assert torch.equal(out, ref)
    assert iters_run.dtype == torch.int32 and int(iters_run) == 6
    j, ji = jclustering.lloyd_converged(jnp.asarray(pts), init, iters=6,
                                        tol=0.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-4)
    assert int(ji) == 6


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_lloyd_converged_early_exit_matches_reference(objective):
    """Three tight blobs converge within a few passes: the same pass count
    as the reference, the centres within 1e-4 of its, and the cost within
    1e-2 of 50 fixed passes (the reference test's bound)."""
    rng = np.random.default_rng(1)
    pts = np.concatenate([c + 0.05 * rng.standard_normal((100, 3))
                          for c in (np.zeros(3), 10 * np.ones(3),
                                    -10 * np.ones(3))]).astype(np.float32)
    init = np.asarray(jclustering.kmeans_pp_init(JKEY, jnp.asarray(pts), 3,
                                                 objective=objective))
    ref, _ = clustering.lloyd(pts, init, iters=50, objective=objective,
                              device="cpu")
    out, iters_run = clustering.lloyd_converged(
        pts, init, iters=50, tol=1e-3, objective=objective, device="cpu")
    j, ji = jclustering.lloyd_converged(jnp.asarray(pts), jnp.asarray(init),
                                        iters=50, tol=1e-3,
                                        objective=objective)
    assert int(iters_run) == int(ji) < 50
    np.testing.assert_allclose(out.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        float(clustering.cost(pts, out, objective=objective, device="cpu")),
        float(clustering.cost(pts, ref, objective=objective, device="cpu")),
        rtol=1e-2)


def test_lloyd_converged_sites_stop_independently():
    """With a leading site axis each site stops on its own test: its
    centres and pass count are those of its own unbatched run."""
    rng = np.random.default_rng(2)
    tight = np.concatenate([c + 0.01 * rng.standard_normal((40, 2))
                            for c in (np.zeros(2), 8 * np.ones(2))])
    loose = rng.standard_normal((80, 2)) * 3.0
    pts = np.stack([tight, loose]).astype(np.float32)
    init = pts[:, [0, 45]].copy()
    out, runs = clustering.lloyd_converged(pts, init, iters=30, tol=1e-6,
                                           device="cpu")
    for s in range(2):
        o, r = clustering.lloyd_converged(pts[s], init[s], iters=30,
                                          tol=1e-6, device="cpu")
        assert torch.equal(out[s], o) and int(runs[s]) == int(r)
    assert int(runs[0]) < int(runs[1])


# -- site buckets and the dispatch remainder ---------------------------------

@pytest.mark.parametrize("counts,max_len,min_bucket", [
    ((3, 70, 500), 512, 64), ((400,), 300, 64), ((1,), 512, 16),
    ((0, 64, 65, 4096), 5000, 64)])
def test_site_bucket_lengths_match_reference(counts, max_len, min_bucket):
    assert ops.site_bucket_lengths(counts, max_len, min_bucket) == \
        jops.site_bucket_lengths(counts, max_len, min_bucket=min_bucket)


def test_site_valid_lengths_match_reference(sites):
    """Covering counts of every nonzero-weight slot, an all-zero site
    counting 1, as the reference computes them."""
    _, _, sm, _ = sites
    w = sm.astype(np.float32)
    w[2] = 0.0
    w[3, 5] = -1.5            # a signed slot past the packed prefix
    assert coreset._site_valid_lengths(torch.from_numpy(w)) == \
        jcoreset._site_valid_lengths(jnp.asarray(w))


def test_dispatch_remainder_matches_reference():
    """``ops.lloyd_step``, ``clustering.pairwise_sq_dists`` and
    ``clustering.weiszfeld_stats`` on the plain versions against the
    reference's, with tests/test_kernels.py's tolerances; an empty,
    negative-mass cluster keeps its centre."""
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((500, 7)).astype(np.float32)
    ctr = rng.standard_normal((6, 7)).astype(np.float32)
    ctr[5] = 50.0                                     # an empty cluster
    w = rng.uniform(0.5, 2.0, 500).astype(np.float32)
    new, cost = ops.lloyd_step(torch.from_numpy(pts), torch.from_numpy(ctr),
                               torch.from_numpy(w))
    jnew, jcost = jops.lloyd_step(jnp.asarray(pts), jnp.asarray(ctr),
                                  jnp.asarray(w))
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-5)
    assert torch.equal(new[5], torch.from_numpy(ctr[5]))
    d2 = clustering.pairwise_sq_dists(pts, ctr, device="cpu")
    np.testing.assert_allclose(
        d2.numpy(), np.asarray(jclustering.pairwise_sq_dists(
            jnp.asarray(pts), jnp.asarray(ctr))), rtol=1e-5, atol=1e-3)
    assert d2.shape == (500, 6) and bool((d2 >= 0).all())
    got = clustering.weiszfeld_stats(pts, ctr, w, backend="torch",
                                     device="cpu")
    want = jclustering.weiszfeld_stats(jnp.asarray(pts), jnp.asarray(ctr),
                                       jnp.asarray(w), backend="jnp")
    for x, y, tol in zip(got, want, (1e-2, 1e-3, 1e-4)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                   atol=tol)
