"""The port's trimmed and power objectives against the JAX package's: the
trim count and mask (exact, ties, signed zeros, dead slots, NaN, fractions,
a site axis), the parametrized names, each hook at z in {0.5, 1.5, 3}, the
seeding rows, and Algorithm 2 end to end on both routes -- the power
objectives on the plain instance and on the one with far-field outliers,
where the cause of their divergence is held stage by stage."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import clustering as jclustering
from repro.core import coreset as jcoreset
from repro.core import distributed as jdistributed
from repro.core import objective as jobjective
from repro.core import partition as jpartition
from repro.core import strategy as jstrategy
from repro.core import topology as jtopology
from repro_torch import interop
from repro_torch.core import (backend, clustering, coreset, distributed,
                              objective, prng, topology)

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

K, T = 5, 400
ZS = [0.5, 1.5, 3.0]
TRIMS = [0, 3, 16, 0.05, 0.5]


class _Given:
    """A backend whose ``min_dist_argmin`` returns fixed outputs (the
    reference's, carried across) and whose other ops are the port's plain
    ones: it isolates a hook's own arithmetic from the distance pass."""

    def __init__(self, d2, assign):
        self.d2, self.assign = d2, assign
        self.plain = backend.get_backend("torch")

    def min_dist_argmin(self, points, centers):
        return self.d2, self.assign

    def lloyd_stats(self, points, centers, weights=None):
        return self.plain.lloyd_stats(points, centers, weights)


def _data(n=600, k=7, d=6, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    pts[: n // 50] *= 12.0           # a few far-field outliers
    ctr = (rng.standard_normal((k, d)) * 0.8).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < 0.1] = 0.0     # dead slots
    return pts, ctr, w


# -- the trim count and mask --------------------------------------------------

class _T:
    def __init__(self, t):
        self.t_outliers = t


@pytest.mark.parametrize("t", [0, 1, 7, 10**6, 0.05, 0.5, 0.999, 1e-4,
                               1 / 3, 0.0125])
def test_resolve_trim_count_matches_reference(t):
    live = np.asarray([0, 1, 2, 3, 7, 8, 10, 40, 79, 80, 81, 400, 1001,
                       20000, 99999, 2**24 - 1], np.int32)
    j = np.asarray(jax.vmap(lambda c: jobjective.resolve_trim_count(
        _T(t), c))(jnp.asarray(live)))
    p = objective.resolve_trim_count(_T(t), torch.from_numpy(live))
    assert p.dtype == torch.int32
    np.testing.assert_array_equal(p.numpy(), j)


def _mask_cases():
    rng = np.random.default_rng(3)
    ties = np.repeat(rng.random(8).astype(np.float32), 5)
    zeros = np.asarray([0.0, -0.0, 0.0, -0.0, 1.0, -0.0, 0.0, 2.0],
                       np.float32)
    nan = rng.random(20).astype(np.float32)
    nan[[3, 11]] = np.nan
    dead_big = rng.random(50).astype(np.float32)
    dead_w = (rng.random(50) < 0.7).astype(np.float32)
    dead_big[dead_w == 0] += 100.0
    return [
        ("ties", ties, None),
        ("ties, weighted", ties, (rng.random(40) < 0.8).astype(np.float32)),
        ("signed zeros", zeros, None),
        ("signed zeros, signed weights", zeros,
         np.asarray([1, -1, 0, 2, 1, -0.0, 1, 1], np.float32)),
        ("NaN residuals", nan, None),
        ("dead slots hold the largest residuals", dead_big, dead_w),
        ("all dead", rng.random(9).astype(np.float32),
         np.zeros(9, np.float32)),
        ("negative residuals", (rng.random(30) - 0.5).astype(np.float32),
         None),
    ]


@pytest.mark.parametrize("t", [0, 1, 3, 100, 0.05, 0.2, 0.5])
@pytest.mark.parametrize("case", range(len(_mask_cases())))
def test_trim_mask_matches_reference(case, t):
    _, resid, w = _mask_cases()[case]
    jw = None if w is None else jnp.asarray(w)
    pw = None if w is None else torch.from_numpy(w)
    j = np.asarray(jobjective.trim_mask(_T(t), jnp.asarray(resid), jw))
    p = objective.trim_mask(_T(t), torch.from_numpy(resid), pw)
    np.testing.assert_array_equal(p.numpy(), j)


def test_trim_mask_site_axis_matches_vmapped_reference():
    rng = np.random.default_rng(5)
    resid = rng.random((6, 333)).astype(np.float32)
    resid[:, ::9] = resid[:, :1]     # ties across each row
    w = (rng.random((6, 333)) < 0.6).astype(np.float32)
    w[2] = 0.0
    for t in (4, 0.1):
        j = jax.vmap(lambda r, wi: jobjective.trim_mask(_T(t), r, wi))(
            jnp.asarray(resid), jnp.asarray(w))
        p = objective.trim_mask(_T(t), torch.from_numpy(resid),
                                torch.from_numpy(w))
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


# -- the registry -------------------------------------------------------------

NAMES = ["kmeans_trimmed(16)", "kmeans_trimmed(0.05)", "kmeans_trimmed(0)",
         "kmeans_trimmed(1e-05)", "power(1.5)", "power(0.5)", "power(3)",
         "power(1)", "power(2)"]


@pytest.mark.parametrize("name", NAMES)
def test_parametrized_names_resolve_as_in_the_reference(name):
    assert objective.resolve_name(name) == jobjective.resolve_name(name)
    p, j = objective.get_objective(name), jobjective.get_objective(name)
    assert (p.name, p.power_z, p.t_outliers) == (j.name, j.power_z,
                                                 j.t_outliers)
    assert name in objective.available_objectives()


def test_factories_match_reference():
    for t in (16, 16.0, 0.05, 3):
        assert (objective.kmeans_trimmed(t).name
                == jobjective.kmeans_trimmed(t).name)
    for z in (1, 1.5, 2.0, 3):
        assert (objective.power_objective(z).name
                == jobjective.power_objective(z).name)
    # z = 1 and z = 2 take the fused steps, other z the IRLS step
    assert (objective.power_objective(2).update_stats
            is objective._kmeans_update_stats)
    assert (objective.power_objective(1).update_stats
            is objective._weiszfeld_update_stats)
    assert (objective.power_objective(3).update_stats
            is objective._power_update_stats)


@pytest.mark.parametrize("name", ["kmeans_trimmed(2.0)", "kmeans_trimmed(-1)",
                                  "kmeans_trimmed(1.5)", "power(0)",
                                  "power(-2)", "power(abc)", "powers(2)",
                                  "kmeans_trimmed()"])
def test_bad_parametrized_names_raise_as_in_the_reference(name):
    for module in (jobjective, objective):
        with pytest.raises(ValueError, match="unknown objective"):
            module.resolve_name(name)


def test_descriptor_validation_matches_reference():
    for module in (jobjective, objective):
        with pytest.raises(ValueError, match="power_z must be > 0"):
            module.Objective(name="bad_z", power_z=0.0)
        with pytest.raises(ValueError, match="does not support"):
            module.Objective(name="bad_t", t_outliers=3)
        with pytest.raises(ValueError, match="t_outliers must be"):
            module.kmeans_trimmed(-2)


# -- the hooks ----------------------------------------------------------------

@pytest.mark.parametrize("z", ZS)
def test_power_point_and_clamped_costs_match_reference(z):
    d2 = np.asarray([0.0, 1e-12, 1e-6, 0.25, 1.0, 4.0, 1e6, 3.3e30, -1e-7],
                    np.float32)
    j, p = jobjective.power_objective(z), objective.power_objective(z)
    np.testing.assert_allclose(
        p.clamped_cost(torch.from_numpy(d2)).numpy(),
        np.asarray(j.clamped_cost(jnp.asarray(d2))), rtol=3e-7, atol=0)
    np.testing.assert_allclose(
        p.per_point_cost(torch.from_numpy(d2)).numpy(),
        np.asarray(j.per_point_cost(jnp.asarray(d2))), rtol=3e-7, atol=0)


def _both(name, hook, pts, ctr, w, given=False):
    """A hook on the reference (jnp backend) and on the port (plain torch
    backend, or -- ``given`` -- fed the reference's distance pass)."""
    j_obj, p_obj = jobjective.get_objective(name), objective.get_objective(
        name)
    jb = jbackend.get_backend("jnp")
    pj, cj, wj = jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(w)
    pt, ct, wt = (torch.from_numpy(x) for x in (pts, ctr, w))
    if given:
        d2, a = jb.min_dist_argmin(pj, cj)
        pb = _Given(torch.from_numpy(np.array(d2)),
                    torch.from_numpy(np.array(a)))
    else:
        pb = backend.get_backend("torch")
    if hook == "seeding":
        mind = np.random.default_rng(1).random(len(w)).astype(np.float32)
        return (np.asarray(j_obj.seeding(wj, jnp.asarray(mind))),
                p_obj.seeding(wt, torch.from_numpy(mind)).numpy())
    j = getattr(j_obj, hook)(jb, pj, *((wj, cj) if hook == "update"
                                       else (cj, wj)))
    p = getattr(p_obj, hook)(pb, pt, *((wt, ct) if hook == "update"
                                       else (ct, wt)))
    return ([np.asarray(x) for x in j], [x.numpy() for x in p])


@pytest.mark.parametrize("z", ZS)
@pytest.mark.parametrize("seed", [0, 1])
def test_power_update_matches_reference(z, seed):
    """One IRLS step: centres and cost within 1e-5 (float32 sums and
    products in another order)."""
    pts, ctr, w = _data(seed=seed)
    for weights in (w, 2.0 * w - 1.0):
        (cj, costj), (cp, costp) = _both(f"power({z:g})", "update", pts, ctr,
                                         weights.astype(np.float32))
        np.testing.assert_allclose(cp, cj, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(costp, costj, rtol=1e-5)


@pytest.mark.parametrize("z", [0.5, 1.5])
def test_power_update_at_coincident_centres_differs_only_by_the_distance(z):
    """A limit of parity: with centres on data points (as seeding leaves
    them) the matmul-form d2 of a point to its own centre is cancellation
    noise, 0 in one package and ~1e-5 in the other, and for z < 2 the IRLS
    mass (d2 + 1e-6)^((z-2)/2) of that point turns the noise into a weight
    change of up to 2x. Fed the reference's distance pass, the port's
    step is the reference's to 1e-5."""
    pts, _, w = _data(seed=2)
    ctr = pts[[5, 50, 100, 200, 300, 400, 500]].copy()
    (cj, costj), (cp, costp) = _both(f"power({z:g})", "update", pts, ctr, w,
                                     given=True)
    np.testing.assert_allclose(cp, cj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(costp, costj, rtol=1e-5)


@pytest.mark.parametrize("z", ZS)
def test_power_sensitivities_and_seeding_mass_match_reference(z):
    pts, ctr, w = _data(seed=3)
    (mj, aj, wj), (mp, ap, wp) = _both(f"power({z:g})", "sensitivities",
                                       pts, ctr, w)
    np.testing.assert_array_equal(ap, aj)
    np.testing.assert_array_equal(wp, wj)
    np.testing.assert_allclose(mp, mj, rtol=1e-4, atol=1e-6)
    j, p = _both(f"power({z:g})", "seeding", pts, ctr, w)
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("t", TRIMS)
def test_trimmed_update_matches_reference(t):
    """The two-pass trimmed Lloyd step: the same points trimmed (the
    update fed the reference's distance pass gives its centres to 1e-5),
    and with the port's own distance pass centres and cost within 1e-5."""
    pts, ctr, w = _data(seed=4)
    name = objective.kmeans_trimmed(t).name
    for given in (True, False):
        (cj, costj), (cp, costp) = _both(name, "update", pts, ctr, w,
                                         given=given)
        np.testing.assert_allclose(cp, cj, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(costp, costj, rtol=1e-5)


@pytest.mark.parametrize("t", TRIMS)
def test_trimmed_costs_sensitivities_and_seeding_mass_match_reference(t):
    pts, ctr, w = _data(seed=5)
    name = objective.kmeans_trimmed(t).name
    (mj, aj, wj), (mp, ap, wp) = _both(name, "sensitivities", pts, ctr, w)
    np.testing.assert_array_equal(ap, aj)
    np.testing.assert_array_equal(wp, wj)      # the same points trimmed
    np.testing.assert_allclose(mp, mj, rtol=1e-5, atol=1e-6)
    (cj, aj), (cp, ap) = _both(name, "costs", pts, ctr, w)
    np.testing.assert_array_equal(cp == 0, cj == 0)
    np.testing.assert_allclose(cp, cj, rtol=1e-5, atol=1e-6)
    j, p = _both(name, "seeding", pts, ctr, w)
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("name", ["kmeans_trimmed(0.05)", "kmeans_trimmed(3)",
                                  "power(0.5)", "power(1.5)", "power(3)"])
def test_seeding_picks_the_reference_rows_across_sites(name):
    """D^z seeding for three sites at once (one backend call per step)
    draws the rows of the reference's vmapped kmeans_pp_init."""
    rng = np.random.default_rng(6)
    pts = rng.standard_normal((3, 400, 5)).astype(np.float32)
    pts[:, :6] *= 10.0
    w = (rng.random((3, 400)) < 0.9).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    j = jax.vmap(lambda ki, p, wi: jclustering.kmeans_pp_init(
        ki, p, 6, weights=wi, objective=name, backend="jnp"))(
        keys, jnp.asarray(pts), jnp.asarray(w))
    p = clustering._kmeans_pp_init(
        interop.key(np.asarray(keys), "cpu"), torch.from_numpy(pts),
        torch.from_numpy(w), 6, objective.get_objective(name),
        backend.get_backend("torch"))
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))


# -- Algorithm 2 end to end ---------------------------------------------------

E2E = ["kmeans_trimmed(0.05)", "kmeans_trimmed(20)", "power(1.5)",
       "power(3)"]


def _quickstart(outliers):
    """The quickstart instance (20,000 x 10, k = 5, 9 weighted sites),
    with ``outliers`` far-field points (18 x the unit normal) appended."""
    rng = np.random.default_rng(0)
    centers = 3.0 * rng.standard_normal((K, 10))
    data = np.concatenate(
        [c + 0.2 * rng.standard_normal((4000, 10)) for c in centers]
        + [18.0 * rng.standard_normal((outliers, 10))]).astype(np.float32)
    sp, sm = jpartition.pad_partition(
        data, jpartition.partition_indices(data, 9, "weighted", seed=1))
    return data, sp, sm


@pytest.fixture(scope="module")
def instances():
    """The trimmed objectives run on the quickstart instance with 200
    outliers (what trimming is for), the power objectives on the plain
    quickstart instance of the k-means and k-median pipeline tests here
    and on the outlier instance in the ``outlier_runs`` tests below."""
    return {"trimmed": _quickstart(200), "power": _quickstart(0)}


def _instance(instances, name):
    return instances["trimmed" if name.startswith("kmeans_trimmed")
                     else "power"]


@pytest.fixture(scope="module")
def runs(instances):
    jg, tg = jtopology.grid(3, 3), topology.grid(3, 3)
    jkey, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0)
    k1 = jax.random.split(jkey)[0]
    out = {}
    for name in E2E:
        _, sp, sm = _instance(instances, name)
        for routing in ("flood", "bfs"):
            out[name, routing] = (
                jdistributed.graph_distributed_kmeans(
                    jkey, jnp.asarray(sp), jnp.asarray(sm), K, T, jg,
                    objective=name, routing=routing, backend="jnp"),
                distributed.graph_distributed_kmeans(
                    tkey, sp, sm, K, T, tg, objective=name, routing=routing,
                    device="cpu"))
        out[name, "coreset"] = (
            jcoreset.distributed_coreset(k1, jnp.asarray(sp),
                                         jnp.asarray(sm), K, T,
                                         objective=name, lloyd_iters=8,
                                         backend="jnp"),
            coreset.distributed_coreset(interop.key(np.asarray(k1), "cpu"),
                                        sp, sm, K, T, objective=name,
                                        lloyd_iters=8, device="cpu"))
    return out


@pytest.mark.parametrize("name", E2E)
def test_t_i_exactly_equal(runs, name):
    j, p = runs[name, "coreset"]
    np.testing.assert_array_equal(p.t_i.numpy(), np.asarray(j.t_i))
    assert int(p.t_i.sum()) == T


@pytest.mark.parametrize("route", ["flood", "bfs"])
@pytest.mark.parametrize("name", E2E)
def test_ledgers_exactly_equal(runs, name, route):
    j, p = runs[name, route]
    assert p.ledger.as_dict(by_phase=True) == j.ledger.as_dict(by_phase=True)


@pytest.mark.parametrize("route", ["flood", "bfs"])
@pytest.mark.parametrize("name", E2E[:2])
def test_trimmed_centers_match_reference(runs, name, route):
    """Within test_torch_pipeline.py's 1e-3."""
    j, p = runs[name, route]
    np.testing.assert_allclose(p.centers.numpy(), np.asarray(j.centers),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", E2E[2:])
def test_power_pipeline_against_reference(instances, runs, name):
    """power(z) end to end, where the centres are not held to 1e-3: the
    masses m_q = d2^(z/2) differ in the last bits, so a few inverse-CDF
    draws land on the neighbouring point (8 of 400 slots for power(1.5), 2
    for power(3), 2 for k-means on this instance), and the final IRLS
    solve on a 445-point coreset does not absorb that to 1e-3 (~1e-2
    measured). What holds: at
    least 97% of the sampled slots are the reference's points, the final
    solve on the reference's coreset is its solve to 1e-4 (6e-6 measured),
    and the full-data cost of the port's centres is the reference's to
    2e-3 relative (8.8e-4 and 6.4e-4 measured)."""
    data, _, _ = _instance(instances, name)
    jdc, pdc = runs[name, "coreset"]
    jw = np.asarray(jdc.weights)[:, :T]
    same = (np.asarray(jdc.points)[:, :T] == pdc.points.numpy()[:, :T]
            ).all(-1)
    assert same[jw != 0].mean() >= 0.97
    jres, pres = runs[name, "flood"]
    k2 = jax.random.split(jax.random.PRNGKey(0))[1]
    c_j = jdistributed._solve_on_coreset(k2, jres.coreset, K, name, 8, "jnp")
    cs = interop.coreset(np.asarray(jres.coreset.points),
                         np.asarray(jres.coreset.weights), "cpu")
    c_p = distributed._solve_on_coreset(interop.key(np.asarray(k2), "cpu"),
                                        cs, K, name, 8, "torch")
    j = float(jclustering.cost(jnp.asarray(data), jres.centers,
                               objective=name, backend="jnp"))
    p = float(clustering.cost(data, pres.centers, objective=name,
                              device="cpu"))
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_j), rtol=1e-4,
                               atol=1e-4)
    assert abs(p - j) <= 2e-3 * j


@pytest.mark.parametrize("name", E2E)
def test_routes_solve_the_same_centers(runs, name):
    assert torch.equal(runs[name, "flood"][1].centers,
                       runs[name, "bfs"][1].centers)


@pytest.mark.parametrize("name", E2E[:2])
def test_trimmed_coreset_drops_the_outliers(instances, runs, name):
    """The trimmed coreset's total weight is the live points less the
    trimmed ones (each site trims its own count; the outliers never fold
    back into a centre's weight). With 5% trimmed per site, more than the
    200 far-field points, none of them is sampled."""
    data, _, sm = instances["trimmed"]
    _, p = runs[name, "coreset"]
    live = sm.sum(1)
    t = objective.get_objective(name).t_outliers
    trimmed = (np.floor(np.float32(t) * live.astype(np.float32) + 0.5)
               if isinstance(t, float) else np.minimum(t, live))
    total = float(p.weights.double().sum())
    assert abs(total - (live.sum() - trimmed.sum())) < 1.0
    if isinstance(t, float):
        pts = p.points.numpy()[:, :T][p.weights.numpy()[:, :T] != 0]
        outliers = data[-200:]
        assert not (pts[:, None, :] == outliers[None]).all(-1).any()


# -- the power objectives on the outlier instance -----------------------------
#
# Far-field points change what the distance pass's rounding does. D^z
# seeding picks outliers as seeds (z = 3 weighs them most), and the
# matmul-form d2 of such a seed to its own point is cancellation noise of
# |p|^2 ~ 3,300: 0 in one package and 2 to 4 ulp of 3,300 (4.9e-4, 9.8e-4)
# in the other, either way round. The IRLS mass (d2 + 1e-6)^((z-2)/2) of
# that point is then 1e-3 against 2.2e-2 for z = 3, in a cluster of two
# far-field points ~59 apart, so the first step moves that centre ~1e-2
# away from the reference's. Round 1's centres end up to 5e-2 apart at two
# sites, 8 of 400 drawn slots differ, and the final D^3 solve can settle
# in another local optimum. Fed one exact-form distance pass, the two
# packages agree end to end (every slot, centres to 6e-6): the divergence
# is the distance pass's rounding, not the port's IRLS, sampling or
# solve.

POWER = E2E[2:]


def _direct_d2_jax(points, centers):
    p, c = points.astype(jnp.float32), centers.astype(jnp.float32)
    d2 = 0.0
    for j in range(p.shape[-1]):        # one (n, k) slab per coordinate
        e = p[..., :, None, j] - c[..., None, :, j]
        d2 = e * e if j == 0 else d2 + e * e
    return jnp.min(d2, -1), jnp.argmin(d2, -1).astype(jnp.int32)


def _direct_d2_torch(points, centers):
    p, c = points.float(), centers.float()
    d2 = 0.0
    for j in range(p.shape[-1]):
        e = p[..., :, None, j] - c[..., None, :, j]
        d2 = e * e if j == 0 else d2 + e * e
    m, a = d2.min(-1)
    return m, a.to(torch.int32)


class _DirectJax:
    """The exact-form distance sum_j (p_j - c_j)^2, left to right, for the
    JAX package: 0 at a coincident centre, and the same float32 operations
    in the same order as :class:`_DirectTorch`. The power objectives call
    no other backend op."""

    name = "direct_f32"

    def min_dist_argmin(self, points, centers):
        return _direct_d2_jax(points, centers)


class _DirectTorch:
    name = "direct_f32"

    def min_dist_argmin(self, points, centers):
        return _direct_d2_torch(points, centers)


# one instance each: a backend registers under its name on first use
_DIRECT = (_DirectJax(), _DirectTorch())


@pytest.fixture(scope="module")
def outlier_runs(instances):
    """power(z) on the 200-outlier instance, Algorithm 1 and the flood
    pipeline, with each package's own matmul-form distance pass
    ("plain") and with one exact-form pass in both ("direct")."""
    _, sp, sm = instances["trimmed"]
    jg, tg = jtopology.grid(3, 3), topology.grid(3, 3)
    k1 = jax.random.split(jax.random.PRNGKey(0))[0]
    out = {}
    for name in POWER:
        for kind, jb, pb in (("plain", "jnp", "torch"),
                             ("direct",) + _DIRECT):
            out[name, kind, "coreset"] = (
                jcoreset.distributed_coreset(
                    k1, jnp.asarray(sp), jnp.asarray(sm), K, T,
                    objective=name, lloyd_iters=8, backend=jb),
                coreset.distributed_coreset(
                    interop.key(np.asarray(k1), "cpu"), sp, sm, K, T,
                    objective=name, lloyd_iters=8, backend=pb,
                    device="cpu"))
            out[name, kind, "flood"] = (
                jdistributed.graph_distributed_kmeans(
                    jax.random.PRNGKey(0), jnp.asarray(sp), jnp.asarray(sm),
                    K, T, jg, objective=name, routing="flood", backend=jb),
                distributed.graph_distributed_kmeans(
                    prng.PRNGKey(0), sp, sm, K, T, tg, objective=name,
                    routing="flood", backend=pb, device="cpu"))
    return out


def _same_slots(jdc, pdc):
    jw = np.asarray(jdc.weights)[:, :T]
    same = (np.asarray(jdc.points)[:, :T] == pdc.points.numpy()[:, :T]
            ).all(-1)
    return same[jw != 0].mean()


@pytest.mark.parametrize("kind", ["plain", "direct"])
@pytest.mark.parametrize("name", POWER)
def test_power_on_outliers_t_i_and_ledger_exact(outlier_runs, name, kind):
    j, p = outlier_runs[name, kind, "coreset"]
    np.testing.assert_array_equal(p.t_i.numpy(), np.asarray(j.t_i))
    j, p = outlier_runs[name, kind, "flood"]
    assert p.ledger.as_dict(by_phase=True) == j.ledger.as_dict(by_phase=True)


@pytest.mark.parametrize("name", POWER)
def test_power_on_outliers_first_step_differs_only_at_coincident_seeds(
        instances, name):
    """Round 1, stage by stage, with each package's own distance pass:
    every site seeds on the reference's rows; one IRLS step from those
    seeds fed the reference's distance pass is the reference's step to
    1e-5 at every site; with the port's own pass, every centre more than
    1e-3 from the reference's (four sites for power(3)) is a seed on a
    data point whose self-distance is 0 in one package and not in the
    other."""
    _, sp, sm = instances["trimmed"]
    w = sm.astype(np.float32)
    keys = jstrategy.get_strategy("algorithm1").keys(
        jax.random.split(jax.random.PRNGKey(0))[0], sp.shape[0])[:, 0]
    seeds = np.array(jax.vmap(
        lambda ki, p, wi: jclustering.kmeans_pp_init(
            ki, p, K, weights=wi, objective=name, backend="jnp"))(
        keys, jnp.asarray(sp), jnp.asarray(w)))
    mine = clustering._kmeans_pp_init(
        interop.key(np.asarray(keys), "cpu"), torch.from_numpy(sp),
        torch.from_numpy(w), K, objective.get_objective(name),
        backend.get_backend("torch"))
    np.testing.assert_array_equal(mine.numpy(), seeds)
    jb, pb = jbackend.get_backend("jnp"), backend.get_backend("torch")
    j_obj, p_obj = (jobjective.get_objective(name),
                    objective.get_objective(name))
    moved = 0
    for s in range(sp.shape[0]):
        pts, ctr = sp[s], seeds[s]
        jd2, ja = jb.min_dist_argmin(jnp.asarray(pts), jnp.asarray(ctr))
        jd2, ja = np.array(jd2), np.array(ja)
        pd2, _ = pb.min_dist_argmin(torch.from_numpy(pts),
                                    torch.from_numpy(ctr))
        cj, _ = j_obj.update(jb, jnp.asarray(pts), jnp.asarray(w[s]),
                             jnp.asarray(ctr))
        cj = np.array(cj)
        given = _Given(torch.from_numpy(jd2), torch.from_numpy(ja))
        cg, _ = p_obj.update(given, torch.from_numpy(pts),
                             torch.from_numpy(w[s]), torch.from_numpy(ctr))
        np.testing.assert_allclose(cg.numpy(), cj, rtol=1e-5, atol=1e-5)
        cp, _ = p_obj.update(pb, torch.from_numpy(pts),
                             torch.from_numpy(w[s]), torch.from_numpy(ctr))
        for c in np.nonzero(np.abs(cp.numpy() - cj).max(1) > 1e-3)[0]:
            on = np.nonzero((w[s] > 0) & (pts == ctr[c]).all(1))[0]
            pd2_on = pd2.numpy()[on]
            assert ((jd2[on] == 0) != (pd2_on == 0)).any(), (s, c)
            moved += 1
    if name == "power(3)":
        assert moved >= 1


@pytest.mark.parametrize("name", POWER)
def test_power_on_outliers_same_distance_pass_same_result(instances,
                                                          outlier_runs, name):
    """Fed one exact-form distance pass, the two packages agree end to
    end: every drawn slot is the reference's point, the centres are its
    centres to 1e-4 (6e-6 measured) and the full-data cost its cost to
    1e-5 (at most 2.6e-7 measured)."""
    data, _, _ = instances["trimmed"]
    jdc, pdc = outlier_runs[name, "direct", "coreset"]
    assert _same_slots(jdc, pdc) == 1.0
    np.testing.assert_allclose(pdc.weights.numpy(), np.asarray(jdc.weights),
                               rtol=1e-4, atol=1e-4)
    j, p = outlier_runs[name, "direct", "flood"]
    np.testing.assert_allclose(p.centers.numpy(), np.asarray(j.centers),
                               rtol=1e-4, atol=1e-4)
    cj = float(jclustering.cost(jnp.asarray(data), j.centers,
                                objective=name, backend="jnp"))
    cp = float(clustering.cost(data, p.centers, objective=name,
                               device="cpu"))
    assert abs(cp - cj) <= 1e-5 * cj


@pytest.mark.parametrize("name", POWER)
def test_power_on_outliers_with_own_distance_passes(outlier_runs, name):
    """With each package's own distance pass, Round 1's divergence (the
    first-step test) reaches Round 2 only through the masses: at least 97%
    of the drawn slots are the reference's points (98% for power(3),
    99.75% for power(1.5)). The final solve is not held to the reference
    here (see the note above this section); its centres are finite."""
    jdc, pdc = outlier_runs[name, "plain", "coreset"]
    assert _same_slots(jdc, pdc) >= 0.97
    _, p = outlier_runs[name, "plain", "flood"]
    assert torch.isfinite(p.centers).all()
