"""The port's k-median slice against the JAX package: the Weiszfeld
statistics (plain version, wrapper, two-pass form, site axis), the k-median
update and seeding, and Algorithm 2 with ``objective="kmedian"`` on the
quickstart instance over both routes.

On the CPU the port's wrappers run their kernels' plain versions; the CUDA
kernel itself is held to them by ``tests/test_torch_cuda.py`` on a GPU."""
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
from repro.core import topology as jtopology
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import (backend, clustering, coreset, distributed,
                              objective, prng, topology)
from repro_torch.kernels import lloyd_update as lu_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import weiszfeld as wz_mod

# shapes of tests/test_kernels.py
SHAPES = [
    (8, 4, 3),
    (100, 5, 10),
    (256, 128, 128),
    (300, 17, 90),
    (1024, 50, 32),
    (513, 257, 129),
]
K, T = 5, 400


def _data(n, k, d, seed=0, signed=True):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    ctr = rng.standard_normal((k, d)).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32)
    return pts, ctr, (w if signed else np.abs(w))


def _assert_weiszfeld_close(got, want, atol=1e-3):
    """tests/test_kernels.py's float32 tolerances for the Weiszfeld
    statistics: the two libraries take the sums in other orders."""
    nums, denoms, cost = (np.asarray(x) for x in got)
    nums_j, denoms_j, cost_j = (np.asarray(x) for x in want)
    np.testing.assert_allclose(denoms, denoms_j, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(nums, nums_j, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(cost, cost_j, rtol=5e-3, atol=1e-3)


@pytest.mark.parametrize("n,k,d", SHAPES)
def test_weiszfeld_ref_matches_jax_ref(n, k, d):
    """Signed weights: max(w, 0) pulls, w counts in the cost."""
    pts, ctr, w = _data(n, k, d)
    got = ref.weiszfeld_stats_ref(*map(torch.from_numpy, (pts, ctr, w)))
    want = jref.weiszfeld_stats_ref(*map(jnp.asarray, (pts, ctr, w)))
    _assert_weiszfeld_close(got, want)


@pytest.mark.parametrize("n,k,d", [(300, 17, 90), (100, 5, 10)])
def test_weiszfeld_ref_coincident_centres_match_jax_ref(n, k, d):
    """Centres that are data rows: the exact-form distance is 0 on them in
    both libraries, and the inverse there is w / eta, not cancellation
    noise."""
    pts, _, w = _data(n, k, d, seed=1)
    ctr = pts[:k].copy()
    got = ref.weiszfeld_stats_ref(*map(torch.from_numpy, (pts, ctr, w)))
    want = jref.weiszfeld_stats_ref(*map(jnp.asarray, (pts, ctr, w)))
    _assert_weiszfeld_close(got, want, atol=1e-2)
    # each centre row pulls on its own centre with w / eta (d2 = 0)
    pull = np.maximum(w[:k], 0.0) / np.sqrt(np.float32(ref.WEISZFELD_ETA2))
    assert (got[1].numpy() >= pull * (1 - 1e-6)).all()
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.parametrize("n,k,d", SHAPES[:2])
def test_ops_weiszfeld_matches_pallas_kernel_in_interpret_mode(n, k, d):
    pts, ctr, w = _data(n, k, d, seed=3)
    got = ops.weiszfeld_stats(*map(torch.from_numpy, (pts, ctr, w)))
    want = jops.weiszfeld_stats(*map(jnp.asarray, (pts, ctr, w)),
                                interpret=True)
    _assert_weiszfeld_close(got, want)


def test_weiszfeld_two_pass_form_equals_one_pass_form(monkeypatch):
    """Where weiszfeld.fits is false, weiszfeld_stats takes the two-pass
    form (distance_argmin + weiszfeld_reduce); it computes what the
    one-pass form computes: the same assignment and the same reduction."""
    pts, ctr, w = _data(700, 40, 30, seed=2)
    p, c, wt = map(torch.from_numpy, (pts, ctr, w))
    assert wz_mod.fits(40, 30)
    one = ops.weiszfeld_stats(p, c, wt)
    monkeypatch.setattr(lu_mod, "RESIDENT_FLOATS",
                        wz_mod.shared_floats(40, 30) - 1)
    calls = []
    monkeypatch.setattr(ops, "min_dist_argmin",
                        lambda *a: calls.append(1) or ref.min_dist_argmin_ref(
                            *a))
    two = ops.weiszfeld_stats(p, c, wt)
    assert calls == [1]
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_weiszfeld_large_k_takes_two_pass_form_and_matches_jax_ref():
    pts, ctr, w = _data(512, 1100, 1024, signed=False)
    assert not wz_mod.fits(1100, 1024)
    got = ops.weiszfeld_stats(*map(torch.from_numpy, (pts, ctr, w)))
    want = jref.weiszfeld_stats_ref(*map(jnp.asarray, (pts, ctr, w)))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-3)


# per resident statistics kernel: its wrapper module, its ops entry and
# plain version, its per-row arrays of 64, the bytes of one block at the
# main path's shape (k = 50, d = 90: three blocks per SM) and the largest k
# whose block fits its shared memory, per d
RESIDENT_KERNELS = {
    "weiszfeld_stats": (wz_mod, "weiszfeld_stats", "weiszfeld_stats_ref", 7,
                        67268, {1: 11517, 3: 6372, 33: 776, 90: 256,
                                256: 64}),
    "lloyd_stats": (lu_mod, "lloyd_stats", "lloyd_stats_ref", 6, 67012,
                    {1: 11520, 3: 6385, 33: 778, 90: 256, 256: 64}),
}


# the weiszfeld_stats cases keep their ids from before lloyd_stats shared
# the layout
@pytest.mark.parametrize("name,d,k", [
    pytest.param(name, d, k, id=f"{d}-{k}" if name == "weiszfeld_stats"
                 else f"{name}-{d}-{k}")
    for name, spec in RESIDENT_KERNELS.items()
    for d, k in sorted(spec[-1].items())])
def test_weiszfeld_routing_rule_at_the_shared_memory_limit(monkeypatch, name,
                                                           d, k):
    """The routing rule of both resident statistics kernels is their
    shared-memory count, a function of k and d alone, counted by one
    function (lloyd_update.shared_floats): the point stage (64 d + 4), the
    centres padded to the 64-centre tile at stride k_pad + 2 and their
    norms, the accumulators k (d + 1), the kernel's per-row arrays of 64
    (seven for weiszfeld_stats, six for lloyd_stats) and k + 1 group
    starts, held to 227 KiB. The largest k that fits takes one pass and
    k + 1 takes the two-pass form, which computes the same statistics."""
    mod, entry, plain, row_arrays, main_bytes, _ = RESIDENT_KERNELS[name]
    kc = -(-k // 64) * 64
    assert mod.shared_floats(k, d) == (64 * d + 4 + d * (kc + 2) + kc
                                       + k * (d + 1) + row_arrays * 64
                                       + k + 1)
    assert mod.shared_floats(k, d) == lu_mod.shared_floats(k, d, row_arrays)
    assert lu_mod.RESIDENT_FLOATS * 4 == 227 * 1024
    assert mod.fits(k, d) and not mod.fits(k + 1, d)
    assert all(mod.fits(kk, d) for kk in (1, 2, k // 2, k - 1))
    assert mod.shared_floats(50, 90) * 4 == main_bytes
    pts, ctr, w = _data(9, k + 1, d, seed=d)
    calls = []
    monkeypatch.setattr(ops, "min_dist_argmin",
                        lambda *a: calls.append(1) or ref.min_dist_argmin_ref(
                            *a))
    p, c, wt = map(torch.from_numpy, (pts, ctr, w))
    one = getattr(ops, entry)(p, c[:k], wt)
    assert calls == []
    two = getattr(ops, entry)(p, c, wt)
    assert calls == [1]
    want = getattr(ref, plain)(p, c, wt)
    for a, b in zip(two, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert one[0].shape == (k, d) and two[0].shape == (k + 1, d)


def test_weiszfeld_site_axis_matches_vmapped_reference():
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((6, 200, 12)).astype(np.float32)
    ctr = rng.standard_normal((6, 9, 12)).astype(np.float32)
    w = rng.standard_normal((6, 200)).astype(np.float32)
    p, c, wt = map(torch.from_numpy, (pts, ctr, w))
    got = ops.weiszfeld_stats(p, c, wt)
    want = jax.vmap(jref.weiszfeld_stats_ref)(*map(jnp.asarray,
                                                  (pts, ctr, w)))
    _assert_weiszfeld_close(got, want)
    for s in range(6):
        one = ops.weiszfeld_stats(p[s], c[s], wt[s])
        for a, b in zip(got, one):
            np.testing.assert_allclose(a[s].numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_weiszfeld_zero_weight_points_do_not_contribute():
    pts, ctr, w = _data(128, 4, 8, signed=False)
    w[64:] = 0.0
    a = ops.weiszfeld_stats(*map(torch.from_numpy, (pts, ctr, w)))
    b = ops.weiszfeld_stats(*map(torch.from_numpy, (pts[:64], ctr, w[:64])))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_weiszfeld_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches or raises: a CPU tensor never reaches
    the plain version through it (only ops dispatches by device)."""
    before = wz_mod.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA device"):
        wz_mod.weiszfeld_stats(torch.zeros(1, 8, 3), torch.zeros(1, 64, 3),
                               torch.ones(1, 8), 2)
    assert wz_mod.KERNEL.launches == before


# -- the k-median objective --------------------------------------------------

def test_kmedian_is_registered_and_the_rest_still_raise():
    assert objective.resolve_name("kmedian") == "kmedian"
    assert objective.get_objective("kmedian").power_z == 1.0
    assert objective.WEISZFELD_ITERS == jobjective.WEISZFELD_ITERS
    for name in ("power(3)", "kmeans_trimmed(5)"):
        with pytest.raises(ValueError, match="not yet ported"):
            objective.resolve_name(name)
    with pytest.raises(ValueError, match="not yet ported"):
        objective.Objective(name="cubic", power_z=3.0)


def test_point_and_clamped_costs_match_reference():
    d2 = np.asarray([0.0, 1e-12, 0.25, 4.0, 1e6, -1e-7], np.float32)
    for name in ("kmeans", "kmedian"):
        j = jobjective.get_objective(name)
        p = objective.get_objective(name)
        np.testing.assert_array_equal(
            p.clamped_cost(torch.from_numpy(d2)).numpy(),
            np.asarray(j.clamped_cost(jnp.asarray(d2))))
        np.testing.assert_array_equal(
            p.per_point_cost(torch.from_numpy(d2[:-1])).numpy(),
            np.asarray(j.per_point_cost(jnp.asarray(d2[:-1]))))


@pytest.mark.parametrize("signed", [False, True])
def test_kmedian_update_matches_reference(signed):
    """One k-median step (WEISZFELD_ITERS fused passes) from data-row
    centres, against the reference's with the jnp backend."""
    pts, _, w = _data(600, 6, 5, seed=7, signed=signed)
    ctr = pts[::100].copy()
    new, c = objective.KMEDIAN.update(backend.get_backend("torch"),
                                      torch.from_numpy(pts),
                                      torch.from_numpy(w),
                                      torch.from_numpy(ctr))
    new_j, c_j = jobjective.KMEDIAN.update(jbackend.get_backend("jnp"),
                                           jnp.asarray(pts), jnp.asarray(w),
                                           jnp.asarray(ctr))
    np.testing.assert_allclose(new.numpy(), np.asarray(new_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(c), float(c_j), rtol=1e-5)


def test_kmedian_update_site_axis_equals_per_site_updates():
    rng = np.random.default_rng(8)
    pts = torch.from_numpy(rng.standard_normal((4, 150, 6)).astype(
        np.float32))
    w = torch.from_numpy(rng.random((4, 150)).astype(np.float32))
    ctr = pts[:, :5].clone()
    b = backend.get_backend("torch")
    new, c = objective.KMEDIAN.update(b, pts, w, ctr)
    for s in range(4):
        new_s, c_s = objective.KMEDIAN.update(b, pts[s], w[s], ctr[s])
        np.testing.assert_allclose(new[s].numpy(), new_s.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(float(c[s]), float(c_s), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_kmedian_seeding_picks_the_reference_rows(seed):
    """D^1 seeding with the same key draws the same data rows."""
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((500, 4)) * 3).astype(np.float32)
    w = rng.random(500).astype(np.float32)
    got = clustering.kmeans_pp_init(prng.PRNGKey(seed), pts, 6, weights=w,
                                    objective="kmedian", device="cpu")
    want = jclustering.kmeans_pp_init(jax.random.PRNGKey(seed),
                                      jnp.asarray(pts), 6,
                                      weights=jnp.asarray(w),
                                      objective="kmedian", backend="jnp")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- sites that hold fewer points than k ----------------------------------------

def test_kmedian_t_i_at_sites_with_fewer_points_than_k():
    """A site holding fewer points than k makes every point (nearly) its own
    centre, so its k-median local cost is the sum of sqrt(d2) at d2 ~ 0.
    Both packages take d2 in matmul form, |p|^2 + |c|^2 - 2 p.c, whose
    cancellation leaves noise of order 2**-24 |p|^2 for a point at its own
    centre, and sqrt turns it into ~2**-12 |p| per point; XLA and torch
    round that noise differently, so these sites' costs differ between the
    packages (ROADMAP C; the reference stays as it is). The allocation is
    largest-remainder: sum t_i == t exactly in both, and a site's t_i
    moves with its cost only through its share t c_i / C. Here the tiny
    sites' whole costs add up to less than one sample of that share, so
    each t_i may differ from the reference's by at most one sample (a unit
    of the remainder moving between two sites), and the sites that hold k
    points or more agree on their costs to 1e-4 (float32 solves in
    different orders)."""
    rng = np.random.default_rng(0)
    sizes = [2, 3, 5, 7, 30, 45, 60, 80, 100]
    k, t = 8, 300
    data = (3.0 * rng.standard_normal((sum(sizes), 4))).astype(np.float32)
    edges = np.cumsum([0] + sizes)
    sp, sm = jpartition.pad_partition(
        data, [np.arange(a, b) for a, b in zip(edges[:-1], edges[1:])])
    want = jcoreset.distributed_coreset(
        jax.random.PRNGKey(0), jnp.asarray(sp), jnp.asarray(sm), k, t,
        objective="kmedian", lloyd_iters=8, backend="jnp")
    got = coreset.distributed_coreset(prng.PRNGKey(0), sp, sm, k, t,
                                      objective="kmedian", lloyd_iters=8,
                                      device="cpu")
    t_got, t_want = got.t_i.numpy(), np.asarray(want.t_i)
    c_got, c_want = got.local_costs.numpy(), np.asarray(want.local_costs)
    tiny = np.asarray(sizes) < k
    assert int(t_got.sum()) == t and int(t_want.sum()) == t
    # the premise of the bound: the tiny sites' costs are noise worth less
    # than one sample of the allocation in either package
    for c in (c_got, c_want):
        assert t * c[tiny].sum() / c.sum() < 1.0
    np.testing.assert_allclose(c_got[~tiny], c_want[~tiny], rtol=1e-4)
    assert np.abs(t_got.astype(int) - t_want.astype(int)).max() <= 1


# -- Algorithm 2 with k-median on the quickstart instance ---------------------

@pytest.fixture(scope="module")
def runs():
    """Both packages, both routes, k-median, on the quickstart instance
    (20,000 x 10, k=5, grid(3, 3), t=400)."""
    rng = np.random.default_rng(0)
    centers = 3.0 * rng.standard_normal((K, 10))
    data = np.concatenate(
        [c + 0.2 * rng.standard_normal((4000, 10)) for c in centers]
    ).astype(np.float32)
    sp, sm = jpartition.pad_partition(
        data, jpartition.partition_indices(data, 9, "weighted", seed=1))
    jg, tg = jtopology.grid(3, 3), topology.grid(3, 3)
    jkey, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0)
    out = {"jax": {}, "port": {}}
    for routing in ("flood", "bfs"):
        out["jax"][routing] = jdistributed.graph_distributed_kmeans(
            jkey, jnp.asarray(sp), jnp.asarray(sm), K, T, jg,
            objective="kmedian", routing=routing, backend="jnp")
        out["port"][routing] = distributed.graph_distributed_kmeans(
            tkey, sp, sm, K, T, tg, objective="kmedian", routing=routing,
            device="cpu")
    out["jax"]["t_i"] = np.asarray(jcoreset.distributed_coreset(
        jax.random.split(jkey)[0], jnp.asarray(sp), jnp.asarray(sm), K, T,
        objective="kmedian", lloyd_iters=8, backend="jnp").t_i)
    out["port"]["t_i"] = coreset.distributed_coreset(
        prng.split(tkey)[0], sp, sm, K, T, objective="kmedian",
        lloyd_iters=8, device="cpu").t_i.numpy()
    out["data"] = data
    return out


def test_kmedian_t_i_exactly_equal(runs):
    np.testing.assert_array_equal(runs["port"]["t_i"], runs["jax"]["t_i"])
    assert runs["port"]["t_i"].sum() == T


@pytest.mark.parametrize("route", ["flood", "bfs"])
def test_kmedian_ledgers_exactly_equal(runs, route):
    assert (runs["port"][route].ledger.as_dict(by_phase=True)
            == runs["jax"][route].ledger.as_dict(by_phase=True))


@pytest.mark.parametrize("route", ["flood", "bfs"])
def test_kmedian_centers_match_reference(runs, route):
    """Centres within 1e-3 of max |centre| of the reference's, the bound
    of the k-means pipeline test."""
    got = runs["port"][route].centers.numpy()
    want = np.asarray(runs["jax"][route].centers)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_kmedian_routes_solve_the_same_centers_and_cost(runs):
    assert torch.equal(runs["port"]["flood"].centers,
                       runs["port"]["bfs"].centers)
    data = runs["data"]
    p = float(clustering.cost(data, runs["port"]["flood"].centers,
                              objective="kmedian", device="cpu"))
    j = float(jclustering.cost(jnp.asarray(data),
                               runs["jax"]["flood"].centers,
                               objective="kmedian", backend="jnp"))
    assert abs(p - j) <= 1e-4 * j
