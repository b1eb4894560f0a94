"""The port's kernel modules against the JAX package's.

On the CPU the port's wrappers run their kernels' plain versions, so these
tests hold the plain versions and the wrappers' shape handling (site axis,
centre padding, the two-pass form) to ``repro.kernels.ref`` and, at tiny
shapes, to the Pallas kernels in interpret mode. The CUDA kernels
themselves are held to the plain versions by the ``cuda``-marked tests in
``tests/test_torch_cuda.py``, which run on a GPU machine only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import distance_argmin as da_mod
from repro_torch.kernels import lloyd_update as lu_mod
from repro_torch.kernels import ops, ref

# shapes of tests/test_kernels.py
SHAPES = [
    (8, 4, 3),
    (100, 5, 10),
    (256, 128, 128),
    (300, 17, 90),
    (1024, 50, 32),
    (513, 257, 129),
]


def _data(n, k, d, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    ctr = rng.standard_normal((k, d)).astype(np.float32)
    w = np.abs(rng.standard_normal(n)).astype(np.float32)
    return pts, ctr, w


def _assert_argmins(md, am, md_j, am_j):
    """Argmins equal except at near ties: the reported minima there agree
    within tests/test_kernels.py's tie tolerance (1e-3), and ties are rare
    on random data (at most 1% of rows)."""
    flips = np.asarray(am) != np.asarray(am_j)
    assert flips.sum() <= max(1, flips.size // 100), int(flips.sum())
    np.testing.assert_allclose(np.asarray(md)[flips],
                               np.asarray(md_j)[flips], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n,k,d", SHAPES)
def test_min_dist_argmin_ref_matches_jax_ref(n, k, d):
    pts, ctr, _ = _data(n, k, d)
    md, am = ref.min_dist_argmin_ref(torch.from_numpy(pts),
                                     torch.from_numpy(ctr))
    md_j, am_j = jref.min_dist_argmin_ref(jnp.asarray(pts), jnp.asarray(ctr))
    assert md.dtype == torch.float32 and am.dtype == torch.int32
    # float32 tolerance of tests/test_kernels.py: both libraries evaluate
    # |p|^2 + |c|^2 - 2 p.c in float32, with sums in different orders
    np.testing.assert_allclose(md.numpy(), np.asarray(md_j), rtol=1e-5,
                               atol=1e-5)
    _assert_argmins(md, am, md_j, am_j)


@pytest.mark.parametrize("n,k,d", SHAPES)
def test_lloyd_stats_ref_matches_jax_ref(n, k, d):
    pts, ctr, w = _data(n, k, d)
    sums, counts, cost = ref.lloyd_stats_ref(
        torch.from_numpy(pts), torch.from_numpy(ctr), torch.from_numpy(w))
    sums_j, counts_j, cost_j = jref.lloyd_stats_ref(
        jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(w))
    # tolerances of tests/test_kernels.py (float32)
    np.testing.assert_allclose(counts.numpy(), np.asarray(counts_j),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(float(cost), float(cost_j), rtol=5e-3)


@pytest.mark.parametrize("n,k,d", SHAPES[:2])
def test_ops_match_pallas_kernels_in_interpret_mode(n, k, d):
    """The port's safe wrappers (plain versions on the CPU) against the
    JAX package's safe wrappers around the Pallas kernels, in interpret
    mode at tiny shapes as tests/test_kernels.py runs them."""
    pts, ctr, w = _data(n, k, d, seed=3)
    md, am = ops.min_dist_argmin(torch.from_numpy(pts), torch.from_numpy(ctr))
    md_j, am_j = jops.min_dist_argmin(jnp.asarray(pts), jnp.asarray(ctr),
                                      interpret=True)
    np.testing.assert_allclose(md.numpy(), np.asarray(md_j), rtol=1e-5,
                               atol=1e-5)
    _assert_argmins(md, am, md_j, am_j)
    sums, counts, cost = ops.lloyd_stats(torch.from_numpy(pts),
                                         torch.from_numpy(ctr),
                                         torch.from_numpy(w))
    sums_j, counts_j, cost_j = jops.lloyd_stats(
        jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(counts.numpy(), np.asarray(counts_j),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(sums.numpy(), np.asarray(sums_j), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(float(cost), float(cost_j), rtol=5e-3)


def test_site_axis_matches_vmapped_reference():
    """A leading site axis is the written-out jax.vmap: every site's slice
    equals the reference's vmapped result (and the port's own per-site
    calls exactly)."""
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((6, 200, 12)).astype(np.float32)
    ctr = rng.standard_normal((6, 9, 12)).astype(np.float32)
    w = rng.random((6, 200)).astype(np.float32)
    p, c, wt = map(torch.from_numpy, (pts, ctr, w))
    md, am = ops.min_dist_argmin(p, c)
    sums, counts, cost = ops.lloyd_stats(p, c, wt)
    md_j, am_j = jax.vmap(jref.min_dist_argmin_ref)(jnp.asarray(pts),
                                                   jnp.asarray(ctr))
    np.testing.assert_allclose(md.numpy(), np.asarray(md_j), rtol=1e-5,
                               atol=1e-5)
    _assert_argmins(md, am, md_j, am_j)
    for s in range(6):
        md_s, am_s = ops.min_dist_argmin(p[s], c[s])
        np.testing.assert_allclose(md[s].numpy(), md_s.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(am[s].numpy(), am_s.numpy())
        sums_s, counts_s, cost_s = ops.lloyd_stats(p[s], c[s], wt[s])
        np.testing.assert_allclose(sums[s].numpy(), sums_s.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(counts[s].numpy(), counts_s.numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(cost[s]), float(cost_s), rtol=1e-6)


def test_two_pass_form_equals_one_pass_form(monkeypatch):
    """Where lloyd_update.fits is false, lloyd_stats takes the two-pass
    form (distance_argmin + one-hot product); it computes what the
    one-pass form computes below the limit: the same assignment and the
    same reduction, so the results are equal."""
    pts, ctr, w = _data(700, 40, 30, seed=2)
    p, c, wt = map(torch.from_numpy, (pts, ctr, w))
    assert lu_mod.fits(40, 30)
    one = ops.lloyd_stats(p, c, wt)
    monkeypatch.setattr(lu_mod, "RESIDENT_FLOATS",
                        lu_mod.shared_floats(40, 30) - 1)
    calls = []
    monkeypatch.setattr(ops, "min_dist_argmin",
                        lambda *a: calls.append(1) or ref.min_dist_argmin_ref(
                            *a))
    two = ops.lloyd_stats(p, c, wt)
    assert calls == [1]
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_large_k_takes_two_pass_form_and_matches_jax_ref():
    """A block beyond the shared-memory limit routes through the
    two-pass form and still matches the oracle (tests/test_kernels.py's
    large-k case)."""
    pts, ctr, w = _data(512, 1100, 1024)
    assert not lu_mod.fits(1100, 1024)
    sums, counts, cost = ops.lloyd_stats(torch.from_numpy(pts),
                                         torch.from_numpy(ctr),
                                         torch.from_numpy(w))
    sums_j, counts_j, cost_j = jref.lloyd_stats_ref(
        jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(w))
    np.testing.assert_allclose(counts.numpy(), np.asarray(counts_j),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(float(cost), float(cost_j), rtol=1e-3)


def test_zero_weight_points_do_not_contribute():
    pts, ctr, w = _data(128, 4, 8)
    w[64:] = 0.0
    a = ops.lloyd_stats(*map(torch.from_numpy, (pts, ctr, w)))
    b = ops.lloyd_stats(*map(torch.from_numpy, (pts[:64], ctr, w[:64])))
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("k,k_pad", [(1, 1), (5, 64), (50, 64), (64, 64),
                                     (65, 128)])
def test_pad_centers_to_the_centre_tile_with_the_sentinel(k, k_pad):
    c = torch.randn(3, k, 7)
    padded = ops.pad_centers(c)
    assert padded.shape == (3, k_pad, 7) and padded.is_contiguous()
    assert torch.equal(padded[:, :k], c)
    assert bool((padded[:, k:] == ref.CENTER_SENTINEL).all())
    # sentinel rows never win, and keep every distance finite
    p = torch.randn(3, 20, 7)
    md, am = ref.min_dist_argmin_ref(p, padded)
    assert bool((am < k).all()) and bool(torch.isfinite(md).all())


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches or raises: CPU tensors never reach the
    plain version through it (only ops dispatches by device)."""
    p = torch.zeros(1, 8, 3)
    c = torch.zeros(1, 64, 3)
    before = (da_mod.KERNEL.launches, lu_mod.KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        da_mod.distance_argmin(p, c)
    with pytest.raises(ValueError, match="CUDA device"):
        lu_mod.lloyd_stats(p, c, torch.ones(1, 8), 2)
    assert (da_mod.KERNEL.launches, lu_mod.KERNEL.launches) == before


def test_ops_on_cpu_launch_no_kernel():
    before = [k.launches for k in ops.KERNELS]
    pts, ctr, w = _data(50, 3, 4)
    ops.min_dist_argmin(torch.from_numpy(pts), torch.from_numpy(ctr))
    ops.lloyd_stats(*map(torch.from_numpy, (pts, ctr, w)))
    assert [k.launches for k in ops.KERNELS] == before
