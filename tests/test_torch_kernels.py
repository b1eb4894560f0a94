"""The port's kernel modules against the JAX package's.

On the CPU the port's wrappers run their kernels' plain versions, so these
tests hold the plain versions and the wrappers' shape handling (site axis,
centre padding, the two-pass form) to ``repro.kernels.ref`` and, at tiny
shapes, to the Pallas kernels in interpret mode. The CUDA kernels
themselves are held to the plain versions by the ``cuda``-marked tests in
``tests/test_torch_cuda.py``, which run on a GPU machine only.
"""
import ctypes

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

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

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
    kernels = (da_mod.KERNEL, da_mod.STREAM, lu_mod.KERNEL, lu_mod.REDUCE,
               lu_mod.REDUCE_GROUPED)
    before = [kern.launches for kern in kernels]
    with pytest.raises(ValueError, match="CUDA device"):
        da_mod.distance_argmin(p, c)
    with pytest.raises(ValueError, match="CUDA device"):
        da_mod.distance_argmin_stream(p, c)
    with pytest.raises(ValueError, match="CUDA device"):
        lu_mod.lloyd_stats(p, c, torch.ones(1, 8), 2)
    with pytest.raises(ValueError, match="CUDA device"):
        lu_mod.lloyd_reduce(p, torch.ones(1, 8), torch.zeros(1, 8),
                            torch.zeros(1, 8, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="CUDA device"):
        lu_mod.lloyd_reduce_grouped(p, torch.ones(1, 8), torch.zeros(1, 8),
                                    torch.zeros(1, 8, dtype=torch.int32), 2,
                                    1)
    assert [kern.launches for kern in kernels] == before


@pytest.mark.parametrize("n,k,d", SHAPES)
def test_ops_lloyd_reduce_on_cpu_matches_jax_ref(n, k, d):
    """ops.lloyd_reduce on CPU tensors is the plain reduction (no launch),
    with and without the site axis; given the plain assignment it gives
    the JAX package's lloyd statistics."""
    pts, ctr, w = _data(n, k, d, seed=3)
    p, c, wt = map(torch.from_numpy, (pts, ctr, w))
    md, am = ref.min_dist_argmin_ref(p, c)
    before = [kern.launches for kern in ops.KERNELS]
    out = ops.lloyd_reduce(p, k, wt, md, am)
    batched = ops.lloyd_reduce(p[None], k, wt[None], md[None], am[None])
    assert [kern.launches for kern in ops.KERNELS] == before
    for a, b, x in zip(out, ref.lloyd_reduce(p, k, wt, md, am), batched):
        assert torch.equal(a, b)
        # a batched product may sum in another order than a 2-D one
        np.testing.assert_allclose(x[0].numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6)
    sums_j, counts_j, cost_j = jref.lloyd_stats_ref(
        jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(w))
    same = np.asarray(am) == np.asarray(jref.min_dist_argmin_ref(
        jnp.asarray(pts), jnp.asarray(ctr))[1])
    if same.all():
        np.testing.assert_allclose(out[0].numpy(), np.asarray(sums_j),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(counts_j),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(out[2]), float(cost_j), rtol=1e-4)


@pytest.mark.parametrize("n,k,d", SHAPES)
def test_ops_weiszfeld_reduce_on_cpu_matches_jax_ref(n, k, d):
    """ops.weiszfeld_reduce on CPU tensors is the plain reduction (no
    launch), with and without the site axis; given the JAX package's
    assignment it gives the JAX package's Weiszfeld reduction."""
    pts, ctr, w = _data(n, k, d, seed=4)
    w = 2.0 * w - 1.0
    p, c, wt = map(torch.from_numpy, (pts, ctr, w))
    _, am_j = jref.min_dist_argmin_ref(jnp.asarray(pts), jnp.asarray(ctr))
    am = torch.from_numpy(np.array(am_j))
    before = [kern.launches for kern in ops.KERNELS]
    out = ops.weiszfeld_reduce(p, c, wt, am)
    batched = ops.weiszfeld_reduce(p[None], c[None], wt[None], am[None])
    assert [kern.launches for kern in ops.KERNELS] == before
    want = jref.weiszfeld_reduce(jnp.asarray(pts), jnp.asarray(ctr),
                                 jnp.asarray(w), am_j)
    for a, b, x in zip(out, ref.weiszfeld_reduce(p, c, wt, am), batched):
        assert torch.equal(a, b)
        np.testing.assert_allclose(x[0].numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-6)
    for a, b in zip(out, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-3)


def test_ops_on_cpu_launch_no_kernel():
    before = [k.launches for k in ops.KERNELS]
    pts, ctr, w = _data(50, 3, 4)
    ops.min_dist_argmin(torch.from_numpy(pts), torch.from_numpy(ctr))
    ops.lloyd_stats(*map(torch.from_numpy, (pts, ctr, w)))
    assert [k.launches for k in ops.KERNELS] == before


def _argmin_layout_floats(k_pad, d):
    """The resident tile's shared memory as csrc/distance_argmin.cu lays it
    out, counted here apart from the wrapper: resident_tile.cuh's layout
    with no accumulators and no per-row array of the kernel's own -- the
    point stage (64 d + 4), the centres padded to the 64-centre tile at a
    row stride 2 above it, their norms, five per-row arrays of 64 and one
    group start."""
    kc = -(-k_pad // 64) * 64
    return 64 * d + 4 + d * (kc + 2) + kc + 5 * 64 + 1


# the largest k_pad (a multiple of 64) whose resident block fits the 227 KiB
# at each d, and the next one; at d = 444 the largest d with 64 centres
@pytest.mark.parametrize("k_pad,d,fits", [
    (64, 90, True), (512, 90, True), (576, 90, False), (64, 444, True),
    (64, 445, False), (128, 256, True), (192, 256, False),
    (14336, 3, True), (14400, 3, False), (28800, 1, True),
    (28864, 1, False)])
def test_resident_fits_at_the_layout_boundary(k_pad, d, fits):
    """distance_argmin.resident_fits is the header's layout count against
    the shared memory a block may use on Hopper (227 KiB); where it is
    false the entries take the streamed tile (above 8 rows per site)."""
    assert da_mod.RESIDENT_FLOATS * 4 == 227 * 1024
    assert (_argmin_layout_floats(k_pad, d) <= 227 * 1024 // 4) is fits
    assert da_mod.resident_fits(k_pad, d) is fits
    # the main path's block: 48,356 bytes, four blocks per SM
    assert _argmin_layout_floats(64, 90) * 4 == 48356


def test_route_counters_are_kernels_of_the_distance_argmin_library():
    """Every launch of either entry is counted under one of the kernels it
    routes to, in the order of the C side's route codes; each counter names
    the library its kernel is built into."""
    assert da_mod.ROUTES == (da_mod.ONE_CENTER, da_mod.RESIDENT, da_mod.TILE,
                             da_mod.STREAM)
    assert {k.library for k in da_mod.ROUTES} == {"distance_argmin"}
    assert da_mod.TILE.function == "distance_argmin_tile_launch"
    assert da_mod.RESIDENT.function == "distance_argmin_resident_launch"
    assert da_mod.STREAM.function == "distance_argmin_stream_launch"
    assert len({k.name for k in (*ops.KERNELS, *da_mod.ROUTES)}) == 10


@pytest.mark.parametrize("entry,served", [
    ("KERNEL", 0), ("KERNEL", 1), ("KERNEL", 2), ("KERNEL", 3),
    ("KERNEL_BATCHED", 0), ("KERNEL_BATCHED", 1), ("KERNEL_BATCHED", 2),
    ("KERNEL_BATCHED", 3), ("RESIDENT", 1), ("TILE", 2), ("STREAM", 3)])
def test_count_launch_counts_the_entry_and_the_kernel_reported(entry,
                                                               served):
    """A launch counts once under its entry and once under the kernel the
    library reports it launched; an entry of one kernel alone counts once,
    under that kernel."""
    kern = getattr(da_mod, entry)
    counters = (da_mod.KERNEL, da_mod.KERNEL_BATCHED, *da_mod.ROUTES)
    before = [c.launches for c in counters]
    da_mod.count_launch(kern, served)
    moved = [c.launches - b for c, b in zip(counters, before)]
    expect = [int(c is kern) + int(c is da_mod.ROUTES[served]
                                   and c is not kern) for c in counters]
    assert moved == expect
    assert sum(moved) == (1 if kern is da_mod.ROUTES[served] else 2)


@pytest.mark.parametrize("served", [-1, 4])
def test_count_launch_refuses_an_unknown_kernel_code(served):
    """A code outside ROUTES (a library that reported nothing) raises and
    counts nothing."""
    before = [c.launches for c in (da_mod.KERNEL, *da_mod.ROUTES)]
    with pytest.raises(RuntimeError):
        da_mod.count_launch(da_mod.KERNEL, served)
    assert [c.launches for c in (da_mod.KERNEL, *da_mod.ROUTES)] == before


# (M, k_pad, d): one centre; up to 8 rows per site; the resident block's
# limit at d = 90 (k_pad 512 fits, 576 does not) and at 64 centres (d 444
# fits, 445 does not); data selection's shape (d = 4,096 never fits)
@pytest.mark.parametrize("M,k_pad,d,kernel", [
    (2048, 1, 4096, "ONE_CENTER"), (1, 64, 90, "TILE"), (8, 64, 4096, "TILE"),
    (8, 576, 90, "TILE"), (9, 64, 90, "RESIDENT"), (9, 64, 4096, "STREAM"),
    (300, 512, 90, "RESIDENT"), (300, 576, 90, "STREAM"),
    (300, 64, 444, "RESIDENT"), (300, 64, 445, "STREAM"),
    (21280, 64, 90, "RESIDENT"), (2048, 64, 4096, "STREAM"),
    (40, 320, 1000, "STREAM"), (1001, 1024, 4095, "STREAM")])
def test_route_is_the_librarys_rule(M, k_pad, d, kernel):
    """distance_argmin.route names the kernel ``route`` in
    csrc/distance_argmin.cu picks: kNarrowRows = 8 rows, then the resident
    block's fit."""
    assert da_mod.NARROW_ROWS == 8
    assert da_mod.route(M, k_pad, d) is getattr(da_mod, kernel)


@pytest.mark.parametrize("group", [0, -1])
def test_lloyd_reduce_grouped_refuses_groups_below_one(group):
    """The column walk's grouped entry takes at least one centre a block
    (the C entry refuses less too); the wrapper raises before it looks at
    the tensors, and counts no launch."""
    p = torch.zeros(1, 8, 3)
    before = lu_mod.REDUCE_GROUPED.launches
    with pytest.raises(ValueError, match="at least one centre"):
        lu_mod.lloyd_reduce_grouped(p, torch.ones(1, 8), torch.zeros(1, 8),
                                    torch.zeros(1, 8, dtype=torch.int32), 2,
                                    group)
    assert lu_mod.REDUCE_GROUPED.launches == before


def test_lloyd_reduce_grouped_is_an_entry_of_the_lloyd_reduce_library():
    """The grouped entry is built into lloyd_reduce's library and counts
    apart from lloyd_reduce, with one argument (the group) more."""
    assert lu_mod.REDUCE_GROUPED.library == lu_mod.REDUCE.library
    assert lu_mod.REDUCE_GROUPED.function == "lloyd_reduce_grouped_launch"
    assert lu_mod.REDUCE_GROUPED.name != lu_mod.REDUCE.name
    assert lu_mod.REDUCE_GROUPED not in ops.KERNELS
    assert (lu_mod.REDUCE_GROUPED.argtypes[:-1]
            == lu_mod.REDUCE.argtypes[:-1] + [ctypes.c_int])
    assert lu_mod.REDUCE_GROUPED.argtypes[-1] == lu_mod.REDUCE.argtypes[-1]


@pytest.mark.parametrize("k", [1, 2, 8, 64, 65])
def test_ops_pass_the_rows_before_the_padding_as_live(monkeypatch, k):
    """ops.min_dist_argmin and ops.min_dist_argmin_batched hand the kernel
    the centres padded to the centre tile and ``live = k``: every row from
    ``live`` on is the sentinel row, so those rows are equal bit for bit
    and the streamed tile may take rows 0 .. live alone (what the CUDA
    tests hold to the general tile bit for bit)."""
    calls = []

    def record(points, centers, live=None):
        calls.append((centers.clone(), live))
        S, M = points.shape[:2]
        return torch.zeros(S, M), torch.zeros(S, M, dtype=torch.int32)

    monkeypatch.setattr(da_mod, "distance_argmin", record)
    monkeypatch.setattr(da_mod, "distance_argmin_batched", record)
    # the wrappers' CUDA branch, on CPU tensors
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    rng = np.random.default_rng(k)
    c = torch.from_numpy(rng.standard_normal((2, k, 5)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((2, 7, 5)).astype(np.float32))
    ops.min_dist_argmin(p, c)
    ops.min_dist_argmin(p[0], c[0])
    ops.min_dist_argmin_batched(p, c)
    assert len(calls) == 3
    for padded, live in calls:
        assert live == k
        assert padded.shape[1] == -(-k // da_mod.center_tile(k)) * \
            da_mod.center_tile(k)
        assert torch.equal(padded[:, :k], c[:padded.shape[0]])
        assert bool((padded[:, k:] == ref.CENTER_SENTINEL).all())
