"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they need a CUDA device and nvcc, and skip elsewhere. They
import no JAX, so they run on a GPU machine that has none:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import distance_argmin as da_mod
from repro_torch.kernels import lloyd_update as lu_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import weiszfeld as wz_mod


def _assert_argmins(md, am, md_r, am_r):
    """Argmins equal except at near ties (the minima there agree within
    1e-3, tests/test_kernels.py's tie tolerance), at most 1% of rows."""
    flips = am.numpy() != am_r.numpy()
    assert flips.sum() <= max(1, flips.size // 100), int(flips.sum())
    np.testing.assert_allclose(md.numpy()[flips], md_r.numpy()[flips],
                               rtol=1e-3, atol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CUDA_SHAPES = [(1, 8, 4, 3), (1, 300, 17, 90), (1, 777, 130, 256),
               (7, 1001, 1, 33), (5, 2000, 50, 90)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,k,d", CUDA_SHAPES)
def test_cuda_kernels_match_plain_versions(cuda, S, n, k, d):
    rng = np.random.default_rng(n)
    p = torch.tensor(rng.standard_normal((S, n, d)), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.standard_normal((S, k, d)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(rng.random((S, n)), dtype=torch.float32, device=cuda)
    called = (da_mod.KERNEL, lu_mod.KERNEL)
    launches = [kern.launches for kern in called]
    md, am = ops.min_dist_argmin(p, c)
    sums, counts, cost = ops.lloyd_stats(p, c, w)
    torch.cuda.synchronize()
    # a block that does not fit shared memory takes the two-pass form: a
    # second distance_argmin launch instead of lloyd_stats
    fused = lu_mod.fits(k, d)
    assert [kern.launches for kern in called] == [
        launches[0] + (1 if fused else 2), launches[1] + (1 if fused else 0)]
    md_r, am_r = ref.min_dist_argmin_ref(p, c)
    # float32 on both sides, sums in different orders (see chip_smoke.py)
    np.testing.assert_allclose(md.cpu().numpy(), md_r.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    _assert_argmins(md.cpu(), am.cpu(), md_r.cpu(), am_r.cpu())
    # sums against the plain reduction of the kernel's own assignment
    sr, cr, co = ref.lloyd_reduce(p, k, w, md, am)
    np.testing.assert_allclose(sums.cpu().numpy(), sr.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(counts.cpu().numpy(), cr.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cost.cpu().numpy(), co.cpu().numpy(),
                               rtol=1e-4)
    again = ops.lloyd_stats(p, c, w)
    assert all(torch.equal(a, b) for a, b in zip((sums, counts, cost),
                                                 again))


@pytest.mark.cuda
def test_cuda_ties_pick_the_lowest_index(cuda):
    p = torch.randn(3000, 12, device=cuda)
    c = torch.randn(35, 12, device=cuda)
    _, am = ops.min_dist_argmin(p, torch.cat([c, c]))
    _, am_r = ref.min_dist_argmin_ref(p, torch.cat([c, c]))
    assert torch.equal(am, am_r) and bool((am < 35).all())


def _weiszfeld_scale(p, c, w, am):
    """The sums of |terms| of the Weiszfeld reduction given an assignment:
    the scale its float32 sums in another order are held to."""
    idx = am.long().unsqueeze(-1).expand(*am.shape, p.shape[-1])
    diff = p - torch.gather(c, -2, idx)
    d2 = (diff * diff).sum(-1)
    inv = w.clamp_min(0.0) / torch.sqrt(d2 + ref.WEISZFELD_ETA2)
    oh = torch.nn.functional.one_hot(am.long(), c.shape[-2]).float()
    nums = (oh * inv.unsqueeze(-1)).transpose(-1, -2) @ p.abs()
    return nums, (w.abs() * torch.sqrt(d2)).sum(-1)


def _check_weiszfeld(p, c, w):
    """ops.weiszfeld_stats on the card against the plain reduction of the
    kernel's own assignment (weiszfeld_stats assigns bit for bit as
    distance_argmin does), within 1e-4 of the sums of |terms|; a rerun is
    bit-identical. Shapes whose block does not fit the kernel's shared
    memory take the two-pass form and launch no weiszfeld_stats."""
    before = wz_mod.KERNEL.launches
    nums, denoms, cost = ops.weiszfeld_stats(p, c, w)
    again = ops.weiszfeld_stats(p, c, w)
    _, am = ops.min_dist_argmin(p, c)
    torch.cuda.synchronize()
    fused = wz_mod.fits(c.shape[-2], c.shape[-1])
    assert wz_mod.KERNEL.launches == before + (2 if fused else 0)
    assert all(torch.equal(a, b) for a, b in zip((nums, denoms, cost),
                                                 again))
    nr, dr, cr = ref.weiszfeld_reduce(p, c, w, am)
    na, ca = _weiszfeld_scale(p, c, w, am)
    assert bool(((nums - nr).abs() <= 1e-4 * na + 1e-4).all())
    assert bool(((denoms - dr).abs() <= 1e-4 * dr + 1e-4).all())
    assert bool(((cost - cr).abs() <= 1e-4 * ca + 1e-4).all())
    return am


def _check_lloyd(p, c, w):
    """ops.lloyd_stats on the card against the plain reduction of the
    kernel's own assignment and min d2 (lloyd_stats assigns bit for bit as
    distance_argmin does), within 1e-4 of the sums of |terms|; a rerun is
    bit-identical. Shapes whose block does not fit the kernel's shared
    memory take the two-pass form and launch no lloyd_stats."""
    before = lu_mod.KERNEL.launches
    sums, counts, cost = ops.lloyd_stats(p, c, w)
    again = ops.lloyd_stats(p, c, w)
    md, am = ops.min_dist_argmin(p, c)
    torch.cuda.synchronize()
    k = c.shape[-2]
    fused = lu_mod.fits(k, c.shape[-1])
    assert lu_mod.KERNEL.launches == before + (2 if fused else 0)
    assert all(torch.equal(a, b) for a, b in zip((sums, counts, cost),
                                                 again))
    sr, cr, co = ref.lloyd_reduce(p, k, w, md, am)
    sa, ca, coa = ref.lloyd_reduce(p.abs(), k, w.abs(), md, am)
    assert bool(((sums - sr).abs() <= 1e-4 * sa + 1e-4).all())
    assert bool(((counts - cr).abs() <= 1e-4 * ca + 1e-4).all())
    assert bool(((cost - co).abs() <= 1e-4 * coa + 1e-4).all())
    return am


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,k,d", CUDA_SHAPES)
def test_cuda_weiszfeld_matches_plain_reduction(cuda, S, n, k, d):
    rng = np.random.default_rng(n + 1)
    p = torch.tensor(rng.standard_normal((S, n, d)), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.standard_normal((S, k, d)), dtype=torch.float32,
                     device=cuda)
    # signed weights: max(w, 0) feeds the inverse, w the cost
    w = torch.tensor(rng.standard_normal((S, n)), dtype=torch.float32,
                     device=cuda)
    _check_weiszfeld(p, c, w)


@pytest.mark.cuda
def test_cuda_weiszfeld_coincident_centres_and_ties(cuda):
    """Centres that are data rows give d2 = 0 exactly on those rows (the
    inverse there is w / eta); with every centre twice the lower index
    takes all the mass."""
    p = torch.randn(3000, 12, device=cuda)
    w = torch.rand(3000, device=cuda)
    c = p[:35].clone()
    _check_weiszfeld(p, c, w)
    _, denoms, cost = ops.weiszfeld_stats(p[:35], c, w[:35])
    eta = ref.WEISZFELD_ETA2 ** 0.5
    torch.testing.assert_close(denoms, w[:35] / torch.tensor(eta),
                               rtol=1e-6, atol=0.0)
    assert float(cost) == 0.0
    nums, denoms, _ = ops.weiszfeld_stats(p, torch.cat([c, c]), w)
    assert bool((denoms[35:] == 0).all()) and bool((nums[35:] == 0).all())


# the resident statistics kernels (resident_tile.cuh) and their checks
STATS_CHECKS = {"weiszfeld_stats": _check_weiszfeld,
                "lloyd_stats": _check_lloyd}


# M = 1001 and 2113 are multiples of neither the 64-row tile nor the
# 1,024-row block; k = 1 runs the same kernel with the centre padded to 64
# sentinel columns in shared memory. Offsets: 1 float, and a view that
# starts at row 1 (d floats: off a 16-byte boundary unless 4 divides d).
@pytest.mark.cuda
@pytest.mark.parametrize("offset", ["0", "1", "row"])
@pytest.mark.parametrize("d", [1, 3, 33, 90, 256])
@pytest.mark.parametrize("S,M,k", [(1, 1001, 50), (3, 2113, 1)])
@pytest.mark.parametrize("name", sorted(STATS_CHECKS))
def test_cuda_weiszfeld_widths_offsets_and_ragged_rows(cuda, name, S, M, k,
                                                       d, offset):
    """Both resident kernels over feature widths, a points view at an odd
    storage offset (the tile copy starts off a 16-byte boundary) and ragged
    row counts, against the plain reduction of distance_argmin's
    assignment; a rerun is bit-identical."""
    shift = {"0": 0, "1": 1, "row": d}[offset]
    rng = np.random.default_rng(100 * d + 10 * k + shift)
    buf = torch.empty(S * M * d + shift, device=cuda)
    p = buf[shift:].view(S, M, d)
    p.copy_(torch.tensor(rng.standard_normal((S, M, d)),
                         dtype=torch.float32))
    assert p.is_contiguous() and p.storage_offset() == shift
    c = torch.tensor(rng.standard_normal((S, k, d)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(rng.standard_normal((S, M)), dtype=torch.float32,
                     device=cuda)
    STATS_CHECKS[name](p, c, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STATS_CHECKS))
def test_cuda_weiszfeld_nan_row(cuda, name):
    """A row holding a NaN is assigned centre 0 by every kernel (no
    distance wins; its min d2 is +inf). In weiszfeld_stats it makes
    nums[0], denoms[0] and the cost NaN; in lloyd_stats it makes sums[0]
    NaN in the NaN's column only, adds its weight to counts[0] and makes
    the cost +inf. Every other entry equals the plain reduction of the
    other rows within tolerance (the plain one-hot product would spread the
    NaN over its column: 0 * NaN is NaN), and a rerun is bit-identical."""
    rng = np.random.default_rng(11)
    p = torch.tensor(rng.standard_normal((1001, 90)), dtype=torch.float32,
                     device=cuda)
    p[500, 7] = float("nan")
    c = torch.tensor(rng.standard_normal((50, 90)), dtype=torch.float32,
                     device=cuda)
    w = torch.rand(1001, device=cuda)
    stats = getattr(ops, name)
    first, second, cost = stats(p, c, w)
    again = stats(p, c, w)
    md, am = ops.min_dist_argmin(p, c)
    keep = torch.ones(1001, dtype=torch.bool, device=cuda)
    keep[500] = False
    torch.cuda.synchronize()
    assert int(am[500]) == 0 and float(md[500]) == float("inf")
    assert all(torch.equal(a, b) for a, b in zip((first[1:], second[1:]),
                                                 (again[0][1:],
                                                  again[1][1:])))
    if name == "weiszfeld_stats":
        nr, dr, _ = ref.weiszfeld_reduce(p[keep], c, w[keep], am[keep])
        na, _ = _weiszfeld_scale(p[keep], c, w[keep], am[keep])
        assert bool(torch.isnan(first[0]).all())
        assert bool(torch.isnan(second[0])) and bool(torch.isnan(cost))
    else:
        nr, dr, _ = ref.lloyd_reduce(p[keep], 50, w[keep], md[keep],
                                     am[keep])
        na, _, _ = ref.lloyd_reduce(p[keep].abs(), 50, w[keep], md[keep],
                                    am[keep])
        assert bool(torch.isnan(first[0, 7]))
        assert bool(torch.isfinite(first[0, :7]).all())
        assert bool(torch.isfinite(first[0, 8:]).all())
        # row 500 adds its weight to counts[0] and w * p to sums[0]
        scale = w[500] * p[500].abs()
        rest = (first[0] - nr[0] - w[500] * p[500]).abs()
        assert bool((rest <= 1e-4 * (na[0] + scale) + 1e-4)[
            torch.arange(90, device=cuda) != 7].all())
        assert abs(float(second[0] - dr[0] - w[500])) <= 1e-4 * float(
            dr[0] + w[500]) + 1e-4
        assert not bool(torch.isfinite(cost))
        if float(w[500]) > 0:
            assert float(cost) == float("inf")
    assert bool(torch.isfinite(first[1:]).all())
    assert bool(((first[1:] - nr[1:]).abs() <= 1e-4 * na[1:] + 1e-4).all())
    assert bool(((second[1:] - dr[1:]).abs() <= 1e-4 * dr[1:] + 1e-4).all())


# the largest k whose block fits each kernel's shared memory at d: at
# d = 3 weiszfeld_stats takes all but 4 bytes of the 227 KiB a block may
# use, and lloyd_stats all of them
@pytest.mark.cuda
@pytest.mark.parametrize("name,k,d", [
    ("weiszfeld_stats", 6372, 3), ("weiszfeld_stats", 256, 90),
    ("lloyd_stats", 6385, 3), ("lloyd_stats", 256, 90)])
def test_cuda_weiszfeld_at_the_shared_memory_limit(cuda, name, k, d):
    """Just under the limit the kernel launches (its own count of shared
    memory agrees with lloyd_update.shared_floats) and matches the plain
    reduction; one centre more takes the two-pass form, with no launch of
    the kernel, and equals the plain reduction of distance_argmin's
    assignment exactly."""
    mod = {"weiszfeld_stats": wz_mod, "lloyd_stats": lu_mod}[name]
    assert mod.fits(k, d) and not mod.fits(k + 1, d)
    rng = np.random.default_rng(k + d)
    p = torch.tensor(rng.standard_normal((3000, d)), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.standard_normal((k + 1, d)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(rng.standard_normal(3000), dtype=torch.float32,
                     device=cuda)
    STATS_CHECKS[name](p, c[:k], w)
    before = (mod.KERNEL.launches, da_mod.KERNEL.launches)
    out = getattr(ops, name)(p, c, w)
    md, am = ops.min_dist_argmin(p, c)
    want = (ref.weiszfeld_reduce(p, c, w, am) if name == "weiszfeld_stats"
            else ref.lloyd_reduce(p, k + 1, w, md, am))
    torch.cuda.synchronize()
    assert (mod.KERNEL.launches, da_mod.KERNEL.launches) == (
        before[0], before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STATS_CHECKS))
def test_cuda_weiszfeld_reruns_bit_identical_at_sites_shape(cuda, name):
    """The main path's shape (100 sites of 21,280 rows, k = 50, d = 90):
    within tolerance of the plain reduction, and two launches equal bit
    for bit."""
    g = torch.Generator(device="cpu").manual_seed(5)
    p = torch.randn(100, 21280, 90, generator=g).to(cuda)
    c = p[:, 100:150].clone()
    w = torch.rand(100, 21280, generator=g).to(cuda)
    STATS_CHECKS[name](p, c, w)


@pytest.mark.cuda
@pytest.mark.parametrize("T,m,k,d", [(1, 8, 4, 3), (256, 8, 64, 90),
                                     (33, 64, 17, 90), (5, 1024, 50, 90),
                                     (7, 200, 1, 33)])
def test_cuda_batched_argmin_equals_per_tenant_loop(cuda, T, m, k, d):
    """The stacked-tenant entry against a loop of single-tenant launches
    over the same stacked buffers, bit for bit (DESIGN.md Sec. 13), and
    against the plain version within float32 tolerance; masked rows
    (sentinel) never win."""
    rng = np.random.default_rng(T * m)
    q = torch.tensor(rng.standard_normal((T, m, d)), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.standard_normal((T, k, d)), dtype=torch.float32,
                     device=cuda)
    k_real = torch.tensor(rng.integers(1, k + 1, T), device=cuda)
    mask = torch.arange(k, device=cuda)[None, :] < k_real[:, None]
    c = torch.where(mask[..., None], c, ref.CENTER_SENTINEL)
    before = (da_mod.KERNEL.launches, da_mod.KERNEL_BATCHED.launches)
    md, am = ops.min_dist_argmin_batched(q, c)
    torch.cuda.synchronize()
    assert (da_mod.KERNEL.launches,
            da_mod.KERNEL_BATCHED.launches) == (before[0], before[1] + 1)
    for t in range(T):
        md_t, am_t = ops.min_dist_argmin(q[t], c[t])
        assert torch.equal(md[t], md_t) and torch.equal(am[t], am_t)
    assert bool((am < k_real[:, None]).all())
    md_r, am_r = ref.min_dist_argmin_batched_ref(q, c)
    np.testing.assert_allclose(md.cpu().numpy(), md_r.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    _assert_argmins(md.cpu(), am.cpu(), md_r.cpu(), am_r.cpu())


def _with_sentinels(c):
    """One centre per site ``(S, 1, d)`` padded to the general tile's
    ``CENTER_TILE`` rows with the sentinel, so the entries take the
    general (or narrow) tile instead of the one-centre kernel."""
    pad = c.new_full((c.shape[0], da_mod.CENTER_TILE - 1, c.shape[2]),
                     ref.CENTER_SENTINEL)
    return torch.cat([c, pad], dim=1)


def _points_at_offset(rng, S, M, d, offset, device):
    """``(S, M, d)`` standard-normal points as a contiguous view that starts
    ``offset`` floats into its storage (odd offsets misalign the rows), with
    one row holding a NaN."""
    buf = torch.empty(S * M * d + offset, device=device)
    p = buf[offset:].view(S, M, d)
    p.copy_(torch.tensor(rng.standard_normal((S, M, d)),
                         dtype=torch.float32))
    p[S - 1, M // 2, 0] = float("nan")
    assert p.is_contiguous() and p.storage_offset() == offset
    return p


# M = 40 lies below one tile of the one-centre kernel (128 rows in the flat
# layout, 47 in the row layout at d = 256); 1001 is a multiple of neither.
@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [1, 3, 33, 90, 256])
@pytest.mark.parametrize("S,M", [(1, 40), (1, 1001), (7, 40), (7, 1001)])
def test_cuda_one_center_equals_general_tile(cuda, S, M, d, offset):
    """Both C entries at k_pad = 1 (the one-centre kernel) against the same
    entry with the centre padded to 64 sentinel rows (the general tile):
    the same chain of roundings, so equal bit for bit; a NaN row gives +inf
    at index 0 in both; a second launch is bit-identical."""
    rng = np.random.default_rng(1000 * S + M + 7 * d + offset)
    p = _points_at_offset(rng, S, M, d, offset, cuda)
    c = torch.tensor(rng.standard_normal((S, 1, d)), dtype=torch.float32,
                     device=cuda)
    wide = _with_sentinels(c)
    for entry, kern in ((da_mod.distance_argmin, da_mod.KERNEL),
                        (da_mod.distance_argmin_batched,
                         da_mod.KERNEL_BATCHED)):
        before = kern.launches
        md, am = entry(p, c)
        again = entry(p, c)
        md_g, am_g = entry(p, wide)
        torch.cuda.synchronize()
        assert kern.launches == before + 3
        assert torch.equal(md, md_g) and torch.equal(am, am_g)
        assert torch.equal(md, again[0]) and torch.equal(am, again[1])
        assert not bool(am.any())
        assert float(md[S - 1, M // 2]) == float("inf")
        finite = torch.ones_like(md, dtype=torch.bool)
        finite[S - 1, M // 2] = False
        assert bool(torch.isfinite(md[finite]).all())
    # and within float32 tolerance of the plain version off the NaN row
    md_r, _ = ref.min_dist_argmin_ref(p, c)
    np.testing.assert_allclose(md[finite].cpu().numpy(),
                               md_r[finite].cpu().numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_cuda_one_center_reruns_bit_identical_at_seeding_shape(cuda):
    """Seeding's shape with fewer rows per site (100 sites, d = 90) through
    ops.min_dist_argmin, as _kmeans_pp_init calls it: two launches equal bit
    for bit, and equal to the padded general tile."""
    g = torch.Generator(device="cpu").manual_seed(3)
    p = torch.randn(100, 2128, 90, generator=g).to(cuda)
    c = p[:, 17:18].clone()
    before = da_mod.KERNEL.launches
    first = ops.min_dist_argmin(p, c)
    second = ops.min_dist_argmin(p, c)
    general = da_mod.distance_argmin(p, _with_sentinels(c))
    torch.cuda.synchronize()
    assert da_mod.KERNEL.launches == before + 3
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(first, general))
    assert float(first[0][:, 17].abs().max()) <= 1e-3
