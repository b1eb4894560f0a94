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
    called = (da_mod.KERNEL, lu_mod.KERNEL, lu_mod.REDUCE)
    launches = [kern.launches for kern in called]
    md, am = ops.min_dist_argmin(p, c)
    sums, counts, cost = ops.lloyd_stats(p, c, w)
    torch.cuda.synchronize()
    # a block that does not fit shared memory takes the two-pass form: a
    # second distance_argmin launch and lloyd_reduce instead of lloyd_stats
    fused = lu_mod.fits(k, d)
    assert [kern.launches for kern in called] == [
        launches[0] + (1 if fused else 2), launches[1] + (1 if fused else 0),
        launches[2] + (0 if fused else 1)]
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


# below the limit (k <= 256 at d = 90) the fused kernel runs too; k = 70
# spans two centre groups of lloyd_reduce; d = 4,096 is data selection's
@pytest.mark.cuda
@pytest.mark.parametrize("S,n,k,d", [(1, 8, 3, 5), (3, 1001, 50, 90),
                                     (2, 2500, 70, 33), (2, 2048, 8, 4096)])
def test_cuda_lloyd_reduce_equals_fused_lloyd_stats(cuda, S, n, k, d):
    """lloyd_reduce on distance_argmin's assignment and min d2 equals the
    fused lloyd_stats kernel bit for bit where the fused block fits (the
    same rows per block, the same chains in row order), and the plain
    reduction within 1e-4 of the sums of |terms| at every shape; a row
    assigned outside [0, k) adds to the cost only; a rerun is
    bit-identical."""
    rng = np.random.default_rng(n + d)
    p = torch.tensor(rng.standard_normal((S, n, d)), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.standard_normal((S, k, d)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(rng.random((S, n)), dtype=torch.float32, device=cuda)
    md, am = ops.min_dist_argmin(p, c)
    before = lu_mod.REDUCE.launches
    out = ops.lloyd_reduce(p, k, w, md, am)
    again = ops.lloyd_reduce(p, k, w, md, am)
    torch.cuda.synchronize()
    assert lu_mod.REDUCE.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    if lu_mod.fits(k, d):
        fused = ops.lloyd_stats(p, c, w)
        assert all(torch.equal(a, b) for a, b in zip(out, fused))
    plain = ref.lloyd_reduce(p, k, w, md, am)
    scale = ref.lloyd_reduce(p.abs(), k, w.abs(), md, am)
    for a, b, s in zip(out, plain, scale):
        assert bool(((a - b).abs() <= 1e-4 * s + 1e-4).all())
    # row 0 of site 0 moved to a centre past k: off every sum and count
    am_out = am.clone()
    am_out[0, 0] = k
    sums, counts, cost = ops.lloyd_reduce(p, k, w, md, am_out)
    keep = torch.ones(n, dtype=torch.bool, device=cuda)
    keep[0] = False
    sr, cr, _ = ref.lloyd_reduce(p[0, keep], k, w[0, keep], md[0, keep],
                                 am[0, keep])
    sa, ca, _ = ref.lloyd_reduce(p[0, keep].abs(), k, w[0, keep],
                                 md[0, keep], am[0, keep])
    assert bool(((sums[0] - sr).abs() <= 1e-4 * sa + 1e-4).all())
    assert bool(((counts[0] - cr).abs() <= 1e-4 * ca + 1e-4).all())
    assert torch.equal(cost, out[2])


# as test_cuda_lloyd_reduce_equals_fused_lloyd_stats; k = 320 at d = 90 is
# over the fused kernel's limit (phase 2 of chip_smoke.py takes it there)
@pytest.mark.cuda
@pytest.mark.parametrize("S,n,k,d", [(1, 8, 3, 5), (3, 1001, 50, 90),
                                     (2, 2500, 70, 33), (2, 3000, 320, 90),
                                     (2, 2048, 8, 4096)])
def test_cuda_weiszfeld_reduce_equals_fused_weiszfeld_stats(cuda, S, n, k,
                                                            d):
    """weiszfeld_reduce on distance_argmin's assignment equals the fused
    weiszfeld_stats kernel bit for bit where the fused block fits (the
    exact-form d2 by the same lanes and butterfly, the same rows per block,
    the same chains in row order), and the plain reduction within 1e-4 of
    the sums of |terms| at every shape; a row assigned outside [0, k) adds
    nothing; a rerun is bit-identical."""
    rng = np.random.default_rng(n + d + 1)
    p = torch.tensor(rng.standard_normal((S, n, d)), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.standard_normal((S, k, d)), dtype=torch.float32,
                     device=cuda)
    w = torch.tensor(rng.standard_normal((S, n)), dtype=torch.float32,
                     device=cuda)
    _, am = ops.min_dist_argmin(p, c)
    before = wz_mod.REDUCE.launches
    out = ops.weiszfeld_reduce(p, c, w, am)
    again = ops.weiszfeld_reduce(p, c, w, am)
    torch.cuda.synchronize()
    assert wz_mod.REDUCE.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    if wz_mod.fits(k, d):
        fused = ops.weiszfeld_stats(p, c, w)
        assert all(torch.equal(a, b) for a, b in zip(out, fused))
    plain = ref.weiszfeld_reduce(p, c, w, am)
    na, ca = _weiszfeld_scale(p, c, w, am)
    for a, b, s in zip(out, plain, (na, plain[1], ca)):
        assert bool(((a - b).abs() <= 1e-4 * s + 1e-4).all())
    # row 0 of site 0 moved to a centre past k: off every sum and the cost
    am_out = am.clone()
    am_out[0, 0] = k
    nums, denoms, cost = ops.weiszfeld_reduce(p, c, w, am_out)
    keep = torch.ones(n, dtype=torch.bool, device=cuda)
    keep[0] = False
    nr, dr, cr = ref.weiszfeld_reduce(p[0, keep], c[0], w[0, keep],
                                      am[0, keep])
    na, ca = _weiszfeld_scale(p[0, keep], c[0], w[0, keep], am[0, keep])
    assert bool(((nums[0] - nr).abs() <= 1e-4 * na + 1e-4).all())
    assert bool(((denoms[0] - dr).abs() <= 1e-4 * dr + 1e-4).all())
    assert abs(float(cost[0] - cr)) <= 1e-4 * float(ca) + 1e-4


@pytest.mark.cuda
def test_cuda_weiszfeld_two_pass_runs_no_plain_product(cuda, monkeypatch):
    """At data selection's shape (8 sites x 2,048 rows x 4,096 features,
    k = 8) ops.weiszfeld_stats launches one distance_argmin and one
    weiszfeld_reduce, and never reaches a plain version."""
    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(ref, "weiszfeld_reduce", refuse)
    monkeypatch.setattr(ref, "weiszfeld_stats_ref", refuse)
    g = torch.Generator(device="cpu").manual_seed(8)
    p = torch.randn(8, 2048, 4096, generator=g).to(cuda)
    c = p[:, :8].clone()
    w = torch.rand(8, 2048, generator=g).to(cuda)
    assert not wz_mod.fits(8, 4096)
    before = [kern.launches for kern in ops.KERNELS]
    ops.weiszfeld_stats(p, c, w)
    torch.cuda.synchronize()
    moved = {kern.name: kern.launches - b
             for kern, b in zip(ops.KERNELS, before)}
    assert moved == {"distance_argmin": 1, "lloyd_stats": 0,
                     "weiszfeld_stats": 0, "distance_argmin_batched": 0,
                     "lloyd_reduce": 0, "weiszfeld_reduce": 1}, moved


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
    memory take the two-pass form and launch weiszfeld_reduce instead of
    weiszfeld_stats."""
    before = (wz_mod.KERNEL.launches, wz_mod.REDUCE.launches)
    nums, denoms, cost = ops.weiszfeld_stats(p, c, w)
    again = ops.weiszfeld_stats(p, c, w)
    _, am = ops.min_dist_argmin(p, c)
    torch.cuda.synchronize()
    fused = wz_mod.fits(c.shape[-2], c.shape[-1])
    assert (wz_mod.KERNEL.launches, wz_mod.REDUCE.launches) == (
        before[0] + (2 if fused else 0), before[1] + (0 if fused else 2))
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
    memory take the two-pass form and launch lloyd_reduce instead of
    lloyd_stats."""
    before = (lu_mod.KERNEL.launches, lu_mod.REDUCE.launches)
    sums, counts, cost = ops.lloyd_stats(p, c, w)
    again = ops.lloyd_stats(p, c, w)
    md, am = ops.min_dist_argmin(p, c)
    torch.cuda.synchronize()
    k = c.shape[-2]
    fused = lu_mod.fits(k, c.shape[-1])
    assert (lu_mod.KERNEL.launches, lu_mod.REDUCE.launches) == (
        before[0] + (2 if fused else 0), before[1] + (0 if fused else 2))
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
    the kernel: the reduction kernel (weiszfeld_reduce, lloyd_reduce) on
    distance_argmin's assignment exactly, and the plain reduction within
    1e-4 of the sums of |terms|."""
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
    before = (mod.KERNEL.launches, da_mod.KERNEL.launches,
              mod.REDUCE.launches)
    out = getattr(ops, name)(p, c, w)
    md, am = ops.min_dist_argmin(p, c)
    lloyd = name == "lloyd_stats"
    want = (lu_mod.lloyd_reduce(p[None], w[None], md[None], am[None], k + 1)
            if lloyd else wz_mod.weiszfeld_reduce(p[None], c[None], w[None],
                                                  am[None]))
    torch.cuda.synchronize()
    assert (mod.KERNEL.launches, da_mod.KERNEL.launches,
            mod.REDUCE.launches) == (before[0], before[1] + 2,
                                     before[2] + 2)
    assert all(torch.equal(a, b[0]) for a, b in zip(out, want))
    if lloyd:
        plain = ref.lloyd_reduce(p, k + 1, w, md, am)
        scale = ref.lloyd_reduce(p.abs(), k + 1, w.abs(), md, am)
    else:
        plain = ref.weiszfeld_reduce(p, c, w, am)
        na, ca = _weiszfeld_scale(p, c, w, am)
        scale = (na, plain[1], ca)
    for a, b, s in zip(out, plain, scale):
        assert bool(((a - b).abs() <= 1e-4 * s + 1e-4).all())


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
                                     (7, 200, 1, 33), (64, 16, 64, 90),
                                     (40, 32, 33, 90), (1024, 8, 50, 90),
                                     (3, 1024, 64, 90)])
def test_cuda_batched_argmin_equals_per_tenant_loop(cuda, T, m, k, d):
    """The stacked-tenant entry against a loop of single-tenant launches
    over the same stacked buffers, bit for bit (DESIGN.md Sec. 13), and
    against the resident and the general tile on the same stacked buffers,
    bit for bit; and against the plain version within float32 tolerance;
    masked rows (sentinel) never win. The launch is counted under the
    kernel the library reports it launched: one centre the one-centre
    kernel, else the general tile's 8-point shape up to 8 rows and the
    resident tile above."""
    rng = np.random.default_rng(T * m)
    q = torch.tensor(rng.standard_normal((T, m, d)), dtype=torch.float32,
                     device=cuda)
    c = torch.tensor(rng.standard_normal((T, k, d)), dtype=torch.float32,
                     device=cuda)
    k_real = torch.tensor(rng.integers(1, k + 1, T), device=cuda)
    mask = torch.arange(k, device=cuda)[None, :] < k_real[:, None]
    c = torch.where(mask[..., None], c, ref.CENTER_SENTINEL)
    before = (da_mod.KERNEL.launches, da_mod.KERNEL_BATCHED.launches)
    served = (da_mod.ONE_CENTER if k == 1 else da_mod.TILE if m <= 8
              else da_mod.RESIDENT)
    by_kernel = _route_counts()
    md, am = ops.min_dist_argmin_batched(q, c)
    torch.cuda.synchronize()
    assert (da_mod.KERNEL.launches,
            da_mod.KERNEL_BATCHED.launches) == (before[0], before[1] + 1)
    moved = {name: n - by_kernel[name] for name, n in _route_counts().items()}
    assert moved == {kern.name: int(kern is served) for kern in da_mod.ROUTES}
    for t in range(T):
        md_t, am_t = ops.min_dist_argmin(q[t], c[t])
        assert torch.equal(md[t], md_t) and torch.equal(am[t], am_t)
    for entry in (da_mod.distance_argmin_tile,
                  da_mod.distance_argmin_resident):
        md_g, am_g = entry(q, _padded_to_tile(c))
        assert torch.equal(md, md_g) and torch.equal(am, am_g)
    assert bool((am < k_real[:, None]).all())
    md_r, am_r = ref.min_dist_argmin_batched_ref(q, c)
    np.testing.assert_allclose(md.cpu().numpy(), md_r.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    _assert_argmins(md.cpu(), am.cpu(), md_r.cpu(), am_r.cpu())


def _with_sentinels(c):
    """One centre per site ``(S, 1, d)`` padded to the general tile's
    ``CENTER_TILE`` rows with the sentinel, so the entries take the
    resident tile instead of the one-centre kernel."""
    return _padded_to_tile(c)


def _padded_to_tile(c):
    """``(S, k, d)`` centres padded with sentinel rows to a multiple of
    ``CENTER_TILE`` (one centre too), as the general tile takes them."""
    k = c.shape[1]
    pad = c.new_full((c.shape[0], -k % da_mod.CENTER_TILE, c.shape[2]),
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
    entry with the centre padded to 64 sentinel rows (the resident tile)
    and against the general tile on those rows: the same chain of
    roundings, so equal bit for bit; a NaN row gives +inf at index 0 in
    all; a second launch is bit-identical."""
    rng = np.random.default_rng(1000 * S + M + 7 * d + offset)
    p = _points_at_offset(rng, S, M, d, offset, cuda)
    c = torch.tensor(rng.standard_normal((S, 1, d)), dtype=torch.float32,
                     device=cuda)
    wide = _with_sentinels(c)
    md_t, am_t = da_mod.distance_argmin_tile(p, wide)
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
        assert torch.equal(md, md_t) and torch.equal(am, am_t)
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


def _route_counts():
    return {kern.name: kern.launches for kern in da_mod.ROUTES}


# k = 320 is the two-pass form of the statistics kernels at d = 90; at
# d = 256 the blocks of k = 256 and 320 do not fit and take the general
# tile. M = 40 lies below one 64-row tile; 1001 is not a multiple of 64.
@pytest.mark.cuda
@pytest.mark.parametrize("offset", ["0", "row"])
@pytest.mark.parametrize("M", [40, 1001])
@pytest.mark.parametrize("k", [2, 50, 64, 65, 256, 320])
@pytest.mark.parametrize("d", [1, 3, 33, 90, 256])
def test_cuda_resident_tile_equals_general_tile(cuda, d, k, M, offset):
    """Both entries at k_pad > 1 take the resident tile where its block
    fits shared memory, else the general tile (the counters, which count
    the kernel the library reports, show which) and give the
    general tile's output bit for bit, on 3 sites with points as a view
    from row 1 (off a 16-byte boundary unless 4 divides d) and a NaN row,
    which gets +inf at index 0; a rerun is bit-identical; within float32
    tolerance of the plain version off the NaN row."""
    S = 3
    rng = np.random.default_rng(1000 * d + 10 * k + M)
    p = _points_at_offset(rng, S, M, d, {"0": 0, "row": d}[offset], cuda)
    c = torch.tensor(rng.standard_normal((S, k, d)), dtype=torch.float32,
                     device=cuda)
    c_pad = _padded_to_tile(c)
    served = (da_mod.RESIDENT if da_mod.resident_fits(c_pad.shape[1], d)
              else da_mod.TILE)
    before = _route_counts()
    md, am = da_mod.distance_argmin(p, c_pad)
    again = da_mod.distance_argmin(p, c_pad)
    md_b, am_b = da_mod.distance_argmin_batched(p, c_pad)
    md_t, am_t = da_mod.distance_argmin_tile(p, c_pad)
    torch.cuda.synchronize()
    moved = {name: n - before[name] for name, n in _route_counts().items()}
    expect = {kern.name: 0 for kern in da_mod.ROUTES}
    expect[da_mod.TILE.name] += 1
    expect[served.name] += 3
    assert moved == expect
    for x, y in ((md, md_t), (am, am_t), (again[0], md), (again[1], am),
                 (md_b, md_t), (am_b, am_t)):
        assert torch.equal(x, y)
    assert float(md[S - 1, M // 2]) == float("inf")
    assert int(am[S - 1, M // 2]) == 0
    finite = torch.ones_like(md, dtype=torch.bool)
    finite[S - 1, M // 2] = False
    md_r, am_r = ref.min_dist_argmin_ref(p, c)
    np.testing.assert_allclose(md[finite].cpu().numpy(),
                               md_r[finite].cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    _assert_argmins(md[finite].cpu(), am[finite].cpu(),
                    md_r[finite].cpu(), am_r[finite].cpu())


# the largest k_pad x d whose resident block fits the 227 KiB (at d = 444
# it takes all but 12 bytes), and one centre tile or one feature more
@pytest.mark.cuda
@pytest.mark.parametrize("k,d,fits", [(512, 90, True), (520, 90, False),
                                      (64, 444, True), (2, 445, False)])
def test_cuda_at_and_beyond_the_resident_limit(cuda, k, d, fits):
    """At the limit the resident tile launches; beyond it both entries
    take the general tile (the counters show it), and either way the
    output is the general tile's bit for bit."""
    rng = np.random.default_rng(k + d)
    p = torch.tensor(rng.standard_normal((2, 300, d)), dtype=torch.float32,
                     device=cuda)
    c = _padded_to_tile(torch.tensor(rng.standard_normal((2, k, d)),
                                     dtype=torch.float32, device=cuda))
    served = da_mod.RESIDENT if fits else da_mod.TILE
    assert da_mod.resident_fits(c.shape[1], d) is fits
    before = _route_counts()
    out = [da_mod.distance_argmin(p, c), da_mod.distance_argmin_batched(p, c)]
    md_t, am_t = da_mod.distance_argmin_tile(p, c)
    torch.cuda.synchronize()
    moved = {name: n - before[name] for name, n in _route_counts().items()}
    assert moved[served.name] == (2 if fits else 3)
    assert moved[da_mod.ONE_CENTER.name] == 0
    assert moved[da_mod.RESIDENT.name] == (2 if fits else 0)
    for md, am in out:
        assert torch.equal(md, md_t) and torch.equal(am, am_t)
    md_r, _ = ref.min_dist_argmin_ref(p, c)
    np.testing.assert_allclose(md_t.cpu().numpy(), md_r.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


# where the entries switch from the general tile's 8-point shape to the
# resident tile, at the main path's width and at the resident limit
@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 9, 32])
@pytest.mark.parametrize("k,d", [(50, 90), (512, 90), (2, 3)])
def test_cuda_entries_report_the_kernel_they_launched(cuda, k, d, rows):
    """Both entries take the general tile up to 8 rows per site and the
    resident tile above (the block fits at these shapes); the counters
    move under the kernel the library reports, and the output is the
    other kernel's bit for bit."""
    rng = np.random.default_rng(k + d + rows)
    p = torch.tensor(rng.standard_normal((4, rows, d)), dtype=torch.float32,
                     device=cuda)
    c = _padded_to_tile(torch.tensor(rng.standard_normal((4, k, d)),
                                     dtype=torch.float32, device=cuda))
    served, other = ((da_mod.TILE, da_mod.distance_argmin_resident)
                     if rows <= 8 else
                     (da_mod.RESIDENT, da_mod.distance_argmin_tile))
    for entry in (da_mod.distance_argmin, da_mod.distance_argmin_batched):
        before = _route_counts()
        md, am = entry(p, c)
        moved = {name: n - before[name]
                 for name, n in _route_counts().items()}
        assert moved == {kern.name: int(kern is served)
                         for kern in da_mod.ROUTES}
        md_o, am_o = other(p, c)
        torch.cuda.synchronize()
        assert torch.equal(md, md_o) and torch.equal(am, am_o)


# blocks that own several 64-row tiles and a ragged last one: one site of
# 100,003 rows, sites of 577 rows, 1,000 sites of 129 rows, the full data
@pytest.mark.cuda
@pytest.mark.parametrize("S,M", [(1, 100_003), (2, 64 * 9 + 1),
                                 (1000, 129), (1, 515_345)])
def test_cuda_resident_tile_writes_every_row_once(cuda, S, M):
    """The resident tile's rows per block (worked out from the blocks that
    fit on the card) cover every row: its outputs, in buffers that held
    poison just before, equal the general tile's bit for bit."""
    rng = np.random.default_rng(S + M)
    p = torch.tensor(rng.standard_normal((S, M, 16)), dtype=torch.float32,
                     device=cuda)
    c = _padded_to_tile(torch.tensor(rng.standard_normal((S, 50, 16)),
                                     dtype=torch.float32, device=cuda))
    md_t, am_t = da_mod.distance_argmin_tile(p, c)
    # two freed buffers of the outputs' size, all bits set (NaN, -1): the
    # caching allocator hands them to the resident tile's outputs
    poison = [torch.full((S, M), -1, dtype=torch.int32, device=cuda)
              for _ in range(2)]
    torch.cuda.synchronize()
    del poison
    md, am = da_mod.distance_argmin_resident(p, c)
    torch.cuda.synchronize()
    assert torch.equal(md, md_t) and torch.equal(am, am_t)
    assert bool((am >= 0).all()) and bool(torch.isfinite(md).all())


@pytest.mark.cuda
def test_cuda_resident_tile_at_the_sites_shape(cuda):
    """The sensitivities' shape (100 sites of 21,280 rows, k = 50, d = 90)
    through ops.min_dist_argmin: the resident tile, equal bit for bit to
    the general tile, and two launches equal bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(7)
    p = torch.randn(100, 21280, 90, generator=g).to(cuda)
    c = p[:, 200:250].clone()
    before = da_mod.RESIDENT.launches
    first = ops.min_dist_argmin(p, c)
    second = ops.min_dist_argmin(p, c)
    general = da_mod.distance_argmin_tile(p, ops.pad_centers(c))
    torch.cuda.synchronize()
    assert da_mod.RESIDENT.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(first, general))
    assert float(first[0][:, 200:250].abs().max()) <= 1e-2


# -- the staged engine and the stream service on the card -------------------

def _staged_sites(n_sites=6, per=150, k=4, d=8, seed=0):
    """The staged tests' instance: 4 tight clusters over 6 weighted sites."""
    from repro_torch.core.partition import pad_partition, partition_indices
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((k, d))
    pts = np.concatenate(
        [centers[i] + 0.15 * rng.standard_normal((per, d)) for i in range(k)]
    ).astype(np.float32)
    idx = partition_indices(pts, n_sites, "weighted", seed=seed + 1)
    return pad_partition(pts, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("strat,obj", [("algorithm1", "kmeans"),
                                       ("cohen_addad", "kmedian"),
                                       ("mapreduce", "kmeans"),
                                       ("algorithm1", "kmedian")])
def test_cuda_staged_strict_equals_lockstep(cuda, strat, obj):
    """Strict mode on the card: every field bit-equal to the lockstep
    path, with each kernel launched once per site where lockstep launches
    it once for all sites."""
    from repro_torch.core import prng
    from repro_torch.core.coreset import (distributed_coreset,
                                          staged_distributed_coreset)
    sp, sm = (torch.from_numpy(a).to(cuda) for a in _staged_sites())
    key = prng.PRNGKey(0, device=cuda)

    def launched(fn):
        before = [kern.launches for kern in ops.KERNELS]
        out = fn()
        torch.cuda.synchronize()
        return out, [kern.launches - b for kern, b in zip(ops.KERNELS,
                                                          before)]

    base, n_base = launched(lambda: distributed_coreset(
        key, sp, sm, 4, 200, objective=obj, strategy=strat,
        backend="cuda", device=cuda))
    (staged, detail), n_staged = launched(
        lambda: staged_distributed_coreset(
            key, sp, sm, 4, 200, objective=obj, strategy=strat,
            backend="cuda", device=cuda))
    for f in ("points", "weights", "t_i", "local_costs"):
        assert torch.equal(getattr(base, f), getattr(staged, f)), f
    assert n_staged == [sp.shape[0] * n for n in n_base]
    assert (detail.iters_run == 5).all() and detail.host_reads == 0


@pytest.mark.cuda
def test_cuda_lloyd_converged_strict_equals_lloyd(cuda):
    from repro_torch.core import clustering
    g = torch.Generator(device="cpu").manual_seed(3)
    pts = torch.randn(2000, 90, generator=g).to(cuda)
    init = pts[:50].clone()
    ref_c, _ = clustering.lloyd(pts, init, iters=6, backend="cuda",
                                device=cuda)
    out, runs = clustering.lloyd_converged(pts, init, iters=6, tol=0.0,
                                           backend="cuda", device=cuda)
    assert torch.equal(out, ref_c) and int(runs) == 6
    out, runs = clustering.lloyd_converged(pts, init, iters=50, tol=1e-3,
                                           backend="cuda", device=cuda)
    assert 1 <= int(runs) <= 50 and bool(torch.isfinite(out).all())


@pytest.mark.cuda
def test_cuda_service_answers_equal_query_assignments(cuda):
    """ClusterQueryService on the card: every answer bit-equal to
    query_assignments with the service's cached centres, through the
    batched kernel; query_load's counts equal the plain lloyd_stats
    counts."""
    from repro_torch.core.backend import query_assignments
    from repro_torch.data.synthetic import drifting_mixture_stream
    from repro_torch.stream import (ClusterQueryService, StreamState,
                                    TreeConfig)
    cfg = TreeConfig(k=8, t=200, d=16, batch_size=1024, levels=8)
    state = StreamState(cfg, device=cuda)
    for b in drifting_mixture_stream(5, 1000, d=16, k=8, seed=1):
        state.push(b)
    svc = ClusterQueryService(state, k=8, staleness_frac=0.1,
                              max_bucket=256, backend="cuda")
    rng = np.random.default_rng(2)
    before = da_mod.KERNEL_BATCHED.launches
    for m in (8, 100, 256, 700):
        q = rng.standard_normal((m, 16)).astype(np.float32)
        assign, dist = svc.query(q)
        a, d = query_assignments(torch.from_numpy(q).to(cuda),
                                 svc.cached_centers(), backend="cuda",
                                 device=cuda)
        assert torch.equal(assign, a) and torch.equal(dist, d)
        load = svc.query_load(q)
        _, counts, _ = ref.lloyd_stats_ref(torch.from_numpy(q).to(cuda),
                                           svc.cached_centers())
        assert torch.equal(load, counts)
    assert da_mod.KERNEL_BATCHED.launches > before



def _spy(record):
    """Wrap the SPMD path's stages in this process so that one run records
    what they saw: the draws and masses of the sample, the centres of each
    Lloyd solve and the final solve's inputs (the gathered coreset and its
    seeds). Returns a function that restores them."""
    from repro_torch.core import clustering, distributed
    from repro_torch.core.coreset import weighted_choice
    sample, lloyd = distributed._sample_and_weight, clustering._lloyd

    def spy_sample(keys, points, m, weights, assign, k, t_local, t_buffer,
                   *rest):
        record["draws"] = weighted_choice(keys, m, t_buffer)[0].cpu().numpy()
        record["m"] = m[0].cpu().numpy()
        record["assign"] = assign[0].cpu().numpy()
        return sample(keys, points, m, weights, assign, k, t_local,
                      t_buffer, *rest)

    def spy_lloyd(points, centers, weights, *rest):
        out = lloyd(points, centers, weights, *rest)
        record.setdefault("lloyd", []).append(
            [x.cpu().numpy() for x in (points, centers, weights, out[0])])
        return out

    distributed._sample_and_weight = spy_sample
    clustering._lloyd = spy_lloyd

    def restore():
        distributed._sample_and_weight = sample
        clustering._lloyd = lloyd
    return restore


def spmd_instance():
    """The 8-site instance of the reference's SPMD script (k = 4, d = 8,
    t = 256)."""
    from repro_torch.core.partition import pad_partition, partition_indices
    rng = np.random.default_rng(0)
    c0 = 3.0 * rng.standard_normal((4, 8))
    pts = np.concatenate([c0[i] + 0.15 * rng.standard_normal((400, 8))
                          for i in range(4)]).astype(np.float32)
    return (pts,) + pad_partition(pts, partition_indices(pts, 8, "weighted",
                                                         seed=1))


def spmd_two_ranks(mesh):
    """One rank of the SPMD path on :func:`spmd_instance` at W = 2 (four
    sites merged per rank) under all three collectives: (centers,
    local_costs, t_i) per mode as host arrays, the all-gather run's stages
    (:func:`_spy`), the launches per kernel and the staged bytes."""
    from repro_torch.core import prng
    from repro_torch.core.distributed import spmd_distributed_kmeans
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, sp, sm = spmd_instance()
    out = {"stages": {}}
    for kern in ops.KERNELS:
        kern.launches = 0
    for mode in ("all_gather", "neighbor_rounds", "torus_2d"):
        restore = _spy(out["stages"]) if mode == "all_gather" else None
        c, lc, t_i = spmd_distributed_kmeans(
            mesh, "sites", prng.PRNGKey(0, device=mesh.device), sp, sm, 4,
            t=256, t_buffer=256, collectives=mode)
        if restore is not None:
            restore()
        out[mode] = tuple(x.cpu().numpy() for x in (c, lc, t_i))
    out["launches"] = {kern.name: kern.launches for kern in ops.KERNELS}
    out["staged_bytes"] = mesh.staged_bytes
    return out


@pytest.mark.cuda
def test_cuda_spmd_two_ranks_on_one_card_match_the_cpu(cuda):
    """Two gloo ranks on cuda:0 through the launcher, buffers staged
    through pinned host memory: the three collectives and both ranks
    bit-identical, the kernels launched in every rank, the staged bytes
    exactly the payloads', and the same two ranks on the CPU's plain
    versions agreeing stage by stage -- t_i exactly; Round 1's centres to
    1e-5 of max |centre| and its masses within the kernels' distance
    tolerance; a draw may land on the neighbouring point where the masses'
    cumulative sums differ in the last bits (at most 1% of the slots, each
    one index off: the named cause, as for the strategies' draws in ROADMAP
    C); the final solve, given the card's gathered coreset, to 1e-3 of max
    |centre|; and the full-data cost of the card's centres to 1e-3 of the
    CPU's. The centres themselves are not held to 1e-3 end to end: one
    moved draw of 512 moves them by up to 1.2e-3 (the chip run that traced
    it: two of rank 0's 256 draws one index off)."""
    from repro_torch.core import clustering, prng
    from repro_torch.core.mesh import launch
    from repro_torch.kernels import _build
    _build.build()      # the ranks load the libraries, never build them
    gpu = launch(f"{__name__}:spmd_two_ranks", 2, device="cuda:0",
                 timeout=300)
    cpu = launch(f"{__name__}:spmd_two_ranks", 2, device="cpu", timeout=300)
    first = gpu[0]["all_gather"]
    # per payload and mode: 8,320 + 1,040 + 4 bytes over one all-gather
    # (out and W back) or one hop each way (ring, and the (1, 2) torus),
    # plus the output gather's two scalars
    staged = 3 * (8320 + 1040 + 4) + 2 * 2 * (8320 + 1040 + 4) + 3 * 24
    for rank in gpu:
        for mode in ("all_gather", "neighbor_rounds", "torus_2d"):
            for a, b in zip(first, rank[mode]):
                assert a.tobytes() == b.tobytes(), mode
        # per mode: 2k + 1 distance_argmin and 8 + 10 lloyd_stats launches
        assert rank["launches"] == {
            "distance_argmin": 3 * 9, "lloyd_stats": 3 * 18,
            "weiszfeld_stats": 0, "distance_argmin_batched": 0,
            "lloyd_reduce": 0, "weiszfeld_reduce": 0}
        assert rank["staged_bytes"] == staged
    assert all(r["launches"]["distance_argmin"] == 0
               and r["staged_bytes"] == 0 for r in cpu)
    c_cpu, _, t_cpu = cpu[0]["all_gather"]
    np.testing.assert_array_equal(first[2], t_cpu)
    pts, sp, _ = spmd_instance()
    for r, (g, c) in enumerate(zip(gpu, cpu)):
        gs, cs = g["stages"], c["stages"]
        centres = gs["lloyd"][0][3]
        np.testing.assert_allclose(centres, cs["lloyd"][0][3], rtol=0,
                                   atol=1e-5 * np.abs(centres).max())
        # m = |w| d2 (weights 0 or 1): the kernels' distance tolerance
        block = sp[4 * r:4 * r + 4].reshape(-1, 8)
        scale = (block ** 2).sum(1) + (centres[gs["assign"]] ** 2).sum(1)
        assert (np.abs(gs["m"] - cs["m"]) <= 1e-5 * scale + 1e-6).all()
        moved = np.nonzero(gs["draws"] != cs["draws"])[0]
        assert moved.size <= gs["draws"].size // 100, moved
        assert (np.abs(gs["draws"][moved] - cs["draws"][moved]) == 1).all()
        # the final solve on the card's coreset, replayed on the CPU
        cs_pts, seeds, cs_w, fc = gs["lloyd"][1]
        key = prng.fold_in(prng.PRNGKey(0, device="cpu"), 0)
        again = clustering.kmeans_pp_init(key, cs_pts, 4,
                                          weights=np.maximum(cs_w, 0.0),
                                          device="cpu")
        np.testing.assert_array_equal(again.numpy(), seeds)
        again, _ = clustering.lloyd(cs_pts, seeds, weights=cs_w, iters=10,
                                    device="cpu")
        np.testing.assert_allclose(again.numpy(), fc, rtol=0,
                                   atol=1e-3 * np.abs(fc).max())
    costs = [float(clustering.cost(pts, c, device="cpu"))
             for c in (first[0], c_cpu)]
    assert abs(costs[0] - costs[1]) <= 1e-3 * costs[1], costs


# -- the WAN runtime and data selection on the card -------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "clock", "random"])
def test_cuda_wan_flood_matches_the_cpu(cuda, mode):
    """wan_flood_exec on a CUDA payload against the same flood on the CPU
    (wan_clusters(3, 4) under drops, churn, a dead node and duplicates):
    the relay tables bit for bit, NaN and signed-zero payloads included,
    and every result field but the wall time."""
    from repro_torch.core import topology
    from repro_torch.wan import FaultPlan, wan_flood_exec
    g = topology.wan_clusters(3, 4, cross_links=2, seed=0)
    plan = FaultPlan(drop=((0, 1),), churn=((5, 1, 3), (9, 0, -1)),
                     dup_rate=0.3, seed=3)
    rng = np.random.default_rng(1)
    pay = rng.standard_normal((g.n, 7, 5)).astype(np.float32)
    pay[::2, 0, 0] = -0.0
    pay[1::3, 1, 1] = np.nan
    out = {}
    for dev in ("cpu", cuda):
        table, res = wan_flood_exec(g, torch.from_numpy(pay).to(dev),
                                    mode=mode, faults=plan, unit_points=2.0,
                                    dim=4, seed=7, p=0.4)
        out[str(dev)] = (table.cpu(), res)
    (tc, rc), (tg, rg) = out["cpu"], out["cuda"]
    assert torch.equal(tc.view(torch.int32), tg.view(torch.int32))
    assert (rc.rounds, rc.rounds_to_complete, rc.rounds_to_quiesce,
            rc.per_round_transmissions) == (
        rg.rounds, rg.rounds_to_complete, rg.rounds_to_quiesce,
        rg.per_round_transmissions)
    for f in ("completion", "staleness", "known"):
        assert np.array_equal(getattr(rc, f), getattr(rg, f)), f
    assert rc.ledger.as_dict(by_phase=True) == rg.ledger.as_dict(
        by_phase=True)


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["kmeans", "kmedian"])
def test_cuda_async_equals_exec_and_the_restricted_oracle(cuda, objective):
    """On the card: engine="async" in full mode equals engine="exec" bit for
    bit with the same launches per kernel; a faulty clock run equals the
    restricted oracle and the final solve bit for bit."""
    from repro_torch.core import distributed, prng, topology
    from repro_torch.core.coreset import Coreset
    from repro_torch.wan import FaultPlan, restricted_sim_coreset
    sp, sm = (torch.from_numpy(a).to(cuda) for a in _staged_sites(12))
    g = topology.wan_clusters(3, 4, cross_links=2, seed=0)
    key = prng.PRNGKey(5, device=cuda)

    def run(**kw):
        before = [kern.launches for kern in ops.KERNELS]
        res = distributed.graph_distributed_kmeans(
            key, sp, sm, 4, 96, g, objective=objective, backend="cuda",
            device=cuda, **kw)
        torch.cuda.synchronize()
        return res, [kern.launches - b for kern, b in zip(ops.KERNELS,
                                                          before)]

    ex, n_ex = run(engine="exec")
    asy, n_as = run(engine="async", wan_mode="full")
    assert torch.equal(ex.centers, asy.centers)
    assert torch.equal(ex.coreset.points, asy.coreset.points)
    assert torch.equal(ex.coreset.weights, asy.coreset.weights)
    assert n_ex == n_as and sum(n_as) > 0
    plan = FaultPlan(drop=((0, 1),), churn=((5, 1, 3), (9, 0, -1)), seed=3)
    res, _ = run(engine="async", faults=plan, wan_seed=1)
    k1, k2 = prng.split(key)
    pts, w, _, _ = restricted_sim_coreset(
        k1, sp, sm, 4, 96, 96, objective, 8, False, "cuda",
        plan.surviving_nodes(g.n), device=cuda)
    assert torch.equal(res.coreset.points, pts)
    assert torch.equal(res.coreset.weights, w)
    assert torch.equal(res.centers, distributed._solve_on_coreset(
        k2, Coreset(pts, w), 4, objective, 8, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 4096])
def test_cuda_select_coreset_matches_the_cpu(cuda, monkeypatch, d):
    """select_coreset on the card against the CPU's plain versions: t_i
    exact, the weight-0 pattern and the live slots' indices equal but for
    draws one index off (at most 1%: the masses differ in the last bits),
    the mass the pool's, a rerun bit-identical; at d = 4,096 distance_argmin
    runs the general tile and lloyd_stats the two-pass form (lloyd_reduce
    after it). embed_examples
    agrees with the CPU to 1e-6 and chunks alike."""
    from repro_torch.core import prng
    from repro_torch.data import embed_examples, select_coreset, selection
    rng = np.random.default_rng(d)
    table = rng.standard_normal((500, d)).astype(np.float32)
    toks = rng.integers(0, 500, size=(4, 256, 16))
    emb_c = embed_examples(table, toks, device="cpu")
    emb_g = embed_examples(table, toks, device=cuda)
    np.testing.assert_allclose(emb_g.cpu().numpy(), emb_c.numpy(),
                               rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(selection, "EMBED_CHUNK_BYTES", 2 ** 20)
    assert torch.equal(emb_g, embed_examples(table, toks, device=cuda))
    mask = np.ones((4, 256), bool)
    before = {r.name: r.launches for r in da_mod.ROUTES}
    lloyd_before = (lu_mod.KERNEL.launches, lu_mod.REDUCE.launches)
    sel_g = select_coreset(prng.PRNGKey(0, device=cuda), emb_g, mask, 4, 64,
                           backend="cuda", device=cuda)
    torch.cuda.synchronize()
    by = {r.name: r.launches - before[r.name] for r in da_mod.ROUTES}
    fused = lu_mod.fits(4, d)
    assert (lu_mod.KERNEL.launches - lloyd_before[0],
            lu_mod.REDUCE.launches - lloyd_before[1]) == (
                (5, 0) if fused else (0, 5))
    assert by[da_mod.ONE_CENTER.name] == 4
    general = by[da_mod.TILE.name] + by[da_mod.RESIDENT.name]
    assert general == (1 if fused else 6)
    assert (by[da_mod.TILE.name] > 0) == (d == 4096)
    again = select_coreset(prng.PRNGKey(0, device=cuda), emb_g, mask, 4, 64,
                           backend="cuda", device=cuda)
    for f in ("indices", "weights", "t_i", "local_costs"):
        assert torch.equal(getattr(sel_g, f), getattr(again, f)), f
    sel_c = select_coreset(prng.PRNGKey(0), emb_g.cpu(), mask, 4, 64,
                           device="cpu")
    assert torch.equal(sel_g.t_i.cpu(), sel_c.t_i)
    wg, wc = sel_g.weights.cpu().numpy(), sel_c.weights.numpy()
    assert np.array_equal(wg != 0, wc != 0)
    ig, ic = sel_g.indices.cpu().numpy(), sel_c.indices.numpy()
    moved = (ig != ic) & (wc != 0)
    assert moved.sum() <= max(1, moved.size // 100), int(moved.sum())
    np.testing.assert_allclose(float(wg.astype(np.float64).sum()), 4 * 256,
                               rtol=1e-3)


# -- the language-model stack (repro_torch.models) ------------------------------

from _lm_routes import rows_before_first_flip           # noqa: E402
from repro_torch import configs as lm_configs            # noqa: E402
from repro_torch.models import flash as lm_flash         # noqa: E402
from repro_torch.models import moe as lm_moe             # noqa: E402
from repro_torch.models import (forward as lm_forward,   # noqa: E402
                                init_cache as lm_init_cache,
                                init_params as lm_init_params,
                                make_positions as lm_positions)

LM_ARCHS = lm_configs.ARCH_IDS
LM_B, LM_L, LM_LP = 2, 32, 24
# the CPU tests' tolerances against the JAX package, relative to max |logit|
LM_F32_RTOL, LM_BF16_RTOL, LM_NEAR_TIE = 2e-4, 5e-2, 4e-3


def _lm_cfg(arch, exact):
    import dataclasses
    cfg = lm_configs.get_reduced(arch)
    if not exact:
        return cfg
    cf = (float(cfg.n_experts) / cfg.top_k if cfg.n_experts
          else cfg.capacity_factor)
    return dataclasses.replace(cfg, dtype="float32", capacity_factor=cf)


def _lm_modes(tc, params, tok, monkeypatch):
    """Score forward (MoE routing recorded), prefill of LM_LP tokens,
    decode to LM_L, on ``tok``'s device; host copies."""
    seen = []
    route = lm_moe.route

    def spy(p, x, cfg):
        out = route(p, x, cfg)
        seen.append((out[0].float().cpu(), out[2].cpu()))
        return out

    monkeypatch.setattr(lm_moe, "route", spy)
    out = {}
    with torch.inference_mode():
        logits, _, aux = lm_forward(params, tok, lm_positions(tok, tc), tc)
        monkeypatch.setattr(lm_moe, "route", route)
        out["logits"], out["aux"], out["routes"] = logits.cpu(), float(aux), \
            seen
        cache = lm_init_cache(tc, LM_B, LM_L, tok.device)
        lp, cache, _ = lm_forward(params, tok[:, :LM_LP],
                                  lm_positions(tok[:, :LM_LP], tc), tc,
                                  cache=cache)
        out["prefill"] = lp.cpu()
        steps = []
        for s in range(LM_LP, LM_L):
            ls, cache, _ = lm_forward(params, tok[:, s:s + 1], lm_positions(
                tok[:, s:s + 1], tc, offset=s), tc, cache=cache)
            steps.append(ls[:, 0].cpu())
        out["decode"] = torch.stack(steps, dim=1)
        out["cache"] = [{k: v.cpu() for k, v in c.items()} for c in cache]
    return out


def _lm_runs(arch, exact, cuda, monkeypatch, **changes):
    import dataclasses
    tc = dataclasses.replace(_lm_cfg(arch, exact), **changes)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab_size, (LM_B, LM_L)).astype(np.int32))
    runs = {}
    for where in ("cpu", cuda):
        params = lm_init_params(torch.Generator().manual_seed(0), tc, where)
        runs[str(where)] = _lm_modes(tc, params, tok.to(where), monkeypatch)
    return tc, runs["cpu"], runs[str(cuda)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_matches_the_cpu_in_f32(cuda, monkeypatch, arch):
    """Exactified f32, the same params on both devices: score, prefill and
    decode logits, the aux loss and the prefill-and-decode cache."""
    tc, cpu, gpu = _lm_runs(arch, True, cuda, monkeypatch)
    scale = float(cpu["logits"].abs().max())
    for k in ("logits", "prefill", "decode"):
        torch.testing.assert_close(gpu[k], cpu[k], rtol=0,
                                   atol=LM_F32_RTOL * scale, msg=k)
    assert abs(gpu["aux"] - cpu["aux"]) <= LM_F32_RTOL * max(
        abs(cpu["aux"]), 1e-6)
    for a, b in zip(gpu["cache"], cpu["cache"]):
        for k in a:
            if a[k].dtype == torch.int32:
                assert torch.equal(a[k], b[k]), k
            else:
                torch.testing.assert_close(
                    a[k].float(), b[k].float(), rtol=0,
                    atol=LM_F32_RTOL * float(b[k].abs().max() + 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_matches_the_cpu_in_bf16(cuda, monkeypatch, arch):
    """The default bf16: within LM_BF16_RTOL of max |logit|; a MoE model's
    score forward up to each row's first routing flip, every flip at a near
    tie (its prefill and decode are held in f32 above)."""
    tc, cpu, gpu = _lm_runs(arch, False, cuda, monkeypatch)
    scale = float(cpu["logits"].abs().max())
    if not tc.n_experts:
        for k in ("logits", "prefill", "decode"):
            torch.testing.assert_close(gpu[k], cpu[k], rtol=0,
                                       atol=LM_BF16_RTOL * scale, msg=k)
        return
    rows = torch.from_numpy(rows_before_first_flip(
        [p.numpy() for p, _ in cpu["routes"]],
        [i.numpy() for _, i in cpu["routes"]],
        [i.numpy() for _, i in gpu["routes"]], tc.top_k, LM_NEAR_TIE))
    assert int(rows.sum()) >= LM_L // 2
    err = (gpu["logits"] - cpu["logits"]).abs().amax(-1)
    assert bool((err[rows] <= LM_BF16_RTOL * scale).all())
    assert abs(gpu["aux"] - cpu["aux"]) <= LM_BF16_RTOL * abs(cpu["aux"])


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_decode_matches_forward(cuda, monkeypatch, arch, kv):
    """On the card, exactified f32: prefill and decode logits equal the
    score forward's within 5e-4 * max |logit| (tests/test_models.py's
    check); with an int8 KV cache within 5e-2 (K and V quantized to 1/127
    of each row's largest magnitude)."""
    tc, _, gpu = _lm_runs(arch, True, cuda, monkeypatch, kv_cache_dtype=kv)
    scale = float(gpu["logits"].abs().max())
    tol = (5e-4 if kv == "bfloat16" else 5e-2) * scale
    torch.testing.assert_close(gpu["prefill"], gpu["logits"][:, :LM_LP],
                               rtol=0, atol=tol)
    torch.testing.assert_close(gpu["decode"], gpu["logits"][:, LM_LP:],
                               rtol=0, atol=tol)


@pytest.mark.cuda
def test_cuda_lm_entry_points_default_to_the_card(cuda):
    """With no device, params and caches land on CUDA, positions follow
    the tokens, and a forward runs there."""
    tc = lm_configs.get_reduced("recurrentgemma_2b")
    params = lm_init_params(0, tc)
    cache = lm_init_cache(tc, 1, 8)
    leaves = [params["embed"]["table"]] + [
        x for layer in params["layers"] for x in _lm_leaves(layer)] + [
        x for c in cache for x in c.values()]
    assert all(x.device.type == "cuda" for x in leaves)
    tok = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        logits, cache, _ = lm_forward(params, tok, lm_positions(tok, tc), tc,
                                      cache=cache)
    assert logits.device.type == "cuda"
    assert bool(torch.isfinite(logits).all())


def _lm_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _lm_leaves(v)]
    return [tree]


@pytest.mark.cuda
def test_cuda_lm_sets_no_tf32(cuda):
    """A fresh interpreter that imports every port module and runs a
    forward and a flash backward on the card leaves float32 matmuls at full
    precision and cuDNN's TF32 flag at PyTorch's default: the port sets no
    TF32 anywhere."""
    import os
    import subprocess
    import sys
    script = """
import importlib, pkgutil, torch
before = torch.backends.cudnn.allow_tf32
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
from repro_torch import configs
from repro_torch.models import forward, init_params, make_positions
from repro_torch.models.flash import flash_attention
cfg = configs.get_reduced("llama3_8b")
p = init_params(0, cfg)
tok = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
forward(p, tok, make_positions(tok, cfg), cfg)
q = torch.randn(1, 8, 2, 2, 16, device="cuda", requires_grad=True)
k = torch.randn(1, 8, 2, 16, device="cuda")
pos = torch.arange(8, device="cuda")
flash_attention(q, k, k, pos, pos).sum().backward()
print(torch.backends.cuda.matmul.allow_tf32,
      torch.backends.cudnn.allow_tf32 == before,
      torch.get_float32_matmul_precision())
"""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.stdout.split()[-3:] == ["False", "True", "highest"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_matches_the_cpu(cuda, dtype):
    """Flash attention's forward and gradients on the card against the CPU
    on the same inputs (f32: 2e-4 forward, 3e-3 gradients, the reference
    test's tolerances; bf16: one bf16 rounding)."""
    rng = np.random.default_rng(0)
    B, L, KV, G, hd = 2, 96, 2, 2, 16
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=dtype)
               for s in ((B, L, KV, G, hd), (B, L, KV, hd), (B, L, KV, hd)))
    pos = torch.arange(L, dtype=torch.int32)
    res = []
    for where in ("cpu", cuda):
        xs = [x.to(where).requires_grad_() for x in (q, k, v)]
        out = lm_flash.flash_attention(*xs, pos.to(where), pos.to(where), 32,
                                       48)
        grads = torch.autograd.grad(out.float().sum(), xs)
        res.append([out.detach().float().cpu()] + [
            g.float().cpu() for g in grads])
    tols = ((2e-4, 3e-3, 3e-3, 3e-3) if dtype == torch.float32
            else (2 ** -7,) * 4)
    for a, b, tol in zip(res[1], res[0], tols):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


# -- training and LM serving ---------------------------------------------------

from _train_rules import (CARD_GRAD_RTOL, LOSS_RTOL,    # noqa: E402
                          assert_first_step, assert_grads)
from repro_torch import tree as lm_tree                  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,   # noqa: E402
                                    restore as ck_restore)
from repro_torch.core import prng as lm_prng             # noqa: E402
from repro_torch.data import BigramLM                    # noqa: E402
from repro_torch.optim import AdamWConfig, adamw         # noqa: E402
from repro_torch.serve import Engine, Request, generate  # noqa: E402
from repro_torch.train import (TrainConfig,              # noqa: E402
                               make_train_step)
from repro_torch.train import train_step as lm_train_step  # noqa: E402


def _train_case(arch, where):
    import dataclasses
    tc = dataclasses.replace(lm_configs.get_reduced(arch), dtype="float32")
    params = lm_init_params(torch.Generator().manual_seed(0), tc, where)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(
        0, tc.vocab_size, (LM_B, LM_L)).astype(np.int32)).to(where)
        for k in ("tokens", "labels")}
    return tc, params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_train_step_matches_the_cpu(cuda, arch):
    """f32, remat "full", the chunked loss, the same params: the loss within
    the CPU tests' tolerance and every gradient leaf within CARD_GRAD_RTOL,
    then one train step's metrics and params under the first-step rule
    (the CPU run's gradients as the reference)."""
    kw = dict(remat="full", loss_chunk=8, warmup_steps=0, peak_lr=1e-3)
    runs = {}
    for where in ("cpu", cuda):
        tc, params, batch = _train_case(arch, where)
        (loss, _), grads = lm_train_step.value_and_grad(
            params, batch["tokens"], batch["labels"], tc, TrainConfig(**kw))
        p0 = [p.cpu().clone() for p in lm_tree.leaves(params)]
        opt = adamw.init(params)
        _, _, m = make_train_step(tc, TrainConfig(**kw))(params, opt, batch,
                                                         0)
        runs[str(where)] = (float(loss), [g.cpu() for g in grads], p0,
                            [p.cpu() for p in lm_tree.leaves(params)],
                            {k: float(v) for k, v in m.items()})
    cpu, gpu = runs["cpu"], runs[str(cuda)]
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=LOSS_RTOL)
    assert_grads(gpu[1], cpu[1], arch, CARD_GRAD_RTOL)
    for k, v in gpu[4].items():
        np.testing.assert_allclose(v, cpu[4][k], rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    assert all(torch.equal(a, b) for a, b in zip(gpu[2], cpu[2]))
    assert_first_step(cpu[2], gpu[3], cpu[3], cpu[1], cpu[4]["lr"],
                      min(1.0, 1.0 / cpu[4]["grad_norm"]), arch,
                      CARD_GRAD_RTOL)


@pytest.mark.cuda
def test_cuda_adamw_matches_the_cpu(cuda):
    """Ten updates (no clipping) from the same state and gradients on both
    devices, in place: both round each op once, so the moments are
    bit-equal; the bias corrections' pow may differ in its last place, so
    the params agree to a few ulps of |p| + lr."""
    rng = np.random.default_rng(0)
    draw = lambda f: {"w": f((64, 33)), "b": f((33,)),
                      "layers": [{"k": f((5, 7, 3))}]}
    p_np = draw(lambda s: rng.standard_normal(s).astype(np.float32))
    where = ("cpu", cuda)
    params = [lm_tree.map(lambda a: torch.tensor(a, device=w), p_np)
              for w in where]
    state = [adamw.init(p) for p in params]
    eps = float(np.finfo(np.float32).eps)
    for step in range(10):
        g_np = draw(lambda s: (rng.standard_normal(s) * 10.0 ** rng.integers(
            -6, 2, s)).astype(np.float32))
        for w, p, st in zip(where, params, state):
            g = lm_tree.map(lambda a: torch.tensor(a, device=w), g_np)
            adamw.update(g, st, p, torch.tensor(1e-3, device=w),
                         AdamWConfig(grad_clip_norm=0.0))
        for name in ("m", "v"):
            for x, y in zip(lm_tree.leaves(state[1][name]),
                            lm_tree.leaves(state[0][name])):
                assert torch.equal(x.cpu(), y), (step, name)
        for x, y in zip(lm_tree.leaves(params[1]), lm_tree.leaves(params[0])):
            tol = 8 * eps * (y.abs() + 1e-3)
            assert bool(((x.cpu() - y).abs() <= tol).all()), step
        assert int(state[1]["step"]) == step + 1


@pytest.mark.cuda
def test_cuda_checkpoint_restores_on_the_cpu_and_back(cuda, tmp_path):
    """A train state on the card (bf16 params, f32 master and moments, the
    int32 step) saved through ``AsyncCheckpointer``: restored onto the CPU
    and onto the card, bit for bit, each leaf on its target's device."""
    tc = lm_configs.get_reduced("qwen2_vl_2b")
    params, opt = lm_train_step.init_state(0, tc, TrainConfig(
        bf16_params=True), device=cuda)
    tree = {"params": params, "opt": opt}
    saved = lm_tree.map(lambda x: x.clone(), tree)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(3, tree)
    lm_tree.leaves(params)[0].add_(1)       # after the snapshot
    ck.wait()
    ck.close()
    on_cpu = lm_tree.map(lambda x: torch.empty_like(x, device="cpu"), tree)
    got, step = ck_restore(str(tmp_path), target=on_cpu)
    back, _ = ck_restore(str(tmp_path), target=tree)
    assert step == 3
    for a, b, c in zip(lm_tree.leaves(got), lm_tree.leaves(back),
                       lm_tree.leaves(saved)):
        assert a.device.type == "cpu" and b.device.type == "cuda"
        assert a.dtype == c.dtype and b.dtype == c.dtype
        bits = {2: torch.int16, 4: torch.int32}
        view = (lambda t: t.view(bits[t.element_size()])
                if t.is_floating_point() else t)
        assert torch.equal(view(a), view(c.cpu()))
        assert torch.equal(view(b), view(c))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_370m",
                                  "recurrentgemma_2b", "gemma3_27b"])
def test_cuda_engine_matches_generate(cuda, arch):
    """On the card, f32: the slot engine's output equals ``generate`` per
    request, with more requests than slots."""
    import dataclasses
    tc = dataclasses.replace(lm_configs.get_reduced(arch), dtype="float32")
    params = lm_init_params(torch.Generator().manual_seed(0), tc, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab_size, size=6).astype(np.int32)
               for _ in range(5)]
    want = [generate(params, tc, torch.from_numpy(p[None]).to(cuda),
                     6)[0].cpu().numpy() for p in prompts]
    done = Engine(params, tc, n_slots=2, max_len=12).run(
        [Request(prompt=p, max_new=6) for p in prompts])
    for r, w in zip(done, want):
        np.testing.assert_array_equal(r.out, w)


@pytest.mark.cuda
def test_cuda_bigram_and_draws_match_the_cpu(cuda):
    """``randint`` bit for bit, ``normal`` to a few ulps, and BigramLM's
    batches equal on the card and on the CPU in one process."""
    for seed in (0, 5):
        a = lm_prng.randint(lm_prng.PRNGKey(seed, cuda), (64, 3), 0, 128_256)
        b = lm_prng.randint(lm_prng.PRNGKey(seed), (64, 3), 0, 128_256)
        assert torch.equal(a.cpu(), b)
        x = lm_prng.normal(lm_prng.PRNGKey(seed, cuda), (200, 200)).cpu()
        y = lm_prng.normal(lm_prng.PRNGKey(seed), (200, 200))
        torch.testing.assert_close(x, y, rtol=8 * 2.0 ** -23, atol=0)
    gpu = BigramLM(128_256, device=cuda)
    cpu = BigramLM(128_256, device="cpu")
    for step in (0, 9):
        got, want = gpu.batch(step, 8, 64), cpu.batch(step, 8, 64)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (step, k)
