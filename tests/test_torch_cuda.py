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
    assert [kern.launches for kern in called] == [x + 1 for x in launches]
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
    kernel's own assignment (weiszfeld_stats and distance_argmin assign
    through one routine), within 1e-4 of the sums of |terms|; a rerun is
    bit-identical."""
    before = wz_mod.KERNEL.launches
    nums, denoms, cost = ops.weiszfeld_stats(p, c, w)
    again = ops.weiszfeld_stats(p, c, w)
    _, am = ops.min_dist_argmin(p, c)
    torch.cuda.synchronize()
    assert wz_mod.KERNEL.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip((nums, denoms, cost),
                                                 again))
    nr, dr, cr = ref.weiszfeld_reduce(p, c, w, am)
    na, ca = _weiszfeld_scale(p, c, w, am)
    assert bool(((nums - nr).abs() <= 1e-4 * na + 1e-4).all())
    assert bool(((denoms - dr).abs() <= 1e-4 * dr + 1e-4).all())
    assert bool(((cost - cr).abs() <= 1e-4 * ca + 1e-4).all())
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
