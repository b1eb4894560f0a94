"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they need a CUDA device and nvcc, and skip elsewhere. They
import no JAX, so they run on a GPU machine that has none:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


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
    launches = [kern.launches for kern in ops.KERNELS]
    md, am = ops.min_dist_argmin(p, c)
    sums, counts, cost = ops.lloyd_stats(p, c, w)
    torch.cuda.synchronize()
    assert [kern.launches for kern in ops.KERNELS] == [x + 1 for x in
                                                       launches]
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
