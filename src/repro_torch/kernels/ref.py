"""Plain PyTorch versions of the CUDA kernels.

They are the semantics the kernels must match (``chip_smoke.py`` holds each
kernel against them on the card; the CPU tests hold them against
``repro.kernels.ref``). They materialize the full (n, k) distance matrix --
exactly what the kernels avoid. Every function takes an optional leading
batch axis (one slice per site), the written-out form of ``jax.vmap``.

Matrix products here run in full float32: PyTorch's CUDA matmul does so
unless ``torch.backends.cuda.matmul.allow_tf32`` is switched on, and TF32
would flip argmins near ties.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# Masking sentinel for padded center rows: a center at coordinate 1e15 is
# ~30 orders of magnitude farther than any real data, so it can never win
# an argmin, yet its squared distance stays finite in float32
# (d * 1e30 << 3.4e38) -- no inf/NaN propagation through min reductions.
CENTER_SENTINEL = 1.0e15


def min_dist_argmin_ref(points: torch.Tensor, centers: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., n, d), (..., k, d) -> (min squared distance (..., n) f32,
    argmin (..., n) i32)``; the lowest index wins ties."""
    p = points.float()
    c = centers.float()
    p2 = (p * p).sum(-1, keepdim=True)
    c2 = (c * c).sum(-1)
    d2 = torch.clamp_min(
        p2 + c2.unsqueeze(-2) - 2.0 * (p @ c.transpose(-1, -2)), 0.0)
    return d2.amin(-1), d2.argmin(-1).to(torch.int32)


def lloyd_reduce(points: torch.Tensor, k: int, weights: torch.Tensor,
                 min_d2: torch.Tensor, assign: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Lloyd statistics given an assignment, as a weighted one-hot
    product: ``(sums (..., k, d), counts (..., k), cost (...))``. Shared by
    the one-pass plain version and the two-pass form of ``ops.py``."""
    p = points.float()
    w = weights.float()
    oh = torch.nn.functional.one_hot(assign.long(), k).float()
    oh = oh * w.unsqueeze(-1)
    sums = oh.transpose(-1, -2) @ p
    counts = oh.sum(-2)
    cost = (w * min_d2).sum(-1)
    return sums, counts, cost


def lloyd_stats_ref(points: torch.Tensor, centers: torch.Tensor,
                    weights: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused Lloyd statistics pass.

    Returns (sums (..., k, d) f32, counts (..., k) f32, cost (...) f32)
    where sums[c] = sum_{p: argmin(p)=c} w_p * p, counts[c] = sum w_p,
    cost = sum_p w_p * min_d2(p).
    """
    if weights is None:
        weights = points.new_ones(points.shape[:-1], dtype=torch.float32)
    min_d2, assign = min_dist_argmin_ref(points, centers)
    return lloyd_reduce(points, centers.shape[-2], weights, min_d2, assign)


def min_dist_argmin_batched_ref(points: torch.Tensor, centers: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked tenants: ``(T, m, d), (T, k, d) -> ((T, m) f32, (T, m) i32)``,
    tenant t's queries reduced over tenant t's centres only, as a plain loop
    over :func:`min_dist_argmin_ref`. Masked-out centre rows arrive filled
    with :data:`CENTER_SENTINEL` and never win."""
    outs = [min_dist_argmin_ref(points[t], centers[t])
            for t in range(points.shape[0])]
    return (torch.stack([md for md, _ in outs]),
            torch.stack([am for _, am in outs]))


# Squared smoothing length eta^2 of the Weiszfeld inverse distance,
# dist = sqrt(d2 + eta^2): the classic iteration is undefined at data
# points, and seeds are data points; eta bounds the pull of a coincident
# point at w / eta (DESIGN.md Sec. 10).
WEISZFELD_ETA2 = 1e-6


def weiszfeld_reduce(points: torch.Tensor, centers: torch.Tensor,
                     weights: Optional[torch.Tensor], assign: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The normative Weiszfeld reduction given an assignment (DESIGN.md
    Sec. 10), shared by the plain version and the two-pass form of
    ``ops.py``: the assigned distance in exact form, sum((p - c_assign)^2)
    (never |p|^2 + |c|^2 - 2 p.c, whose cancellation 1/sqrt amplifies near
    zero); the eta-smoothed inverse max(w, 0) / sqrt(d2 + eta^2); the
    signed, unsmoothed cost sum w sqrt(d2). Returns (nums (..., k, d),
    denoms (..., k), cost (...)), all f32."""
    p = points.float()
    c = centers.float()
    w = (p.new_ones(p.shape[:-1]) if weights is None else weights.float())
    idx = assign.long().unsqueeze(-1).expand(*assign.shape, p.shape[-1])
    diff = p - torch.gather(c, -2, idx)
    d2 = (diff * diff).sum(-1)
    inv = torch.clamp_min(w, 0.0) / torch.sqrt(d2 + WEISZFELD_ETA2)
    oh = torch.nn.functional.one_hot(assign.long(), c.shape[-2]).float()
    oh = oh * inv.unsqueeze(-1)
    nums = oh.transpose(-1, -2) @ p
    denoms = oh.sum(-2)
    cost = (w * torch.sqrt(d2)).sum(-1)
    return nums, denoms, cost


def weiszfeld_stats_ref(points: torch.Tensor, centers: torch.Tensor,
                        weights: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused Weiszfeld statistics pass (k-median): with dist(p) the
    smoothed exact-form distance to the nearest centre,
    nums[c] = sum_{p: argmin(p)=c} max(w_p, 0) p / dist(p),
    denoms[c] = sum_{p: argmin(p)=c} max(w_p, 0) / dist(p),
    cost = sum_p w_p sqrt(d2(p))."""
    _, assign = min_dist_argmin_ref(points, centers)
    return weiszfeld_reduce(points, centers, weights, assign)
