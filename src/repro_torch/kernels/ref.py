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
