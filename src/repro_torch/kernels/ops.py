"""Safe wrappers around the CUDA kernels: dispatch by device, padding, the
resident-centres limit and the per-kernel launch counts.

Every function takes an optional leading site axis -- ``(S, n, d)`` points
with ``(S, k, d)`` centres -- and then serves all sites in ONE launch, as
``jax.vmap`` over a ``pallas_call`` does in the JAX package.

* **Device.** A CUDA tensor goes to its kernel, which launches or raises;
  nothing falls back. A CPU tensor goes to the kernel's plain version
  (:mod:`repro_torch.kernels.ref`): the CPU has no kernel to run.
* **Padding contract** (``src/repro/kernels/ops.py``, re-derived for the
  card). Centre rows are padded to the kernel's centre tile with
  :data:`~repro_torch.kernels.ref.CENTER_SENTINEL`, so padded rows never win
  an argmin. Point rows and features are not copied into a padded buffer:
  the kernels mask the ragged tile edge themselves, which computes what
  zero-weight padded rows and zero features would. Point rows that callers
  pad (``pad_partition``'s slots) carry weight 0 and add nothing.
* **Resident-centres limit.** ``lloyd_stats`` keeps each block's sums and
  counts, ``k (d + 1)`` floats, in shared memory:
  ``LLOYD_RESIDENT_FLOATS = 47104`` floats (184 KiB of the 227 KiB a block
  may use on Hopper). The TPU kernel's limit was ``k d <= 2**20`` floats of
  resident centres (4 MiB of VMEM). Above the limit :func:`lloyd_stats`
  takes the two-pass form: the ``distance_argmin`` kernel, then the
  weighted one-hot product (a plain matrix product, as the JAX package
  left it to XLA).
* **Launch counts.** :data:`KERNELS` lists each kernel with its
  ``launches`` counter.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import distance_argmin as _da
from repro_torch.kernels import lloyd_update as _lu
from repro_torch.kernels import ref

LLOYD_RESIDENT_FLOATS = _lu.RESIDENT_FLOATS
KERNELS = (_da.KERNEL, _lu.KERNEL)


def pad_centers(centers: torch.Tensor) -> torch.Tensor:
    """``(S, k, d)`` -> ``(S, k_pad, d)`` contiguous, rows past ``k`` at the
    sentinel coordinate."""
    k = centers.shape[1]
    k_pad = -(-k // _da.center_tile(k)) * _da.center_tile(k)
    c = centers.contiguous()
    if k_pad == k:
        return c
    pad = c.new_full((c.shape[0], k_pad - k, c.shape[2]),
                     ref.CENTER_SENTINEL)
    return torch.cat([c, pad], dim=1)


def _sites(points: torch.Tensor, centers: torch.Tensor):
    """Batched views: (S, n, d), (S, k, d) and whether to drop the axis."""
    if points.ndim == 2 and centers.ndim == 2:
        return points.unsqueeze(0), centers.unsqueeze(0), True
    if points.ndim == 3 and centers.ndim == 3:
        return points, centers, False
    raise ValueError(f"points {tuple(points.shape)} and centers "
                     f"{tuple(centers.shape)} must both be 2-D or both 3-D")


def min_dist_argmin(points: torch.Tensor, centers: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., n, d), (..., k, d) -> ((..., n) f32, (..., n) i32)``."""
    if not points.is_cuda:
        return ref.min_dist_argmin_ref(points, centers)
    p, c, squeeze = _sites(points, centers)
    md, am = _da.distance_argmin(p.contiguous(), pad_centers(c))
    return (md[0], am[0]) if squeeze else (md, am)


def lloyd_stats(points: torch.Tensor, centers: torch.Tensor,
                weights: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused Lloyd statistics ``(sums (..., k, d), counts (..., k),
    cost (...))``; two passes when ``k (d + 1)`` exceeds
    :data:`LLOYD_RESIDENT_FLOATS`."""
    k, d = centers.shape[-2], centers.shape[-1]
    if weights is None:
        weights = points.new_ones(points.shape[:-1], dtype=torch.float32)
    if k * (d + 1) > LLOYD_RESIDENT_FLOATS:
        min_d2, assign = min_dist_argmin(points, centers)
        return ref.lloyd_reduce(points, k, weights, min_d2, assign)
    if not points.is_cuda:
        return ref.lloyd_stats_ref(points, centers, weights)
    p, c, squeeze = _sites(points, centers)
    w = weights.unsqueeze(0) if squeeze else weights
    sums, counts, cost = _lu.lloyd_stats(p.contiguous(), pad_centers(c),
                                         w.contiguous(), k)
    return (sums[0], counts[0], cost[0]) if squeeze else (sums, counts, cost)
