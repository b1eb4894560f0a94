"""Wrapper of the CUDA kernel ``csrc/weiszfeld_stats.cu``.

It replaces the Pallas TPU kernel ``src/repro/kernels/weiszfeld.py:
weiszfeld_stats``: one pass over the points producing the numerators,
denominators and cost of a k-median (Weiszfeld) step. It shares the
partials of ``lloyd_stats`` (fixed row slices summed in block order) and
assigns every point as ``distance_argmin`` does, bit for bit, but keeps its
own resident state: each block holds the site's centres and one copy of the
current point tile in shared memory, and recomputes each point's distance
to its assigned centre in exact form. Use
:func:`repro_torch.kernels.ops.weiszfeld_stats`, which pads the centres,
routes shapes that do not :func:`fit` to the two-pass form and takes the
plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._build import Kernel
from repro_torch.kernels.distance_argmin import CENTER_TILE
from repro_torch.kernels.lloyd_update import STATS_ARGS, launch_stats

KERNEL = Kernel("weiszfeld_stats", "weiszfeld_stats_launch", STATS_ARGS)

# point rows per tile of the kernel (kTileRows in the CUDA source)
TILE_ROWS = 64

# floats of shared memory a block may use on Hopper (227 KiB): the limit of
# what one block of the kernel keeps resident (:func:`shared_floats`)
RESIDENT_FLOATS = 58112


def shared_floats(k: int, d: int) -> int:
    """Floats of shared memory one block of the kernel holds for ``k``
    centres of ``d`` features, as ``csrc/weiszfeld_stats.cu`` counts them:
    the point stage (64 rows, and 4 floats for its misalignment shift), the
    centres padded to the centre tile at a row stride 2 above it, their
    norms, the accumulators ``k (d + 1)``, seven per-row arrays and
    ``k + 1`` group starts."""
    kc = -(-k // CENTER_TILE) * CENTER_TILE
    return (TILE_ROWS * d + 4 + d * (kc + 2) + kc + k * (d + 1)
            + 7 * TILE_ROWS + k + 1)


def fits(k: int, d: int) -> bool:
    """Whether ``k`` centres of ``d`` features fit the kernel's shared
    memory; ``ops.weiszfeld_stats`` takes the two-pass form where not."""
    return shared_floats(k, d) <= RESIDENT_FLOATS


def weiszfeld_stats(points: torch.Tensor, centers: torch.Tensor,
                    weights: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch over S sites: points ``(S, M, d)``, centres
    ``(S, k_pad, d)`` (the first ``k`` rows real, the rest at
    ``ref.CENTER_SENTINEL``), signed weights ``(S, M)``, all f32 ->
    ``(nums (S, k, d), denoms (S, k), cost (S,))``."""
    return launch_stats(KERNEL, points, centers, weights, k, fits)
