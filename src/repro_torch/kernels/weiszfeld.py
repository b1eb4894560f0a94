"""Wrapper of the CUDA kernel ``csrc/weiszfeld_stats.cu``.

It replaces the Pallas TPU kernel ``src/repro/kernels/weiszfeld.py:
weiszfeld_stats``: one pass over the points producing the numerators,
denominators and cost of a k-median (Weiszfeld) step. It shares the
skeleton of ``lloyd_stats`` -- the same argmin routine and tile shape,
per-block partials over fixed row slices summed in block order, the same
resident limit -- and recomputes each point's distance to its assigned
centre in exact form. Use :func:`repro_torch.kernels.ops.weiszfeld_stats`,
which pads the centres, routes large ``k * d`` to the two-pass form and
takes the plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._build import Kernel
from repro_torch.kernels.lloyd_update import STATS_ARGS, launch_stats

KERNEL = Kernel("weiszfeld_stats", "weiszfeld_stats_launch", STATS_ARGS)


def weiszfeld_stats(points: torch.Tensor, centers: torch.Tensor,
                    weights: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch over S sites: points ``(S, M, d)``, centres
    ``(S, k_pad, d)`` (the first ``k`` rows real, the rest at
    ``ref.CENTER_SENTINEL``), signed weights ``(S, M)``, all f32 ->
    ``(nums (S, k, d), denoms (S, k), cost (S,))``."""
    return launch_stats(KERNEL, points, centers, weights, k)
