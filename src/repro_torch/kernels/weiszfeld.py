"""Wrapper of the CUDA kernel ``csrc/weiszfeld_stats.cu``.

It replaces the Pallas TPU kernel ``src/repro/kernels/weiszfeld.py:
weiszfeld_stats``: one pass over the points producing the numerators,
denominators and cost of a k-median (Weiszfeld) step. It is built on the
core it shares with ``lloyd_stats`` (``csrc/resident_tile.cuh``: resident
centres, one copy of each point tile, assignments bit for bit
``distance_argmin``'s, partials summed in block order) and recomputes each
point's distance to its assigned centre in exact form. Use
:func:`repro_torch.kernels.ops.weiszfeld_stats`, which pads the centres,
routes shapes that do not :func:`fit <fits>` to the two-pass form and takes
the plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import lloyd_update as _lu
from repro_torch.kernels._build import Kernel

KERNEL = Kernel("weiszfeld_stats", "weiszfeld_stats_launch", _lu.STATS_ARGS)

# per-row arrays of a weiszfeld_stats block: p2, inv, sqrt(d2), w, argmin,
# order and its centres
ROW_ARRAYS = 7


def shared_floats(k: int, d: int) -> int:
    """Floats of shared memory one block of the kernel holds for ``k``
    centres of ``d`` features (:func:`lloyd_update.shared_floats` with this
    kernel's per-row arrays)."""
    return _lu.shared_floats(k, d, ROW_ARRAYS)


def fits(k: int, d: int) -> bool:
    """Whether ``k`` centres of ``d`` features fit the kernel's shared
    memory (``lloyd_update.RESIDENT_FLOATS``); ``ops.weiszfeld_stats`` takes
    the two-pass form where not."""
    return shared_floats(k, d) <= _lu.RESIDENT_FLOATS


def weiszfeld_stats(points: torch.Tensor, centers: torch.Tensor,
                    weights: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch over S sites: points ``(S, M, d)``, centres
    ``(S, k_pad, d)`` (the first ``k`` rows real, the rest at
    ``ref.CENTER_SENTINEL``), signed weights ``(S, M)``, all f32 ->
    ``(nums (S, k, d), denoms (S, k), cost (S,))``."""
    return _lu.launch_stats(KERNEL, points, centers, weights, k, fits)
