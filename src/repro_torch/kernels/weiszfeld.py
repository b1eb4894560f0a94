"""Wrappers of the CUDA kernel ``csrc/weiszfeld_stats.cu`` and of the
``weiszfeld_reduce`` entry of ``csrc/lloyd_reduce.cu``.

It replaces the Pallas TPU kernel ``src/repro/kernels/weiszfeld.py:
weiszfeld_stats``: one pass over the points producing the numerators,
denominators and cost of a k-median (Weiszfeld) step. It is built on the
core it shares with ``lloyd_stats`` (``csrc/resident_tile.cuh``: resident
centres, one copy of each point tile, assignments bit for bit
``distance_argmin``'s, partials summed in block order) and recomputes each
point's distance to its assigned centre in exact form. Use
:func:`repro_torch.kernels.ops.weiszfeld_stats`, which pads the centres,
routes shapes that do not :func:`fit <fits>` to the two-pass form and takes
the plain version for CPU tensors. The two-pass form is the
``distance_argmin`` kernel, then :func:`weiszfeld_reduce`: a row pass for
each point's exact-form distance and ``lloyd_reduce``'s column walk, over
the same rows per block and in the same order as the fused kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import lloyd_update as _lu
from repro_torch.kernels._build import Kernel
from repro_torch.kernels.distance_argmin import check_cuda

KERNEL = Kernel("weiszfeld_stats", "weiszfeld_stats_launch", _lu.STATS_ARGS)
# points, centres, weights, assignment, per-row scratch, partials, out, S,
# M, k, d, rows per block, stream
REDUCE = Kernel("weiszfeld_reduce", "weiszfeld_reduce_launch",
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                + [ctypes.c_void_p], library="lloyd_reduce")

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


def weiszfeld_reduce(points: torch.Tensor, centers: torch.Tensor,
                     weights: torch.Tensor, assign: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch over S sites of the Weiszfeld statistics given an
    assignment: points ``(S, M, d)``, centres ``(S, k, d)``, signed weights
    ``(S, M)`` f32, assignment ``(S, M)`` i32 -> ``(nums (S, k, d), denoms
    (S, k), cost (S,))``. A row assigned outside ``[0, k)`` adds nothing."""
    check_cuda(centers, "centers", 3)
    S, M, d = points.shape
    k = centers.shape[1]
    if centers.shape[0] != S or centers.shape[2] != d:
        raise ValueError(f"centers {tuple(centers.shape)} do not match "
                         f"points {tuple(points.shape)}")
    if centers.device != points.device:
        raise ValueError("centers and points are on different devices")
    partials, out = _lu.reduce_buffers(points, weights, assign, k)
    rows = torch.empty((2, S, M), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = REDUCE.fn()(points.data_ptr(), centers.data_ptr(),
                         weights.data_ptr(), assign.data_ptr(),
                         rows.data_ptr(), partials.data_ptr(),
                         out.data_ptr(), S, M, k, d, _lu.ROWS_PER_BLOCK,
                         stream)
    return _lu.reduce_result(REDUCE, rc, out, k, d)
