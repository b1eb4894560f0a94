"""Wrappers of the CUDA kernels ``csrc/lloyd_stats.cu`` and
``csrc/lloyd_reduce.cu``, and the shared-memory count of the resident
statistics kernels (``csrc/resident_tile.cuh``).

It replaces the Pallas TPU kernel ``src/repro/kernels/lloyd_update.py:
lloyd_stats``: one pass over the points producing the weighted sums,
counts and cost of a Lloyd step. The TPU kernel carried its accumulators
across an in-order grid; here each block writes a partial over a fixed
slice of rows and a second kernel sums them in block order, so results are
bit-identical run to run. Each block keeps the site's centres and one copy
of the current point tile in shared memory, and assigns every point as
``distance_argmin`` does, bit for bit. What bounds it on the card is noted
in the CUDA source. Shapes that do not :func:`fit <fits>` take the
two-pass form: the ``distance_argmin`` kernel assigns the points, then
:func:`lloyd_reduce` sums them, each block over the same rows and in the
same order as the fused kernel. Use
:func:`repro_torch.kernels.ops.lloyd_stats`, which pads the centres, routes
by shape and takes the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from repro_torch.kernels._build import Kernel
from repro_torch.kernels.distance_argmin import (CENTER_TILE,
                                                RESIDENT_FLOATS, TILE_ROWS,
                                                center_tile, check_cuda)

_P = ctypes.c_void_p
_I = ctypes.c_int

STATS_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
KERNEL = Kernel("lloyd_stats", "lloyd_stats_launch", STATS_ARGS)
# points, weights, min d2, assignment, partials, out, S, M, k, d, rows per
# block, stream
REDUCE = Kernel("lloyd_reduce", "lloyd_reduce_launch",
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
# the same with the most centres' accumulators a block before the stream:
# the column walk's centre groups at any k, so the tests can hold them to
# the fused kernel bit for bit
REDUCE_GROUPED = Kernel("lloyd_reduce_grouped", "lloyd_reduce_grouped_launch",
                        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                        library="lloyd_reduce")

# rows each block owns: sets the number of partials of a site
# (ceil(M / ROWS_PER_BLOCK)), and so the order of the final sum
ROWS_PER_BLOCK = 1024

# per-row arrays of a lloyd_stats block: p2, min d2, w, argmin, order and
# its centres
ROW_ARRAYS = 6


def lloyd_stats(points: torch.Tensor, centers: torch.Tensor,
                weights: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch over S sites: points ``(S, M, d)``, centres
    ``(S, k_pad, d)`` (the first ``k`` rows real, the rest at
    ``ref.CENTER_SENTINEL``), weights ``(S, M)``, all f32 ->
    ``(sums (S, k, d), counts (S, k), cost (S,))``."""
    return launch_stats(KERNEL, points, centers, weights, k, fits)


def lloyd_reduce(points: torch.Tensor, weights: torch.Tensor,
                 min_d2: torch.Tensor, assign: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch over S sites of the Lloyd statistics given an assignment:
    points ``(S, M, d)``, weights and min d2 ``(S, M)`` f32, assignment
    ``(S, M)`` i32 -> ``(sums (S, k, d), counts (S, k), cost (S,))``. A row
    assigned outside ``[0, k)`` adds to the cost only."""
    return _reduce(REDUCE, points, weights, min_d2, assign, k)


def lloyd_reduce_grouped(points: torch.Tensor, weights: torch.Tensor,
                         min_d2: torch.Tensor, assign: torch.Tensor, k: int,
                         group: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`lloyd_reduce` with the accumulators of at most ``group``
    centres a block: the centre groups the column walk takes where one
    block cannot hold all ``k`` (above 355 centres at d = 4,096), at any
    shape, to hold them against the fused kernel where that runs too."""
    if group < 1:
        raise ValueError(f"group {group}: a block holds at least one centre")
    return _reduce(REDUCE_GROUPED, points, weights, min_d2, assign, k, group)


def _reduce(kernel: Kernel, points: torch.Tensor, weights: torch.Tensor,
            min_d2: torch.Tensor, assign: torch.Tensor, k: int, *group: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    partials, out = reduce_buffers(points, weights, assign, k,
                                   min_d2=min_d2)
    S, M, d = points.shape
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel.fn()(points.data_ptr(), weights.data_ptr(),
                         min_d2.data_ptr(), assign.data_ptr(),
                         partials.data_ptr(), out.data_ptr(), S, M, k, d,
                         ROWS_PER_BLOCK, *group, stream)
    return reduce_result(kernel, rc, out, k, d)


def reduce_buffers(points: torch.Tensor, weights: torch.Tensor,
                   assign: torch.Tensor, k: int, **rows: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs of an entry of ``csrc/lloyd_reduce.cu`` -- points
    ``(S, M, d)``, weights, the assignment (i32) and the other per-row
    inputs ``rows`` ``(S, M)`` -- and allocate its partials ``(S, G, k d +
    k + 1)`` and output ``(S, k d + k + 1)``."""
    check_cuda(points, "points", 3)
    check_cuda(weights, "weights", 2)
    check_cuda(assign, "assign", 2, torch.int32)
    for name, t in rows.items():
        check_cuda(t, name, 2)
    S, M, d = points.shape
    for name, t in (("weights", weights), ("assign", assign), *rows.items()):
        if tuple(t.shape) != (S, M):
            raise ValueError(f"{name} {tuple(t.shape)} do not match points "
                             f"{tuple(points.shape)}")
        if t.device != points.device:
            raise ValueError(f"{name} and points are on different devices")
    if min(S, M, d, k) == 0:
        raise ValueError(f"bad sizes: points {tuple(points.shape)}, {k} "
                         f"centres")
    if S > 65535:
        raise ValueError(f"{S} sites exceed the grid's 65535")
    E = k * d + k + 1
    G = -(-M // ROWS_PER_BLOCK)
    return (torch.empty((S, G, E), dtype=torch.float32, device=points.device),
            torch.empty((S, E), dtype=torch.float32, device=points.device))


def reduce_result(kernel: Kernel, rc: int, out: torch.Tensor, k: int, d: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raise on a failed launch, else count it and split the output into
    its three blocks ``((S, k, d), (S, k), (S,))``."""
    if rc != 0:
        raise RuntimeError(f"{kernel.name} launch failed with CUDA error "
                           f"{rc}")
    kernel.launches += 1
    return (out[:, :k * d].view(-1, k, d), out[:, k * d:k * d + k],
            out[:, -1])


def shared_floats(k: int, d: int, row_arrays: int = ROW_ARRAYS) -> int:
    """Floats of shared memory one block of a resident statistics kernel
    holds for ``k`` centres of ``d`` features, as ``shared_floats`` in
    ``csrc/resident_tile.cuh`` counts them: the point stage (64 rows, and 4
    floats for its misalignment shift), the centres padded to the centre
    tile at a row stride 2 above it, their norms, the accumulators
    ``k (d + 1)``, ``row_arrays`` per-row arrays of 64 and ``k + 1`` group
    starts."""
    kc = -(-k // CENTER_TILE) * CENTER_TILE
    return (TILE_ROWS * d + 4 + d * (kc + 2) + kc + k * (d + 1)
            + row_arrays * TILE_ROWS + k + 1)


def fits(k: int, d: int) -> bool:
    """Whether ``k`` centres of ``d`` features fit the kernel's shared
    memory; ``ops.lloyd_stats`` takes the two-pass form where not."""
    return shared_floats(k, d) <= RESIDENT_FLOATS


def launch_stats(kernel: Kernel, points: torch.Tensor, centers: torch.Tensor,
                 weights: torch.Tensor, k: int,
                 fits_kernel: Callable[[int, int], bool]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the inputs and launch a fused statistics kernel: one with the
    C interface of ``lloyd_stats_launch``, whose output is per-block
    partials of ``k d + k + 1`` floats summed in block order
    (``csrc/partials.cuh``), and whose shared memory holds ``k`` centres
    of ``d`` features where ``fits_kernel(k, d)``. Returns the three blocks
    of the sum."""
    check_cuda(points, "points", 3)
    check_cuda(centers, "centers", 3)
    check_cuda(weights, "weights", 2)
    S, M, d = points.shape
    k_pad = centers.shape[1]
    if centers.shape[0] != S or centers.shape[2] != d:
        raise ValueError(f"centers {tuple(centers.shape)} do not match "
                         f"points {tuple(points.shape)}")
    if tuple(weights.shape) != (S, M):
        raise ValueError(f"weights {tuple(weights.shape)} do not match "
                         f"points {tuple(points.shape)}")
    if len({points.device, centers.device, weights.device}) != 1:
        raise ValueError("points, centers and weights are on different "
                         "devices")
    if min(S, M, d, k) == 0 or not k <= k_pad:
        raise ValueError(f"bad sizes: points {tuple(points.shape)}, "
                         f"{k} centres in {k_pad} rows")
    if k_pad % center_tile(k_pad):
        raise ValueError(f"{k_pad} centre rows are not a multiple of the "
                         f"centre tile")
    if not fits_kernel(k, d):
        raise ValueError(f"{k} centres of {d} features exceed the shared "
                         f"memory of {kernel.name}; ops.{kernel.name} takes "
                         f"the two-pass form")
    if S > 65535:
        raise ValueError(f"{S} sites exceed the grid's 65535")
    E = k * d + k + 1
    G = -(-M // ROWS_PER_BLOCK)
    partials = torch.empty((S, G, E), dtype=torch.float32,
                           device=points.device)
    out = torch.empty((S, E), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel.fn()(points.data_ptr(), centers.data_ptr(),
                         weights.data_ptr(), partials.data_ptr(),
                         out.data_ptr(), S, M, k, k_pad, d, ROWS_PER_BLOCK,
                         stream)
    if rc != 0:
        raise RuntimeError(f"{kernel.name} launch failed with CUDA error "
                           f"{rc}")
    kernel.launches += 1
    return (out[:, :k * d].view(S, k, d), out[:, k * d:k * d + k],
            out[:, -1])
