"""Wrapper of the CUDA kernel ``csrc/lloyd_stats.cu``.

It replaces the Pallas TPU kernel ``src/repro/kernels/lloyd_update.py:
lloyd_stats``: one pass over the points producing the weighted sums,
counts and cost of a Lloyd step. The TPU kernel carried its accumulators
across an in-order grid; here each block writes a partial over a fixed
slice of rows and a second kernel sums them in block order, so results are
bit-identical run to run. What bounds it on the card is noted in the CUDA
source. Use :func:`repro_torch.kernels.ops.lloyd_stats`, which pads the
centres, routes large ``k * d`` to the two-pass form and takes the plain
version for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import Kernel
from repro_torch.kernels.distance_argmin import center_tile, check_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int

STATS_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
KERNEL = Kernel("lloyd_stats", "lloyd_stats_launch", STATS_ARGS)

# rows each block owns: sets the number of partials of a site
# (ceil(M / ROWS_PER_BLOCK)), and so the order of the final sum
ROWS_PER_BLOCK = 1024

# floats of per-block accumulators (sums k*d + counts k) that fit the
# shared memory a block may use on Hopper (227 KiB) beside at most 37 KiB
# of tile staging: 184 KiB
RESIDENT_FLOATS = 47104


def lloyd_stats(points: torch.Tensor, centers: torch.Tensor,
                weights: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch over S sites: points ``(S, M, d)``, centres
    ``(S, k_pad, d)`` (the first ``k`` rows real, the rest at
    ``ref.CENTER_SENTINEL``), weights ``(S, M)``, all f32 ->
    ``(sums (S, k, d), counts (S, k), cost (S,))``."""
    return launch_stats(KERNEL, points, centers, weights, k)


def launch_stats(kernel: Kernel, points: torch.Tensor, centers: torch.Tensor,
                 weights: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check the inputs and launch a fused statistics kernel: one with the
    C interface of ``lloyd_stats_launch``, whose output is per-block
    partials of ``k d + k + 1`` floats summed in block order
    (``csrc/partials.cuh``). Returns the three blocks of the sum."""
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
    if k * (d + 1) > RESIDENT_FLOATS:
        raise ValueError(f"k (d + 1) = {k * (d + 1)} floats exceed the "
                         f"{RESIDENT_FLOATS} the kernel keeps in shared "
                         f"memory; ops.{kernel.name} takes the two-pass form")
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
