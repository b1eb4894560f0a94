"""Wrapper of the CUDA kernel ``csrc/distance_argmin.cu``.

It replaces the Pallas TPU kernel
``src/repro/kernels/distance_argmin.py:distance_argmin``: per point, the
min squared distance over k centres and its argmin (lowest index on
ties), with the (n, k) matrix never leaving the chip's registers. What
bounds it on the card and how its design answers that is noted in the
CUDA source. Use :func:`repro_torch.kernels.ops.min_dist_argmin`, which
pads the centres and takes the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
KERNEL = Kernel("distance_argmin", "distance_argmin_launch", _ARGS)
KERNEL_BATCHED = Kernel("distance_argmin_batched",
                        "distance_argmin_batched_launch", _ARGS,
                        library="distance_argmin")
# the one-centre kernel that both entries launch for k_pad == 1 (D^2
# seeding): its launches are counted here as well as under the entry's own
ONE_CENTER = Kernel("distance_one_center", "distance_argmin_launch", _ARGS,
                    library="distance_argmin")

# centres per tile of the general tile shape; must equal kCenterTile in
# csrc/argmin_tile.cuh (the kernel refuses other paddings)
CENTER_TILE = 64


def center_tile(k: int) -> int:
    """The padded centre count the kernel takes for ``k`` centres is a
    multiple of this: 1 for k == 1 (the one-centre kernel, which gives
    what the general tile gives for the centre padded to CENTER_TILE rows,
    bit for bit), else CENTER_TILE."""
    return 1 if k == 1 else CENTER_TILE


def check_cuda(t: torch.Tensor, name: str, ndim: int,
               dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``ndim`` axes and
    ``dtype``: the kernels take nothing else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if not t.is_cuda:
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} axes, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def distance_argmin(points: torch.Tensor, centers: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch over S sites: points ``(S, M, d)`` f32 and centres
    ``(S, k_pad, d)`` f32 with ``k_pad`` a multiple of
    :func:`center_tile` (padded rows at ``ref.CENTER_SENTINEL``) ->
    ``(min_d2 (S, M) f32, argmin (S, M) i32)``."""
    return _launch(KERNEL, points, centers)


def distance_argmin_batched(queries: torch.Tensor, centers: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked-tenant entry (it replaces
    ``src/repro/kernels/distance_argmin.py:distance_argmin_batched``): one
    launch over T tenants, queries ``(T, m, d)`` and centres
    ``(T, k_pad, d)`` (masked rows at ``ref.CENTER_SENTINEL``), shapes as
    :func:`distance_argmin`. It takes a narrower point tile for small
    query buckets, and gives bit for bit what a loop of
    :func:`distance_argmin` over the tenants gives; it counts its launches
    apart, so a run shows that serving went through it."""
    return _launch(KERNEL_BATCHED, queries, centers)


def _launch(kernel: Kernel, points: torch.Tensor, centers: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_cuda(points, "points", 3)
    check_cuda(centers, "centers", 3)
    S, M, d = points.shape
    if centers.shape[0] != S or centers.shape[2] != d:
        raise ValueError(f"centers {tuple(centers.shape)} do not match "
                         f"points {tuple(points.shape)}")
    if centers.device != points.device:
        raise ValueError("points and centers are on different devices")
    k_pad = centers.shape[1]
    if min(S, M, d, k_pad) == 0:
        raise ValueError(f"empty input: points {tuple(points.shape)}, "
                         f"centers {tuple(centers.shape)}")
    if k_pad % center_tile(k_pad):
        raise ValueError(f"{k_pad} centre rows: pad to a multiple of "
                         f"{CENTER_TILE} (ops.min_dist_argmin does)")
    if S > 65535:
        raise ValueError(f"{S} sites exceed the grid's 65535")
    out_min = torch.empty((S, M), dtype=torch.float32, device=points.device)
    out_arg = torch.empty((S, M), dtype=torch.int32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel.fn()(points.data_ptr(), centers.data_ptr(),
                         out_min.data_ptr(), out_arg.data_ptr(), S, M, k_pad,
                         d, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel.name} launch failed with CUDA error "
                           f"{rc}")
    kernel.launches += 1
    if k_pad == 1:
        ONE_CENTER.launches += 1
    return out_min, out_arg
