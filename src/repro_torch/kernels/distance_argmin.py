"""Wrapper of the CUDA kernel ``csrc/distance_argmin.cu``.

It replaces the Pallas TPU kernel
``src/repro/kernels/distance_argmin.py:distance_argmin``: per point, the
min squared distance over k centres and its argmin (lowest index on
ties), with the (n, k) matrix never leaving the chip's registers. Both
entries route by shape inside the CUDA library (``route`` in the source):
one centre to the one-centre kernel; more to the resident tile where its
block fits shared memory (:func:`resident_fits`) and a site has more than
8 rows; else to the general tile. Each launch reports the kernel it
took, and :data:`ROUTES` counts it. Every route gives the same output
bit for bit.
What bounds it on the card and how its design answers that is noted in
the CUDA source. Use :func:`repro_torch.kernels.ops.min_dist_argmin`,
which pads the centres and takes the plain version for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

# points, centres, min d2, argmin, S, M, k_pad, d, stream, and a host int
# the entry sets to the code of the kernel it launched (ROUTES' order)
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P, ctypes.POINTER(_I)]
KERNEL = Kernel("distance_argmin", "distance_argmin_launch", _ARGS)
KERNEL_BATCHED = Kernel("distance_argmin_batched",
                        "distance_argmin_batched_launch", _ARGS,
                        library="distance_argmin")
# The kernels both entries route to: the one-centre kernel (D^2 seeding),
# the resident tile and the general tile. Each launch of an entry is
# counted under the entry and under the kernel the library reports it
# launched. The resident and general tiles have entries of their own too,
# whose launches their counts also take, so that each can be held against
# the other.
ONE_CENTER = Kernel("distance_one_center", "distance_argmin_launch", _ARGS,
                    library="distance_argmin")
RESIDENT = Kernel("distance_argmin_resident",
                  "distance_argmin_resident_launch", _ARGS,
                  library="distance_argmin")
TILE = Kernel("distance_argmin_tile", "distance_argmin_tile_launch", _ARGS,
              library="distance_argmin")
# in the order of the codes the entries report (enum Route in the source)
ROUTES = (ONE_CENTER, RESIDENT, TILE)

# centres per tile of the general tile shape; must equal kCenterTile in
# csrc/argmin_tile.cuh (the kernel refuses other paddings)
CENTER_TILE = 64

# point rows per tile of the resident kernels (kTileRows in
# csrc/resident_tile.cuh)
TILE_ROWS = 64

# floats of shared memory a block may use on Hopper (227 KiB): the limit of
# what one block of a resident kernel keeps
RESIDENT_FLOATS = 58112


def center_tile(k: int) -> int:
    """The padded centre count the kernel takes for ``k`` centres is a
    multiple of this: 1 for k == 1 (the one-centre kernel, which gives
    what the general tile gives for the centre padded to CENTER_TILE rows,
    bit for bit), else CENTER_TILE."""
    return 1 if k == 1 else CENTER_TILE


def resident_fits(k_pad: int, d: int) -> bool:
    """Whether a resident block for ``k_pad`` centres of ``d`` features fits
    shared memory; where not, the entries take the general tile. It counts
    the floats as ``argmin_floats`` in ``csrc/distance_argmin.cu`` does:
    the layout of ``resident_tile.cuh`` with no accumulators and no per-row
    array of the kernel's own (the point stage, 64 rows and 4 floats of
    shift; the centres at a row stride 2 above the 64-centre tile; their
    norms; five per-row arrays of 64 and one group start)."""
    kc = -(-k_pad // CENTER_TILE) * CENTER_TILE
    floats = TILE_ROWS * d + 4 + d * (kc + 2) + kc + 5 * TILE_ROWS + 1
    return floats <= RESIDENT_FLOATS


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
    :func:`distance_argmin`. It takes the kernel :func:`distance_argmin`
    takes for the same shape, and gives bit for bit what a loop of :func:`distance_argmin`
    over the tenants gives; it counts its launches apart, so a run shows
    that serving went through it."""
    return _launch(KERNEL_BATCHED, queries, centers)


def distance_argmin_tile(points: torch.Tensor, centers: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The general tile alone at any shape (``k_pad`` a multiple of
    :data:`CENTER_TILE`), shapes as :func:`distance_argmin`: what the
    entries route to where the resident tile does not serve, and what the
    resident tile is held to bit for bit."""
    return _launch(TILE, points, centers)


def distance_argmin_resident(points: torch.Tensor, centers: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The resident tile alone at any row count (``k_pad`` a multiple of
    :data:`CENTER_TILE` whose block :func:`fits <resident_fits>`), shapes
    as :func:`distance_argmin`, so that it can be held against the general
    tile where the entries route to that."""
    return _launch(RESIDENT, points, centers)


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
    if k_pad % (CENTER_TILE if kernel in (TILE, RESIDENT)
                else center_tile(k_pad)):
        raise ValueError(f"{k_pad} centre rows: pad to a multiple of "
                         f"{CENTER_TILE} (ops.min_dist_argmin does)")
    if kernel is RESIDENT and not resident_fits(k_pad, d):
        raise ValueError(f"{k_pad} centres of {d} features exceed the "
                         f"resident tile's shared memory")
    if S > 65535:
        raise ValueError(f"{S} sites exceed the grid's 65535")
    out_min = torch.empty((S, M), dtype=torch.float32, device=points.device)
    out_arg = torch.empty((S, M), dtype=torch.int32, device=points.device)
    served = _I(-1)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = kernel.fn()(points.data_ptr(), centers.data_ptr(),
                         out_min.data_ptr(), out_arg.data_ptr(), S, M, k_pad,
                         d, stream, ctypes.byref(served))
    if rc != 0:
        raise RuntimeError(f"{kernel.name} launch failed with CUDA error "
                           f"{rc}")
    count_launch(kernel, served.value)
    return out_min, out_arg


def count_launch(entry: Kernel, served: int) -> None:
    """Count one launch of ``entry`` that the library reports served by
    the kernel of code ``served`` (the index into :data:`ROUTES`): under
    the entry, and under that kernel unless the entry is that kernel's
    own."""
    if not 0 <= served < len(ROUTES):
        raise RuntimeError(f"{entry.name} reported kernel code {served}")
    entry.launches += 1
    if ROUTES[served] is not entry:
        ROUTES[served].launches += 1
