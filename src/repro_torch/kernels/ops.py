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
* **Resident limits.** ``lloyd_stats`` and ``weiszfeld_stats`` keep the
  site's centres, one point tile and the accumulators in shared memory:
  :func:`repro_torch.kernels.lloyd_update.shared_floats` counts a block's
  layout, and each kernel's ``fits`` holds it against
  ``lloyd_update.RESIDENT_FLOATS`` (the 227 KiB a block may use on
  Hopper). The TPU kernels' limit was ``k d <= 2**20`` floats of resident
  centres (4 MiB of VMEM). Above its limit each takes the two-pass form:
  the ``distance_argmin`` kernel, then the reduction given the assignment
  -- for ``lloyd_stats`` the ``lloyd_reduce`` kernel
  (:func:`lloyd_reduce`), for ``weiszfeld_stats`` its ``weiszfeld_reduce``
  entry (:func:`weiszfeld_reduce`). That is routing by shape: a CUDA
  tensor still reaches a kernel.
* **Launch counts.** :data:`KERNELS` lists each kernel entry with its
  ``launches`` counter (the batched argmin is an entry of the
  ``distance_argmin`` library with a counter of its own);
  ``distance_argmin.ROUTES`` counts the same entries' launches again by
  the kernel that served them (one-centre, resident, general and streamed
  tile).
* **Query buckets.** :func:`query_bucket`, :func:`pad_queries` and
  :func:`chunk_queries` bound the shapes serving dispatches to powers of
  two (DESIGN.md Sec. 9); :func:`site_bucket_lengths` does the same for
  the staged engine's per-site solves.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import distance_argmin as _da
from repro_torch.kernels import lloyd_update as _lu
from repro_torch.kernels import ref
from repro_torch.kernels import weiszfeld as _wz

KERNELS = (_da.KERNEL, _lu.KERNEL, _wz.KERNEL, _da.KERNEL_BATCHED,
           _lu.REDUCE, _wz.REDUCE)


def query_bucket(n: int, min_bucket: int = 8,
                 max_bucket: Optional[int] = None) -> int:
    """The padded row count serving uses for an ``n``-row (chunk of a)
    query batch: the next power of two, clamped to ``[min_bucket,
    max_bucket]``, so the reachable set is ``{min_bucket, 2 min_bucket,
    ..., max_bucket}`` whatever the traffic. ``n`` exceeds ``max_bucket``
    only through :func:`chunk_queries`."""
    b = max(min_bucket, 1 << max(n - 1, 0).bit_length())
    if max_bucket is not None:
        if max_bucket < min_bucket:
            raise ValueError(f"max_bucket {max_bucket} < min_bucket "
                             f"{min_bucket}")
        b = min(b, max_bucket)
    return b


def pad_queries(points: torch.Tensor, min_bucket: int = 8,
                max_bucket: Optional[int] = None) -> Tuple[torch.Tensor, int]:
    """Pad a query batch ``(n, d)`` with zero rows to its
    :func:`query_bucket`; returns the padded batch and ``n`` (callers slice
    results back with it). An empty batch pads up to ``min_bucket`` rows; a
    batch above ``max_bucket`` raises: split it with
    :func:`chunk_queries`."""
    n = points.shape[0]
    cap = query_bucket(n, min_bucket, max_bucket)
    if n > cap:
        raise ValueError(
            f"query batch of {n} rows exceeds max_bucket={max_bucket}; "
            f"split it with chunk_queries() instead")
    return torch.nn.functional.pad(points, (0, 0, 0, cap - n)), n


def site_bucket_lengths(site_counts, max_len: int,
                        min_bucket: int = 64) -> Tuple[int, ...]:
    """Per-site padded solve lengths for the staged coreset engine: each
    site's valid-point count rounded up to its :func:`query_bucket` power
    of two, clamped at the lockstep pad length ``max_len``, so the set of
    solve shapes stays O(log max_len)."""
    return tuple(min(query_bucket(int(c), min_bucket=min_bucket),
                     int(max_len)) for c in site_counts)


def chunk_queries(points: torch.Tensor, min_bucket: int = 8,
                  max_bucket: Optional[int] = None
                  ) -> List[Tuple[torch.Tensor, int, int]]:
    """Split a query batch ``(n, d)`` into ``max_bucket``-row chunks, each
    padded to its own bucket: ``[(padded, n_chunk, offset), ...]``. An
    empty batch gives one all-padding chunk (``n_chunk == 0``)."""
    n = points.shape[0]
    step = max_bucket if max_bucket is not None else max(n, 1)
    out = []
    off = 0
    while True:
        part = points[off:off + step]
        out.append(pad_queries(part, min_bucket, max_bucket) + (off,))
        off += part.shape[0]
        if off >= n:
            return out


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
    md, am = _da.distance_argmin(p.contiguous(), pad_centers(c),
                                 live=c.shape[1])
    return (md[0], am[0]) if squeeze else (md, am)


def min_dist_argmin_batched(queries: torch.Tensor, centers: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked tenants: ``(T, m, d), (T, k, d) -> ((T, m) f32, (T, m)
    i32)`` in one launch of the batched entry; per tenant what
    :func:`min_dist_argmin` gives. Masked centre rows arrive at the
    sentinel (``backend.query_assignments_batched`` fills them)."""
    if not queries.is_cuda:
        return ref.min_dist_argmin_batched_ref(queries, centers)
    if queries.ndim != 3 or centers.ndim != 3:
        raise ValueError(f"queries {tuple(queries.shape)} and centers "
                         f"{tuple(centers.shape)} must both be 3-D")
    return _da.distance_argmin_batched(queries.contiguous(),
                                       pad_centers(centers),
                                       live=centers.shape[1])


def _fused_stats(kernel_fn, plain_fn, reduce_fn, fits, points, centers,
                 weights):
    """The shared dispatch of the fused statistics kernels: the two-pass
    form where ``fits(k, d)`` is false, the plain version on the CPU, else
    one launch over all sites."""
    k, d = centers.shape[-2], centers.shape[-1]
    if weights is None:
        weights = points.new_ones(points.shape[:-1], dtype=torch.float32)
    if not fits(k, d):
        min_d2, assign = min_dist_argmin(points, centers)
        return reduce_fn(points, centers, weights, min_d2, assign)
    if not points.is_cuda:
        return plain_fn(points, centers, weights)
    p, c, squeeze = _sites(points, centers)
    w = weights.unsqueeze(0) if squeeze else weights
    out = kernel_fn(p.contiguous(), pad_centers(c), w.contiguous(), k)
    return tuple(x[0] for x in out) if squeeze else out


def lloyd_stats(points: torch.Tensor, centers: torch.Tensor,
                weights: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused Lloyd statistics ``(sums (..., k, d), counts (..., k),
    cost (...))``; two passes -- the ``distance_argmin`` kernel, then
    :func:`lloyd_reduce` -- where
    :func:`repro_torch.kernels.lloyd_update.fits` is false, the limit the
    kernel's wrapper itself checks."""
    return _fused_stats(
        _lu.lloyd_stats, ref.lloyd_stats_ref,
        lambda p, c, w, md, am: lloyd_reduce(p, c.shape[-2], w, md, am),
        _lu.fits, points, centers, weights)


def lloyd_reduce(points: torch.Tensor, k: int, weights: torch.Tensor,
                 min_d2: torch.Tensor, assign: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Lloyd statistics given an assignment, ``(sums (..., k, d),
    counts (..., k), cost (...))``: the ``lloyd_reduce`` kernel, one launch
    over all sites, or :func:`ref.lloyd_reduce` for CPU tensors."""
    if not points.is_cuda:
        return ref.lloyd_reduce(points, k, weights, min_d2, assign)
    return _sites_launch(lambda *a: _lu.lloyd_reduce(*a, k), points,
                         weights.float(), min_d2.float(),
                         assign.to(torch.int32))


def _sites_launch(kernel_fn, *args):
    """``kernel_fn`` on contiguous ``args`` with a leading site axis: added
    to and dropped from the results where the points ``args[0]`` are 2-D."""
    squeeze = args[0].ndim == 2
    if squeeze:
        args = tuple(a.unsqueeze(0) for a in args)
    out = kernel_fn(*(a.contiguous() for a in args))
    return tuple(x[0] for x in out) if squeeze else out


def weiszfeld_stats(points: torch.Tensor, centers: torch.Tensor,
                    weights: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused Weiszfeld statistics ``(nums (..., k, d), denoms (..., k),
    cost (...))`` (k-median); two passes -- the ``distance_argmin`` kernel,
    then :func:`weiszfeld_reduce` -- where
    :func:`repro_torch.kernels.weiszfeld.fits` is false, the limit the
    kernel's wrapper itself checks."""
    return _fused_stats(
        _wz.weiszfeld_stats, ref.weiszfeld_stats_ref,
        lambda p, c, w, md, am: weiszfeld_reduce(p, c, w, am),
        _wz.fits, points, centers, weights)


def weiszfeld_reduce(points: torch.Tensor, centers: torch.Tensor,
                     weights: torch.Tensor, assign: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Weiszfeld statistics given an assignment, ``(nums (..., k, d),
    denoms (..., k), cost (...))``: the ``weiszfeld_reduce`` kernel, one
    launch over all sites, or :func:`ref.weiszfeld_reduce` for CPU
    tensors."""
    if not points.is_cuda:
        return ref.weiszfeld_reduce(points, centers, weights, assign)
    return _sites_launch(_wz.weiszfeld_reduce, points, centers.float(),
                         weights.float(), assign.to(torch.int32))


def lloyd_step(points: torch.Tensor, centers: torch.Tensor,
               weights: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full weighted Lloyd iteration through :func:`lloyd_stats`:
    ``(new centres (..., k, d), cost (...))``. Clusters with total weight
    <= 1e-12 keep their previous centre."""
    sums, counts, cost = lloyd_stats(points, centers, weights)
    eps = 1e-12
    new = sums / torch.where(counts > eps, counts, 1.0).unsqueeze(-1)
    new = torch.where((counts > eps).unsqueeze(-1), new, centers.float())
    return new.to(centers.dtype), cost
