"""Work models of the functions the port's kernels compute: the floating
point operations and the device-memory bytes each call needs, from its
shapes.

Each model counts what the function needs whatever implements it (a fused
kernel, a two-pass form, a plain PyTorch version): every input read once,
every output written once, and the operations of the arithmetic itself.
Counts follow the data, not the kernels' padding: ``k`` is the number of
real centres (not the centre tile's padded rows), and the batched
assignment counts the live centres of each tenant only.

:func:`bound` turns a count into the least time a card could take for it.
"""
from __future__ import annotations

from typing import Tuple

Work = Tuple[float, float]   # (flops, bytes)


def min_dist_argmin(S: int, n: int, k: int, d: int) -> Work:
    """S sites of n points against k centres of d features (k = 1 for a
    D^z seeding step): per point and centre the squared distance by the
    norms' form (2 d + 3), the norms of points and centres (2 d each); the
    points and centres read, the min d2 and argmin written."""
    flops = S * n * k * (2 * d + 3) + 2 * S * (n + k) * d
    nbytes = 4 * S * (n * d + k * d) + 8 * S * n
    return flops, nbytes


def min_dist_argmin_batched(T: int, m: int, k_live: int, d: int) -> Work:
    """T tenants of m queries against their live centres only (``k_live``
    is the total over tenants): what the data needs, not the padded
    rows."""
    flops = m * k_live * (2 * d + 3) + 2 * (T * m + k_live) * d
    nbytes = 4 * (T * m * d + k_live * d) + 8 * T * m
    return flops, nbytes


def lloyd_stats(S: int, n: int, k: int, d: int) -> Work:
    """The assignment, then per point one fmaf per feature into the sums
    and the count and cost terms (2 d + 3); the points, weights and centres
    read, the sums, counts and cost written."""
    flops, _ = min_dist_argmin(S, n, k, d)
    flops += S * n * (2 * d + 3)
    nbytes = 4 * S * (n * d + n + k * d) + 4 * S * (k * d + k + 1)
    return flops, nbytes


def weiszfeld_stats(S: int, n: int, k: int, d: int) -> Work:
    """The assignment, the exact-form distance (3 d), the numerators (2 d)
    and the inverse and cost (~8) per point; bytes as
    :func:`lloyd_stats`."""
    flops, _ = min_dist_argmin(S, n, k, d)
    flops += S * n * (5 * d + 8)
    nbytes = 4 * S * (n * d + n + k * d) + 4 * S * (k * d + k + 1)
    return flops, nbytes


def lloyd_reduce(S: int, n: int, k: int, d: int) -> Work:
    """The Lloyd statistics given an assignment: one fmaf per point feature,
    an add per count and an fmaf per cost term; each point, weight, min d2
    and assignment read once, the statistics written once."""
    flops = 2 * S * n * (d + 2)
    nbytes = 4 * S * n * (d + 3) + 4 * S * (k * d + k + 1)
    return flops, nbytes


def weiszfeld_reduce(S: int, n: int, k: int, d: int) -> Work:
    """The Weiszfeld statistics given an assignment: per point the
    exact-form distance to its centre (3 d), the numerators (2 d) and the
    inverse, denominator and cost (~8); each point, weight and assignment
    read once, the centres once, the statistics written once."""
    flops = S * n * (5 * d + 8)
    nbytes = 4 * S * (n * (d + 2) + k * d) + 4 * S * (k * d + k + 1)
    return flops, nbytes


MODELS = {
    "min_dist_argmin": min_dist_argmin,
    "min_dist_argmin_batched": min_dist_argmin_batched,
    "lloyd_stats": lloyd_stats,
    "weiszfeld_stats": weiszfeld_stats,
    "lloyd_reduce": lloyd_reduce,
    "weiszfeld_reduce": weiszfeld_reduce,
}


def bound(flops: float, nbytes: float, hardware) -> Tuple[float, str]:
    """Least time (ms) ``hardware`` (a :class:`report.Hardware`) could take
    for the work, and which limit sets it: the larger of the operations
    over the float32 peak of its CUDA cores and the bytes over its memory
    rate."""
    t_ops = flops / hardware.fp32_flops * 1e3
    t_bytes = nbytes / hardware.hbm_bytes_per_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
