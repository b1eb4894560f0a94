"""The benchmark's yardstick for the kernels: the operations and bytes each
kernel function needs, counted from the cell's data, and the card's
peaks.

The models are a copy of the port's ``roofline/work.py``: every input read
once, every output written once, the arithmetic of the function itself.
They are fed the data's real rows, never a call's padded shape: in Round 1
each site's own rows, in the solve the coreset's real points (t sample
slots in all plus k centres per site), and the real k. A change that stops
touching padding therefore leaves the work unchanged and raises the share.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

Work = Tuple[float, float]   # (flops, bytes)

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W: float32 on
# the CUDA cores, and HBM3
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def min_dist_argmin(S: int, n: int, k: int, d: int) -> Work:
    """Squared distances by the norms' form (2 d + 3 a pair), the norms
    (2 d a row); points and centres read, min d2 and argmin written."""
    flops = S * n * k * (2 * d + 3) + 2 * S * (n + k) * d
    nbytes = 4 * S * (n * d + k * d) + 8 * S * n
    return flops, nbytes


def lloyd_stats(S: int, n: int, k: int, d: int) -> Work:
    """The assignment, then 2 d + 3 per point into sums, count and cost;
    points, weights and centres read, the statistics written."""
    flops, _ = min_dist_argmin(S, n, k, d)
    flops += S * n * (2 * d + 3)
    nbytes = 4 * S * (n * d + n + k * d) + 4 * S * (k * d + k + 1)
    return flops, nbytes


def weiszfeld_stats(S: int, n: int, k: int, d: int) -> Work:
    """The assignment, the exact-form distance (3 d), the numerators (2 d)
    and the inverse and cost (~8) per point; bytes as :func:`lloyd_stats`."""
    flops, _ = min_dist_argmin(S, n, k, d)
    flops += S * n * (5 * d + 8)
    nbytes = 4 * S * (n * d + n + k * d) + 4 * S * (k * d + k + 1)
    return flops, nbytes


MODELS = {"min_dist_argmin": min_dist_argmin, "lloyd_stats": lloyd_stats,
          "weiszfeld_stats": weiszfeld_stats}

# the phases whose calls have real rows to count: the sites' in Round 1,
# the coreset's in the solve
PHASE_ROWS = ("round1", "solve")


def call_work(label: str, phase: str, sizes: List[int], k: int, t: int,
              d: int) -> Work:
    """The work one call of ``label`` (a ``work:`` scope's function, e.g.
    ``lloyd_stats`` or ``min_dist_argmin[k=1]``) needs in ``phase``: over
    every site's real rows in Round 1, over the coreset's t + k x sites real
    points in the solve."""
    function, _, centres = label.partition("[k=")
    kc = int(centres.rstrip("]")) if centres else k
    model = MODELS[function]
    if phase not in PHASE_ROWS:
        raise ValueError(f"no real rows for a call in phase {phase!r}")
    if phase == "solve":
        return model(1, t + k * len(sizes), kc, d)
    flops = nbytes = 0.0
    for n in sizes:
        f, b = model(1, n, kc, d)
        flops += f
        nbytes += b
    return flops, nbytes


def bound_s(work: Work, peaks: Dict[str, float]) -> float:
    """The least seconds the card could take: the larger of operations
    over the float32 peak and bytes over the memory rate."""
    flops, nbytes = work
    return max(flops / peaks["fp32_flops"], nbytes / peaks["hbm_bytes_per_s"])
