"""Deterministic synthetic data (numpy only; the port's copy of
``repro.data.synthetic.paper_dataset``).

:func:`paper_dataset` makes Gaussian-mixture stand-ins shape-matched to the
paper's evaluation datasets (the UCI files are unavailable offline; see
DESIGN.md Sec. 7). The ``synthetic`` entry *is* the paper's own synthetic
setup: k=5 centers ~ N(0, I_10), 20k points per center.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_PAPER_SHAPES = {
    # name: (n_points, dim, k, n_true_clusters, noise)
    "synthetic": (100_000, 10, 5, 5, 1.0),
    "spam": (4_601, 58, 10, 12, 0.6),
    "pendigits": (10_992, 16, 10, 10, 0.5),
    "letter": (20_000, 16, 10, 26, 0.7),
    "colorhistogram": (68_040, 32, 10, 14, 0.5),
    "yearpredictionmsd": (515_345, 90, 50, 60, 0.8),
}


def paper_dataset(name: str, seed: int = 0, scale: float = 1.0
                  ) -> Tuple[np.ndarray, int]:
    """Gaussian-mixture stand-in matched to the paper dataset's (n, d, k).
    ``scale`` < 1 subsamples n for CI-speed runs. Returns (points, k)."""
    n, d, k, n_clusters, noise = _PAPER_SHAPES[name]
    # subsampling floor: below ~5k points the k=10..50 instances degenerate
    n = max(int(n * scale), min(n, 5000), n_clusters * 10)
    rng = np.random.default_rng(seed)
    if name == "synthetic":
        centers = rng.standard_normal((5, 10))
        per = n // 5
        pts = np.concatenate([
            c + rng.standard_normal((per, 10)) for c in centers])
        return pts.astype(np.float32), k
    centers = rng.standard_normal((n_clusters, d)) * 3.0
    weights = rng.dirichlet(np.ones(n_clusters) * 2.0)
    counts = rng.multinomial(n, weights)
    parts = []
    for c, cnt in zip(centers, counts):
        cov_scale = noise * (0.5 + rng.random())
        parts.append(c + cov_scale * rng.standard_normal((cnt, d)))
    pts = np.concatenate(parts)
    # a few far outliers, as in real UCI tables
    n_out = max(n // 1000, 1)
    pts[:n_out] += rng.standard_normal((n_out, d)) * 20.0
    rng.shuffle(pts)
    return pts.astype(np.float32), k


def paper_dataset_names():
    return list(_PAPER_SHAPES)
