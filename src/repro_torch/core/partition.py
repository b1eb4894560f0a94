"""Data partitioning across sites (paper Sec. 5 experimental methodology;
a numpy copy of ``repro.core.partition``, whose package imports JAX).

Given a global dataset, distribute points to ``n`` sites by one of:

* ``uniform``    -- each point i.i.d. uniform over sites;
* ``similarity`` -- each site gets a random anchor point; points are assigned
  with probability proportional to a Gaussian kernel similarity to the
  anchors;
* ``weighted``   -- site weights ~ |N(0,1)|, points assigned proportionally;
* ``degree``     -- probability proportional to the site's degree in the
  communication graph (preferential-attachment experiments).

Sites receive variable-size shards; :func:`pad_partition` converts them to the
fixed-shape (n, max_size, d) + mask representation that the site-batched
paths take (one launch serves every site; DESIGN.md Sec. 7).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def partition_indices(
    data: np.ndarray,
    n_sites: int,
    method: str = "uniform",
    seed: int = 0,
    degrees: Optional[np.ndarray] = None,
) -> List[np.ndarray]:
    """Return per-site index arrays into ``data``."""
    rng = np.random.default_rng(seed)
    n_pts = data.shape[0]
    if method == "uniform":
        probs = np.full((n_pts, n_sites), 1.0 / n_sites)
    elif method == "similarity":
        anchors = data[rng.choice(n_pts, size=n_sites, replace=False)]
        # Gaussian kernel similarity; bandwidth = mean anchor-anchor distance
        d2 = ((data[:, None, :] - anchors[None, :, :]) ** 2).sum(-1) \
            if n_pts * n_sites * data.shape[1] < 5e8 else _chunked_d2(data, anchors)
        a2 = ((anchors[:, None, :] - anchors[None, :, :]) ** 2).sum(-1)
        bw = np.sqrt(a2[a2 > 0].mean()) if (a2 > 0).any() else 1.0
        sim = np.exp(-d2 / (2.0 * bw * bw))
        probs = sim / np.maximum(sim.sum(1, keepdims=True), 1e-30)
    elif method == "weighted":
        w = np.abs(rng.standard_normal(n_sites))
        w = np.maximum(w, 1e-3)
        probs = np.tile(w / w.sum(), (n_pts, 1))
    elif method == "degree":
        if degrees is None:
            raise ValueError("degree partition requires the graph degrees")
        w = degrees.astype(np.float64)
        probs = np.tile(w / w.sum(), (n_pts, 1))
    else:
        raise ValueError(f"unknown partition method: {method}")
    # vectorized categorical draw per point
    cum = probs.cumsum(axis=1)
    u = rng.random((n_pts, 1))
    site = (u > cum).sum(axis=1).clip(0, n_sites - 1)
    out = [np.nonzero(site == s)[0] for s in range(n_sites)]
    # every site must own at least one point (the paper's sites are non-empty)
    for s in range(n_sites):
        if len(out[s]) == 0:
            donor = int(np.argmax([len(o) for o in out]))
            out[s] = out[donor][-1:]
            out[donor] = out[donor][:-1]
    return out


def _chunked_d2(data: np.ndarray, anchors: np.ndarray, chunk: int = 65536
                ) -> np.ndarray:
    out = np.empty((data.shape[0], anchors.shape[0]), dtype=np.float64)
    a2 = (anchors ** 2).sum(-1)
    for i in range(0, data.shape[0], chunk):
        blk = data[i:i + chunk]
        out[i:i + chunk] = (blk ** 2).sum(-1, keepdims=True) + a2[None, :] \
            - 2.0 * blk @ anchors.T
    return out


def pad_partition(
    data: np.ndarray,
    indices: List[np.ndarray],
    pad_multiple: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-size shards into (n_sites, max_size, d) + bool mask."""
    n_sites = len(indices)
    max_size = max(len(ix) for ix in indices)
    max_size = int(np.ceil(max_size / pad_multiple) * pad_multiple)
    d = data.shape[1]
    out = np.zeros((n_sites, max_size, d), dtype=data.dtype)
    mask = np.zeros((n_sites, max_size), dtype=bool)
    for s, ix in enumerate(indices):
        out[s, : len(ix)] = data[ix]
        mask[s, : len(ix)] = True
    return out, mask
