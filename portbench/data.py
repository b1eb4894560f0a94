"""The benchmark's inputs, made from a configuration and ``--seed``.

* :func:`site_sizes` -- the ``weighted`` partition rule (site weights
  ~ |N(0, 1)|, floored at 1e-3) with each site's size fixed from the
  configuration's own ``partition_seed`` by largest remainder over n, so
  every ``--seed`` gives the same sizes and the same padded length. No
  (points x sites) table is built.
* :func:`make_sites` -- a Gaussian-mixture stand-in at the source's (n, d),
  drawn on the device from ``--seed`` in a few large calls, laid out as the
  program takes its sites: ``(sites, M, d)`` float32 with the rows of each
  site first and zero padding behind, and a ``(sites, M)`` mask. The
  mixture is the configuration's; ``--seed`` changes the points drawn
  from it, and with them which points each site holds; never the sizes.
* :func:`graph_edges` -- the configuration's topology as an edge list.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Sites:
    """Padded site tensors and the sizes behind them."""

    points: torch.Tensor     # (S, M, d) float32
    mask: torch.Tensor       # (S, M) bool
    sizes: List[int]         # real rows per site

    @property
    def padded(self) -> int:
        return int(self.points.shape[1])


def site_sizes(n: int, sites: int, partition_seed: int) -> List[int]:
    """Rows per site under the ``weighted`` rule, fixed by
    ``partition_seed``: shares w / sum(w) with w = max(|N(0, 1)|, 1e-3),
    floors of n x share, the remainder to the largest fractional parts
    (lower site first on ties), and every site at least one row."""
    w = np.abs(np.random.default_rng(partition_seed).standard_normal(sites))
    w = np.maximum(w, 1e-3)
    exact = n * (w / w.sum())
    base = np.floor(exact).astype(np.int64)
    order = np.argsort(-(exact - base), kind="stable")
    base[order[:n - int(base.sum())]] += 1
    for s in range(sites):
        if base[s] == 0:
            donor = int(np.argmax(base))
            base[donor] -= 1
            base[s] = 1
    return [int(x) for x in base]


def padded_rows(sizes: List[int], multiple: int) -> int:
    """The largest site rounded up to ``multiple`` rows."""
    return -(-max(sizes) // multiple) * multiple


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def mixture(cfg: dict, seed: int, device: torch.device) -> torch.Tensor:
    """``cfg["n"]`` points in ``cfg["d"]`` features: ``clusters`` centres
    ~ center_scale x N(0, I), Dirichlet(2) cluster shares, a spread per
    cluster of noise x U(0.5, 1.5), and a share of far outliers (an extra
    outlier_scale x N(0, I)), as the repo's paper stand-ins are made. The
    mixture itself is the configuration's (numpy under its
    ``mixture_seed``), so every seed clusters alike and the kernels do the
    same work; the points are drawn from it on the device under
    ``seed``."""
    mix = cfg["mixture"]
    n, d, c = int(cfg["n"]), int(cfg["d"]), int(mix["clusters"])
    rng = np.random.default_rng(int(mix["mixture_seed"]))
    centres = rng.standard_normal((c, d)) * float(mix["center_scale"])
    shares = rng.dirichlet(np.full(c, 2.0))
    spread = float(mix["noise"]) * (0.5 + rng.random(c))
    g = _generator(seed, device)
    as_dev = dict(dtype=torch.float32, device=device)
    label = torch.multinomial(torch.tensor(shares, **as_dev), n,
                              replacement=True, generator=g)
    pts = torch.randn((n, d), generator=g, **as_dev)
    pts.mul_(torch.tensor(spread, **as_dev)[label, None])
    pts.add_(torch.tensor(centres, **as_dev)[label])
    far = torch.rand((n,), generator=g, **as_dev) < float(mix["outlier_share"])
    if bool(far.any()):
        extra = torch.randn((int(far.sum()), d), generator=g, **as_dev)
        pts[far] += float(mix["outlier_scale"]) * extra
    return pts


def make_sites(cfg: dict, seed: int, device: torch.device) -> Sites:
    """The configuration's padded sites for ``seed``: points drawn i.i.d.
    (:func:`mixture`), the first ``sizes[0]`` to site 0, the next to site
    1, and so on."""
    sizes = site_sizes(int(cfg["n"]), int(cfg["sites"]),
                       int(cfg["partition_seed"]))
    M = padded_rows(sizes, int(cfg["pad_multiple"]))
    flat = mixture(cfg, seed, device)
    points = torch.zeros((len(sizes), M, flat.shape[1]), dtype=torch.float32,
                         device=device)
    mask = torch.zeros((len(sizes), M), dtype=torch.bool, device=device)
    off = 0
    for s, size in enumerate(sizes):
        points[s, :size] = flat[off:off + size]
        mask[s, :size] = True
        off += size
    del flat
    return Sites(points, mask, sizes)


def graph_edges(topology: dict) -> Tuple[int, List[Tuple[int, int]]]:
    """(nodes, sorted undirected edges) of the configuration's topology;
    ``grid`` only: rows x cols, each node joined to its right and lower
    neighbours."""
    if topology["kind"] != "grid":
        raise ValueError(f"unknown topology {topology['kind']!r}")
    rows, cols = int(topology["rows"]), int(topology["cols"])
    edges = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                edges.append((v, v + 1))
            if r + 1 < rows:
                edges.append((v, v + cols))
    return rows * cols, sorted(edges)
