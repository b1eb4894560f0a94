"""Baselines the paper compares against (the port of
``repro.core.baselines``; paper Sec. 1, Sec. 5).

* :func:`combine` -- COMBINE: each site builds a *local* coreset of its
  own data and the union is shipped: n (t/n + k) points, the factor-n
  blowup that Algorithm 1 removes. All sites are built at once, one
  backend call per step, as the reference's ``jax.vmap`` of
  ``build_coreset``.
* :func:`zhang_tree` -- Zhang et al.: on a rooted spanning tree every node
  builds a coreset of its own data and its children's coresets and sends
  it to its parent ("coreset of coresets"), leaves to root. Error
  compounds over the tree height.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import objective as objective_mod
from repro_torch.core import prng
from repro_torch.core.backend import BackendLike, DeviceLike, as_tensor
from repro_torch.core.comm import CommLedger, flood_cost
from repro_torch.core.coreset import Coreset, _build_coresets, build_coreset
from repro_torch.core.objective import ObjectiveLike
from repro_torch.core.topology import Graph, SpanningTree


def combine(key, site_points, site_mask, k: int, t_total: int,
            objective: ObjectiveLike = "kmeans", lloyd_iters: int = 5,
            backend: BackendLike = None, device: DeviceLike = None
            ) -> Coreset:
    """Union of per-site local coresets, each of ``t_total // n`` samples
    plus its ``k`` centres: n (t_total // n + k) slots. Site i builds on
    ``split(key, n)[i]``, as in the reference."""
    dev = backend_mod.resolve_device(device)
    site_points = as_tensor(site_points, dev)
    n_sites, _, d = site_points.shape
    s = max(t_total // n_sites, 1)
    w = as_tensor(site_mask, dev).to(site_points.dtype)
    keys = prng.split(as_tensor(key, dev), n_sites)
    cs = _build_coresets(keys, site_points, w, k, s,
                         objective_mod.get_objective(objective),
                         backend_mod.get_backend(backend, dev), lloyd_iters,
                         clip_negative=False)
    return Coreset(points=cs.points.reshape(-1, d),
                   weights=cs.weights.reshape(-1))


def combine_ledger(g: Graph, n_sites: int, k: int, t_total: int, d: int
                   ) -> CommLedger:
    """COMBINE's flood of the n local coresets of ``t_total // n + k``
    points each."""
    s = max(t_total // n_sites, 1)
    return flood_cost(g, n_messages=n_sites, unit_points=float(s + k), dim=d)


def _pad_bucket(n: int, bucket: int = 256) -> int:
    return int(np.ceil(max(n, 1) / bucket) * bucket)


def zhang_tree(key, site_points, site_mask, tree: SpanningTree, k: int,
               s: int, objective: ObjectiveLike = "kmeans",
               lloyd_iters: int = 5, backend: BackendLike = None,
               device: DeviceLike = None) -> Tuple[Coreset, CommLedger]:
    """Coreset of coresets, leaves to root, orchestrated from the host (the
    node instances are ragged). Node v builds an (s + k)-point coreset on
    ``split(key, n)[v]`` from its own points (weight 1) followed by its
    children's coresets, zero-padded to a multiple of 256 rows as in the
    reference (its draws depend on that length); the concatenation stays
    on the device.

    Communication: every non-root node sends its coreset one edge up,
    (n - 1)(s + k) points in all."""
    dev = backend_mod.resolve_device(device)
    site_points = as_tensor(site_points, dev)
    site_mask = as_tensor(site_mask, dev).bool()
    n_sites, _, d = site_points.shape
    children = tree.children()
    keys = prng.split(as_tensor(key, dev), n_sites)
    store = [None] * n_sites
    for v in tree.bottom_up_order():
        own = site_points[v][site_mask[v]]
        pts = torch.cat([own] + [store[c].points for c in children[v]])
        ws = torch.cat([own.new_ones(own.shape[0])]
                       + [store[c].weights for c in children[v]])
        pad = _pad_bucket(pts.shape[0]) - pts.shape[0]
        store[v] = build_coreset(
            keys[v], torch.nn.functional.pad(pts, (0, 0, 0, pad)), k, s,
            weights=torch.nn.functional.pad(ws, (0, pad)),
            objective=objective, lloyd_iters=lloyd_iters, backend=backend,
            device=dev)
    ledger = CommLedger(points=float((n_sites - 1) * (s + k)),
                        messages=float(n_sites - 1), dim=d)
    return store[tree.root], ledger
