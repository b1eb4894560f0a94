"""The timed path broken underneath, in each way a clustering cell can
break, for the checks that the comparison fails what it should:

* ``state_unchanged`` -- every Lloyd or Weiszfeld step returns the centres
  it was given;
* ``half_batch`` -- every other point is left out of a step's sums, the
  means taken over the rest;
* ``no_exchange`` -- Round 1's exchange left out: each site normalises its
  sample weights by its own cost total, not the sum the sites flood;
* ``answer_altered`` -- every centre moved by 1e-3 of the largest
  coordinate as the solve returns it;
* ``one_site_cost`` -- the largest site's sampling masses, and so its
  Round-1 scalar, 1e-3 high: a fault confined to one site, which the
  comparisons of the median site and of the count of sites let pass.

A one-chip cell has no exchange between chips. :func:`planted` patches the
program for the length of a ``with`` block, on any device.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_batch", "no_exchange", "answer_altered",
          "one_site_cost")


def _unchanged(orig):
    def stats(points, centers, weights=None):
        _, den, cost = orig(points, centers, weights)
        return centers.float() * den[..., None], den, cost
    return stats


def _half(orig):
    def stats(points, centers, weights=None):
        w = (torch.ones(points.shape[:-1], device=points.device)
             if weights is None else weights.clone())
        w[..., 1::2] = 0.0
        return orig(points, centers, w)
    return stats


@contextlib.contextmanager
def planted(fault: str, objective: str):
    """Run the body with ``fault`` planted in the program's path for
    ``objective`` ("kmeans" or "kmedian")."""
    from repro_torch.core import coreset, distributed
    from repro_torch.kernels import ops
    if fault in ("state_unchanged", "half_batch"):
        owner = ops
        name = "weiszfeld_stats" if objective == "kmedian" else "lloyd_stats"
        wrap = _unchanged if fault == "state_unchanged" else _half
        new = wrap(getattr(ops, name))
    elif fault == "no_exchange":
        owner, name = coreset, "_round2_portions"
        orig = coreset._round2_portions

        def new(keys, site_points, m, w_eff, assign, centers, t_i, total_m,
                *rest):
            return orig(keys, site_points, m, w_eff, assign, centers, t_i,
                        m.sum(-1), *rest)
    elif fault == "answer_altered":
        owner, name = distributed, "_solve_on_coreset"
        orig = distributed._solve_on_coreset

        def new(*args, **kw):
            c = orig(*args, **kw)
            return c + 1e-3 * float(c.abs().max())
    elif fault == "one_site_cost":
        owner, name = coreset, "round1_local_solves"
        orig = coreset.round1_local_solves

        def new(keys, site_points, w_site, *args, **kw):
            centers, m, assign, _, w_eff = orig(keys, site_points, w_site,
                                                *args, **kw)
            m = m.clone()
            m[int((w_site != 0).sum(-1).argmax())] *= 1.001
            return centers, m, assign, m.sum(-1), w_eff
    else:
        raise ValueError(f"unknown fault {fault!r}")
    saved = getattr(owner, name)
    setattr(owner, name, new)
    try:
        yield
    finally:
        setattr(owner, name, saved)
