"""The comparison that decides ``correct``: one timed run's output against
the plain reference (:mod:`portbench.reference`), stage by stage.

* Round 1 runs in the reference from the run's key alone (seeding and
  refinement of every site): ``local_cost_median_gap`` is the median
  site's relative gap between the program's Round-1 scalar and the
  reference's, ``local_cost_sites_off`` the number of sites whose gap is
  above :data:`SITE_RTOL`. The widest site's (``local_cost_gap``) is
  reported, not compared: eight steps leave a site now and then mid-way
  through moving a boundary between two clusters, where rounding alone
  moves that site as far as the control moves its widest.
  ``local_cost_eval_gap`` is the widest site's relative gap between the
  program's Round-1 scalar and the cost, worked out by the reference, of
  the program's own local centres on that site's points: no step lies
  between the two, so it holds every site to rounding, the unpadded
  largest as much as any.
* The allocation and the ledger follow the program's own scalars exactly:
  ``alloc_miss`` counts the sites whose valid sample slots (the nonzero
  weights, which must be a prefix) are not the largest-remainder
  ``t_i``; ``ledger_miss`` counts the ledger's entries (by phase) that
  differ from Theorem 2's flood ledger of those ``t_i``.
* Round 2 follows the program from its own local centres (the last k slots
  of each site's portion): the reference draws the sample from the masses
  those centres give, with the same keys. ``draw_miss`` is the share of
  valid sample slots holding another point than the reference's draw (an
  inverse-CDF draw moves to a neighbour where the masses' last bits move a
  boundary); ``sample_weight_gap`` the widest relative gap of the weights
  of the slots that agree; ``centre_weight_gap`` the widest gap of a
  centre's weight from W(P_b) - the weights of its valid samples, beyond
  what points at a near tie between two centres and float32 sums can
  move, relative to W(P_b).
* The solve follows the program from its own coreset, with the run's
  solve key. Per centre, the widest coordinate gap between the program's
  centres and the reference's, relative to the largest coordinate:
  ``solve_third_gap`` is the third widest centre's, ``solve_gap`` the
  widest's. A point within rounding of a tie between two centres, now and
  then on the solve's path, goes to the other side in one of the two:
  both centres move, by as much as the control moves them, and no other
  does. The third widest is the first that such a flip cannot move.

A cell compares the numbers its ``limits/<workload>.json`` lists, each
against its limit; the run is correct when none is above. The others are
returned for the readings the limits are set from.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench import reference as ref

NUMBERS = ("local_cost_gap", "local_cost_median_gap", "local_cost_sites_off",
           "local_cost_eval_gap", "alloc_miss", "ledger_miss", "draw_miss", "sample_weight_gap",
           "centre_weight_gap", "solve_gap", "solve_third_gap")

# a site's Round-1 scalar further than this from the reference's, relative,
# counts towards ``local_cost_sites_off``
SITE_RTOL = 1e-5


# two nearest centres closer than this share of |p|^2 + max |c|^2 are a
# near tie (the kernels' squared distances agree with the plain float32
# ones to ~1e-6 of that magnitude)
TIE_RTOL = 1e-5
# float32 sums of a cluster's weights, relative to the sum of their sizes
SUM_RTOL = 1e-5


def _either(a1, a2, w, k: int):
    """Per cluster, the weight of the points whose nearest or second
    nearest it is."""
    return (ref.cluster_weights(a1, w, k) + ref.cluster_weights(a2, w, k))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}/{key}")
    else:
        yield prefix, tree


def ledger_misses(got: dict, want: dict) -> int:
    """Entries of two ledgers (nested dicts of numbers) that differ or that
    only one has."""
    a, b = dict(_leaves(got)), dict(_leaves(want))
    return sum(1 for key in set(a) | set(b) if a.get(key) != b.get(key))


def judge(out: ref.Output, key: torch.Tensor, points: torch.Tensor,
          mask: torch.Tensor, cfg: dict, objective: str, n_edges: int,
          block: int = 25) -> Dict[str, float]:
    """The numbers of one run's output ``out`` (a :class:`ref.Output`) on
    the inputs it was given."""
    z = ref.Z[objective]
    k, t, iters = int(cfg["k"]), int(cfg["t"]), int(cfg["lloyd_iters"])
    S, M, d = points.shape
    keys, k2 = ref.key_table(key, S)
    slots = out.cs_points.reshape(S, t + k, d)
    weights = out.cs_weights.reshape(S, t + k)
    costs = out.local_costs.float()

    # Round 1 from the key alone
    _, masses, _ = ref.round1(keys[:, 0], points, mask, k, z, iters,
                              block=block)
    want = masses.double().sum(-1)
    site_gaps = (costs.double() - want).abs() / want.clamp_min(ref.TINY)
    del masses

    # the allocation and the ledger of the program's scalars
    t_i = ref.allocate(costs, t)
    live = weights[:, :t] != 0.0
    t_prog = live.sum(-1)
    prefix = (live == (torch.arange(t, device=live.device)
                       < t_prog[:, None])).all(-1)
    alloc_miss = int(((t_prog != t_i) | ~prefix).sum())
    ledger_miss = ledger_misses(out.ledger, ref.flood_ledger(
        S, n_edges, t_i.tolist(), k, d))

    # Round 2 from the program's local centres and scalars
    total = ref.window_sum(costs).expand(S)
    misses = valid_n = 0
    w_gap = c_gap = e_gap = 0.0
    for b in ref.blocks(S, block):
        p, w = points[b], mask[b].to(points.dtype)
        centres = slots[b, t:]
        d2, _ = ref.min_d2(p, centres)
        m = w * ref.point_cost(d2, z)
        own = m.double().sum(-1)
        e_gap = max(e_gap, float(((costs[b].double() - own).abs()
                                  / own.clamp_min(ref.TINY)).max()))
        idx = ref.draw(keys[b, 1], m, t)
        drawn = p.gather(-2, idx[..., None].expand(-1, -1, d))
        got_pts, got_w = slots[b, :t], weights[b, :t]
        valid = torch.arange(t, device=p.device) < t_i[b, None]
        same = (drawn == got_pts).all(-1)
        misses += int((valid & ~same).sum())
        valid_n += int(valid.sum())
        w_want = ref.sample_weights(m.gather(-1, idx), w.gather(-1, idx),
                                    t_i[b], total[b], t)
        agree = valid & same
        if bool(agree.any()):
            rel = ((got_w - w_want).abs()
                   / w_want.abs().clamp_min(ref.TINY))[agree]
            w_gap = max(w_gap, float(rel.max()))
        # a centre's weight: its cluster's weight less its valid samples';
        # a point at a near tie may sit in either of its two nearest
        # clusters, so its weight is slack for both
        taken_w = torch.where(valid, got_w, 0.0).double()
        tie, a1, a2 = ref.near_ties(p, centres, TIE_RTOL)
        tie_q, a1_q, a2_q = ref.near_ties(got_pts, centres, TIE_RTOL)
        mass = ref.cluster_weights(a1, w.double(), k)
        taken = ref.cluster_weights(a1_q, taken_w, k)
        slack = (_either(a1, a2, torch.where(tie, w, 0.0).double(), k)
                 + _either(a1_q, a2_q,
                           torch.where(tie_q, taken_w.abs(), 0.0), k)
                 + SUM_RTOL * (mass + ref.cluster_weights(
                     a1_q, taken_w.abs(), k)))
        gap = (((weights[b, t:].double() - (mass - taken)).abs() - slack)
               .clamp_min(0.0) / mass.clamp_min(1.0))
        c_gap = max(c_gap, float(gap.max()))
    draw_miss = misses / max(valid_n, 1)

    # the solve from the program's coreset
    centres = ref.solve(k2, out.cs_points, out.cs_weights, k, z, iters)
    widest = ((out.centres.float() - centres).abs().amax(-1)
              / centres.abs().max().clamp_min(ref.TINY)).sort(
                  descending=True).values
    return {"local_cost_gap": float(site_gaps.max()),
            "local_cost_median_gap": float(site_gaps.median()),
            "local_cost_sites_off": int((site_gaps > SITE_RTOL).sum()),
            "local_cost_eval_gap": e_gap,
            "alloc_miss": alloc_miss,
            "ledger_miss": ledger_miss, "draw_miss": draw_miss,
            "sample_weight_gap": w_gap, "centre_weight_gap": c_gap,
            "solve_gap": float(widest[0]),
            "solve_third_gap": float(widest[min(2, k - 1)])}


def verdict(worst: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number is at or under its limit (a missing
    number, or a NaN, fails)."""
    return all(name in worst and worst[name] <= limits[name]
               for name in limits)
