"""The plain reference: distributed k-means / k-median over a flood
(Algorithm 1's two rounds, then Algorithm 2's solve on the coreset) in
plain PyTorch, imported from nothing of the program.

It follows the published algorithm (Balcan, Ehrlich & Liang, NIPS 2013)
with the program's conventions, so that the same key draws the same
numbers: the key table (``split(k1, 2 n)``), D^z seeding by Gumbel-max
over ``log(w d^z + 1e-30)``, ``iters`` Lloyd steps (k-means) or steps of
four Weiszfeld passes with eta^2 = 1e-6 (k-median), the sampling masses
``m_p = w_p cost(p, B_i)``, the largest-remainder allocation and the
window sums in the program's summation order, the inverse-CDF draws over
a blocked prefix sum, the sample and centre weights, and the analytic
flood ledger of Theorem 2.

Distances are the norm form ``|p|^2 + |c|^2 - 2 p.c`` in float32 with
TF32 off (the configurations state float32). ``Arith(lowp=True)`` rounds
every matrix product's inputs to TF32 (10 mantissa bits) first: the
control, the nearest precision below the one the configurations state.
Every stage runs site-batched on blocks of sites, so the reference fits
beside the program's inputs at the timed sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from portbench import threefry as tf

TINY = 1e-30
EPS = 1e-12
ETA2 = 1e-6
SCAN_BLOCK = 16
SUM_WINDOW = 32
WEISZFELD_PASSES = 4
Z = {"kmeans": 2, "kmedian": 1}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Arith:
    """How matrix products round: float32 (``lowp=False``) or TF32."""

    lowp: bool = False

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.lowp:
            a, b = tf32(a), tf32(b)
        return torch.matmul(a, b)


F32 = Arith(False)


@dataclasses.dataclass
class Output:
    """What one distributed clustering gives back, as the program returns
    it: centres (k, d), the flat coreset (sites x (t + k) slots: t sample
    slots, then the site's k centres), the ledger as a dict by phase, and
    the Round-1 scalars."""

    centres: torch.Tensor
    cs_points: torch.Tensor
    cs_weights: torch.Tensor
    ledger: dict
    local_costs: torch.Tensor


# -- distances and costs --------------------------------------------------------

def min_d2(points, centres, ar: Arith = F32):
    """(B, M, d), (B, k, d) -> min squared distance (B, M) and argmin
    (B, M), lowest index on ties."""
    p2 = (points * points).sum(-1, keepdim=True)
    c2 = (centres * centres).sum(-1)
    d2 = torch.clamp_min(
        p2 + c2[:, None, :] - 2.0 * ar.mm(points, centres.transpose(-1, -2)),
        0.0)
    return d2.amin(-1), d2.argmin(-1)


def near_ties(points, centres, rtol: float):
    """Where the two nearest centres lie within ``rtol`` x (|p|^2 +
    max |c|^2) of each other, so that rounding alone can pick either:
    (tie (B, M) bool, nearest (B, M), second nearest (B, M))."""
    p2 = (points * points).sum(-1, keepdim=True)
    c2 = (centres * centres).sum(-1)
    d2 = p2 + c2[:, None, :] - 2.0 * (points @ centres.transpose(-1, -2))
    two = torch.topk(d2, 2, dim=-1, largest=False)
    gap = two.values[..., 1] - two.values[..., 0]
    tie = gap <= rtol * (p2[..., 0] + c2.amax(-1, keepdim=True))
    return tie, two.indices[..., 0], two.indices[..., 1]


def point_cost(d2: torch.Tensor, z: int) -> torch.Tensor:
    return d2 if z == 2 else torch.sqrt(d2)


# -- D^z seeding -----------------------------------------------------------------

def _masked_choice(keys, mass):
    idx = tf.categorical(keys, torch.log(mass + TINY))
    return torch.where(mass.sum(-1) > 0.0, idx, 0)


def seed_centres(keys, points, weights, k: int, z: int,
                 ar: Arith = F32) -> torch.Tensor:
    """k D^z seeds per site: keys (B, 2), points (B, M, d), weights (B, M)
    -> (B, k, d)."""
    B, _, d = points.shape
    rows = torch.arange(B, device=points.device)
    w = torch.clamp_min(weights, 0.0)
    sp = tf.split(keys)
    key, k0 = sp[:, 0], sp[:, 1]
    centres = points.new_zeros((B, k, d))
    c = points[rows, _masked_choice(k0, w)]
    centres[:, 0] = c
    mind = point_cost(min_d2(points, c[:, None, :], ar)[0], z)
    for i in range(1, k):
        sp = tf.split(key)
        key, ki = sp[:, 0], sp[:, 1]
        c = points[rows, _masked_choice(ki, w * mind)]
        centres[:, i] = c
        mind = torch.minimum(mind,
                             point_cost(min_d2(points, c[:, None, :], ar)[0],
                                        z))
    return centres


# -- centre updates ----------------------------------------------------------------

def _ratio_or_keep(nums, denoms, centres):
    keep = denoms > EPS
    new = nums / torch.where(keep, denoms, 1.0)[..., None]
    return torch.where(keep[..., None], new, centres)


def lloyd_step(points, weights, centres, ar: Arith = F32):
    """One weighted Lloyd step; clusters of weight <= 1e-12 keep their
    centre."""
    _, a = min_d2(points, centres, ar)
    oh = torch.nn.functional.one_hot(a, centres.shape[1]).float()
    oh = oh * weights[..., None]
    return _ratio_or_keep(ar.mm(oh.transpose(-1, -2), points), oh.sum(-2),
                          centres)


def weiszfeld_pass(points, weights, centres, ar: Arith = F32):
    """One Weiszfeld pass: assign by the norm form, then the exact-form
    distance to the assigned centre, smoothed by eta^2, as the inverse
    weight max(w, 0) / sqrt(d2 + eta^2)."""
    _, a = min_d2(points, centres, ar)
    own = torch.gather(centres, 1,
                       a[..., None].expand(-1, -1, points.shape[-1]))
    diff = points - own
    del own
    inv = torch.clamp_min(weights, 0.0) / torch.sqrt(
        (diff * diff).sum(-1) + ETA2)
    del diff
    oh = torch.nn.functional.one_hot(a, centres.shape[1]).float()
    oh = oh * inv[..., None]
    return _ratio_or_keep(ar.mm(oh.transpose(-1, -2), points), oh.sum(-2),
                          centres)


def refine(points, weights, centres, iters: int, z: int, ar: Arith = F32):
    """``iters`` update steps: Lloyd (z = 2) or four Weiszfeld passes
    (z = 1) each."""
    for _ in range(iters):
        if z == 2:
            centres = lloyd_step(points, weights, centres, ar)
        else:
            for _ in range(WEISZFELD_PASSES):
                centres = weiszfeld_pass(points, weights, centres, ar)
    return centres


def solve(key, points, weights, k: int, z: int, iters: int,
          ar: Arith = F32) -> torch.Tensor:
    """Algorithm 2's solve on a weighted instance (n, d): seeding on
    max(w, 0), refinement on the signed weights. Returns (k, d)."""
    c = seed_centres(key[None], points[None],
                     torch.clamp_min(weights, 0.0)[None], k, z, ar)
    return refine(points[None], weights[None], c, iters, z, ar)[0]


# -- the program's summation orders ------------------------------------------------

def cumsum_blocked(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum over the last axis: blocks of 16 summed
    left to right, the block totals scanned the same way, each block offset
    by the scan of the blocks before it."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, -1)
    nb = -(-n // SCAN_BLOCK)
    padded = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - n))
    tiles = padded.reshape(*x.shape[:-1], nb, SCAN_BLOCK)
    inner = cumsum_blocked(tiles)
    offsets = cumsum_blocked(inner[..., -1])
    out = torch.cat([inner[..., :1, :],
                     offsets[..., :-1, None] + inner[..., 1:, :]], dim=-2)
    return out.reshape(*x.shape[:-1], nb * SCAN_BLOCK)[..., :n]


def window_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in windows of 32: zero-padded to a
    multiple of 32 (half the padding in front), each window summed left to
    right, repeated on the window sums until one is left."""
    while True:
        n = x.shape[-1]
        pad = -n % SUM_WINDOW if n else SUM_WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        windows = x.reshape(*x.shape[:-1], -1, SUM_WINDOW)
        total = windows.new_zeros(windows.shape[:-1])
        for j in range(SUM_WINDOW):
            total = total + windows[..., j]
        if total.shape[-1] == 1:
            return total[..., 0]
        x = total


def allocate(costs: torch.Tensor, t: int) -> torch.Tensor:
    """Largest-remainder split of ``t`` samples in proportion to the
    float32 ``costs``: floors of t x cost / total, the remainder to the
    largest fractional parts (lower site first on ties), a negative
    remainder taken from the smallest; int32 (sites,)."""
    n_sites = costs.shape[0]
    total = window_sum(costs)
    frac = torch.where(total > TINY,
                       t * (costs / torch.clamp_min(total, TINY)),
                       torch.full_like(costs, t / n_sites))
    base = torch.floor(frac)
    rem = t - int(window_sum(base))
    fr = frac - base
    rank_hi = torch.argsort(torch.argsort(-fr, stable=True), stable=True)
    pos = max(rem, 0)
    award = pos // n_sites + (rank_hi < pos % n_sites).to(torch.int32)
    need = max(-rem, 0)
    order = torch.argsort(fr, stable=True)
    cap = base[order].to(torch.int32)
    before = torch.cumsum(cap, 0, dtype=torch.int32) - cap
    take_sorted = torch.minimum(torch.clamp_min(need - before, 0), cap)
    take = torch.empty_like(take_sorted)
    take[order] = take_sorted
    return (base.to(torch.int32) + award - take).to(torch.int32)


def draw(keys, masses, t: int) -> torch.Tensor:
    """``t`` inverse-CDF draws per site ~ masses (B, M): (B, t) int64."""
    cdf = cumsum_blocked(masses)
    u = tf.uniform(keys, (t,)) * cdf[..., -1:]
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    return idx.clamp(0, masses.shape[-1] - 1)


def sample_weights(m_q, w_q, t_i, total, t: int) -> torch.Tensor:
    """The program's sample weight (sum_z m_z) w_q / (t m_q) on the first
    t_i slots of each site, 0 elsewhere; float32 (B, t)."""
    slots = torch.arange(m_q.shape[-1], device=m_q.device)
    valid = (slots < t_i[:, None]) & (total[:, None] > TINY)
    t_total = torch.full(t_i.shape, float(t), device=m_q.device)
    return torch.where(
        valid & (m_q > TINY),
        total[:, None] * w_q / (torch.clamp_min(t_total, 1.0)[:, None]
                                * torch.clamp_min(m_q, TINY)),
        0.0)


def cluster_weights(assign, weights, k: int) -> torch.Tensor:
    """Each cluster's weight total per site: (B, k)."""
    oh = torch.nn.functional.one_hot(assign, k).to(weights.dtype)
    return (weights[..., None] * oh).sum(-2)


# -- the ledger ----------------------------------------------------------------------

def _ledger_entry(scalars, points, messages, dim, link_cost) -> Dict:
    return {"scalars": float(scalars), "points": float(points),
            "messages": float(messages),
            "bytes": 4.0 * scalars + 4.0 * (dim + 1) * points,
            "link_cost": float(link_cost), "staleness": 0.0}


def flood_ledger(n_nodes: int, n_edges: int, t_i, k: int, d: int) -> Dict:
    """Theorem 2's flood on an undirected graph of unit link costs: Round 1
    floods the n cost scalars over every link, Round 2 the n portions of
    t_i + k points each; by phase, as the program's ``as_dict``."""
    per = float(2 * n_edges)
    r1 = _ledger_entry(per * n_nodes, 0.0, per * n_nodes, 0,
                       per * n_nodes * 4.0)
    units = np.asarray(t_i, np.float64) + k
    link = 0.0
    for u in units.tolist():
        link += per * (4.0 * (d + 1) * u)
    r2 = _ledger_entry(0.0, per * float(units.sum()), per * n_nodes, d, link)
    out = _ledger_entry(r1["scalars"] + r2["scalars"],
                        r1["points"] + r2["points"],
                        r1["messages"] + r2["messages"], d,
                        r1["link_cost"] + r2["link_cost"])
    out["phases"] = {"round1": r1, "round2": r2}
    return out


# -- Algorithm 1 and 2 ------------------------------------------------------------------

def key_table(key, n_sites: int):
    """(k1's per-site table (n, 2, 2), k2): column 0 of the table drives
    Round 1, column 1 Round 2; k2 the solve."""
    k12 = tf.split(key)
    return tf.split(k12[0], n_sites * 2).reshape(n_sites, 2, 2), k12[1]


def blocks(n: int, size: int) -> List[slice]:
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def round1(keys, points, mask, k: int, z: int, iters: int,
           ar: Arith = F32, block: int = 25):
    """Every site's local solve and sampling masses: (centres (S, k, d),
    masses (S, M) float32, assignment (S, M))."""
    S = points.shape[0]
    centres, masses, assign = [], [], []
    for b in blocks(S, block):
        p, w = points[b], mask[b].to(points.dtype)
        c = seed_centres(keys[b], p, w, k, z, ar)
        c = refine(p, w, c, iters, z, ar)
        d2, a = min_d2(p, c, ar)
        centres.append(c)
        masses.append(w.abs() * point_cost(d2, z))
        assign.append(a)
    return torch.cat(centres), torch.cat(masses), torch.cat(assign)


def round2(keys, points, mask, centres, masses, assign, local_costs, k: int,
           t: int, block: int = 25):
    """Every site's portion S_i u B_i under the global total: (points
    (S, t + k, d), weights (S, t + k), t_i)."""
    S = points.shape[0]
    t_i = allocate(local_costs, t)
    total = window_sum(local_costs).expand(S)
    pts, wts = [], []
    for b in blocks(S, block):
        w = mask[b].to(points.dtype)
        idx = draw(keys[b], masses[b], t)
        m_q = masses[b].gather(-1, idx)
        sampled = points[b].gather(
            -2, idx[..., None].expand(-1, -1, points.shape[-1]))
        w_s = sample_weights(m_q, w.gather(-1, idx), t_i[b], total[b], t)
        w_b = (cluster_weights(assign[b], w, k)
               - cluster_weights(assign[b].gather(-1, idx), w_s, k))
        pts.append(torch.cat([sampled, centres[b]], dim=-2))
        wts.append(torch.cat([w_s, w_b], dim=-1))
    return torch.cat(pts), torch.cat(wts), t_i


def cluster(key, points, mask, k: int, t: int, objective: str, iters: int,
            n_edges: int, ar: Arith = F32, block: int = 25) -> Output:
    """One distributed clustering end to end, in the program's place."""
    z = Z[objective]
    S, _, d = points.shape
    keys, k2 = key_table(key, S)
    centres, masses, assign = round1(keys[:, 0], points, mask, k, z, iters,
                                     ar, block)
    local_costs = masses.sum(-1)
    cs_p, cs_w, t_i = round2(keys[:, 1], points, mask, centres, masses,
                             assign, local_costs, k, t, block)
    cs_p, cs_w = cs_p.reshape(-1, d), cs_w.reshape(-1)
    return Output(solve(k2, cs_p, cs_w, k, z, iters, ar), cs_p, cs_w,
                  flood_ledger(S, n_edges, t_i.tolist(), k, d), local_costs)
