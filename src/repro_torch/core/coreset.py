"""Coreset constructions (the port of ``repro.core.coreset``; paper Sec. 3,
Algorithm 1).

* :func:`build_coreset` -- the centralized sensitivity-sampling
  construction on a (possibly weighted) point set.
* :func:`distributed_coreset` -- **Algorithm 1**: every site solves its
  local instance, the ``n`` scalar local costs are the only values
  exchanged, and each site samples ``t_i = t * cost_i / sum_j cost_j``
  points with probability proportional to ``m_p = cost(p, B_i)``.

Everything is fixed-shape, as in the JAX package: sites sample into a
``t_buffer``-slot buffer whose invalid slots carry weight exactly 0
(DESIGN.md Sec. 7), so the port's coresets compare slot by slot with the
reference's. Site-batched stages carry a leading site axis; one backend
call serves every site.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import clustering
from repro_torch.core import objective as objective_mod
from repro_torch.core import prng
from repro_torch.core.backend import BackendLike, DeviceLike, as_tensor
from repro_torch.core.objective import ObjectiveLike

_TINY = 1e-30
# block length of XLA's two-level scan (its CPU cumsum): see _cumsum
_SCAN_BLOCK = 16


@contextlib.contextmanager
def _phase(times: Optional[dict], name: str, device: torch.device):
    """Add the wall seconds of the block to ``times[name]``, synchronizing
    the device before and after; does nothing when ``times`` is None."""
    if times is None:
        yield
        return

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    yield
    sync()
    times[name] = times.get(name, 0.0) + time.perf_counter() - t0


@dataclasses.dataclass
class Coreset:
    """Weighted summary: invalid slots carry weight exactly 0."""

    points: torch.Tensor    # (..., M, d)
    weights: torch.Tensor   # (..., M)

    @property
    def size(self) -> int:
        return int(self.points.shape[-2])

    def effective_size(self) -> torch.Tensor:
        return (self.weights != 0.0).sum(-1)

    @staticmethod
    def concat(*coresets: "Coreset") -> "Coreset":
        """Weight-preserving union of summaries (invalid slots stay inert);
        works on site-batched summaries too."""
        if not coresets:
            raise ValueError("Coreset.concat needs at least one coreset")
        return Coreset(
            points=torch.cat([c.points for c in coresets], dim=-2),
            weights=torch.cat([c.weights for c in coresets], dim=-1))

    def compact(self, size: Optional[int] = None) -> "Coreset":
        """Move weight-carrying slots to the front (stable) and truncate to
        ``size`` slots (default: same size). ``size`` must be >= the number
        of nonzero-weight slots, otherwise mass is silently dropped."""
        size = self.size if size is None else size
        order = torch.argsort((self.weights == 0.0).to(torch.int8),
                              stable=True)
        return Coreset(points=self.points[order][:size],
                       weights=self.weights[order][:size])


def sensitivities(points, centers, weights, objective: ObjectiveLike =
                  "kmeans", backend: BackendLike = None):
    """Per-point sampling masses, assignments and effective weights
    ``(m, assign, w_eff)``: m_p = |w_p| * cost(p, B) with ``w_eff`` the
    weights unchanged (absolute value: signed instances still need a valid
    sampling distribution)."""
    obj = objective_mod.get_objective(objective)
    b = backend_mod.get_backend(backend, points.device)
    return obj.sensitivities(b, points, centers, weights)


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum over the last axis, in the summation
    order of XLA's CPU ``cumsum``: blocks of 16 summed left to right, the
    block totals scanned the same way (recursively), each block offset by
    the scan of the blocks before it. Bit-equal to ``jnp.cumsum`` on the
    JAX package's CPU runs, and the same on every device (no FMA, fixed
    order)."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, -1)
    nb = -(-n // _SCAN_BLOCK)
    padded = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    blocks = padded.reshape(*x.shape[:-1], nb, _SCAN_BLOCK)
    inner = _cumsum(blocks)
    offsets = _cumsum(inner[..., -1])
    out = torch.cat([inner[..., :1, :],
                     offsets[..., :-1, None] + inner[..., 1:, :]], dim=-2)
    return out.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


def weighted_choice(key: torch.Tensor, masses: torch.Tensor,
                    n_draws: int) -> torch.Tensor:
    """``n_draws`` i.i.d. draws proportional to ``masses`` by inverse CDF,
    one row of draws per key: key (..., 2), masses (..., M) -> (..., n_draws)
    int64. Zero-mass entries are never drawn."""
    cdf = _cumsum(masses)
    total = cdf[..., -1:]
    u = prng.uniform(key, (n_draws,)) * total
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    return idx.clamp(0, masses.shape[-1] - 1)


def _sample_and_weight(keys, points, m, weights, assign, k: int, t_local,
                       t_buffer: int, total_m, t_total):
    """Draw ``t_local`` (<= t_buffer) points ~ m_p per site; compute sample
    and center weights. Site-batched: keys (S, 2), points (S, M, d), m /
    weights / assign (S, M), t_local / total_m / t_total (S,)."""
    idx = weighted_choice(keys, m, t_buffer)
    slots = torch.arange(t_buffer, device=points.device)
    valid = (slots < t_local[:, None]) & (total_m[:, None] > _TINY)
    # w_q = (sum_z m_z) * w_q_orig / (t * m_q); zero for invalid slots
    m_q = m.gather(-1, idx)
    w_s = torch.where(
        valid & (m_q > _TINY),
        total_m[:, None] * weights.gather(-1, idx)
        / (torch.clamp_min(t_total, 1.0)[:, None]
           * torch.clamp_min(m_q, _TINY)),
        0.0)
    sampled = points.gather(
        -2, idx[..., None].expand(-1, -1, points.shape[-1]))
    # center weights: w_b = W(P_b) - sum_{q in P_b cap S} w_q (one-hot
    # sums: a fixed reduction order, unlike atomic scatter-adds on the GPU)
    oh = torch.nn.functional.one_hot(assign.long(), k).to(points.dtype)
    w_pb = (weights[..., None] * oh).sum(-2)
    sampled_assign = assign.gather(-1, idx).long()
    oh_s = torch.nn.functional.one_hot(sampled_assign, k).to(points.dtype)
    w_sb = (w_s[..., None] * oh_s).sum(-2)
    return sampled, w_s, w_pb - w_sb


def build_coreset(key, points, k: int, t: int, weights=None,
                  objective: ObjectiveLike = "kmeans", lloyd_iters: int = 5,
                  clip_negative: bool = False, backend: BackendLike = None,
                  device: DeviceLike = None) -> Coreset:
    """Centralized sensitivity-sampling coreset of ``t`` samples + ``k``
    solution centers on a weighted instance. Output size t + k."""
    dev = backend_mod.resolve_device(device)
    points = as_tensor(points, dev)
    key = as_tensor(key, dev)
    w = (points.new_ones(points.shape[0]) if weights is None
         else as_tensor(weights, dev))
    obj = objective_mod.get_objective(objective)
    b = backend_mod.get_backend(backend, dev)
    # solve B on the non-negative part of the measure; the signed w stays
    # authoritative for sensitivities and the weight identities
    w_solve = torch.clamp_min(w, 0.0)
    split = prng.split(key)
    key, ks = split[0], split[1]
    centers = clustering._kmeans_pp_init(key[None], points[None],
                                         w_solve[None], k, obj, b)
    centers, _ = clustering._lloyd(points[None], centers, w_solve[None],
                                   lloyd_iters, obj, b)
    m, assign, w_eff = obj.sensitivities(b, points[None], centers, w[None])
    total_m = m.sum(-1)
    t_vec = torch.full((1,), float(t), device=dev)
    sampled, w_s, w_b = _sample_and_weight(
        ks[None], points[None], m, w_eff, assign, k,
        torch.full((1,), t, device=dev), t, total_m, t_vec)
    if clip_negative:
        w_b = torch.clamp_min(w_b, 0.0)
    return Coreset.concat(Coreset(sampled[0], w_s[0]),
                          Coreset(centers[0], w_b[0]))


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    """Float32 sum of a short vector from left to right: the order XLA's CPU
    reduction takes for up to 16 elements, and the same on every device."""
    total = x[0]
    for i in range(1, x.shape[0]):
        total = total + x[i]
    return total


def proportional_allocation(costs: torch.Tensor, t: int) -> torch.Tensor:
    """Largest-remainder allocation of ``t`` samples proportional to local
    costs: sum_i t_i == t exactly, t_i >= 0, t_i ~= t * cost_i / sum_j
    cost_j. All-zero costs fall back to the uniform allocation.

    The remainder correction is sign-safe: float error can drive
    ``rem = t - sum(floor(frac))`` negative at extreme cost scales; a
    negative remainder is taken back from the sites with the smallest
    fractional parts, capped per site at its floor, and a remainder above
    the site count is awarded cyclically. Ratio-first: costs/total <= 1
    never overflows, while t * costs can reach inf around 1e36 in f32."""
    n_sites = costs.shape[0]
    total = _sequential_sum(costs)
    frac = torch.where(total > _TINY,
                       t * (costs / torch.clamp_min(total, _TINY)),
                       torch.full_like(costs, t / n_sites))
    base = torch.floor(frac)
    rem = t - int(_sequential_sum(base))
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


@dataclasses.dataclass
class DistributedCoreset:
    """Per-site local portions (Algorithm 1 output, before any sharing).

    ``points``: (n_sites, t_buffer + k, d); ``weights``: (n_sites,
    t_buffer + k) with exact zeros on invalid slots; ``t_i``: realized
    per-site sample counts; ``local_costs``: cost(P_i, B_i) -- the Round-1
    scalars."""

    points: torch.Tensor
    weights: torch.Tensor
    t_i: torch.Tensor
    local_costs: torch.Tensor

    def flatten(self) -> Coreset:
        d = self.points.shape[-1]
        return Coreset(points=self.points.reshape(-1, d),
                       weights=self.weights.reshape(-1))


def distributed_coreset(key, site_points, site_mask, k: int, t: int,
                        t_buffer: Optional[int] = None,
                        objective: ObjectiveLike = "kmeans",
                        lloyd_iters: int = 5, clip_negative: bool = False,
                        backend: BackendLike = None, site_weights=None,
                        strategy=None, device: DeviceLike = None,
                        phase_times: Optional[dict] = None
                        ) -> DistributedCoreset:
    """The distributed coreset rounds over all sites at once, driven by a
    registered :class:`~repro_torch.core.strategy.CoresetStrategy`
    (``"algorithm1"``). The only cross-site quantities are the
    ``local_costs`` (Round 1: n scalars) and their sum.

    ``site_weights`` (n_sites, M) generalizes each site to a weighted
    instance; when given, ``site_mask`` is ignored. ``phase_times``, when a
    dict, receives the wall seconds of ``"round1"`` and ``"round2"``
    (the device is synchronized at each boundary)."""
    from repro_torch.core import strategy as strategy_mod
    dev = backend_mod.resolve_device(device)
    t_buffer = t if t_buffer is None else t_buffer
    backend = backend_mod.resolve_name(backend, dev)
    objective = objective_mod.resolve_name(objective)
    strat = strategy_mod.get_strategy(strategy)
    site_points = as_tensor(site_points, dev)
    key = as_tensor(key, dev)
    n_sites = site_points.shape[0]
    w_site = (as_tensor(site_mask, dev).to(site_points.dtype)
              if site_weights is None
              else as_tensor(site_weights, dev).to(site_points.dtype))
    keys = strat.keys(key, n_sites)

    with _phase(phase_times, "round1", dev):
        r1 = strat.summary(keys[:, 0], site_points, w_site, k=k,
                           objective=objective, lloyd_iters=lloyd_iters,
                           backend=backend)
    with _phase(phase_times, "round2", dev):
        local_costs = r1.local_costs
        t_i = strat.allocate(local_costs, t)
        totals = _sequential_sum(local_costs).expand(n_sites)
        portions = strat.contribute(keys[:, 1], site_points, r1, t_i, totals,
                                    k=k, t=t, t_buffer=t_buffer,
                                    clip_negative=clip_negative)
    return DistributedCoreset(points=portions.points,
                              weights=portions.weights, t_i=t_i,
                              local_costs=local_costs)


def round1_local_solves(keys, site_points, w_site, k: int, objective: str,
                        lloyd_iters: int, backend: str):
    """Algorithm 1 Round 1, the purely local stage, for every site at
    once: returns (centers (n, k, d), sensitivities m (n, M), assignments
    (n, M), local_costs (n,), w_eff (n, M))."""
    obj = objective_mod.get_objective(objective)
    b = backend_mod.get_backend(backend, site_points.device)
    # solve B_i on max(w, 0) (identity for masked sites), signed w for the
    # sensitivities
    w_solve = torch.clamp_min(w_site, 0.0)
    centers = clustering._kmeans_pp_init(keys, site_points, w_solve, k, obj,
                                         b)
    centers, _ = clustering._lloyd(site_points, centers, w_solve,
                                   lloyd_iters, obj, b)
    m, assign, w_eff = obj.sensitivities(b, site_points, centers, w_site)
    return centers, m, assign, m.sum(-1), w_eff


def round2_local_samples(keys, site_points, m, w_eff, assign, centers, t_i,
                         total_m, k: int, t: int, t_buffer: int,
                         clip_negative: bool) -> Coreset:
    """Algorithm 1 Round 2, the purely local stage: every site draws its
    ``t_i`` samples and assembles its portion S_i u B_i (a site-batched
    :class:`Coreset`). ``total_m`` is the global sensitivity total each
    site received, per site (n,)."""
    t_total = torch.full(t_i.shape, float(t), device=site_points.device)
    sampled, w_s, w_b = _sample_and_weight(keys, site_points, m, w_eff,
                                           assign, k, t_i, t_buffer, total_m,
                                           t_total)
    if clip_negative:
        w_b = torch.clamp_min(w_b, 0.0)
    return Coreset.concat(Coreset(sampled, w_s), Coreset(centers, w_b))
