"""Coreset constructions (the port of ``repro.core.coreset``; paper Sec. 3,
Algorithm 1).

* :func:`build_coreset` -- the centralized sensitivity-sampling
  construction on a (possibly weighted) point set.
* :func:`distributed_coreset` -- **Algorithm 1**: every site solves its
  local instance, the ``n`` scalar local costs are the only values
  exchanged, and each site samples ``t_i = t * cost_i / sum_j cost_j``
  points with probability proportional to ``m_p = cost(p, B_i)``.
* :func:`staged_distributed_coreset` -- the same rounds dispatched one
  site at a time (DESIGN.md Sec. 17), bit-identical in strict mode.
* :func:`merge_coresets` -- the streaming tree's merge-and-reduce step.

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
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import clustering
from repro_torch.core import objective as objective_mod
from repro_torch.core import prng
from repro_torch.core.backend import BackendLike, DeviceLike, as_tensor
from repro_torch.core.objective import ObjectiveLike
from repro_torch.roofline import trace as _trace

_TINY = 1e-30
# block length of XLA's two-level scan (its CPU cumsum): see _cumsum
_SCAN_BLOCK = 16


@contextlib.contextmanager
def _phase(times: Optional[dict], name: str, device: torch.device):
    """Run the block as phase ``name`` (``repro_torch.roofline.trace.phase``:
    a profiler scope, and the phase the work ledger and its collective
    records read) and add its wall seconds to ``times[name]``, synchronizing
    the device before and after; no wall and no sync when ``times`` is
    None."""
    if times is None:
        with _trace.phase(name):
            yield
        return

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    with _trace.phase(name):
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


def _sample_draws(keys, points, m, weights, assign, t_buffer: int):
    """The allocation-independent draws of :func:`_sample_and_weight`: the
    ``t_buffer`` indices ~ m and their masses, weights, points and
    assignments -- all from Round-1 locals, so a site can draw before its
    ``t_i`` arrives. Site-batched like :func:`_sample_and_weight`. Returns
    (sampled, m_q, w_idx, sampled_assign)."""
    idx = weighted_choice(keys, m, t_buffer)
    m_q = m.gather(-1, idx)
    w_idx = weights.gather(-1, idx)
    sampled = points.gather(
        -2, idx[..., None].expand(-1, -1, points.shape[-1]))
    sampled_assign = assign.gather(-1, idx).long()
    return sampled, m_q, w_idx, sampled_assign


def _cluster_weights(assign, weights, k: int) -> torch.Tensor:
    """Each cluster's weight total W(P_b), per site, as a one-hot sum (a
    fixed reduction order, unlike atomic scatter-adds on the GPU)."""
    oh = torch.nn.functional.one_hot(assign.long(), k).to(weights.dtype)
    return (weights[..., None] * oh).sum(-2)


def _sample_suffix(m_q, w_idx, sampled_assign, w_pb, k: int, t_local,
                   t_buffer: int, total_m, t_total):
    """The allocation-dependent suffix of :func:`_sample_and_weight`: the
    validity of the first ``t_local`` slots, the sample weights and the
    residual center weights. Returns (w_s, w_b)."""
    slots = torch.arange(t_buffer, device=m_q.device)
    valid = (slots < t_local[:, None]) & (total_m[:, None] > _TINY)
    # w_q = (sum_z m_z) * w_q_orig / (t * m_q); zero for invalid slots
    w_s = torch.where(
        valid & (m_q > _TINY),
        total_m[:, None] * w_idx
        / (torch.clamp_min(t_total, 1.0)[:, None]
           * torch.clamp_min(m_q, _TINY)),
        0.0)
    # center weights: w_b = W(P_b) - sum_{q in P_b cap S} w_q
    oh_s = torch.nn.functional.one_hot(sampled_assign, k).to(w_s.dtype)
    w_sb = (w_s[..., None] * oh_s).sum(-2)
    return w_s, w_pb - w_sb


def _sample_and_weight(keys, points, m, weights, assign, k: int, t_local,
                       t_buffer: int, total_m, t_total):
    """Draw ``t_local`` (<= t_buffer) points ~ m_p per site; compute sample
    and center weights. Site-batched: keys (S, 2), points (S, M, d), m /
    weights / assign (S, M), t_local / total_m / t_total (S,)."""
    sampled, m_q, w_idx, sampled_assign = _sample_draws(
        keys, points, m, weights, assign, t_buffer)
    w_pb = _cluster_weights(assign, weights, k)
    w_s, w_b = _sample_suffix(m_q, w_idx, sampled_assign, w_pb, k, t_local,
                              t_buffer, total_m, t_total)
    return sampled, w_s, w_b


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
    cs = _build_coresets(key[None], points[None], w[None], k, t,
                         objective_mod.get_objective(objective),
                         backend_mod.get_backend(backend, dev), lloyd_iters,
                         clip_negative)
    return Coreset(cs.points[0], cs.weights[0])


def _build_coresets(keys, points, w, k: int, t: int, obj, b,
                    lloyd_iters: int, clip_negative: bool) -> Coreset:
    """:func:`build_coreset` for S instances at once (the reference's
    ``jax.vmap`` of it): keys (S, 2), points (S, M, d), weights (S, M) ->
    a site-batched Coreset (S, t + k, d); one backend call per step."""
    # solve B on the non-negative part of the measure; the signed w stays
    # authoritative for sensitivities and the weight identities
    w_solve = torch.clamp_min(w, 0.0)
    split = prng.split(keys)
    key, ks = split[:, 0], split[:, 1]
    centers = clustering._kmeans_pp_init(key, points, w_solve, k, obj, b)
    centers, _ = clustering._lloyd(points, centers, w_solve, lloyd_iters,
                                   obj, b)
    m, assign, w_eff = obj.sensitivities(b, points, centers, w)
    S = points.shape[0]
    sampled, w_s, w_b = _sample_and_weight(
        ks, points, m, w_eff, assign, k,
        torch.full((S,), t, device=points.device), t, m.sum(-1),
        torch.full((S,), float(t), device=points.device))
    if clip_negative:
        w_b = torch.clamp_min(w_b, 0.0)
    return Coreset.concat(Coreset(sampled, w_s), Coreset(centers, w_b))


def merge_coresets(key, a: Coreset, b: Coreset, k: int, t: int,
                   objective: ObjectiveLike = "kmeans", lloyd_iters: int = 5,
                   backend: BackendLike = None,
                   device: DeviceLike = None) -> Coreset:
    """Merge-and-reduce step of the streaming coreset tree: re-run
    sensitivity sampling on the union of two (signed) summaries. The union
    of coresets is a coreset of the union; the output has t + k slots
    whatever the inputs' sizes."""
    u = Coreset.concat(a, b)
    return build_coreset(key, u.points, k, t, weights=u.weights,
                         objective=objective, lloyd_iters=lloyd_iters,
                         backend=backend, device=device)


# width of the windows of XLA's CPU reduction of a long vector
_SUM_WINDOW = 32


def _windowed_sum(x: torch.Tensor) -> torch.Tensor:
    """Float32 sum over the last axis in the order of ``jnp.sum`` on the CPU
    (XLA's CPU reduction; per row, as under ``jax.vmap``), the same on
    every device: up to 32 elements, left to right from 0; above that, the
    vector zero-padded to a multiple of 32 (``pad // 2`` zeros in front,
    the rest behind), each window of 32 summed from 0 left to right, and
    the same rule applied to the window sums until one is left.
    Whole-tensor adds: 32 per level, none per element."""
    while True:
        n = x.shape[-1]
        pad = -n % _SUM_WINDOW if n else _SUM_WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        windows = x.reshape(*x.shape[:-1], -1, _SUM_WINDOW)
        total = windows.new_zeros(windows.shape[:-1])
        for j in range(_SUM_WINDOW):
            total = total + windows[..., j]
        if total.shape[-1] == 1:
            return total[..., 0]
        x = total


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
    total = _windowed_sum(costs)
    frac = torch.where(total > _TINY,
                       t * (costs / torch.clamp_min(total, _TINY)),
                       torch.full_like(costs, t / n_sites))
    base = torch.floor(frac)
    rem = t - int(_windowed_sum(base))
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
    (``"algorithm1"``, ``"cohen_addad"`` or ``"mapreduce"``). For
    exchanging strategies the only cross-site quantities are the
    ``local_costs`` (Round 1: n scalars) and their sum; single-shuffle
    strategies (``"mapreduce"``) use none.

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
        if strat.needs_exchange:
            totals = _windowed_sum(local_costs).expand(n_sites)
        else:
            totals = strat.local_totals(local_costs)
        portions = strat.contribute(keys[:, 1], site_points, r1, t_i, totals,
                                    k=k, t=t, t_buffer=t_buffer,
                                    clip_negative=clip_negative)
    return DistributedCoreset(points=portions.points,
                              weights=portions.weights, t_i=t_i,
                              local_costs=local_costs)


# ---------------------------------------------------------------------------
# the staged Round-1/Round-2 engine: one site at a time instead of lockstep
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StagedDetail:
    """Measurement sidecar of :func:`staged_distributed_coreset`.

    ``site_lengths``: the per-site solve lengths (all the lockstep pad M
    unless ``site_buckets``); ``iters_run``: per-site refinement passes
    (``lloyd_iters`` everywhere unless ``tol > 0`` let a site stop early);
    the walls split Round 1 (the solves, until every site's scalar is on
    the host) from Round 2 (allocation and the portions). ``host_reads``
    counts the convergence checks' host reads (one per pass when ``tol >
    0``, none in strict mode)."""

    site_lengths: Tuple[int, ...]
    iters_run: torch.Tensor
    wall_round1_s: float
    wall_round2_s: float
    wall_total_s: float
    host_reads: int = 0


def _site_scalar(strat, m: torch.Tensor, site: int,
                 n_sites: int) -> torch.Tensor:
    """Site ``site``'s Round-1 scalar from its masses ``m`` (1, L), summed
    as row ``site`` of an (n_sites, L) batch whose other rows are zero:
    torch on the card picks a reduction's order from the tensor's shape,
    so the row sums exactly as the same site does inside the lockstep
    batch."""
    rows = m.new_zeros((n_sites, m.shape[-1]))
    rows[site] = m[0]
    return strat.site_total(rows)[site:site + 1]


def _staged_solve_site(key, pts, w, k: int, objective: str,
                       lloyd_iters: int, tol: float, backend: str,
                       strategy: str, site: int, n_sites: int):
    """One site's Round-1 stage with a leading site axis of 1 (key (1, 2),
    pts (1, L, d), w (1, L)): the stages of :func:`round1_local_solves`
    (bit-identical at ``tol == 0``) with the strategy's sampling-mass rule
    and Round-1 scalar. Returns (centers, m, assign, cost (1,), w_eff,
    iters_run (1,))."""
    from repro_torch.core import strategy as strategy_mod
    strat = strategy_mod.get_strategy(strategy)
    obj = objective_mod.get_objective(objective)
    b = backend_mod.get_backend(backend, pts.device)
    w_solve = torch.clamp_min(w, 0.0)
    centers = clustering._kmeans_pp_init(key, pts, w_solve, k, obj, b)
    centers, iters_run = clustering._lloyd_converged(pts, centers, w_solve,
                                                     lloyd_iters, tol, obj, b)
    m, assign, w_eff = strat.site_sensitivities(pts, centers, w,
                                                objective=objective,
                                                backend=backend)
    return (centers, m, assign, _site_scalar(strat, m, site, n_sites),
            w_eff, iters_run)


def _staged_round2_precompute(key, pts, m, assign, w_eff, t_buffer: int):
    """A site's Round-2 work that needs no allocation: the draws of
    :func:`_sample_and_weight`, term for term."""
    return _sample_draws(key, pts, m, w_eff, assign, t_buffer)


def _staged_round2_finalize(sampled, m_q, w_idx, sampled_assign, w_pb,
                            centers, t_local, total_m, t_total, k: int,
                            t_buffer: int, clip_negative: bool):
    """Round-2 work after the exchange, for every site at once: the suffix
    of :func:`_sample_and_weight` and the portions S_i u B_i, as
    :func:`_round2_portions` assembles them. Returns (points, weights)."""
    w_s, w_b = _sample_suffix(m_q, w_idx, sampled_assign, w_pb, k, t_local,
                              t_buffer, total_m, t_total)
    if clip_negative:
        w_b = torch.clamp_min(w_b, 0.0)
    return (torch.cat([sampled, centers], dim=-2),
            torch.cat([w_s, w_b], dim=-1))


def _site_valid_lengths(w_site) -> Tuple[int, ...]:
    """Per-site count covering every nonzero-weight slot (1 + its last
    index; 1 for a site with none). ``pad_partition`` packs valid slots
    first, so this is the site's size there."""
    w = (w_site.detach().cpu().numpy() if isinstance(w_site, torch.Tensor)
         else np.asarray(w_site))
    nz = (w != 0.0)[:, ::-1].argmax(axis=1)
    any_nz = (w != 0.0).any(axis=1)
    return tuple(int(w.shape[1] - z) if a else 1
                 for z, a in zip(nz, any_nz))


def staged_distributed_coreset(key, site_points, site_mask, k: int, t: int,
                               t_buffer: Optional[int] = None,
                               objective: ObjectiveLike = "kmeans",
                               lloyd_iters: int = 5,
                               clip_negative: bool = False,
                               backend: BackendLike = None,
                               site_weights=None, strategy=None,
                               tol: float = 0.0, site_buckets: bool = False,
                               min_bucket: int = 64,
                               device: DeviceLike = None
                               ) -> Tuple[DistributedCoreset, StagedDetail]:
    """:func:`distributed_coreset` with Round 1 run one site at a time: each
    site's solve is dispatched on its own (the site-batched stages with a
    leading axis of 1), its Round-1 scalar starts its copy to the host the
    moment the solve is queued (a non-blocking copy into pinned memory and
    an event, on the card), and the previous site's allocation-independent
    Round-2 draws are queued behind it; the allocation runs on the host
    copies once every scalar has arrived. What depends on the allocation --
    validity, weights, the portions -- runs after it, for every site in
    one call, with each cluster's weight total W(P_b): there the
    reductions run at the lockstep path's shapes, as torch on the card
    orders a reduction by its tensor's shape.

    Two knobs trade strictness for wall time:

    * ``tol`` -- the early exit of
      :func:`~repro_torch.core.clustering.lloyd_converged` (one host read
      per pass); ``0.0`` keeps the lockstep pass count;
    * ``site_buckets`` -- solve each site at its own power-of-two length
      (:func:`repro_torch.kernels.ops.site_bucket_lengths`) instead of the
      lockstep pad M; changes the draws (shorter sampling CDFs), so
      deterministic but not equal to lockstep.

    With both off (strict mode) every field of the returned
    :class:`DistributedCoreset` equals :func:`distributed_coreset`'s bit
    for bit, for every registered strategy: the key table, the stages and
    the weight formulas are shared. Returns ``(coreset, StagedDetail)``."""
    from repro_torch.core import strategy as strategy_mod
    from repro_torch.kernels.ops import site_bucket_lengths
    dev = backend_mod.resolve_device(device)
    t_buffer = t if t_buffer is None else t_buffer
    backend = backend_mod.resolve_name(backend, dev)
    objective = objective_mod.resolve_name(objective)
    strategy = strategy_mod.resolve_name(strategy)
    strat = strategy_mod.get_strategy(strategy)
    site_points = as_tensor(site_points, dev)
    key = as_tensor(key, dev)
    n_sites, M = site_points.shape[0], site_points.shape[1]
    w_site = (as_tensor(site_mask, dev).to(site_points.dtype)
              if site_weights is None
              else as_tensor(site_weights, dev).to(site_points.dtype))
    lengths = (site_bucket_lengths(_site_valid_lengths(w_site), M,
                                   min_bucket=min_bucket)
               if site_buckets else (M,) * n_sites)
    keys = strat.keys(key, n_sites)
    tol = float(tol)
    on_card = dev.type == "cuda"

    t0 = time.perf_counter()
    solves: list = []
    draws: list = []
    host_costs = torch.empty((n_sites,), dtype=site_points.dtype,
                             pin_memory=on_card)
    arrived = []

    def dispatch_round2(i):
        _, m_i, a_i, _, w_eff_i, _ = solves[i]
        draws.append(_staged_round2_precompute(
            keys[i:i + 1, 1], site_points[i:i + 1, :lengths[i]], m_i, a_i,
            w_eff_i, t_buffer))

    for i in range(n_sites):
        solves.append(_staged_solve_site(
            keys[i:i + 1, 0], site_points[i:i + 1, :lengths[i]],
            w_site[i:i + 1, :lengths[i]], k, objective, lloyd_iters, tol,
            backend, strategy, i, n_sites))
        # the site's Round-1 scalar starts its exchange at once ...
        host_costs[i:i + 1].copy_(solves[-1][3], non_blocking=on_card)
        if on_card:
            ev = torch.cuda.Event()
            ev.record()
            arrived.append(ev)
        # ... and the previous site's Round-2 draws queue behind its solve
        if i:
            dispatch_round2(i - 1)
    dispatch_round2(n_sites - 1)
    for ev in arrived:
        ev.synchronize()
    local_costs = torch.cat([r[3] for r in solves])
    wall_r1 = time.perf_counter() - t0

    t1 = time.perf_counter()
    # the allocator works on the scalars that reached the host (the same
    # exact float32 steps on either device: t_i as distributed_coreset's)
    t_i = strat.allocate(host_costs, t).to(dev)
    if strat.needs_exchange:
        totals = _windowed_sum(local_costs).expand(n_sites)
    else:
        totals = strat.local_totals(local_costs)
    if len(set(lengths)) == 1:
        w_pb = _cluster_weights(torch.cat([r[2] for r in solves]),
                                torch.cat([r[4] for r in solves]), k)
    else:   # site buckets: each site at its own length
        w_pb = torch.cat([_cluster_weights(r[2], r[4], k) for r in solves])
    sampled, m_q, w_idx, sampled_assign = (torch.cat(x)
                                           for x in zip(*draws))
    points, weights = _staged_round2_finalize(
        sampled, m_q, w_idx, sampled_assign, w_pb,
        torch.cat([r[0] for r in solves]), t_i, totals,
        strat.sample_t_total(t, t_i), k, t_buffer, clip_negative)
    if on_card:
        torch.cuda.synchronize(dev)
    wall_r2 = time.perf_counter() - t1

    iters_run = torch.cat([r[5] for r in solves])
    detail = StagedDetail(
        site_lengths=tuple(lengths), iters_run=iters_run,
        wall_round1_s=wall_r1, wall_round2_s=wall_r2,
        wall_total_s=wall_r1 + wall_r2,
        host_reads=int(iters_run.sum()) if tol > 0.0 else 0)
    return (DistributedCoreset(points=points, weights=weights, t_i=t_i,
                               local_costs=local_costs), detail)


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


def _round2_portions(keys, site_points, m, w_eff, assign, centers, t_i,
                     total_m, t_total, k: int, t_buffer: int,
                     clip_negative: bool) -> Coreset:
    """Every site draws its ``t_i`` samples and assembles its portion
    S_i u B_i (a site-batched :class:`Coreset`); the sample weights divide
    by ``total_m`` and ``t_total``, per site (n,)."""
    sampled, w_s, w_b = _sample_and_weight(keys, site_points, m, w_eff,
                                           assign, k, t_i, t_buffer, total_m,
                                           t_total)
    if clip_negative:
        w_b = torch.clamp_min(w_b, 0.0)
    return Coreset.concat(Coreset(sampled, w_s), Coreset(centers, w_b))


def round2_local_samples(keys, site_points, m, w_eff, assign, centers, t_i,
                         total_m, k: int, t: int, t_buffer: int,
                         clip_negative: bool) -> Coreset:
    """Algorithm 1 Round 2, the purely local stage: every site draws its
    ``t_i`` samples and assembles its portion S_i u B_i. ``total_m`` is the
    global sensitivity total each site received, per site (n,); the sample
    weights divide by Algorithm 1's ``sample_t_total`` (the global t)."""
    from repro_torch.core.strategy import ALGORITHM1
    return _round2_portions(keys, site_points, m, w_eff, assign, centers,
                            t_i, total_m, ALGORITHM1.sample_t_total(t, t_i),
                            k, t_buffer, clip_negative)


def round2_local_samples_localized(keys, site_points, m, w_eff, assign,
                                   centers, t_i, total_m, k: int,
                                   t_buffer: int,
                                   clip_negative: bool) -> Coreset:
    """Round 2 with per-site normalization (the mapreduce strategy's local
    stage): each site's weight formula uses its own sensitivity total
    (``total_m`` holds each site's own scalar) and mapreduce's
    ``sample_t_total`` (its own draw count ``t_i``), so each portion is a
    standalone coreset of its site's data."""
    from repro_torch.core.strategy import MAPREDUCE
    return _round2_portions(keys, site_points, m, w_eff, assign, centers,
                            t_i, total_m, MAPREDUCE.sample_t_total(None, t_i),
                            k, t_buffer, clip_negative)
