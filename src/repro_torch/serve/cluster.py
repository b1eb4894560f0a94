"""Multi-tenant cluster-query serving engine (the port of
``repro.serve.cluster``; DESIGN.md Sec. 13).

A small coreset summary stands in for the full data, so a serving tier pays
for nearest-centre *queries*, not solves. :class:`ClusterServeEngine`
serves many (stream, k, model) tenants by fusing their query traffic into
single device dispatches of
:func:`repro_torch.core.backend.query_assignments_batched` (one launch of
the batched ``distance_argmin`` entry on the card):

* **admission queue + continuous batching**: ``enqueue(tenant, points)`` is
  non-blocking and returns a :class:`QueryTicket`; each ``step()`` drains
  the queue, splits batches above ``max_bucket`` into chunks, and groups
  chunks by ``(d, k_bucket, padded size, objective)``, so ragged traffic
  assembles into stacked batches over a bounded set of dispatched shapes
  (``compiled_shapes`` records the set, ``dispatches_by_shape`` the
  dispatches of each);
* **stacked-centre dispatch**: each group stacks up to ``max_group``
  tenants' centres into one ``(T, k_bucket, d)`` buffer with a live-row
  mask (the tenant axis padded to a power of two) and makes ONE dispatch
  for all of them;
* **per-tenant staleness**: the engine runs at most ``refresh_budget``
  centre re-solves per step, never-solved tenants first, then the most
  stale; a deferred stale tenant serves its cached centres, and only a
  tenant that has never solved holds its queries to a later step.

A centre source is any object with ``cached_centers() -> (k, d) | None``,
``is_stale() -> bool`` and ``refresh() -> (k, d)`` (optionally
``staleness() -> float`` for the order); :class:`StaticCenters` adapts a
fixed centre set.

Queries are staged on the host; each dispatch sends its stacked query
buffer to the device once, and the stacked centres once per change of the
group's composition. Tickets hold numpy results, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import objective as objective_mod
from repro_torch.core.backend import DeviceLike
from repro_torch.kernels.ops import query_bucket


def _host(x) -> np.ndarray:
    """A (k, d) centre set (tensor on any device, or array) as host f32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


class StaticCenters:
    """Minimal centre source: a fixed centre set, never stale."""

    def __init__(self, centers):
        self._centers = _host(centers)

    def cached_centers(self) -> np.ndarray:
        return self._centers

    def is_stale(self) -> bool:
        return False

    def refresh(self) -> np.ndarray:
        return self._centers


@dataclasses.dataclass(slots=True)
class QueryTicket:
    """Handle of one enqueued query batch. ``assign`` / ``dist`` fill in as
    the engine's steps serve the batch's chunks (``None`` until the first
    chunk lands; a ticket served whole by one dispatch gets views of the
    dispatch's result); ``done`` flips once every row is written.
    ``n_padded`` counts the padding rows shipped on its behalf."""

    tenant_id: int
    n: int
    assign: np.ndarray = dataclasses.field(default=None, repr=False)
    dist: np.ndarray = dataclasses.field(default=None, repr=False)
    n_padded: int = 0
    _left: int = 0

    @property
    def done(self) -> bool:
        return self._left == 0


@dataclasses.dataclass
class EngineStats:
    """Engine-level serving counters."""

    n_queries: int = 0          # real query rows served
    n_padded: int = 0           # padding rows shipped to fill buckets
    n_tickets: int = 0
    n_steps: int = 0
    n_dispatches: int = 0       # fused device dispatches issued
    n_tenant_dispatches: int = 0  # tenant-chunks served (serial equivalent)
    n_refreshes: int = 0        # centre re-solves run by the step loop
    n_deferred_refreshes: int = 0  # stale tenants served cached centres
    refresh_s: float = 0.0
    assign_s: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


class _Tenant:
    """Per-tenant record: source, pending work and the host-staged padded
    centres (re-staged when the source's cached object changes)."""

    __slots__ = ("tid", "k", "d", "objective", "source", "pending",
                 "k_bucket", "stage_epoch", "_staged_from", "_centers_np")

    def __init__(self, tid: int, k: int, d: int, objective: str, source):
        self.tid = tid
        self.k = int(k)
        self.d = int(d)
        self.objective = objective
        self.source = source
        self.pending: List[Tuple[QueryTicket, np.ndarray]] = []
        self.k_bucket = max(8, 1 << (self.k - 1).bit_length())
        self.stage_epoch = 0      # bumps on every re-stage (cache key)
        self._staged_from = None
        self._centers_np: Optional[np.ndarray] = None

    def staged_centers(self) -> Optional[np.ndarray]:
        """Host-staged ``(k_bucket, d)`` centres (rows >= k are dead and
        masked at dispatch); ``None`` until the source first solves."""
        cur = self.source.cached_centers()
        if cur is None:
            return None
        if cur is not self._staged_from:
            c = np.zeros((self.k_bucket, self.d), np.float32)
            c[:self.k] = _host(cur)
            self._staged_from = cur
            self._centers_np = c
            self.stage_epoch += 1
        return self._centers_np


class ClusterServeEngine:
    """Continuous-batching serving engine over stacked-centre dispatches.

    ``max_bucket`` caps the padded query rows per chunk (larger enqueues
    split), ``max_group`` caps tenants per dispatch, ``refresh_budget``
    caps centre re-solves per step (``None`` = unbounded). The tenant axis
    of a dispatch is padded to a power of two, so the set of dispatched
    shapes stays within O(log max_group * log max_bucket * #(k_bucket, d))
    under any traffic. Runs on ``device`` (CUDA unless the caller asks for
    the CPU)."""

    def __init__(self, backend: backend_mod.BackendLike = None,
                 min_bucket: int = 8, max_bucket: int = 1024,
                 max_group: int = 256,
                 refresh_budget: Optional[int] = None,
                 device: DeviceLike = None):
        if max_bucket < min_bucket:
            raise ValueError(f"max_bucket {max_bucket} < min_bucket "
                             f"{min_bucket}")
        self.device = backend_mod.resolve_device(device)
        self.backend = backend_mod.resolve_name(backend, self.device)
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        self.max_group = int(max_group)
        self.refresh_budget = refresh_budget
        self.stats = EngineStats()
        self.compiled_shapes: set = set()   # (T_pad, bucket, k_pad, d, obj)
        # dispatches issued per shape of compiled_shapes
        self.dispatches_by_shape: Dict[tuple, int] = {}
        self._tenants: Dict[int, _Tenant] = {}
        self._next_tid = 0
        # steady traffic re-assembles the same tenant composition every
        # step: the stacked (centres, mask) device buffers are cached per
        # composition, invalidated by the tenants' stage epochs
        self._center_cache: Dict[tuple, tuple] = {}

    # -- tenant admission ----------------------------------------------------

    def add_tenant(self, source, k: int, d: int,
                   objective: objective_mod.ObjectiveLike = "kmeans",
                   tenant_id: Optional[int] = None) -> int:
        """Register a centre source serving ``k`` centres in R^``d``.
        ``objective`` is any registered objective (unknown names raise
        here, before any traffic); its canonical name rides in the grouping
        key and picks the query-distance metric. Returns the tenant id
        (auto-assigned when not given)."""
        objective = objective_mod.resolve_name(objective)
        if tenant_id is None:
            while self._next_tid in self._tenants:
                self._next_tid += 1
            tenant_id = self._next_tid
        tenant_id = int(tenant_id)
        if tenant_id in self._tenants:
            raise ValueError(f"tenant {tenant_id} already registered")
        if k < 1 or d < 1:
            raise ValueError(f"need k >= 1 and d >= 1, got k={k} d={d}")
        for attr in ("cached_centers", "is_stale", "refresh"):
            if not callable(getattr(source, attr, None)):
                raise TypeError(f"center source must provide {attr}()")
        self._tenants[tenant_id] = _Tenant(tenant_id, k, d, objective,
                                           source)
        return tenant_id

    def tenant_ids(self) -> Tuple[int, ...]:
        return tuple(self._tenants)

    # -- admission queue -----------------------------------------------------

    def enqueue(self, tenant_id: int, points) -> QueryTicket:
        """Queue a ``(n, d)`` query batch for a tenant (non-blocking). The
        ticket fills in as later :meth:`step` calls serve it; an empty
        batch completes at once."""
        t = self._tenants.get(int(tenant_id))
        if t is None:
            raise KeyError(f"unknown tenant {tenant_id}")
        q = _host(points)
        if q.ndim != 2 or q.shape[1] != t.d:
            raise ValueError(f"expected (n, {t.d}) query points for tenant "
                             f"{tenant_id}, got shape {q.shape}")
        n = q.shape[0]
        ticket = QueryTicket(tenant_id=t.tid, n=n, _left=n)
        self.stats.n_tickets += 1
        if n > 0:
            t.pending.append((ticket, q))
        else:
            ticket.assign = np.zeros((0,), np.int32)
            ticket.dist = np.zeros((0,), np.float32)
        return ticket

    # -- step loop -----------------------------------------------------------

    def _refresh_phase(self, budget: Optional[int]) -> None:
        """Budgeted centre refresh across tenants with queued work:
        never-solved tenants first (they cannot serve at all), then
        most-stale-first. Deferred tenants keep serving cached centres."""
        need = []
        for t in self._tenants.values():
            if not t.pending:
                continue
            uninit = t.source.cached_centers() is None
            if uninit or t.source.is_stale():
                stale_fn = getattr(t.source, "staleness", None)
                s = float(stale_fn()) if callable(stale_fn) else 0.0
                need.append((not uninit, -s, t))
        if not need:
            return
        need.sort(key=lambda x: x[:2])
        t0 = time.perf_counter()
        n = len(need) if budget is None else min(budget, len(need))
        for _, _, t in need[:n]:
            t.source.refresh()
            self.stats.n_refreshes += 1
        self.stats.n_deferred_refreshes += len(need) - n
        self.stats.refresh_s += time.perf_counter() - t0

    def step(self, refresh_budget: Optional[int] = -1) -> int:
        """One serving step: the budgeted refresh phase, then one dispatch
        per assembled group for everything serveable in the queue. Returns
        the query rows served; an empty queue is a no-op (no refresh, no
        dispatch)."""
        if not any(t.pending for t in self._tenants.values()):
            return 0
        self.stats.n_steps += 1
        self._refresh_phase(self.refresh_budget if refresh_budget == -1
                            else refresh_budget)

        # tenant-chunks grouped by (d, k_bucket, bucket, objective); a
        # tenant whose source has never solved stays queued
        groups: Dict[tuple, list] = {}
        for t in self._tenants.values():
            if not t.pending or t.staged_centers() is None:
                continue
            work, t.pending = t.pending, []
            for ticket, q in work:
                for off in range(0, q.shape[0], self.max_bucket):
                    part = q[off:off + self.max_bucket]
                    b = query_bucket(part.shape[0], self.min_bucket,
                                     self.max_bucket)
                    key = (t.d, t.k_bucket, b, t.objective)
                    groups.setdefault(key, []).append((t, ticket, off, part))

        served = 0
        t0 = time.perf_counter()
        for (d, kb, b, objective), items in sorted(
                groups.items(), key=lambda kv: kv[0][:3]):
            for s0 in range(0, len(items), self.max_group):
                served += self._dispatch(items[s0:s0 + self.max_group],
                                         d, kb, b, objective)
        self.stats.assign_s += time.perf_counter() - t0
        return served

    def _staged_group_centers(self, items: list, Tp: int, kb: int, d: int):
        """Stacked ``(Tp, kb, d)`` centres and live mask of one dispatch
        group on the device, cached per tenant composition: re-stacked and
        re-sent only when a tenant's centres change (its ``stage_epoch``
        bumps)."""
        sig = tuple((t.tid, t.stage_epoch) for t, _, _, _ in items)
        cached = self._center_cache.get((Tp, kb, d))
        if cached is not None and cached[0] == sig:
            return cached[1], cached[2]
        c = np.zeros((Tp, kb, d), np.float32)
        mask = np.zeros((Tp, kb), bool)
        for i, (t, _, _, _) in enumerate(items):
            c[i] = t.staged_centers()
            mask[i, :t.k] = True
        cd = torch.from_numpy(c).to(self.device)
        md = torch.from_numpy(mask).to(self.device)
        self._center_cache[(Tp, kb, d)] = (sig, cd, md)
        return cd, md

    def _dispatch(self, items: list, d: int, kb: int, b: int,
                  objective: str) -> int:
        """One fused stacked-centre dispatch for up to ``max_group``
        same-group tenant-chunks; scatter the results into the tickets."""
        T = len(items)
        Tp = 1 << (T - 1).bit_length()
        if T == Tp and all(p.shape[0] == b for _, _, _, p in items):
            # full buckets: one stack, no padding rows
            q = np.stack([p for _, _, _, p in items])
        else:
            q = np.zeros((Tp, b, d), np.float32)
            for i, (_, _, _, part) in enumerate(items):
                q[i, :part.shape[0]] = part
        # padding tenants keep an all-False mask: every centre row becomes
        # the sentinel, the reduction stays finite, results are dropped
        cd, md = self._staged_group_centers(items, Tp, kb, d)
        assign, dist = backend_mod.query_assignments_batched(
            torch.from_numpy(q).to(self.device), cd, md,
            objective=objective, backend=self.backend, device=self.device)
        assign = assign.cpu().numpy()
        dist = dist.cpu().numpy()
        self.stats.n_dispatches += 1
        self.stats.n_tenant_dispatches += T
        shape = (Tp, b, kb, d, objective)
        self.compiled_shapes.add(shape)
        self.dispatches_by_shape[shape] = (
            self.dispatches_by_shape.get(shape, 0) + 1)
        served = 0
        for i, (_, ticket, off, part) in enumerate(items):
            n = part.shape[0]
            if off == 0 and n == ticket.n:
                # served whole by this dispatch: views, no copy
                ticket.assign = assign[i, :n]
                ticket.dist = dist[i, :n]
            else:
                if ticket.assign is None:
                    ticket.assign = np.empty((ticket.n,), np.int32)
                    ticket.dist = np.empty((ticket.n,), np.float32)
                ticket.assign[off:off + n] = assign[i, :n]
                ticket.dist[off:off + n] = dist[i, :n]
            ticket.n_padded += b - n
            ticket._left -= n
            served += n
        self.stats.n_queries += served
        self.stats.n_padded += Tp * b - served
        return served

    def run(self, max_steps: int = 10_000) -> int:
        """Step until the queue drains; returns rows served. Raises if the
        queue cannot make progress within ``max_steps`` (e.g. a refresh
        budget of 0 against a never-solved tenant)."""
        total = 0
        for _ in range(max_steps):
            if not any(t.pending for t in self._tenants.values()):
                return total
            r0 = self.stats.n_refreshes
            s = self.step()
            total += s
            if s == 0 and self.stats.n_refreshes == r0:
                raise RuntimeError(
                    "serve queue cannot make progress (refresh budget 0 "
                    "against a never-solved tenant?)")
        raise RuntimeError(f"serve queue failed to drain in {max_steps} "
                           f"steps")
