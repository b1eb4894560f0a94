"""Cluster-query service over a live stream summary (the port of
``repro.stream.service``).

:class:`ClusterQueryService` owns a :class:`~repro_torch.stream.ingest.
StreamState` (or any object with its ``push`` / ``summary`` /
``total_weight`` / ``config`` surface) and answers batched nearest-centre
queries against centres solved from the current summary:

* **queries** go through the multi-tenant engine
  (:class:`repro_torch.serve.cluster.ClusterServeEngine`): the service
  registers itself as a centre source on a private single-tenant engine
  (or a shared one passed as ``engine``), and each ``query()`` is an
  enqueue plus steps -- fused dispatches of the batched
  ``distance_argmin`` kernel on the card, in power-of-two buckets capped
  at ``max_bucket`` (larger batches are chunked);
* **freshness** is staleness-bounded: the service re-solves its centres
  from the summary when the mass pushed since the last solve exceeds
  ``staleness_frac`` of the total (or ``max_stale_points``), checked
  lazily at each query; between solves queries use the cached centres.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import clustering
from repro_torch.core import prng
from repro_torch.core.backend import DeviceLike, as_tensor
from repro_torch.kernels.ops import chunk_queries
from repro_torch.stream.ingest import StreamState

# each service built without an explicit key or tenant id folds a fresh
# instance id into its seed, so two services never replay the same
# restart draws
_INSTANCE_IDS = itertools.count()


@dataclasses.dataclass
class ServiceStats:
    """Serving counters. ``n_padded_queries`` counts the padding rows
    shipped to fill buckets; ``refresh_s`` / ``assign_s`` add up the wall
    seconds of centre solves and of query assignment."""

    n_queries: int = 0
    n_batches: int = 0
    n_refreshes: int = 0
    n_padded_queries: int = 0
    refresh_s: float = 0.0
    assign_s: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        total = self.n_queries + self.n_padded_queries
        d["padded_frac"] = self.n_padded_queries / total if total else 0.0
        return d


class ClusterQueryService:
    """Live centres and batched nearest-centre queries with bounded
    staleness. ``staleness_frac=0.0`` re-solves after every ingest;
    ``None`` turns the fractional trigger off (``max_stale_points`` only).

    It is also a centre source for a
    :class:`~repro_torch.serve.cluster.ClusterServeEngine`
    (``cached_centers`` / ``is_stale`` / ``staleness`` / ``refresh``).
    Runs on ``device`` (default: the stream's device)."""

    def __init__(self, stream: StreamState, k: int,
                 staleness_frac: Optional[float] = 0.1,
                 max_stale_points: Optional[float] = None,
                 lloyd_iters: int = 8,
                 restarts: int = 2,
                 backend: backend_mod.BackendLike = None,
                 key=None,
                 tenant_id: Optional[int] = None,
                 max_bucket: int = 4096,
                 engine=None,
                 device: DeviceLike = None):
        self.stream = stream
        self.device = (backend_mod.resolve_device(device) if device
                       is not None or not hasattr(stream, "device")
                       else stream.device)
        self.k = k
        self.staleness_frac = staleness_frac
        self.max_stale_points = max_stale_points
        self.lloyd_iters = lloyd_iters
        self.restarts = restarts
        self.backend = backend_mod.resolve_name(
            backend if backend is not None
            else getattr(stream.config, "backend", None), self.device)
        self.tenant_id = (next(_INSTANCE_IDS) if tenant_id is None
                          else int(tenant_id))
        # fold the tenant id into the default seed: a bare PRNGKey(0)
        # would make every service replay the same restart seeds
        self._key = (prng.fold_in(prng.PRNGKey(0, device=self.device),
                                  self.tenant_id)
                     if key is None else as_tensor(key, self.device))
        self.max_bucket = int(max_bucket)
        self._centers: Optional[torch.Tensor] = None
        self._weight_at_refresh = 0.0
        self.stats = ServiceStats()
        self._engine = engine
        self._engine_tid: Optional[int] = None

    # -- freshness policy ----------------------------------------------------

    def staleness(self) -> float:
        """Mass ingested since the centres were last solved."""
        return self.stream.total_weight() - self._weight_at_refresh

    def is_stale(self) -> bool:
        if self._centers is None:
            return True
        s = self.staleness()
        total = self.stream.total_weight()
        if self.max_stale_points is not None and s > self.max_stale_points:
            return True
        return (self.staleness_frac is not None
                and s > self.staleness_frac * max(total, 1.0))

    # centre-source surface for ClusterServeEngine
    _stale = is_stale

    def cached_centers(self) -> Optional[torch.Tensor]:
        """The cached serving centres (``None`` before the first solve);
        never triggers a refresh."""
        return self._centers

    def refresh(self) -> torch.Tensor:
        """Re-solve the centres from the current summary, on the
        non-negative part of its signed measure."""
        t0 = time.perf_counter()
        objective = self.stream.config.objective
        cs = self.stream.summary()
        w_solve = torch.clamp_min(cs.weights, 0.0)
        self._key, k1 = prng.split(self._key)
        centers, _ = clustering.solve(k1, cs.points, self.k,
                                      weights=w_solve,
                                      lloyd_iters=self.lloyd_iters,
                                      objective=objective,
                                      restarts=self.restarts,
                                      backend=self.backend,
                                      device=self.device)
        if centers.is_cuda:
            torch.cuda.synchronize(centers.device)
        self._centers = centers
        self._weight_at_refresh = self.stream.total_weight()
        self.stats.n_refreshes += 1
        self.stats.refresh_s += time.perf_counter() - t0
        return centers

    def centers(self) -> torch.Tensor:
        """The serving centres, refreshed first if stale."""
        if self.is_stale():
            self.refresh()
        return self._centers

    # -- ingestion + queries -------------------------------------------------

    def push(self, batch) -> None:
        """Ingest through the service (keeps the staleness clock honest)."""
        self.stream.push(batch)

    def _as_batch(self, points) -> np.ndarray:
        """Query input as a host (n, d) float32 array, n >= 0: a single
        d-vector is one row, an empty input (``[]`` or ``(0, d)``) the
        (0, d) batch; any other width raises. The engine stages queries on
        the host, so a device tensor is copied back once here."""
        d = self.stream.config.d
        if isinstance(points, torch.Tensor):
            points = points.detach().cpu().numpy()
        q = np.asarray(points, np.float32)
        if q.ndim <= 1 and q.size == 0:
            return np.zeros((0, d), np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != d:
            raise ValueError(f"expected (n, {d}) query points, got shape "
                             f"{tuple(q.shape)}")
        return q

    def _serve_engine(self):
        """The engine this service serves through: a private single-tenant
        :class:`ClusterServeEngine` unless one was given, with this service
        registered as its centre source."""
        if self._engine is None:
            from repro_torch.serve.cluster import ClusterServeEngine

            self._engine = ClusterServeEngine(backend=self.backend,
                                              max_bucket=self.max_bucket,
                                              device=self.device)
        if self._engine_tid is None:
            self._engine_tid = self._engine.add_tenant(
                self, k=self.k, d=self.stream.config.d,
                objective=self.stream.config.objective,
                tenant_id=self.tenant_id
                if self.tenant_id not in self._engine.tenant_ids() else None)
        return self._engine

    def query(self, points) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched nearest-centre query: (n, d) -> (assign (n,) int32, dist
        (n,) f32 in the objective's metric: squared for z = 2, euclidean
        for z = 1), on the service's device. An empty batch returns empty
        tensors and solves nothing. Served by the engine: enqueue, then
        step until the ticket completes."""
        q = self._as_batch(points)
        if q.shape[0] == 0:
            return (torch.zeros((0,), dtype=torch.int32, device=self.device),
                    torch.zeros((0,), dtype=torch.float32,
                                device=self.device))
        eng = self._serve_engine()
        ticket = eng.enqueue(self._engine_tid, q)
        r0 = self.stats.refresh_s
        t0 = time.perf_counter()
        while not ticket.done:
            eng.step()
        # engine-run refreshes book their own time in refresh()
        self.stats.assign_s += (time.perf_counter() - t0) \
            - (self.stats.refresh_s - r0)
        self.stats.n_queries += ticket.n
        self.stats.n_batches += 1
        self.stats.n_padded_queries += ticket.n_padded
        return (as_tensor(ticket.assign, self.device),
                as_tensor(ticket.dist, self.device))

    def query_load(self, points, weights=None) -> torch.Tensor:
        """Per-centre (optionally weighted) query-load histogram (k,) of one
        batch: the counts of fused ``lloyd_stats`` passes over the batch's
        buckets (chunked at ``max_bucket``; weight-0 padding keeps counts
        exact). An empty batch is an all-zero histogram."""
        q = self._as_batch(points)
        if q.shape[0] == 0:
            return torch.zeros((self.k,), dtype=torch.float32,
                               device=self.device)
        q = as_tensor(q, self.device)
        w = (q.new_ones((q.shape[0],)) if weights is None
             else as_tensor(weights, self.device).to(torch.float32))
        centers = self.centers()
        be = backend_mod.get_backend(self.backend, self.device)
        total = torch.zeros((self.k,), dtype=torch.float32,
                            device=self.device)
        for qp, n, off in chunk_queries(q, max_bucket=self.max_bucket):
            wp = q.new_zeros((qp.shape[0],))
            wp[:n] = w[off:off + n]
            _, counts, _ = be.lloyd_stats(qp, centers, wp)
            total = total + counts
        return total
