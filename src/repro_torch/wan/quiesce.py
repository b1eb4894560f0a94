"""Quiescence certification for the WAN runtime (the port of
``repro.wan.quiesce``; DESIGN.md Sec. 14).

Three properties, each checked by *running* the runtime, never by
trusting the formulas that motivated it:

1. **Completion within the surviving diameter** -- flooding unique
   payloads under the fault plan, every surviving node learns every
   surviving origin no later than round ``H + P * D'`` (churn horizon
   ``H``, surviving-subgraph diameter ``D'``, max edge period ``P``; ``P
   = 1`` for mode ``"full"``), and the flood *quiesces*: the outstanding
   send-once obligations hit zero, after which the measured traffic is
   zero forever. Why the bound holds: from round ``H`` every surviving
   node is permanently up, so any payload held by some survivor crosses
   each remaining hop of the surviving subgraph within one activation
   period -- after ``H`` the schedule degenerates to a (period-dilated)
   synchronous flood on the surviving subgraph. Mode ``"random"`` has no
   deterministic bound and is certified for quiescence only.

2. **Duplicate idempotence** -- re-running the identical plan with a
   positive ``dup_rate`` must deliver strictly more messages yet leave
   every relay table bit-unchanged (relay state is overwrite/max, never
   sum).

3. **Engine-vs-oracle bit-identity** --
   ``graph_distributed_kmeans(engine="exec", faults=plan)`` must return
   centers (and the assembled coreset) bit-identical to the host sim
   oracle restricted to the surviving sites.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core.backend import DeviceLike
from repro_torch.core.topology import Graph, diameter
from repro_torch.wan.faults import FaultPlan
from repro_torch.wan.runtime import wan_flood_exec
from repro_torch.wan.schedules import wan_schedule

_DUP_PROBE = 0.35


@dataclasses.dataclass
class QuiescenceCertificate:
    """Evidence record of one certification run. ``ok`` only if every
    checked property held; ``centers_match`` is None when the clustering
    check was skipped (``check_clustering=False``)."""

    mode: str
    horizon: int
    surviving_diameter: int
    max_period: int
    rounds_to_complete: int
    rounds_to_quiesce: int
    bound: Optional[int]          # None for mode="random" (no determinism)
    completed_within_bound: bool
    quiesced: bool
    duplicates_idempotent: bool
    duplicate_messages_extra: float
    centers_match: Optional[bool]
    staleness_mean: float

    @property
    def ok(self) -> bool:
        return (self.completed_within_bound and self.quiesced
                and self.duplicates_idempotent
                and self.centers_match is not False)


def certify_quiescence(g: Graph, plan: FaultPlan, mode: str = "full",
                       seed: int = 0, p: float = 0.5,
                       check_clustering: bool = False,
                       key=None, site_points=None, site_mask=None,
                       k: int = 3, t: int = 24,
                       backend: Optional[str] = None,
                       device: DeviceLike = None
                       ) -> QuiescenceCertificate:
    """Certify the three WAN-runtime properties for one (graph, plan).

    Raises ``ValueError`` (via the runtime) if the plan disconnects the
    surviving subgraph -- a partitioned deployment has no quiescence
    bound, and the checker refuses to pretend otherwise. With
    ``check_clustering=True`` (needs ``key``/``site_points``/
    ``site_mask``) it additionally runs property 3 end to end, with the
    local solves dispatched through ``backend`` on both sides. The floods
    and the clustering run on ``device`` (CUDA unless the caller asks for
    the CPU)."""
    dev = backend_mod.resolve_device(device)
    sub, _ = plan.surviving_graph(g)
    d_surv = diameter(sub)
    h = plan.horizon()
    ws = wan_schedule(g)
    period = ws.max_period if mode == "clock" else 1

    # distinct per-origin scalars so any mis-relay shows up as a bit diff
    payload = (torch.arange(g.n, dtype=torch.float32, device=dev)[:, None]
               * 1000.0 + 7.0)
    base_plan = dataclasses.replace(plan, dup_rate=0.0)
    table, res = wan_flood_exec(g, payload, mode=mode, faults=base_plan,
                                unit_scalars=1.0, seed=seed, p=p)

    bound = None if mode == "random" else h + period * d_surv
    within = True if bound is None else res.rounds_to_complete <= bound
    quiesced = res.rounds_to_quiesce <= res.rounds

    # duplicates: same masks + forced dup draws; tables must not move
    dup_plan = dataclasses.replace(plan, dup_rate=max(plan.dup_rate,
                                                      _DUP_PROBE))
    dtable, dres = wan_flood_exec(g, payload, mode=mode, faults=dup_plan,
                                  unit_scalars=1.0, seed=seed, p=p)
    surv = plan.surviving_nodes(g.n)
    same = bool(np.array_equal(table.cpu().numpy()[surv][:, surv],
                               dtable.cpu().numpy()[surv][:, surv]))
    extra = float(dres.ledger.messages - res.ledger.messages)
    idempotent = same and (extra >= 0.0)

    centers_match: Optional[bool] = None
    if check_clustering:
        from repro_torch.core import prng
        from repro_torch.core.backend import as_tensor
        from repro_torch.core.coreset import Coreset
        from repro_torch.core.distributed import (_solve_on_coreset,
                                                  graph_distributed_kmeans)
        from repro_torch.wan.runtime import restricted_sim_coreset

        backend = backend_mod.resolve_name(backend, dev)
        key = as_tensor(key, dev)
        result = graph_distributed_kmeans(
            key, site_points, site_mask, k, t, g, engine="exec",
            faults=plan, wan_mode=mode, wan_seed=seed, wan_p=p,
            backend=backend, device=dev)
        k1, k2 = prng.split(key)
        pts, w, _, _ = restricted_sim_coreset(
            k1, site_points, site_mask, k, t, t_buffer=t,
            objective="kmeans", lloyd_iters=8, clip_negative=False,
            backend=backend, surviving=surv, device=dev)
        oracle_centers = _solve_on_coreset(k2, Coreset(pts, w), k,
                                           "kmeans", 8, backend)
        centers_match = (
            torch.equal(result.coreset.points, pts)
            and torch.equal(result.coreset.weights, w)
            and torch.equal(result.centers, oracle_centers))

    return QuiescenceCertificate(
        mode=mode, horizon=h, surviving_diameter=d_surv, max_period=period,
        rounds_to_complete=res.rounds_to_complete,
        rounds_to_quiesce=res.rounds_to_quiesce, bound=bound,
        completed_within_bound=within, quiesced=quiesced,
        duplicates_idempotent=idempotent, duplicate_messages_extra=extra,
        centers_match=centers_match,
        staleness_mean=res.ledger.staleness)
