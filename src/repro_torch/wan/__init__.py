"""Asynchronous, failure-prone WAN execution runtime (the port of
``repro.wan``; DESIGN.md Sec. 14).

Layers an asynchronous message-passing runtime over the synchronous
topology execution engine of :mod:`repro_torch.core.message_passing`:

* :mod:`repro_torch.wan.faults` -- :class:`FaultPlan`, the deterministic,
  seed-replayable fault model (dropped links, duplicated deliveries, node
  churn with rejoin) and its surviving-graph algebra.
* :mod:`repro_torch.wan.schedules` -- per-round activation masks:
  randomized gossip (seeded random edge subsets) and per-edge clocks
  (heterogeneous periods derived from ``edge_costs``), composed with the
  fault masks. Everything is precomputed on the host into dense boolean
  arrays; the round loop never mutates Python state.
* :mod:`repro_torch.wan.runtime` -- the send-once relay rounds on the
  payload's device (:func:`wan_flood_exec`), the measured per-round
  ledgers with the ``staleness`` axis, and the faulty Algorithm-1 rounds
  (:func:`async_algorithm1_rounds`) plus the restricted sim oracle.
* :mod:`repro_torch.wan.quiesce` -- quiescence certification: flooding
  completes within the surviving subgraph's diameter after the churn
  horizon, duplicated deliveries leave relay tables bit-unchanged, and
  executed centers under faults equal the oracle's bit-for-bit.
"""
from repro_torch.wan.faults import FaultPlan, random_fault_plan
from repro_torch.wan.runtime import (WanExecResult, async_algorithm1_rounds,
                                     restricted_sim_coreset, wan_flood_exec)
from repro_torch.wan.quiesce import QuiescenceCertificate, certify_quiescence

__all__ = [
    "FaultPlan", "random_fault_plan", "WanExecResult", "wan_flood_exec",
    "async_algorithm1_rounds", "restricted_sim_coreset",
    "QuiescenceCertificate", "certify_quiescence",
]
