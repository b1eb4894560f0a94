"""Streaming coreset subsystem (the port of ``repro.stream``; DESIGN.md
Sec. 9).

* :mod:`repro_torch.stream.tree` -- the merge-and-reduce coreset tree
  (:class:`CoresetTree`): an any-time, bounded-memory coreset of an
  unbounded stream in O(log n) fixed-size buckets on the device.
* :mod:`repro_torch.stream.ingest` -- the ingestion state
  (:class:`StreamState`) and the distributed mode
  (:class:`DistributedStream`): one tree per topology node and periodic
  Algorithm-1 aggregation rounds, each a ``CommLedger`` phase.
* :mod:`repro_torch.stream.service` -- :class:`ClusterQueryService`: live
  centres with a staleness-bounded refresh, batched nearest-centre
  queries through the serving engine's fused dispatches.
"""

from repro_torch.stream.ingest import (AggregateResult, DistributedStream,
                                       StreamState)
from repro_torch.stream.service import ClusterQueryService, ServiceStats
from repro_torch.stream.tree import CoresetTree, TreeConfig

__all__ = [
    "AggregateResult", "DistributedStream", "StreamState",
    "ClusterQueryService", "ServiceStats", "CoresetTree", "TreeConfig",
]
