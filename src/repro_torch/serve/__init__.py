"""Serving layer of the port: the multi-tenant cluster-query engine
(``cluster``, DESIGN.md Sec. 13)."""

from repro_torch.serve.cluster import (ClusterServeEngine, EngineStats,
                                       QueryTicket, StaticCenters)

__all__ = ["ClusterServeEngine", "EngineStats", "QueryTicket",
           "StaticCenters"]
