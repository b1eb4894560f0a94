"""Serving layer of the port: the LM slot engine (``engine``) and the
multi-tenant cluster-query engine (``cluster``, DESIGN.md Sec. 13)."""

from repro_torch.serve.cluster import (ClusterServeEngine, EngineStats,
                                       QueryTicket, StaticCenters)
from repro_torch.serve.engine import (Engine, Request, generate,
                                      make_serve_steps)

__all__ = [
    "ClusterServeEngine", "EngineStats", "QueryTicket", "StaticCenters",
    "Engine", "Request", "generate", "make_serve_steps",
]
