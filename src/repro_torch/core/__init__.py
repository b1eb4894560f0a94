"""The paper's contribution, ported: distributed coreset construction and
clustering on general topologies (Algorithms 1 and 2)."""

from repro_torch.core import (backend, clustering, comm, coreset,
                              distributed, objective, partition, prng,
                              strategy, topology)
from repro_torch.core.backend import (ClusteringBackend, available_backends,
                                      get_backend, query_assignments,
                                      query_assignments_batched,
                                      register_backend, use_backend)
from repro_torch.core.clustering import (cost, kmeans_pp_init, lloyd,
                                         lloyd_stats, min_dist_argmin, solve)
from repro_torch.core.comm import CommLedger
from repro_torch.core.coreset import (Coreset, DistributedCoreset,
                                      build_coreset, distributed_coreset)
from repro_torch.core.distributed import (ClusteringResult,
                                          distributed_kmeans,
                                          distributed_kmeans_tree,
                                          graph_distributed_kmeans)
from repro_torch.core.strategy import (CoresetStrategy, available_strategies,
                                       get_strategy, register_strategy)
from repro_torch.core.topology import (Graph, SpanningTree,
                                       bfs_spanning_tree, erdos_renyi, grid,
                                       spanning_tree)

__all__ = [
    "backend", "clustering", "comm", "coreset", "distributed", "objective",
    "partition", "prng", "strategy", "topology",
    "ClusteringBackend", "available_backends", "get_backend",
    "query_assignments", "query_assignments_batched", "register_backend",
    "use_backend",
    "cost", "kmeans_pp_init", "lloyd", "lloyd_stats", "min_dist_argmin",
    "solve",
    "CommLedger", "Coreset", "DistributedCoreset", "build_coreset",
    "distributed_coreset",
    "ClusteringResult", "distributed_kmeans", "distributed_kmeans_tree",
    "graph_distributed_kmeans",
    "CoresetStrategy", "available_strategies", "get_strategy",
    "register_strategy",
    "Graph", "SpanningTree", "bfs_spanning_tree", "erdos_renyi", "grid",
    "spanning_tree",
]
