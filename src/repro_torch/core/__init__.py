"""The paper's contribution, ported: distributed coreset construction and
clustering on general topologies (Algorithms 1 and 2)."""

from repro_torch.core import (backend, baselines, clustering, comm,
                              coreset, distributed, mesh, message_passing,
                              objective, partition, prng, strategy, topology)
from repro_torch.core.backend import (ClusteringBackend, available_backends,
                                      get_backend, query_assignments,
                                      query_assignments_batched,
                                      register_backend, use_backend)
from repro_torch.core.clustering import (cost, kmeans_pp_init, lloyd,
                                         lloyd_converged, lloyd_stats,
                                         min_dist_argmin, solve)
from repro_torch.core.comm import CommLedger
from repro_torch.core.coreset import (Coreset, DistributedCoreset,
                                      StagedDetail, build_coreset,
                                      distributed_coreset,
                                      merge_coresets,
                                      staged_distributed_coreset)
from repro_torch.core.distributed import (ClusteringResult, ExecDetail,
                                          distributed_kmeans,
                                          distributed_kmeans_tree,
                                          graph_distributed_kmeans,
                                          spmd_distributed_kmeans)
from repro_torch.core.mesh import Mesh, launch
from repro_torch.core.message_passing import (ExecResult, GossipSchedule,
                                              TreeSchedule, collective_hops,
                                              flood_exec,
                                              neighbor_rounds_gather,
                                              neighbor_rounds_sum,
                                              torus_mesh_shape,
                                              torus_rounds_gather,
                                              torus_rounds_sum,
                                              tree_broadcast_exec,
                                              tree_gather_exec,
                                              tree_scatter_exec,
                                              tree_up_sum_exec)
from repro_torch.core.strategy import (CoresetStrategy, available_strategies,
                                       get_strategy, register_strategy)
from repro_torch.core.topology import (Graph, SpanningTree,
                                       bfs_spanning_tree, diameter,
                                       erdos_renyi, grid, heterogeneous,
                                       mst_spanning_tree, preferential, ring,
                                       spanning_tree, star, torus,
                                       wan_clusters)

__all__ = [
    "backend", "baselines", "clustering", "comm", "coreset", "distributed",
    "mesh", "message_passing", "objective", "partition", "prng", "strategy",
    "topology",
    "ClusteringBackend", "available_backends", "get_backend",
    "query_assignments", "query_assignments_batched", "register_backend",
    "use_backend",
    "cost", "kmeans_pp_init", "lloyd", "lloyd_converged", "lloyd_stats",
    "min_dist_argmin", "solve",
    "CommLedger", "Coreset", "DistributedCoreset", "StagedDetail",
    "build_coreset", "distributed_coreset", "merge_coresets",
    "staged_distributed_coreset",
    "ClusteringResult", "ExecDetail", "distributed_kmeans",
    "distributed_kmeans_tree", "graph_distributed_kmeans",
    "spmd_distributed_kmeans",
    "Mesh", "launch",
    "ExecResult", "GossipSchedule", "TreeSchedule", "collective_hops",
    "flood_exec", "neighbor_rounds_gather", "neighbor_rounds_sum",
    "torus_mesh_shape", "torus_rounds_gather", "torus_rounds_sum",
    "tree_broadcast_exec", "tree_gather_exec", "tree_scatter_exec",
    "tree_up_sum_exec",
    "CoresetStrategy", "available_strategies", "get_strategy",
    "register_strategy",
    "Graph", "SpanningTree", "bfs_spanning_tree", "diameter", "erdos_renyi",
    "grid", "heterogeneous", "mst_spanning_tree", "preferential", "ring",
    "spanning_tree", "star", "torus", "wan_clusters",
]
