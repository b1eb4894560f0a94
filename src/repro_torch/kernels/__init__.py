"""The port's hand-written CUDA kernels for Hopper, their plain PyTorch
versions (:mod:`~repro_torch.kernels.ref`) and the safe wrappers the rest
of the port calls (:mod:`~repro_torch.kernels.ops`)."""

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import (chunk_queries, lloyd_stats, lloyd_step,
                                     min_dist_argmin, min_dist_argmin_batched,
                                     pad_queries, query_bucket,
                                     weiszfeld_stats)

__all__ = ["ops", "ref", "chunk_queries", "lloyd_stats", "lloyd_step",
           "min_dist_argmin", "min_dist_argmin_batched", "pad_queries",
           "query_bucket", "weiszfeld_stats"]
