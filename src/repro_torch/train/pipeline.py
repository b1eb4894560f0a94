"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (the port
of ``repro.train.pipeline``).

Each rank of the axis holds ``n_layers / S`` layers' params;
microbatches flow stage to stage, one ring hop of the
:class:`repro_torch.core.mesh.Mesh` per tick where the JAX package's
``shard_map`` program calls ``ppermute`` (fill + steady state + drain = M +
S - 1 ticks). The schedule's cost model (bubble fraction (S-1)/(M+S-1))
is unit-tested against the simulated tick count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.mesh import axis

PyTree = Any


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    n_stages: int
    n_microbatches: int

    @property
    def ticks(self) -> int:
        return self.n_microbatches + self.n_stages - 1

    @property
    def bubble_fraction(self) -> float:
        return (self.n_stages - 1) / self.ticks


def pipeline_forward(
    stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
    stage_params: PyTree,          # this rank's (this stage's) params
    microbatches: torch.Tensor,    # (M, mb, ...) input microbatches
    axis_name: str,
    n_stages: int,
) -> torch.Tensor:
    """Run on every rank of the bound mesh axis ``axis_name``: each applies
    its stage to the stream; the last stage returns the results, the
    others zeros of the same shape.

    GPipe forward schedule: at tick t, stage s processes microbatch t - s.
    Activations move one stage down per tick on a ring hop; stage 0
    receives zeros (``ppermute`` with no source for it), and only the last
    stage writes its output."""
    mesh = axis(axis_name)
    if mesh.size != n_stages:
        raise ValueError(f"axis {axis_name!r} has {mesh.size} ranks, not "
                         f"{n_stages} stages")
    M = microbatches.shape[0]
    stage = mesh.rank
    ticks = M + n_stages - 1
    mb_shape = tuple(microbatches.shape[1:])
    out = torch.zeros((M,) + mb_shape, dtype=microbatches.dtype,
                      device=microbatches.device)
    inflight = torch.zeros(mb_shape, dtype=microbatches.dtype,
                           device=microbatches.device)
    for t in range(ticks):
        # stage 0 ingests microbatch t (if any)
        x = microbatches[min(max(t, 0), M - 1)] if stage == 0 else inflight
        y = stage_fn(stage_params, x)
        # the last stage writes its result for microbatch t - (S-1)
        if stage == n_stages - 1 and t >= n_stages - 1:
            out[t - (n_stages - 1)] = y
        # pass activations downstream (the ring's hop from the last stage
        # to stage 0 is dropped there)
        if n_stages > 1:
            nxt = mesh.hop(y, (stage + 1) % n_stages, (stage - 1) % n_stages)
            inflight = torch.zeros_like(nxt) if stage == 0 else nxt
    return out
