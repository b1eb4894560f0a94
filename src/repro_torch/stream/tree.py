"""Merge-and-reduce coreset tree (the port of ``repro.stream.tree``;
Bentley-Saxe over Algorithm 1's summary).

Coresets compose: the union of eps-coresets of two disjoint sets is an
eps-coreset of the union (merge), and an eps'-coreset of an eps-coreset is
an ((1 + eps)(1 + eps') - 1)-coreset of the original (reduce).
:class:`CoresetTree` keeps one fixed-size slot per level; level ``i``
summarizes ``2^i`` pushed batches. A push builds the batch's leaf summary
and carries it up like a binary counter: two occupied summaries at a level
merge and reduce (:func:`~repro_torch.core.coreset.merge_coresets`),
vacating the level. After ``n`` batches at most ``ceil(log2 n) + 1``
levels are occupied, so the summary holds ``O((t + k) log n)`` points.

The buckets live on the device as two buffers, ``(levels, slot, d)`` points
and ``(levels, slot)`` weights, written in place; a vacant level carries
weight exactly 0, so :meth:`CoresetTree.summary` is a view of constant
shape. Occupancy is host state driven by the push counter alone (never by
data), and the pushed mass is kept on the host in float64.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import objective as objective_mod
from repro_torch.core import prng
from repro_torch.core.backend import DeviceLike, as_tensor
from repro_torch.core.coreset import Coreset, build_coreset, merge_coresets


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Static shape and solver parameters of one tree."""

    k: int                     # centers per local solve
    t: int                     # samples per bucket coreset
    d: int                     # point dimensionality
    batch_size: int            # points per pushed batch (fixed shape)
    levels: int = 24           # >= log2(#batches); 24 ~ 16M batches
    objective: str = "kmeans"  # any registered objective name
    lloyd_iters: int = 5
    backend: Optional[str] = None   # resolved at tree construction

    @property
    def slot(self) -> int:
        """Points per bucket: t samples + k solution centers."""
        return self.t + self.k


def _host_mass(weights) -> float:
    """The float64 host sum of a batch's weights (numpy's order, as the
    reference sums them)."""
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    return float(np.sum(np.asarray(weights, np.float64)))


class CoresetTree:
    """Any-time, bounded-memory coreset of everything pushed so far. Runs
    on ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, config: TreeConfig, key=None,
                 device: DeviceLike = None):
        if config.levels < 1:
            raise ValueError("need at least one level")
        self.device = backend_mod.resolve_device(device)
        # resolve both registries once: unknown names fail here
        self.config = dataclasses.replace(
            config,
            backend=backend_mod.resolve_name(config.backend, self.device),
            objective=objective_mod.resolve_name(config.objective))
        s = config.slot
        self._points = torch.zeros((config.levels, s, config.d),
                                   dtype=torch.float32, device=self.device)
        self._weights = torch.zeros((config.levels, s), dtype=torch.float32,
                                    device=self.device)
        self._occupied = np.zeros((config.levels,), dtype=bool)
        self._key = (prng.PRNGKey(0, device=self.device) if key is None
                     else as_tensor(key, self.device))
        self.n_batches = 0
        self.total_weight = 0.0    # exact mass pushed (host float64)

    # -- internals -----------------------------------------------------------

    def _next_key(self) -> torch.Tensor:
        self._key, sub = prng.split(self._key)
        return sub

    def _leaf(self, batch: torch.Tensor, weights: torch.Tensor) -> Coreset:
        """Level-0 summary of one batch: stored raw (zero-padded, exact)
        when it fits a slot, else reduced by one sensitivity-sampling
        pass."""
        cfg = self.config
        if cfg.batch_size <= cfg.slot:
            pad = cfg.slot - cfg.batch_size
            return Coreset(
                points=torch.nn.functional.pad(batch, (0, 0, 0, pad)),
                weights=torch.nn.functional.pad(weights, (0, pad)))
        return build_coreset(self._next_key(), batch, cfg.k, cfg.t,
                             weights=weights, objective=cfg.objective,
                             lloyd_iters=cfg.lloyd_iters, backend=cfg.backend,
                             device=self.device)

    def _reduce(self, a: Coreset, b: Coreset) -> Coreset:
        cfg = self.config
        return merge_coresets(self._next_key(), a, b, cfg.k, cfg.t,
                              objective=cfg.objective,
                              lloyd_iters=cfg.lloyd_iters,
                              backend=cfg.backend, device=self.device)

    def _bucket(self, level: int) -> Coreset:
        return Coreset(points=self._points[level],
                       weights=self._weights[level])

    def _set_bucket(self, level: int, cs: Optional[Coreset]) -> None:
        if cs is None:
            # vacate: weight exactly 0 keeps summary() a plain view
            self._weights[level] = 0.0
            self._occupied[level] = False
        else:
            self._points[level] = cs.points
            self._weights[level] = cs.weights
            self._occupied[level] = True

    # -- public API ----------------------------------------------------------

    def push(self, batch, weights=None) -> None:
        """Ingest one fixed-size batch ``(batch_size, d)``, optionally
        weighted. Amortized O(1) reduces per push."""
        cfg = self.config
        batch = as_tensor(batch, self.device).to(torch.float32)
        if tuple(batch.shape) != (cfg.batch_size, cfg.d):
            raise ValueError(f"batch shape {tuple(batch.shape)} != "
                             f"{(cfg.batch_size, cfg.d)}; pad with weight-0 "
                             f"slots for partial batches")
        # the mass from host values: a device sum would sync every push
        if weights is None:
            w = batch.new_ones((cfg.batch_size,))
            self.total_weight += float(cfg.batch_size)
        else:
            self.total_weight += _host_mass(weights)
            w = as_tensor(weights, self.device).to(torch.float32)

        carry = self._leaf(batch, w)
        level = 0
        # binary-counter carry: occupancy after n pushes == bits of n
        while level < cfg.levels and self._occupied[level]:
            carry = self._reduce(self._bucket(level), carry)
            self._set_bucket(level, None)
            level += 1
        if level == cfg.levels:
            # overflow: fold into the top bucket (memory stays bounded;
            # the error grows only if levels was undersized)
            self._set_bucket(cfg.levels - 1, carry)
        else:
            self._set_bucket(level, carry)
        self.n_batches += 1

    def occupied_levels(self) -> int:
        return int(self._occupied.sum())

    @property
    def size(self) -> int:
        """Static summary capacity in points (levels * slot)."""
        return self.config.levels * self.config.slot

    def max_summary_points(self) -> int:
        """Occupied capacity: the ``(t + k) * O(log n)`` bound."""
        return self.occupied_levels() * self.config.slot

    def summary(self) -> Coreset:
        """Any-time coreset of everything pushed so far, as one
        constant-shape ``(levels * slot,)`` weighted point set (vacant
        levels carry weight exactly 0); views of the tree's buffers."""
        cfg = self.config
        return Coreset(points=self._points.reshape(-1, cfg.d),
                       weights=self._weights.reshape(-1))

    def compact_summary(self) -> Coreset:
        """Summary with weight-carrying slots packed to the front and
        truncated to the occupied capacity."""
        cap = max(self.max_summary_points(), 1)
        return self.summary().compact(cap)

    def bucket_sizes(self) -> List[int]:
        """Nonzero-weight slot count per level (diagnostics)."""
        counts = (self._weights != 0.0).sum(1).cpu().numpy()
        return [int(c) for c in counts]
