"""Carry the JAX package's state into the port.

The JAX package's values arrive here as numpy arrays (``np.asarray`` of a
``jax.Array``); this module turns them into the port's tensors on a given
device, so a test can take one stage's output from the reference and run
the port's next stage on it:

* raw PRNG keys (``uint32[..., 2]``: one key, a split, or the all-site key
  table) become the port's int64 keys (:mod:`repro_torch.core.prng`);
* ``Coreset`` / ``DistributedCoreset`` fields and centers become float32 /
  integer tensors.

It imports no JAX: callers convert with ``np.asarray`` first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.backend import DeviceLike, as_tensor, resolve_device
from repro_torch.core.coreset import Coreset, DistributedCoreset


def key(raw, device: DeviceLike = None) -> torch.Tensor:
    """A raw threefry key or key table (uint32, last axis 2) as the port's
    int64 key tensor."""
    raw = np.asarray(raw)
    if raw.dtype != np.uint32 or raw.ndim < 1 or raw.shape[-1] != 2:
        raise TypeError(f"a raw key is uint32 with a last axis of 2, got "
                        f"{raw.dtype} {raw.shape}")
    return as_tensor(raw.astype(np.int64), resolve_device(device))


def tensor(arr, device: DeviceLike = None) -> torch.Tensor:
    """A float or integer array (centers, masses, assignments, ...) as a
    tensor with the same dtype."""
    return as_tensor(np.asarray(arr), resolve_device(device))


def coreset(points, weights, device: DeviceLike = None) -> Coreset:
    dev = resolve_device(device)
    return Coreset(points=tensor(points, dev), weights=tensor(weights, dev))


def distributed_coreset(points, weights, t_i, local_costs,
                        device: DeviceLike = None) -> DistributedCoreset:
    dev = resolve_device(device)
    return DistributedCoreset(points=tensor(points, dev),
                              weights=tensor(weights, dev),
                              t_i=tensor(t_i, dev),
                              local_costs=tensor(local_costs, dev))
