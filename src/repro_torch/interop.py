"""Carry the JAX package's state into the port.

The JAX package's values arrive here as numpy arrays (``np.asarray`` of a
``jax.Array``); this module turns them into the port's tensors on a given
device, so a test can take one stage's output from the reference and run
the port's next stage on it:

* raw PRNG keys (``uint32[..., 2]``: one key, a split, or the all-site key
  table) become the port's int64 keys (:mod:`repro_torch.core.prng`);
* ``Coreset`` / ``DistributedCoreset`` / ``Selection`` fields and centers
  become float32 / integer tensors;
* a ``FaultPlan``'s fields become the port's
  :class:`~repro_torch.wan.faults.FaultPlan` (the same plan: the same
  masks from the same seeds);
* a language model's params and cache (numpy pytrees of the JAX package's
  ``init_params`` / ``init_cache`` / ``forward`` outputs) become the
  port's, whose layers are a list in depth order where the JAX package
  stacks them by period and run (:func:`model_params`,
  :func:`model_cache`), and its AdamW state the port's
  (:func:`opt_state`).

It imports no JAX: callers convert with ``np.asarray`` first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.backend import DeviceLike, as_tensor, resolve_device
from repro_torch.core.coreset import Coreset, DistributedCoreset
from repro_torch.data.selection import Selection
from repro_torch.models.config import ModelConfig
from repro_torch.wan.faults import FaultPlan


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


def selection(indices, weights, t_i, local_costs,
              device: DeviceLike = None) -> Selection:
    dev = resolve_device(device)
    return Selection(indices=tensor(indices, dev),
                     weights=tensor(weights, dev), t_i=tensor(t_i, dev),
                     local_costs=tensor(local_costs, dev))


def fault_plan(plan) -> FaultPlan:
    """A fault plan with the reference plan's ``drop``, ``churn``,
    ``dup_rate`` and ``seed`` (read as attributes; the reference's class is
    not imported)."""
    return FaultPlan(drop=tuple(tuple(e) for e in plan.drop),
                     churn=tuple(tuple(c) for c in plan.churn),
                     dup_rate=float(plan.dup_rate), seed=int(plan.seed))


def _unstack_layers(tree, cfg: ModelConfig):
    """The JAX package's ``{"scan": {run: ...}, "rem": {run: ...}}`` layer
    tree as one entry per layer in depth order. ``scan[str(r)]`` holds
    leading dims (n_periods,) for a run of one layer and (n_periods,
    run_len) for a longer one; ``rem[str(r)]`` (run_len,) or none: layers
    come period by period, run by run, then by index within the run."""
    def pick(sub, *index):
        if isinstance(sub, dict):
            return {k: pick(v, *index) for k, v in sub.items()}
        return np.asarray(sub)[index]

    layers = []
    for per in range(cfg.n_full_periods):
        for r, (_, rlen) in enumerate(cfg.runs()):
            sub = tree["scan"][str(r)]
            layers += ([pick(sub, per)] if rlen == 1 else
                       [pick(sub, per, i) for i in range(rlen)])
    for r, (_, rlen) in enumerate(cfg.remainder_runs()):
        sub = tree["rem"][str(r)]
        layers += ([pick(sub)] if rlen == 1 else
                   [pick(sub, i) for i in range(rlen)])
    return layers


def _tensors(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v, device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: no numpy op
        return tensor(arr.astype(np.float32), device).to(torch.bfloat16)
    return tensor(arr, device)


def model_params(ref_params, cfg: ModelConfig, device: DeviceLike = None):
    """The JAX package's LM params (``init_params``'s pytree as numpy) as
    the port's: the same values, layers unstacked into a list."""
    dev = resolve_device(device)
    out = {k: _tensors(v, dev) for k, v in ref_params.items()
           if k != "layers"}
    out["layers"] = _tensors(_unstack_layers(ref_params["layers"], cfg), dev)
    return out


def model_cache(ref_cache, cfg: ModelConfig, device: DeviceLike = None):
    """The JAX package's LM cache (``init_cache`` or a ``forward``'s cache,
    as numpy) as the port's list of per-layer caches."""
    return _tensors(_unstack_layers(ref_cache, cfg), resolve_device(device))


def opt_state(ref_opt, cfg: ModelConfig, device: DeviceLike = None):
    """The JAX package's AdamW state (``optim.adamw.init``'s or
    ``update``'s pytree as numpy) as the port's: the moments ``m`` and
    ``v`` (and the f32 ``master`` copy where present) with their layers
    unstacked as :func:`model_params` unstacks params, the step an int32
    scalar."""
    dev = resolve_device(device)
    out = {name: model_params(ref_opt[name], cfg, dev)
           for name in ("m", "v", "master") if name in ref_opt}
    out["step"] = torch.tensor(int(np.asarray(ref_opt["step"])),
                               dtype=torch.int32, device=dev)
    return out
