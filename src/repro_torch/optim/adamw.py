"""AdamW (the port of ``repro.optim.adamw``): decoupled weight decay,
bias-corrected moments, global-norm clipping.

:func:`update` works in place, the counterpart of the JAX package's
donated buffers (``donate_argnums``): it writes the new params, moments
and step into the tensors it was given, leaf by leaf, and returns the same
objects. A functional copy would hold a second set of params and moments,
which at a large model's widths does not fit beside the first. Every
scalar the JAX package computes in float32 (the bias corrections
``1 - b ** t``, the clip scale, the learning rate) is a float32 tensor
here too, and each moment and param follows the JAX package's order of
operations, so the two agree to a few ulp given the same gradients."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_mod

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    # params whose path contains any of these substrings skip weight decay
    no_decay: Tuple[str, ...] = ("scale", "norm", "b", "Lambda", "A_log",
                                 "D", "dt_bias", "pos")


def init(params: PyTree, keep_master: bool = False) -> Dict[str, PyTree]:
    """``keep_master=True``: mixed-precision training -- compute params are
    bf16 and the optimizer carries the f32 master copy (+ f32 moments)."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    device = tree_mod.leaves(params)[0].device
    state = {
        "m": tree_mod.map(zeros, params),
        "v": tree_mod.map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if keep_master:
        state["master"] = tree_mod.map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    in flattening order. The JAX package sums one term per *stacked*
    leaf (all layers of a run in one), the port one per layer, so the two
    differ in the last bits."""
    total = None
    for x in tree_mod.leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_mod.map(lambda g: g * scale.to(g.dtype), grads), norm


def _decay_mask(params: PyTree, cfg: AdamWConfig) -> PyTree:
    """1.0 where a leaf takes weight decay, else 0.0: the JAX package's
    rule on the port's path names (``layers/<i>/...`` where the JAX package
    has ``layers/scan/<run>/...``). A substring of ``no_decay`` anywhere in
    the path skips decay -- ``"b"`` matches ``embed/table`` and
    ``lm_head/table`` too, so neither embedding is decayed, as in the JAX
    package -- and so does a leaf of at most one dim."""
    def one(path, leaf):
        name = "/".join(path)
        skip = any(s in name.split("/")[-1] or s in name
                   for s in cfg.no_decay) or leaf.ndim <= 1
        return 0.0 if skip else 1.0

    return tree_mod.unflatten(params, [one(p, x) for p, x in
                                       tree_mod.paths(params)])


@torch.no_grad()
def update(
    grads: PyTree,
    state: Dict[str, PyTree],
    params: PyTree,
    lr: torch.Tensor,
    cfg: AdamWConfig = AdamWConfig(),
    norm=global_norm,
) -> Tuple[PyTree, Dict[str, PyTree], Dict[str, torch.Tensor]]:
    """One AdamW step, in place: writes the new params into ``params``,
    the new moments, master copy and step into ``state``, and consumes
    ``grads`` (float32 gradients are overwritten). Returns (params, state,
    metrics), the same ``params`` and ``state`` objects. ``norm`` maps the
    gradient leaves to their global norm: on a mesh of ranks, where each
    holds shards, the train step passes one that reduces over the ranks
    (``train_step.mesh_train_step``), and the moments, params and decay
    mask are the shards' own."""
    g_leaves = tree_mod.leaves(grads)
    gnorm = norm(g_leaves)
    scale = (_clip_scale(gnorm, cfg.grad_clip_norm)
             if cfg.grad_clip_norm > 0 else None)
    state["step"].add_(1)
    t = state["step"].to(torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.pow(f32(cfg.b1), t)
    bc2 = 1.0 - torch.pow(f32(cfg.b2), t)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
    decay = tree_mod.leaves(_decay_mask(params, cfg))
    p_leaves = tree_mod.leaves(params)
    masters = (tree_mod.leaves(state["master"]) if "master" in state
               else p_leaves)
    for g, m, v, p, master, dm in zip(
            g_leaves, tree_mod.leaves(state["m"]), tree_mod.leaves(state["v"]),
            p_leaves, masters, decay):
        g = g.to(torch.float32)
        if scale is not None:
            g.mul_(scale)
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        m.mul_(cfg.b1).add_(torch.mul(g, 1.0 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1.0 - cfg.b2))
        # mhat / (sqrt(vhat) + eps) + wd * dm * p;  p - lr * step
        step = torch.div(m, bc1).div_(torch.div(v, bc2).sqrt_()
                                      .add_(cfg.eps))
        wd = cfg.weight_decay * dm
        if wd:
            step.add_(torch.mul(master.to(torch.float32), wd))
        step.mul_(lr)
        if master.dtype == torch.float32:
            master.sub_(step)
        else:
            master.copy_(master.to(torch.float32).sub_(step))
        del step
        if master is not p:
            p.copy_(master)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, state, metrics
