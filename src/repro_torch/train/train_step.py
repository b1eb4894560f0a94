"""Training step factory (the port of ``repro.train.train_step``):
microbatched gradient accumulation, remat, global-norm clip, AdamW and the
warmup-cosine schedule.

``make_train_step(cfg, tc)`` returns ``(params, opt_state, batch, step) ->
(params, opt_state, metrics)``. With ``grad_sync`` the step hands the
gradients and the loss metrics to it before the clip and the update, and
goes on with what it returns: ``launch.train`` averages them over the
ranks of a data-parallel mesh there. Gradients come from ``torch.autograd``
through the port's ``forward``; the step then updates the params and the
optimizer state in place and returns the same objects -- the counterpart
of the JAX package's ``donate_argnums=(0, 1)``, without which a second
copy of params and moments would have to fit beside the first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.models import forward, make_positions
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, schedule
from repro_torch.train.loss import chunked_lm_loss, lm_loss

PyTree = Any
METRICS = ("ce", "z_loss", "ppl_proxy", "loss", "moe_aux")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    microbatches: int = 1            # grad accumulation steps
    remat: str = "full"              # "none" | "full"
    z_coef: float = 1e-4
    bf16_params: bool = False        # bf16 compute params + f32 master in
                                     # the optimizer
    loss_chunk: int = 0              # >0: chunked CE (never materializes
                                     # the (B, L, vocab) logits)
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()


def loss_fn(params: PyTree, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, tc: TrainConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    pos = make_positions(tokens, cfg)
    if tc.loss_chunk > 0:
        hidden, _, aux = forward(params, tokens, pos, cfg, remat=tc.remat,
                                 head=False)
        head_p = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        return chunked_lm_loss(head_p, hidden, labels, cfg,
                               chunk=tc.loss_chunk, aux=aux,
                               z_coef=tc.z_coef)
    logits, _, aux = forward(params, tokens, pos, cfg, remat=tc.remat)
    return lm_loss(logits, labels, cfg, aux=aux, z_coef=tc.z_coef)


def value_and_grad(params: PyTree, tokens: torch.Tensor,
                   labels: torch.Tensor, cfg: ModelConfig, tc: TrainConfig
                   ) -> Tuple[Tuple[torch.Tensor, Dict[str, torch.Tensor]],
                              List[torch.Tensor]]:
    """((loss, metrics), grads): ``jax.value_and_grad(loss_fn,
    has_aux=True)``, the gradients a list in the params' flattening order
    (zeros for a leaf the loss does not reach, as JAX gives). The params
    are not touched: the loss runs on detached aliases that require
    grad."""
    alias = tree_mod.map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_mod.leaves(alias)
    with torch.enable_grad():
        loss, metrics = loss_fn(alias, tokens, labels, cfg, tc)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def make_train_step(cfg: ModelConfig, tc: TrainConfig, grad_sync=None):
    def train_step(params: PyTree, opt_state: PyTree,
                   batch: Dict[str, torch.Tensor], step
                   ) -> Tuple[PyTree, PyTree, Dict[str, torch.Tensor]]:
        tokens, labels = batch["tokens"], batch["labels"]
        B = tokens.shape[0]
        n_mb = tc.microbatches
        if B % n_mb:
            raise ValueError(f"batch {B} is not a multiple of "
                             f"{n_mb} microbatches")

        if n_mb == 1:
            (_, metrics), grads = value_and_grad(params, tokens, labels,
                                                 cfg, tc)
        else:
            mb_tok = tokens.reshape(n_mb, B // n_mb, -1)
            mb_lab = labels.reshape(n_mb, B // n_mb, -1)
            # the JAX package's scan: sum into zeros of acc_dtype, in order
            acc_dtype = torch.bfloat16 if tc.bf16_params else torch.float32
            grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for p in tree_mod.leaves(params)]
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=tokens.device) for k in METRICS}
            for i in range(n_mb):
                (_, m), g = value_and_grad(params, mb_tok[i], mb_lab[i], cfg,
                                           tc)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                metrics = {k: metrics[k] + m[k] for k in METRICS}
            for acc in grads:
                acc.div_(n_mb)
            metrics = {k: v / n_mb for k, v in metrics.items()}
        if grad_sync is not None:
            grads, metrics = grad_sync(grads, metrics)

        lr = schedule.warmup_cosine(step, tc.peak_lr, tc.warmup_steps,
                                    tc.total_steps, device=tokens.device)
        params, opt_state, opt_metrics = adamw.update(
            grads, opt_state, params, lr, tc.adamw)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def init_state(key, cfg: ModelConfig, tc: Optional[TrainConfig] = None,
               device=None) -> Tuple[PyTree, PyTree]:
    """Params (``models.init_params(key, cfg, device)``) and AdamW state;
    with ``tc.bf16_params`` the params become bf16 and the state keeps
    their f32 master copy."""
    from repro_torch.models import init_params
    params = init_params(key, cfg, device)
    if tc is not None and tc.bf16_params:
        opt = adamw.init(params, keep_master=True)
        params = tree_mod.map(
            lambda p: p.to(torch.bfloat16) if p.is_floating_point() else p,
            params)
        return params, opt
    return params, adamw.init(params)
