"""Cross-entropy loss with padded-vocab masking, z-loss and MoE aux loss
(the port of ``repro.train.loss``).

Two evaluation paths: :func:`lm_loss` over full logits, and
:func:`chunked_lm_loss`, which applies the LM head and the CE one sequence
chunk at a time, recomputing each chunk's logits in the backward
(activation checkpointing), so the (B, L, vocab) f32 logits never
materialize.

Under tensor parallelism (``sharding.model_axis()``) the logits are this
rank's vocab slice: the log-sum-exp takes its max and its sum of
exponentials over ``model`` (all-gathered, reduced in rank order), the
label's logit comes from the rank whose slice holds it, and the z-loss
is taken from the same log-sum-exp, so every rank of ``model`` holds the
same loss."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import lm_head_apply


def _masked_lse(logits: torch.Tensor, labels: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """log-sum-exp over the real vocab and the labels' logits, (B, L)."""
    logits = logits.float()
    ax = sharding.model_axis()
    n = logits.shape[-1]
    lo = 0 if ax is None else ax.rank * n
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(lo, lo + n, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    if ax is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return lse, ll
    m = sharding.all_max(logits.amax(-1), ax)
    lse = m + torch.log(sharding.all_sum(
        torch.exp(logits - m[..., None]).sum(-1), ax))
    local = labels.long() - lo
    ll = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    ll = sharding.all_sum(torch.where((local >= 0) & (local < n), ll, 0.0),
                          ax)
    return lse, ll


def _metrics(ce, zl, cfg: ModelConfig, aux, z_coef: float):
    total = ce + z_coef * zl
    metrics = {"ce": ce, "z_loss": zl,
               "ppl_proxy": torch.exp(torch.clamp_max(ce, 20.0))}
    if aux is not None:
        total = total + cfg.router_aux_coef * aux
        metrics["moe_aux"] = aux
    metrics["loss"] = total
    return total, metrics


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
            mask: Optional[torch.Tensor] = None,
            aux: Optional[torch.Tensor] = None, z_coef: float = 1e-4
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """logits (B, L, vocab_padded) f32, labels (B, L) -> (loss, metrics)."""
    lse, ll = _masked_lse(logits, labels, cfg)
    nll = lse - ll
    m = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp_min(m.sum(), 1.0)
    ce = torch.sum(nll * m) / denom
    zl = torch.sum(lse * lse * m) / denom
    return _metrics(ce, zl, cfg, aux, z_coef)


def chunked_lm_loss(head_params: Dict[str, torch.Tensor],
                    hidden: torch.Tensor, labels: torch.Tensor,
                    cfg: ModelConfig, chunk: int = 512,
                    aux: Optional[torch.Tensor] = None, z_coef: float = 1e-4
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE over sequence chunks of ``hidden`` (B, L, d), the final-norm
    output; peak memory holds one (B, chunk, vocab) block of logits."""
    B, L, _ = hidden.shape
    chunk = min(chunk, L)
    while L % chunk:
        chunk -= 1

    def body(xc, lc):
        lse, ll = _masked_lse(lm_head_apply(head_params, xc, cfg), lc, cfg)
        return torch.sum(lse - ll), torch.sum(lse * lse)

    recompute = torch.is_grad_enabled()
    nll = hidden.new_zeros((), dtype=torch.float32)
    zl = hidden.new_zeros((), dtype=torch.float32)
    for i in range(L // chunk):
        xc = hidden[:, i * chunk:(i + 1) * chunk]
        lc = labels[:, i * chunk:(i + 1) * chunk]
        n, z = (checkpoint(body, xc, lc, use_reentrant=False) if recompute
                else body(xc, lc))
        nll = nll + n
        zl = zl + z
    denom = float(B * L)
    return _metrics(nll / denom, zl / denom, cfg, aux, z_coef)
