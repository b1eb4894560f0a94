"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch
(the port of ``repro.models.moe``).

Dispatch is local per sequence row: every (token, choice) gets a position
inside its expert from a per-row cumulative count over the flattened
(L * K) choices, token-major, and is added into its row of the (B, E,
C_row, d) dispatch buffer (one ``index_add_`` for all choices: each kept
slot receives one token, so the order of the adds changes nothing; the
JAX package scatters one routing choice at a time). Tokens beyond the per-row
capacity C = ceil(L * k / E * cf) (rounded up to 8) are dropped: they
write zero into slot C - 1 and the residual passes through (Switch/GShard
semantics, accounted per row).

Top-k breaks ties as ``jax.lax.top_k`` does, the lower expert first (a
stable descending sort): router logits in bf16 make equal probabilities
common.

Under tensor parallelism (``sharding.model_axis()``) the experts are
expert-parallel: ``param_specs`` gives a rank E / M of them (``d``
FSDP over ``data``). The block has gathered the sequence, so every
rank of ``model`` holds the same rows: each computes the routing, the
capacity slots and the gates of every token, dispatches only the
choices of its own experts, and returns the combine over them as a
partial sum in f32 (bf16 operands upcast, each product exact), which the
block reduce-scatters onto the sequence and rounds once -- the JAX
package's all-to-all of the routed rows there and back. Experts that do
not split over M stay whole on every rank: each computes every expert
and returns its own L / M tokens' rows of the output (zeros elsewhere),
so the sum over ``model`` is the output itself, not M copies. The
load-balance loss is computed the same on every rank of ``model``, so
its gradient would be counted M times: each rank takes the mean
probabilities over its own L / M tokens and the partial losses are summed
over ``model`` (``sharding.all_sum``). Where the sequence runs whole on
every rank of ``model`` (prefill of a length that does not split, decode)
there is no L / M: rank 0 takes every token's share and the others none
(:func:`_token_share`), so the sum is the unsharded value, not M times
it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _pdtype, dense_init, gelu, normal

Params = Dict[str, Any]


def moe_init(key: torch.Generator, cfg: ModelConfig) -> Params:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    pdt = _pdtype(cfg)

    def expert_w(din, dout):
        return normal(key, (E, din, dout), pdt) / math.sqrt(din)

    return {
        "router": dense_init(key, d, E, cfg),
        "experts": {
            "w_gate": expert_w(d, ff),
            "w_in": expert_w(d, ff),
            "w_out": expert_w(ff, d),
        },
    }


def _row_capacity(seq_len: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(seq_len * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return -(-c // 8) * 8


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Router probabilities, the top-k gates and experts, and each choice's
    capacity slot and kept flag: probs (B, L, E) f32, gate (B, L, K) f32,
    idx, pos (B, L, K) int64, keep (B, L, K) bool."""
    B, L, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _row_capacity(L, cfg)
    logits = (x @ p["router"]["w"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                        # (B, L, E)
    gate, idx = top_k(probs, K)                                  # (B, L, K)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    eid = idx.reshape(B, L * K)
    onehot = (eid[..., None] == torch.arange(E, device=x.device)).long()
    pos = torch.gather(onehot.cumsum(dim=1) - 1, 2, eid[..., None])[..., 0]
    keep = pos < C
    pos = pos.clamp_max(C - 1)
    return probs, gate, idx, pos.reshape(B, L, K), keep.reshape(B, L, K)


def _token_share(L: int, ax) -> Tuple[int, int]:
    """The tokens (lo, hi) this rank of ``model`` accounts for where every
    rank holds all L: its L / M under sequence parallelism, all of them
    on rank 0 where the sequence runs whole."""
    if sharding.seq_axis() is not None:
        n = L // ax.size
        return ax.rank * n, (ax.rank + 1) * n
    return (0, L) if ax.rank == 0 else (0, 0)


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, d) -> (y (B, L, d), aux_loss scalar f32); under tensor
    parallelism y is this rank's partial sum in f32."""
    B, L, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _row_capacity(L, cfg)
    probs, gate, idx, pos, keep = route(p, x, cfg)
    w = p["experts"]
    ax = sharding.model_axis()
    n_local = w["w_in"].shape[0]          # E / M when expert-parallel
    split = n_local != E
    e0 = ax.rank * n_local if split else 0
    if split:
        keep = keep & (idx >= e0) & (idx < e0 + n_local)

    # each choice's row of the flattened (B * E * C, d) buffer; a kept
    # choice's slot is its own, a dropped one (or another rank's) adds
    # zero into a slot of this rank's
    local = (idx - e0).clamp(0, n_local - 1)
    slot = (torch.arange(B, device=x.device)[:, None, None] * n_local
            + local) * C + pos                                   # (B, L, K)
    buf = x.new_zeros((B * n_local * C, d))
    buf.index_add_(0, slot.reshape(-1), (x[:, :, None, :] * keep[
        ..., None].to(x.dtype)).reshape(-1, d))
    buf = sharding.constrain(buf.reshape(B, n_local, C, d), "batch",
                             "model", None, None)

    act = F.silu if cfg.mlp_act == "silu" else gelu
    hg = act(torch.einsum("becd,edf->becf", buf, w["w_gate"].to(x.dtype)))
    hi = torch.einsum("becd,edf->becf", buf, w["w_in"].to(x.dtype))
    ho = torch.einsum("becf,efd->becd", hg * hi, w["w_out"].to(x.dtype))
    ho = sharding.constrain(ho, "batch", "model", None, None)

    vals = ho.reshape(B * n_local * C, d)[slot]                  # (B,L,K,d)
    scale = (gate * keep)[..., None].to(ho.dtype)
    if split:
        y = torch.zeros((B, L, d), dtype=torch.float32, device=x.device)
        for j in range(K):
            y = y + vals[:, :, j].float() * scale[:, :, j].float()
    else:
        y = x.new_zeros((B, L, d))
        for j in range(K):
            y = y + vals[:, :, j] * scale[:, :, j]
        if ax is not None:                # every rank holds every expert
            lo, hi = _token_share(L, ax)
            mine = torch.zeros((L,), dtype=torch.bool, device=x.device)
            mine[lo:hi] = True
            y = torch.where(mine[:, None], y.float(), 0.0)
    y = sharding.constrain(y, "batch", "model", None)

    # Switch-style load-balance aux loss; with the batch split over ranks
    # the top-1 fractions are the global batch's, and each rank's own mean
    # probabilities make the ranks' mean the global aux loss and its
    # gradient
    hits = (idx[..., 0].reshape(-1, 1) == torch.arange(
        E, device=x.device)).float()
    bx = sharding.batch_axis()
    if bx is None or bx.size == 1:
        frac = hits.mean(dim=0)
    else:
        frac = bx.all_gather(hits.sum(dim=0), kind="all-reduce").sum(0) / (
            hits.shape[0] * bx.size)
    if ax is None:
        mean_prob = probs.reshape(-1, E).mean(dim=0)
        return y, E * torch.sum(frac * mean_prob)
    # this rank's tokens' share of the mean, the shares summed
    lo, hi = _token_share(L, ax)
    mean_prob = probs[:, lo:hi].reshape(-1, E).sum(dim=0) / (B * L)
    return y, sharding.all_sum(E * torch.sum(frac * mean_prob), ax)
