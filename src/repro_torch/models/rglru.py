"""RG-LRU recurrent block (Griffin / RecurrentGemma; the port of
``repro.models.rglru``).

Temporal mixing: y = W_out( GeLU(W_g x) * RG-LRU(conv1d(W_x x)) ), where the
RG-LRU is the gated diagonal linear recurrence

    r_t = sigmoid(W_a xi_t + b_a)          recurrence gate
    i_t = sigmoid(W_i xi_t + b_i)          input gate
    log a_t = -c * softplus(Lambda) * r_t  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xi_t)

A full pass runs the recurrence as a log-depth scan over the sequence (the
recurrence is diagonal, so (a, b) pairs compose associatively); decode is
a single O(1) state update. A cache passed to :func:`rglru_apply` is
written in place and returned.

Under tensor parallelism (``sharding.model_axis()``) a rank holds
``lru_width / M`` channels: ``w_gate`` and ``w_x`` are column-parallel,
the conv, ``Lambda`` and the recurrence act on those channels, and the
gates' ``w_a`` / ``w_i`` (columns cut over ``model``) read the whole
``xi``, all-gathered over ``model`` (the gradient comes back
reduce-scattered). ``w_out`` is row-parallel: its partial sum comes out
in f32 for the block to reduce-scatter.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (CacheLeaf, _dtype, _pdtype,
                                       _row_apply, allocate, dense_apply,
                                       dense_init, gelu, normal)

Params = Dict[str, Any]

_C = 8.0


def rglru_init(key: torch.Generator, cfg: ModelConfig) -> Params:
    d, w = cfg.d_model, cfg.lru_width
    pdt, dev = _pdtype(cfg), key.device
    # Lambda init so that a^c spans ~(0.9, 0.999) as in Griffin
    u = torch.empty((w,), dtype=pdt, device=dev).uniform_(
        0.9 ** 2, 0.999 ** 2,
        generator=key if isinstance(key, torch.Generator) else None)
    lam = torch.log(torch.exp(-torch.log(u) / (2.0 * _C)) - 1.0)
    return {
        "w_gate": dense_init(key, d, w, cfg),        # GeLU branch
        "w_x": dense_init(key, d, w, cfg),           # recurrent branch
        "conv_w": normal(key, (cfg.conv_width, w), pdt)
        / math.sqrt(cfg.conv_width),
        "conv_b": torch.zeros((w,), dtype=pdt, device=dev),
        "w_a": dense_init(key, w, w, cfg),
        "w_i": dense_init(key, w, w, cfg),
        "Lambda": lam,
        "w_out": dense_init(key, w, d, cfg),
    }


def _gates(p: Params, xi: torch.Tensor):
    """Returns (log_a (B,L,W) f32, gated_input (B,L,W) f32), W this
    rank's channels."""
    xf = xi.float()
    full = xi
    if p["w_a"]["w"].shape[0] != xi.shape[-1]:
        full = sharding.gather(xi, sharding.model_axis(), -1)
    r = torch.sigmoid(dense_apply(p["w_a"], full).float())
    i = torch.sigmoid(dense_apply(p["w_i"], full).float())
    lam = sharding.local_slice(p["Lambda"], xi.shape[-1])
    log_a = -_C * F.softplus(lam.float()) * r
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * (i * xf)
    return log_a, b


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv; returns (y, new_state (B, W-1, C))."""
    W = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return y + b.to(x.dtype), xp[:, -(W - 1):]


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 with h_{-1} = 0, by doubling:
    after the step of offset s each element holds the composition of the
    (up to) 2s steps ending at it, in log2(L) steps."""
    L = a.shape[1]
    s = 1
    while s < L:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def rglru_apply(p: Params, u: torch.Tensor, cfg: ModelConfig,
                cache: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """u (B, L, d). Cache = {"conv": (B, W-1, lru), "h": (B, lru) f32}."""
    B_, L, _ = u.shape
    gate = gelu(dense_apply(p["w_gate"], u))
    xi = dense_apply(p["w_x"], u)
    width = xi.shape[-1]                 # lru_width / M under TP

    conv_state = cache["conv"] if cache is not None else None
    xi, new_conv = _conv_causal(
        xi, sharding.local_slice(p["conv_w"], width),
        sharding.local_slice(p["conv_b"], width), conv_state)

    log_a, b = _gates(p, xi)

    if cache is not None and L == 1:
        h = cache["h"] * torch.exp(log_a[:, 0]) + b[:, 0]        # (B, W)
        y = h[:, None, :]
    else:
        h0 = cache["h"] if cache is not None else b.new_zeros((B_, width))
        # prepend h0 as a pseudo-step: h_t = a_t h_{t-1} + b_t
        a_all = torch.cat([torch.ones_like(h0)[:, None], torch.exp(log_a)],
                          dim=1)
        b_all = torch.cat([h0[:, None, :], b], dim=1)
        hs = linear_scan(a_all, b_all)
        y = hs[:, 1:]                                            # (B, L, W)
        h = hs[:, -1]
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h)

    out = _row_apply(p["w_out"], y.to(u.dtype) * gate)
    return out, cache


def rglru_cache_layout(batch: int, cfg: ModelConfig
                       ) -> Dict[str, CacheLeaf]:
    return {
        "conv": CacheLeaf((batch, cfg.conv_width - 1, cfg.lru_width),
                          _dtype(cfg)),
        "h": CacheLeaf((batch, cfg.lru_width), torch.float32),
    }


def rglru_cache_init(batch: int, cfg: ModelConfig, device=None) -> Params:
    return allocate(rglru_cache_layout(batch, cfg), device)
