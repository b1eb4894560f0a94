"""Residual blocks (the port of ``repro.models.blocks``): one sequence mixer
("attn" | "local" | "ssd" | "rglru") plus -- for attention and RG-LRU
blocks -- a (dense or MoE) MLP, with pre-norms and, where the config asks,
gemma-style sandwich post-norms.

Under tensor parallelism (``sharding.model_axis()``) the residual stream,
the norms and the residual adds hold this rank's L / M tokens: the
sequence is all-gathered after a pre-norm and the mixer's or the MLP's
row-parallel partial sums (attention, SSD, RG-LRU, dense MLP, the MoE's
combine over this rank's experts) are reduce-scattered back (in f32,
rounded once to the stream's dtype) before the post-norm; where the
sequence runs whole on every rank (``sharding.seq_axis()`` None: a
cache's prefill or decode of a length that does not split) they are
summed over ``model`` instead."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (AttnCacheSpec, CacheLeaf, allocate,
                                       attention_apply, attention_init,
                                       mlp_apply, mlp_init, rmsnorm_apply,
                                       rmsnorm_init)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.rglru import (rglru_apply, rglru_cache_layout,
                                      rglru_init)
from repro_torch.models.ssd import ssd_apply, ssd_cache_layout, ssd_init

Params = Dict[str, Any]


def _has_mlp(cfg: ModelConfig, kind: str) -> bool:
    if kind in ("attn", "local"):
        return cfg.d_ff > 0 or cfg.n_experts > 0
    if kind == "rglru":
        return cfg.d_ff > 0
    return False


def block_init(key: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    d, dev = cfg.d_model, key.device
    p: Params = {"ln1": rmsnorm_init(d, cfg, dev)}
    if kind in ("attn", "local"):
        p["attn"] = attention_init(key, cfg)
    elif kind == "ssd":
        p["ssd"] = ssd_init(key, cfg)
    elif kind == "rglru":
        p["rec"] = rglru_init(key, cfg)
    else:
        raise ValueError(kind)
    if cfg.post_norms:
        p["post_ln1"] = rmsnorm_init(d, cfg, dev)
    if _has_mlp(cfg, kind):
        p["ln2"] = rmsnorm_init(d, cfg, dev)
        if cfg.n_experts and kind in ("attn", "local"):
            p["moe"] = moe_init(key, cfg)
        else:
            p["mlp"] = mlp_init(key, cfg)
        if cfg.post_norms:
            p["post_ln2"] = rmsnorm_init(d, cfg, dev)
    return p


def block_apply(p: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, kind: str, cache: Optional[Params] = None,
                cut: bool = False
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (x, new_cache, aux_loss). ``cut``: whether an attention
    cache's length is cut over ``model`` (``sharding.length_cut``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = sharding.seq_gather(rmsnorm_apply(p["ln1"], x, cfg.rms_eps))
    if kind in ("attn", "local"):
        h, new_cache = attention_apply(p["attn"], h, positions, cfg, kind,
                                       cache, cut=cut)
    elif kind == "ssd":
        h, new_cache = ssd_apply(p["ssd"], h, cfg, cache)
    else:  # rglru
        h, new_cache = rglru_apply(p["rec"], h, cfg, cache)
    h = sharding.seq_scatter(h, x.dtype)
    if cfg.post_norms:
        h = rmsnorm_apply(p["post_ln1"], h, cfg.rms_eps)
    x = sharding.constrain(x + h, "batch", "model", None)

    if _has_mlp(cfg, kind):
        h = sharding.seq_gather(rmsnorm_apply(p["ln2"], x, cfg.rms_eps))
        if "moe" in p:
            h, aux = moe_apply(p["moe"], h, cfg)
        else:
            h = mlp_apply(p["mlp"], h, cfg)
        h = sharding.seq_scatter(h, x.dtype)
        if cfg.post_norms:
            h = rmsnorm_apply(p["post_ln2"], h, cfg.rms_eps)
        x = sharding.constrain(x + h, "batch", "model", None)
    return x, new_cache, aux


def block_cache_layout(batch: int, max_len: int, cfg: ModelConfig,
                       kind: str) -> Dict[str, CacheLeaf]:
    """One layer's cache as shapes, dtypes and fill values, nothing
    allocated."""
    if kind == "attn":
        return AttnCacheSpec(max_len).layout(batch, cfg)
    if kind == "local":
        return AttnCacheSpec(min(cfg.window, max_len)).layout(batch, cfg)
    if kind == "ssd":
        return ssd_cache_layout(batch, cfg)
    if kind == "rglru":
        return rglru_cache_layout(batch, cfg)
    raise ValueError(kind)


def block_cache_init(batch: int, max_len: int, cfg: ModelConfig, kind: str,
                     device=None, grid=None) -> Params:
    """An empty cache of one layer: zeros, every slot's ``pos`` -1. On a
    ``grid`` this rank's shard of it under ``sharding.cache_specs``,
    allocated at the shard's shape (the whole cache's shapes are read
    from its layout, never allocated)."""
    layout = block_cache_layout(batch, max_len, cfg, kind)
    if grid is not None:
        specs = sharding.cache_specs(layout, grid)
        layout = {k: dataclasses.replace(v, shape=sharding.shard_shape(
            v.shape, specs[k], grid)) for k, v in layout.items()}
    return allocate(layout, device)
