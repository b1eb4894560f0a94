"""Language model (the port of ``repro.models.model``): embedding -> the
blocks of the pattern, layer by layer -> final norm -> (tied or untied) LM
head.

Params are ``{"embed", "final_norm"[, "lm_head"], "layers": [...]}`` with
one dict per layer in depth order; layer ``i`` is of kind
``cfg.pattern[i % cfg.period]`` (the ``n_layers % period`` remainder blocks
continue the pattern). The JAX package stacks the same layers by period
and run; ``repro_torch.interop.model_params`` carries them across. A cache
is a list with one dict per layer, written in place by :func:`forward`.

On a grid of ranks (``sharding.set_mesh`` of a ``core.mesh.MeshGrid``)
``params`` are this rank's shards under :func:`shard_specs`: each
block's are all-gathered over their FSDP axes inside the block (under
``remat="full"`` again in its backward, so no gathered copy outlives its
block), and under tensor parallelism the embedding, the blocks and the
head run as ``models.layers`` and ``models.blocks`` say, the hidden
state gathered back to the whole sequence before the head. Tensor
parallelism covers every family -- attention, dense and MoE MLPs
(experts split over ``model``), SSD and RG-LRU mixers -- where its widths
split (``sharding.check_model``; attention heads that do not split run
whole on every rank), in training, scoring, prefill and decode. The params come in the layout ``specs`` names: by default the
training layout's :func:`shard_specs` (FSDP over ``data``); a caller
whose params are laid out otherwise passes its spec tree (the serving
cells of ``launch.specs``: bf16, replicated over ``data``), and only the
dims it cuts over ``data`` are gathered. Prefill and decode on a grid
take a ``sharding.GridCache`` (:func:`init_cache` under the bound grid:
the JAX package's serving layout, ``sharding.cache_specs``) and this
rank's rows of the batch; the logits are this rank's vocab slice, as in
training.

Works in three modes:
  * train/score:   forward(params, tokens, positions)          -> logits
  * prefill:       forward(..., cache=init_cache(...))         -> logits, cache
  * decode:        forward with L == 1 and a cache             -> logits, cache
"""
from __future__ import annotations

import functools
import types
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_mod
from repro_torch.models import sharding
from repro_torch.models.blocks import (block_apply, block_cache_init,
                                       block_cache_layout, block_init)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embedding_apply, embedding_init,
                                       lm_head_apply, rmsnorm_apply,
                                       rmsnorm_init)

Params = Dict[str, Any]
Cache = List[Params]
KeyLike = Union[int, torch.Generator]
DeviceLike = Union[str, torch.device, None]


def _device(device: DeviceLike) -> torch.device:
    # imported here: ``repro_torch.core`` imports the roofline layer, which
    # imports this package for its config
    from repro_torch.core.backend import resolve_device
    return resolve_device(device)


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """The mixer kind of each layer, in depth order."""
    return tuple(cfg.pattern[i % cfg.period] for i in range(cfg.n_layers))


class _Shapes:
    """Stands in for a generator where only shapes are wanted
    (:func:`param_spec`): every draw is an empty meta tensor."""

    device = torch.device("meta")


def init_params(key: KeyLike, cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    """Random parameters: dense weights ``normal / sqrt(d_in)``, embeddings
    ``0.02 * normal``, norms ones, and the SSD and RG-LRU inits of the JAX
    package, in ``cfg.param_dtype``. ``key`` is a seed (drawn on the target
    device) or a ``torch.Generator`` (drawn on its device, then moved), so
    one CPU generator gives the same params on every device."""
    cfg.validate()
    dev = _device(device)
    gen = key if isinstance(key, (torch.Generator, _Shapes)) else \
        torch.Generator(device=dev).manual_seed(int(key))
    params: Params = {
        "embed": embedding_init(gen, cfg),
        "final_norm": rmsnorm_init(cfg.d_model, cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embedding_init(gen, cfg)
    params["layers"] = [block_init(gen, cfg, kind)
                        for kind in layer_kinds(cfg)]
    return tree_mod.map(lambda x: x.to(dev), params)


def param_spec(cfg: ModelConfig) -> Params:
    """The params' shapes and dtypes, nothing drawn or allocated (meta
    tensors): the counterpart of ``jax.eval_shape`` of ``init_params``."""
    return init_params(_Shapes(), cfg, "meta")


def shard_specs(cfg: ModelConfig, mesh=None, layout: Optional[str] = None):
    """``sharding.param_specs`` of ``cfg``'s params on ``mesh`` (default:
    the bound grid, None where no grid of more than one rank is bound),
    under ``layout`` (default: the bound one). Cached: do not modify."""
    mesh = mesh if mesh is not None else sharding.bound_grid()
    if mesh is None:
        return None
    names = sharding._axis_names(mesh)
    return _specs(cfg, names, tuple(mesh.shape[n] for n in names),
                  layout or sharding.current_layout())


@functools.lru_cache(maxsize=16)
def _specs(cfg, names, sizes, layout):
    shape = types.SimpleNamespace(axis_names=names,
                                  shape=dict(zip(names, sizes)))
    return sharding.param_specs(param_spec(cfg), shape, layout)


def _block(p, specs, x, positions, cfg, kind, cache, cut):
    """One block on this rank's shards ``p``: their FSDP dims gathered."""
    return block_apply(sharding.gather_params(p, specs), x, positions, cfg,
                       kind, cache, cut)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Cache:
    """An empty cache for ``batch`` rows of up to ``max_len`` tokens. On a
    bound grid (layout "tp") a ``sharding.GridCache``: this rank's shards
    of it under ``sharding.cache_specs``."""
    dev = _device(device)
    grid = sharding.bound_grid()
    kinds = layer_kinds(cfg)
    if grid is None:
        return [block_cache_init(batch, max_len, cfg, kind, dev)
                for kind in kinds]
    if sharding.current_layout() != "tp":
        raise ValueError("a cache on a grid is laid out under layout 'tp'")
    full = [block_cache_layout(batch, max_len, cfg, kind) for kind in kinds]
    return sharding.GridCache(
        [block_cache_init(batch, max_len, cfg, kind, dev, grid)
         for kind in kinds], sharding.cache_specs(full, grid))


def cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> Cache:
    """The cache's shapes and dtypes, nothing allocated (meta tensors);
    on a bound grid this rank's shards'."""
    return init_cache(cfg, batch, max_len, device="meta")


def forward(params: Params, tokens: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig, cache: Optional[Cache] = None,
            remat: str = "none", head: bool = True, specs=None
            ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Returns (logits (B, L, vocab_padded) f32, cache | None, aux). With
    ``head=False`` the first element is the normalized hidden state
    (B, L, d) instead (the chunked-CE loss applies the head itself). With
    ``remat="full"`` each block's activations are recomputed in the
    backward instead of kept. ``specs``: the params' spec tree on the
    bound grid (default :func:`shard_specs`, the training layout)."""
    if remat not in ("none", "full"):
        raise ValueError(f"remat is 'none' or 'full', got {remat!r}")
    tp = sharding.model_axis()
    whole = False
    if tp is not None:
        # a cache's prompt that does not split runs whole on every rank
        whole = cache is not None and tokens.shape[1] % tp.size != 0
        sharding.check_model(cfg, tp.size,
                             None if whole else tokens.shape[1])
    with sharding.whole_sequence(whole):
        return _forward(params, tokens, positions, cfg, cache, remat, head,
                        shard_specs(cfg) if specs is None else specs, tp)


def _forward(params, tokens, positions, cfg, cache, remat, head, specs, tp):
    sub = (lambda k: None) if specs is None else specs.__getitem__
    x = embedding_apply(sharding.gather_params(params["embed"], sub("embed")),
                        tokens, cfg)
    x = sharding.constrain(x, "batch", "model", None)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    recompute = remat == "full" and torch.is_grad_enabled()
    for i, kind in enumerate(layer_kinds(cfg)):
        c = None if cache is None else cache[i]
        cut = (tp is not None and c is not None
               and kind in ("attn", "local") and sharding.length_cut(cache, i))
        spec_i = None if specs is None else specs["layers"][i]
        if recompute:
            x, _, a = checkpoint(_block, params["layers"][i], spec_i, x,
                                 positions, cfg, kind, c, cut,
                                 use_reentrant=False)
        else:
            x, _, a = _block(params["layers"][i], spec_i, x, positions, cfg,
                             kind, c, cut)
        aux_total = aux_total + a

    x = sharding.seq_gather(rmsnorm_apply(params["final_norm"], x,
                                          cfg.rms_eps))
    if not head:
        return x, cache, aux_total
    name = "embed" if cfg.tie_embeddings else "lm_head"
    head_p = sharding.gather_params(params[name], sub(name))
    logits = lm_head_apply(head_p, x, cfg)
    logits = sharding.constrain(logits, "batch", None, "model")
    return logits, cache, aux_total


def make_positions(tokens: torch.Tensor, cfg: ModelConfig,
                   offset: Union[torch.Tensor, int] = 0) -> torch.Tensor:
    """Default position ids (int32). (B, L) for standard RoPE; (B, 3, L)
    with identical t/h/w ids for M-RoPE text-only inputs."""
    B, L = tokens.shape
    pos = torch.arange(L, dtype=torch.int32, device=tokens.device)[None] \
        + offset
    pos = pos.to(torch.int32).expand(B, L)
    if cfg.mrope_sections is not None:
        pos = pos[:, None, :].expand(B, 3, L)
    return pos
