"""Training step factory (the port of ``repro.train.train_step``):
microbatched gradient accumulation, remat, global-norm clip, AdamW and the
warmup-cosine schedule.

``make_train_step(cfg, tc)`` returns ``(params, opt_state, batch, step) ->
(params, opt_state, metrics)``. With ``grad_sync`` the step hands the
gradients and the loss metrics to it before the clip and the update, and
goes on with what it returns: ``launch.train`` averages them over the
ranks of a data-parallel mesh there. The metrics it is handed carry each
microbatch's ce as well (``CE_MICROBATCHES``), and the step takes
``ppl_proxy`` from what comes back: exp(min(ce, 20)) of each
microbatch's ce, averaged over the microbatches, as the JAX package's
global step does (the mean of the batch shards' exp(ce) would be
another number). Gradients come from ``torch.autograd``
through the port's ``forward``; the step then updates the params and the
optimizer state in place and returns the same objects -- the counterpart
of the JAX package's ``donate_argnums=(0, 1)``, without which a second
copy of params and moments would have to fit beside the first.

``mesh_train_step(cfg, tc, mesh, layout)`` is the step on a grid of ranks
(``core.mesh.MeshGrid``), the counterpart of the JAX package's jitted step
under ``set_mesh``: params and AdamW state are this rank's shards under
``models.shard_specs``, the batch this rank's rows
(``sharding.batch_rows``), and the model runs its layout's collectives
(``models.sharding``). Before the update each gradient is summed over
the ranks that computed parts of it and divided by the number of batch
shards (:func:`_mesh_sync`), and the global norm is reduced over the
ranks (:func:`_mesh_norm`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.models import forward, make_positions, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import shard_specs
from repro_torch.optim import adamw, schedule
from repro_torch.train.loss import chunked_lm_loss, lm_loss

PyTree = Any
METRICS = ("ce", "z_loss", "ppl_proxy", "loss", "moe_aux")
# the (microbatches,) ce that ``grad_sync`` is handed beside the metrics
CE_MICROBATCHES = "ce_microbatches"


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
        name = "embed" if cfg.tie_embeddings else "lm_head"
        specs = shard_specs(cfg)
        head_p = sharding.gather_params(params[name],
                                        specs and specs[name])
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


def make_train_step(cfg: ModelConfig, tc: TrainConfig, grad_sync=None,
                    grad_norm=adamw.global_norm):
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
            ces = [metrics["ce"]]
        else:
            mb_tok = tokens.reshape(n_mb, B // n_mb, -1)
            mb_lab = labels.reshape(n_mb, B // n_mb, -1)
            # the JAX package's scan: sum into zeros of acc_dtype, in order
            acc_dtype = torch.bfloat16 if tc.bf16_params else torch.float32
            grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for p in tree_mod.leaves(params)]
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=tokens.device) for k in METRICS}
            ces = []
            for i in range(n_mb):
                (_, m), g = value_and_grad(params, mb_tok[i], mb_lab[i], cfg,
                                           tc)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                metrics = {k: metrics[k] + m[k] for k in METRICS}
                ces.append(m["ce"])
            for acc in grads:
                acc.div_(n_mb)
            metrics = {k: v / n_mb for k, v in metrics.items()}
        if grad_sync is not None:
            grads, metrics = grad_sync(
                grads, {**metrics, CE_MICROBATCHES: torch.stack(ces)})
            metrics["ppl_proxy"] = _ppl_proxy(metrics.pop(CE_MICROBATCHES))

        lr = schedule.warmup_cosine(step, tc.peak_lr, tc.warmup_steps,
                                    tc.total_steps, device=tokens.device)
        params, opt_state, opt_metrics = adamw.update(
            grads, opt_state, params, lr, tc.adamw, grad_norm)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def _ppl_proxy(ces: torch.Tensor) -> torch.Tensor:
    """exp(min(ce, 20)) of each microbatch's ce, averaged as the step
    averages its metrics (summed from zero in order, then divided)."""
    ppl = torch.exp(torch.clamp_max(ces, 20.0))
    if len(ppl) == 1:
        return ppl[0]
    total = torch.zeros((), dtype=torch.float32, device=ces.device)
    for x in ppl:
        total = total + x
    return total / len(ppl)


def mesh_train_step(cfg: ModelConfig, tc: TrainConfig, mesh,
                    layout: str = "tp"):
    """``make_train_step`` on the grid ``mesh`` under ``layout``: the
    returned ``(params, opt_state, batch, step)`` takes this rank's shards
    and batch rows, runs with the mesh bound, and updates the shards in
    place. Raises ValueError where the layout cannot run ``cfg``
    (``sharding.check_model``)."""
    sharding.check_model(cfg, mesh.shape.get("model", 1), layout=layout)
    specs = sharding.spec_leaves(shard_specs(cfg, mesh, layout))
    step = make_train_step(cfg, tc, _mesh_sync(specs, mesh, layout),
                           _mesh_norm(specs, mesh, layout))

    def run(params, opt_state, batch, i):
        with sharding.set_mesh(mesh, layout):
            return step(params, opt_state, batch, i)

    return run


def _sum_axes(spec, mesh, layout):
    """The axes over which a leaf's gradient is still to be summed: the
    batch axes, and under "tp" the model axis where the leaf is
    replicated over it (each rank's part is partial), less the axes its
    FSDP gather already summed over in the backward."""
    batch = sharding.resolve("batch", mesh, layout)
    axes = set((batch,) if isinstance(batch, str) else batch)
    if layout == "tp" and "model" not in spec:
        axes.add("model")
    axes -= sharding.cut_axes(spec, fsdp_only=True)
    return tuple(n for n in mesh.axis_names
                 if n in axes and mesh.shape[n] > 1)


def _reduce(tensors, axes, n_batch):
    """Each tensor summed over its axes (``axes[i]``: a ``core.mesh`` axis
    or None) in rank order, then divided by ``n_batch``: one all-gather
    per axis and dtype."""
    out = list(tensors)
    groups = {}
    for i, (t, ax) in enumerate(zip(out, axes)):
        if ax is not None:
            groups.setdefault((id(ax), t.dtype), (ax, []))[1].append(i)
    for ax, idx in groups.values():
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        summed = ax.all_gather(flat, kind="all-reduce").sum(0)
        for i, piece in zip(idx, summed.split([out[i].numel()
                                               for i in idx])):
            out[i] = piece.reshape(out[i].shape)
    return [t / n_batch for t in out]


def _mesh_sync(specs, mesh, layout):
    """``grad_sync`` on the grid: each gradient summed over
    :func:`_sum_axes`, every gradient and loss metric divided by the
    number of batch shards (the metrics, replicated over any other axis,
    averaged over the batch axis, in one all-gather) -- what one process
    computes on the global batch. Each microbatch's ce
    (``CE_MICROBATCHES``) is averaged the same way, so the step's
    ``ppl_proxy`` is exp of the global ce, as the JAX package's."""
    batch_ax = sharding.axis_of(mesh, sharding.resolve("batch", mesh,
                                                        layout))
    n_batch = batch_ax.size
    batch_ax = batch_ax if n_batch > 1 else None
    names = [_sum_axes(s, mesh, layout) for s in specs]
    axes = [sharding.axis_of(mesh, n) if n else None for n in names]

    def sync(grads, metrics):
        keys = sorted(metrics)
        grads = _reduce(grads, axes, n_batch)
        got = _reduce([metrics[k] for k in keys], [batch_ax] * len(keys),
                      n_batch)
        return grads, dict(zip(keys, got))

    return sync


def _mesh_norm(specs, mesh, layout):
    """The global norm of the gradients' shards: each leaf's sum of
    squares taken from it gathered over its FSDP axes (bit for bit the
    term one process computes), the terms of a leaf sharded over
    ``model`` summed over it in rank order, the leaves added in
    flattening order -- the same norm on every rank."""
    model = (mesh.axes["model"] if layout == "tp" and
             mesh.shape.get("model", 1) > 1 else None)
    tp = torch.tensor(["model" in s for s in specs])

    def norm(leaves):
        terms = torch.stack([
            torch.sum(torch.square(sharding.gather_params(g, s).to(
                torch.float32))) for g, s in zip(leaves, specs)])
        if model is not None:
            every = model.all_gather(terms, kind="all-reduce")
            terms = torch.where(tp.to(terms.device), every.sum(0),
                                every[model.rank])
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        return torch.sqrt(total)

    return norm


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
