"""Training launcher (the port of ``repro.launch.train``), on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1 \\
        [--device cpu] [--mesh 2x1]

Features: an arbitrary (data, model) mesh of ranks, resume from the
latest checkpoint, async checkpointing, heartbeat for the fault-tolerance
supervisor, failure injection (REPRO_FAIL_AT_STEP), and coreset-based data
selection (--data-selection coreset) -- the paper's technique in the
training data plane, on the port's kernels.

The mesh. ``1x1`` runs in this process. ``DxM`` with more than one rank
starts D x M ranks through ``repro_torch.core.mesh.launch`` as a
(data, model) ``MeshGrid`` (gloo on the CPU and where ranks share a card,
nccl where each rank has its own) and runs the train step under the
reference's default layout (``models.sharding``, "tp"): tensor and
sequence parallelism over ``model``, FSDP over ``data``, the batch over
``data`` (``train_step.mesh_train_step``). Every rank starts from
``init_params(0, cfg)`` (or the caller's state, or the checkpoint) cut to
its shards, so every mesh starts from the 1x1 run's bits; the ranks of a
``model`` group share their data row's B / D rows of every batch. On
``Dx1`` the D ranks compute what one process computes on the same global
batch with D microbatches, bit for bit. Rank 0 alone writes checkpoints
(full leaves, gathered), the heartbeat and the metrics; a rank's failure
makes ``main`` raise (a non-zero exit, which the ``Supervisor``
restarts). Every family runs on any mesh whose widths split (attention
heads need not: every rank then runs every head); one whose ``d_ff``,
SSD heads, RG-LRU width, padded vocab or sequence do not split over M
(``sharding.check_model``) raises before any rank starts, naming the
width.

Batches come from ``BigramLM``, whose key hashes a string as the JAX
package's does, and Python salts that hash per process: runs in two
processes (a restart, the ranks) draw the same batches only under one
PYTHONHASHSEED. The ranks get the parent's, or 0 where it has none.

``main(argv, state=(params, opt_state))`` starts from the caller's state
in place of ``init_params(0, cfg)`` and ``adamw.init`` (a checkpoint to
resume from still wins): the tests carry the reference's across with
``repro_torch.interop``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch

from repro_torch import configs
from repro_torch import tree as tree_mod
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.core import prng
from repro_torch.data import (BigramLM, embed_examples, gather_selected,
                              select_coreset)
from repro_torch.launch.ft import Heartbeat
from repro_torch.launch.mesh import run_device, where
from repro_torch.models import init_params, sharding
from repro_torch.models.model import shard_specs
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.train_step import mesh_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b", choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) config")
    ap.add_argument("--width", type=int, default=0,
                    help="override d_model/d_ff scale for ~100M runs")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL, e.g. 2x2: that many ranks, FSDP "
                         "over DATA, tensor and sequence parallel over "
                         "MODEL")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--heartbeat", default="")
    ap.add_argument("--data-selection", choices=["none", "coreset"],
                    default="none")
    ap.add_argument("--selection-pool", type=int, default=512,
                    help="candidate pool size per selection round")
    ap.add_argument("--selection-frac", type=float, default=0.25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def build_cfg(args):
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    if args.width:
        cfg = dataclasses.replace(
            cfg, d_model=args.width,
            d_ff=args.width * 4 if cfg.d_ff else 0,
            head_dim=max(args.width // max(cfg.n_heads, 1), 8)
            if cfg.n_heads else 0,
            lru_width=args.width if cfg.lru_width else 0)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def mesh_shape(spec: str):
    """``DxM`` as (D, M)."""
    try:
        data, model = (int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r} is not DATAxMODEL, e.g. 2x2"
                         ) from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {spec}: sizes must be positive")
    return data, model


def main(argv=None, *, state=None):
    args = parse_args(argv)
    data_ways, model_ways = mesh_shape(args.mesh)
    ranks = data_ways * model_ways
    dev = run_device(args.device)
    cfg = build_cfg(args)
    if ranks == 1:
        return _train(args, cfg, dev, state)
    if args.batch % (data_ways * args.microbatches):
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{data_ways} data ranks in {args.microbatches} "
                         f"microbatches")
    sharding.check_model(cfg, model_ways, args.seq)
    from repro_torch.core.mesh import launch
    if state is not None:
        state = tree_mod.map(lambda x: x.detach().cpu(), state)
    own = dev.type == "cuda" and dev.index is None \
        and torch.cuda.device_count() >= ranks
    with _hash_seed():
        out = launch("repro_torch.launch.train:_rank", ranks,
                     (vars(args), cfg, state), axis_name=("data", "model"),
                     shape=(data_ways, model_ways),
                     backend="nccl" if own else "gloo",
                     device=None if own else dev, timeout=24 * 3600.0)
    return out[0]


@contextlib.contextmanager
def _hash_seed():
    """PYTHONHASHSEED for the ranks: every rank draws the same batches."""
    had = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = had or "0"
    try:
        yield
    finally:
        if had is None:
            del os.environ["PYTHONHASHSEED"]


def _rank(mesh, args: dict, cfg, state):
    """One rank of a ``DxM`` run (``core.mesh.launch``'s target), on the
    parent's config."""
    if state is not None:
        state = tree_mod.map(lambda x: x.to(mesh.device), state)
    return _train(argparse.Namespace(**args), cfg, mesh.device, state, mesh)


def _train(args, cfg, dev, state=None, mesh=None):
    rank = 0 if mesh is None else mesh.rank
    tc = TrainConfig(peak_lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 20, 5),
                     microbatches=args.microbatches, remat="full")

    params, opt_state = (init_params(0, cfg, dev), None) if state is None \
        else state
    specs = state_specs = None
    if mesh is not None:
        specs = shard_specs(cfg, mesh)
        state_specs = [specs, {"m": specs, "v": specs, "step": ()}]
        params = sharding.shard(params, specs, mesh)
        if opt_state is not None:
            opt_state = sharding.shard(opt_state, state_specs[1], mesh)
    if opt_state is None:
        opt_state = adamw.init(params)
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        if mesh is not None or rank == 0:
            ckpt = AsyncCheckpointer(args.ckpt_dir, keep_last=3, mesh=mesh,
                                     specs=state_specs)
        if latest_step(args.ckpt_dir) is not None:
            (params, opt_state), start_step = restore(
                args.ckpt_dir, target=(params, opt_state), specs=state_specs,
                mesh=mesh)
            if rank == 0:
                print(f"[train] resumed from step {start_step}")

    step_fn = (make_train_step(cfg, tc) if mesh is None
               else mesh_train_step(cfg, tc, mesh))
    data = BigramLM(cfg.vocab_size, device=dev)
    hb = Heartbeat(args.heartbeat) if args.heartbeat and rank == 0 else None
    fail_at = int(os.environ.get("REPRO_FAIL_AT_STEP", "-1"))
    data_ways = 1 if mesh is None else mesh.shape["data"]
    with sharding.set_mesh(mesh):
        rows = sharding.batch_rows(args.batch, args.microbatches)

    sel_batches = None
    if args.data_selection == "coreset":
        table = params["embed"]["table"]
        if mesh is not None:
            table = sharding.unshard_leaf(table, specs["embed"]["table"],
                                          mesh)
        sel_batches = _coreset_pool(args, cfg, table, data_ways, data, dev,
                                    verbose=rank == 0)
        del table

    if rank == 0:
        ways = 1 if mesh is None else mesh.size
        print(f"[train] {ways} rank(s) on {where(dev)}", flush=True)
    metrics_log = []
    t_last = time.time()
    for step in range(start_step, args.steps):
        if step == fail_at:
            print(f"[train] INJECTED FAILURE at step {step}", flush=True)
            os._exit(42)
        if sel_batches is not None:
            batch = sel_batches[step % len(sel_batches)]
        else:
            batch = data.batch(step, args.batch, args.seq)
        batch = {k: v[rows] for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        if hb:
            hb.beat(step)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t_last
            t_last = time.time()
            if rank == 0:
                print(f"[train] step={step} loss={m['loss']:.4f} "
                      f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.3f} "
                      f"lr={m['lr']:.2e} ({dt:.2f}s)", flush=True)
            metrics_log.append({"step": step, **m})
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state))
    if ckpt:
        ckpt.save(args.steps, (params, opt_state))
        ckpt.wait()
        ckpt.close()
    if args.metrics_out and rank == 0:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_log, f)
    if rank == 0:
        print("[train] done")
    return metrics_log


def _coreset_pool(args, cfg, table, data_ways, data, dev, verbose=True):
    """Build a coreset-selected training set from a candidate pool
    (Algorithm 1 over example embeddings on the port's kernels; see
    repro_torch.data.selection), the embedding ``table`` whole. The
    labels are gathered by the selected indices, beside the tokens."""
    n_sites = max(data_ways, 2)
    pool = data.batch(10_000_019, args.selection_pool, args.seq)
    per = args.selection_pool // n_sites
    site = {k: v[:per * n_sites].reshape(n_sites, per, -1)
            for k, v in pool.items()}
    emb = embed_examples(table, site["tokens"], device=dev)
    mask = torch.ones(emb.shape[:2], dtype=torch.bool, device=dev)
    t = max(int(args.selection_frac * per * n_sites), 8)
    sel = select_coreset(prng.PRNGKey(1, device=dev), emb, mask, k=8, t=t,
                         device=dev)
    chosen = gather_selected(site["tokens"], sel)
    keep = chosen["weights"] > 0
    sel_toks = chosen["tokens"][keep]
    sel_labs = gather_selected(site["labels"], sel)["tokens"][keep]
    if verbose:
        print(f"[train] coreset selection kept {int(keep.sum())} / "
              f"{args.selection_pool} examples "
              f"(comm: {n_sites} scalars + selection)")
    batches = []
    B = args.batch
    for i in range(max(len(sel_toks) // B, 1)):
        sl = slice(i * B, (i + 1) * B)
        if len(sel_toks[sl]) < B:
            break
        batches.append({"tokens": sel_toks[sl], "labels": sel_labs[sl]})
    return batches or None


if __name__ == "__main__":
    main()
