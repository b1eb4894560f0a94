"""Training launcher (the port of ``repro.launch.train``), on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1 \\
        [--device cpu] [--mesh 2x1]

Features: data parallelism over ``--mesh Dx1`` ranks, resume from the
latest checkpoint, async checkpointing, heartbeat for the fault-tolerance
supervisor, failure injection (REPRO_FAIL_AT_STEP), and coreset-based data
selection (--data-selection coreset) -- the paper's technique in the
training data plane, on the port's kernels.

The mesh. ``1x1`` runs in this process. ``Dx1`` with D > 1 starts D ranks
through ``repro_torch.core.mesh.launch`` (gloo on the CPU and where ranks
share a card, nccl where each rank has its own). Each rank runs the whole
model on its B / D rows of every batch, and the train step averages the
gradients and the loss metrics over the ranks before the clip and the
update (``make_train_step``'s ``grad_sync``: one all-gather per dtype,
summed in rank order), so the D ranks compute what one process computes
on the same global batch with D microbatches. Rank 0 alone writes
checkpoints, the heartbeat and the metrics; a rank's failure makes
``main`` raise (a non-zero exit, which the ``Supervisor`` restarts).
``DxM`` with M > 1 raises: the port has no tensor parallelism.

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
from repro_torch.models import init_params
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, make_train_step


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
                    help="DATAxMODEL: Dx1 runs D data-parallel ranks; "
                         "MODEL > 1 raises (no tensor parallelism)")
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
    """``DxM`` as (D, M); M > 1 raises."""
    try:
        data, model = (int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r} is not DATAxMODEL, e.g. 2x1"
                         ) from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {spec}: sizes must be positive")
    if model > 1:
        raise ValueError(
            f"--mesh {spec}: the port has no tensor parallelism -- each "
            f"rank runs the whole model (models/sharding.py) -- so the "
            f"model axis must be 1; use --mesh {data * model}x1 for "
            f"data parallelism")
    return data, model


def main(argv=None, *, state=None):
    args = parse_args(argv)
    data_ways, _ = mesh_shape(args.mesh)
    dev = run_device(args.device)
    cfg = build_cfg(args)
    if data_ways == 1:
        return _train(args, cfg, dev, state)
    if args.batch % data_ways:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{data_ways} ranks")
    from repro_torch.core.mesh import launch
    if state is not None:
        state = tree_mod.map(lambda x: x.detach().cpu(), state)
    own = dev.type == "cuda" and dev.index is None \
        and torch.cuda.device_count() >= data_ways
    with _hash_seed():
        out = launch("repro_torch.launch.train:_rank", data_ways,
                     (vars(args), cfg, state), axis_name="data",
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
    """One rank of a ``Dx1`` run (``core.mesh.launch``'s target), on the
    parent's config."""
    if state is not None:
        state = tree_mod.map(lambda x: x.to(mesh.device), state)
    return _train(argparse.Namespace(**args), cfg, mesh.device, state, mesh)


def mean_over(mesh):
    """``grad_sync`` of a data-parallel mesh: every rank's gradients and
    loss metrics averaged, one all-gather per dtype summed in rank order,
    so every rank gets the same bits."""
    def average(tensors):
        out = list(tensors)
        for dtype in sorted({t.dtype for t in out}, key=str):
            idx = [i for i, t in enumerate(out) if t.dtype == dtype]
            flat = torch.cat([out[i].reshape(-1) for i in idx])
            mean = mesh.all_gather(flat).sum(0) / mesh.size
            for i, piece in zip(idx, mean.split([out[i].numel()
                                                 for i in idx])):
                out[i] = piece.reshape(out[i].shape)
        return out

    def sync(grads, metrics):
        names = sorted(metrics)
        got = average(list(grads) + [metrics[k] for k in names])
        return got[:len(grads)], dict(zip(names, got[len(grads):]))

    return sync


def _train(args, cfg, dev, state=None, mesh=None):
    rank = 0 if mesh is None else mesh.rank
    ways = 1 if mesh is None else mesh.size
    tc = TrainConfig(peak_lr=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 20, 5),
                     microbatches=args.microbatches, remat="full")

    if state is None:
        params = init_params(0, cfg, dev)
        opt_state = adamw.init(params)
    else:
        params, opt_state = state
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        if rank == 0:
            ckpt = AsyncCheckpointer(args.ckpt_dir, keep_last=3)
        if latest_step(args.ckpt_dir) is not None:
            (params, opt_state), start_step = restore(
                args.ckpt_dir, target=(params, opt_state))
            if rank == 0:
                print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, tc, None if mesh is None
                              else mean_over(mesh))
    data = BigramLM(cfg.vocab_size, device=dev)
    hb = Heartbeat(args.heartbeat) if args.heartbeat and rank == 0 else None
    fail_at = int(os.environ.get("REPRO_FAIL_AT_STEP", "-1"))
    rows = slice(rank * args.batch // ways, (rank + 1) * args.batch // ways)

    sel_batches = None
    if args.data_selection == "coreset":
        sel_batches = _coreset_pool(args, cfg, params, ways, data, dev,
                                    verbose=rank == 0)

    if rank == 0:
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


def _coreset_pool(args, cfg, params, data_ways, data, dev, verbose=True):
    """Build a coreset-selected training set from a candidate pool
    (Algorithm 1 over example embeddings on the port's kernels; see
    repro_torch.data.selection). The labels are gathered by the selected
    indices, beside the tokens."""
    n_sites = max(data_ways, 2)
    pool = data.batch(10_000_019, args.selection_pool, args.seq)
    per = args.selection_pool // n_sites
    site = {k: v[:per * n_sites].reshape(n_sites, per, -1)
            for k, v in pool.items()}
    emb = embed_examples(params["embed"]["table"], site["tokens"],
                         device=dev)
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
