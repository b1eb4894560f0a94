"""How far a tensor-parallel forward's loss lies from one process's in bf16.

Each ``--arch`` (default llama3-8b) at its published widths cut to its
``--layers`` layers, ``--batch`` rows of ``--seq`` tokens per batch (2 x
2,048 by default), on ``--batches`` bigram batches: the loss of the
port's ``train_step.loss_fn`` in one process and on a 1x2 (data, model)
mesh of two gloo ranks sharing the card (tensor and sequence parallel;
the MoE expert parallel), and the relative difference per batch. Prints
the card's name and power limit, then one JSON line per architecture.

    PYTHONHASHSEED=0 PYTHONPATH=src python scripts/torch_tp_loss_spread.py \\
        [--batches 24] [--arch llama3_8b] [--layers 2] [--device cpu]

Several architectures at once: ``--arch granite_moe_3b_a800m,mamba2_370m,
recurrentgemma_2b --layers 2,4,3 --seq 1024`` (one layer count each). On
the CPU pass ``--device cpu`` (and small ``--width`` and ``--seq``: at the
published widths llama3-8b's params alone take 6 GB).
"""
import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def losses(device, args, mesh=None):
    """The forward loss of each batch, on ``mesh`` when one is given."""
    from repro_torch.data import BigramLM
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params, sharding
    from repro_torch.models.model import shard_specs
    from repro_torch.train import TrainConfig, train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    argv = ["--arch", args.arch, "--layers", str(args.layers)]
    if args.width:
        argv += ["--width", str(args.width)]
    cfg = launch_train.build_cfg(launch_train.parse_args(argv))
    params = init_params(0, cfg, device)
    if mesh is not None:
        params = sharding.shard(params, shard_specs(cfg, mesh), mesh)
    data = BigramLM(cfg.vocab_size, device=device)
    out = []
    with sharding.set_mesh(mesh), torch.no_grad():
        for s in range(args.batches):
            b = data.batch(s, args.batch, args.seq)
            loss, _ = train_step.loss_fn(params, b["tokens"], b["labels"],
                                         cfg, TrainConfig())
            out.append(float(loss))
    return out


def rank(mesh, args):
    return losses(mesh.device, args, mesh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--layers", default="2")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.core.mesh import launch
    from repro_torch.launch.mesh import run_device
    dev = run_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    archs = args.arch.split(",")
    layers = args.layers.split(",")
    if len(layers) != len(archs):
        raise ValueError(f"{len(layers)} layer counts for {len(archs)} "
                         f"architectures")
    for arch, n in zip(archs, layers):
        one_arch = argparse.Namespace(**{**vars(args), "arch": arch,
                                         "layers": int(n)})
        one = losses(dev, one_arch)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        two = launch("torch_tp_loss_spread:rank", 2, (one_arch,),
                     axis_name=("data", "model"), shape=(1, 2),
                     device=dev if dev.type == "cpu"
                     else torch.device("cuda", 0), timeout=900)[0]
        rel = [abs(a - b) / abs(a) for a, b in zip(one, two)]
        print(json.dumps({"arch": arch, "layers": int(n),
                          "batch": args.batch, "seq": args.seq,
                          "one": one, "two": two, "rel": rel,
                          "max_rel": max(rel),
                          "mean_rel": sum(rel) / len(rel)}), flush=True)


if __name__ == "__main__":
    main()
