"""How far a tensor-parallel prefill and decode's logits lie from one
process's in bf16.

Each ``--arch`` at its published widths cut to its ``--layers`` layers,
with random params from seed 0: on each of ``--prompts`` prompts of
``--batch`` rows of ``--prompt`` tokens (seeds 0, 1, ...), the prefill
and ``--new`` greedy decode steps of ``models.forward`` with a cache in
one process and on a 1x2 (data, model) mesh of two gloo ranks sharing
the card (``chip_smoke.serve_run``: the mesh's decode steps take the one
process's picks), and max |dlogit| / max |logit| at the prompt's last
position and at each step (``chip_smoke.serve_compare``); ``--int8``
architectures also with an int8 KV cache, ``--f32`` ones also with f32
activations (where the MoE's top-k routing rarely meets a tie). Prints
the card's name and power limit, then one JSON line per architecture
and variant: the largest prefill and decode spread per prompt and the
positions where the picks differ, with the top-two gap there.

    PYTHONPATH=src python scripts/torch_tp_decode_spread.py [--prompts 8] \\
        [--arch granite_moe_3b_a800m,mamba2_370m,recurrentgemma_2b] \\
        [--layers 2,4,3] [--int8 granite_moe_3b_a800m] \\
        [--f32 granite_moe_3b_a800m] [--no-bf16] [--device cpu]

On the CPU pass ``--device cpu`` with small ``--width``, ``--prompt``
and ``--new``.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rank(grid, args):
    """Every architecture's spreads on this rank (rank 0 returns them)."""
    from chip_smoke import serve_compare, serve_run
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params, sharding
    from repro_torch.models.model import shard_specs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = grid.device
    out = []
    for arch, layers in zip(args.arch.split(","), args.layers.split(",")):
        argv = ["--arch", arch, "--layers", layers]
        if args.width:
            argv += ["--width", str(args.width)]
        cfg = launch_train.build_cfg(launch_train.parse_args(argv))
        full = init_params(0, cfg, dev)
        shards = sharding.shard(full, shard_specs(cfg, grid, "tp"), grid)
        if grid.rank:
            full = None
        variants = []
        if args.bf16:
            variants.append(("bf16", cfg))
        if arch in args.int8.split(","):
            variants.append(("int8", dataclasses.replace(
                cfg, kv_cache_dtype="int8")))
        if arch in args.f32.split(","):
            variants.append(("f32", dataclasses.replace(
                cfg, dtype="float32")))
        for name, c in variants:
            row = {"arch": arch, "layers": int(layers), "variant": name,
                   "prefill": [], "decode": [], "ties": []}
            for seed in range(args.prompts):
                prompt = torch.randint(
                    0, c.vocab_size, (args.batch, args.prompt),
                    generator=torch.Generator().manual_seed(seed)).to(dev)
                one = serve_run(full, c, prompt, args.new) \
                    if grid.rank == 0 else None
                picks = one["picks"] if one else torch.zeros(
                    (args.batch, args.new + 1), dtype=torch.int64,
                    device=dev)
                feed = grid.world.all_gather(picks)[0]
                got = serve_run(shards, c, prompt, args.new, grid, feed)
                if one:
                    cmp = serve_compare(one, got)
                    row["prefill"].append(cmp["err"][0])
                    row["decode"].append(max(cmp["err"][1:]))
                    row["ties"] += [(seed, i, g)
                                    for i, g in cmp["ties"].items()]
                del one, got
            if grid.rank == 0:
                row["max_prefill"] = max(row["prefill"])
                row["max_decode"] = max(row["decode"])
                out.append(row)
        del full, shards
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--arch",
                    default="granite_moe_3b_a800m,mamba2_370m,"
                            "recurrentgemma_2b")
    ap.add_argument("--layers", default="2,4,3")
    ap.add_argument("--int8", default="granite_moe_3b_a800m")
    ap.add_argument("--f32", default="granite_moe_3b_a800m",
                    help="architectures also run with f32 activations")
    ap.add_argument("--no-bf16", dest="bf16", action="store_false",
                    help="only the --int8 and --f32 runs")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--width", type=int, default=0)
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
    rows = launch("torch_tp_decode_spread:rank", 2, (args,),
                  axis_name=("data", "model"), shape=(1, 2), device=dev,
                  timeout=3000)[0]
    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
