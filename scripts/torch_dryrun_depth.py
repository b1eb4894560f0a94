"""The port's dry run of one cell at several depths: how its temp bytes
and collectives grow with the number of layers.

For each ``--layers`` count, ``launch.dryrun.run_cell`` on the cell of
``--arch`` x ``--shape`` at its published widths cut to that many layers,
on the production mesh (``--mesh single|multi``): one JSON line each with
the per-device temp, argument and peak bytes, ``fits_hbm`` on an H100
SXM, the link bytes, the collectives by kind and the host seconds of the
global and the rank's run. Everything runs on meta tensors on the host
(nothing is allocated), so the CPU is enough.

    PYTHONPATH=src python scripts/torch_dryrun_depth.py --arch llama3_8b \\
        --shape train_4k --layers 1,2,4,8
"""
import argparse
import dataclasses
import json

import torch

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.roofline.report import H100_SXM


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_IDS, required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", default="1,2,4,8",
                    help="comma-separated layer counts")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for n in (int(x) for x in args.layers.split(",")):
        cfg = dataclasses.replace(configs.get(args.arch), n_layers=n)
        r = dryrun.run_cell(args.arch, args.shape, args.mesh, "",
                            verbose=False, hardware=H100_SXM,
                            cfg_override=cfg, network_bytes_per_s=(
                                50e9 if args.mesh == "multi" else None))
        print(json.dumps({
            "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
            "layers": n, "temp_bytes": r["temp_bytes"],
            "arg_bytes": r["arg_bytes"],
            "peak_memory_bytes": r["peak_memory_bytes"],
            "fits_hbm": r["fits_hbm"], "ici_bytes": r["ici_bytes"],
            "dcn_bytes": r["dcn_bytes"],
            "collective_counts": r["collective_counts"],
            "global_run_s": r["lower_s"], "rank_run_s": r["compile_s"]}),
            flush=True)


if __name__ == "__main__":
    main()
