"""Serving launcher (the port of ``repro.launch.serve``): batched generation
with the slot Engine, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \\
        --reduced --requests 6 --max-new 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch.mesh import run_device, where
from repro_torch.models import init_params
from repro_torch.serve import Engine, Request


def main(argv=None, *, params=None):
    """``params``: the caller's params for the reduced config (on the run's
    device), in place of ``init_params(0, cfg)`` -- the tests carry the
    reference's across."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b", choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = run_device(args.device)

    cfg = configs.get_reduced(args.arch)
    if params is None:
        params = init_params(0, cfg, dev)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(
        0, cfg.vocab_size, size=args.prompt_len).astype(np.int32),
        max_new=args.max_new) for _ in range(args.requests)]

    eng = Engine(params, cfg, n_slots=args.slots, max_len=args.max_len)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = eng.run(reqs)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out) - len(r.prompt) for r in done)
    print(f"[serve] {len(done)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s on {where(dev)})")
    for i, r in enumerate(done):
        print(f"  req{i}: prompt={r.prompt[:4]}... out_len={len(r.out)}")
    return done


if __name__ == "__main__":
    main()
