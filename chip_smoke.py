#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU. It needs a CUDA device and the CUDA toolkit (nvcc), and no network.

    python3 chip_smoke.py [--seed 0]

Phases (any failed check raises, and the script exits non-zero):

1. Build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc for
   sm_90a; print build times and ptxas's register / spill lines.
2. Hold each kernel against its plain PyTorch version on the card at the
   paths' shapes (full data, all sites batched, the 1.5M-slot coresets of
   phases 3 and 5, 256 stacked serving tenants) plus ragged, d=256,
   forced-tie and coincident-centre cases, and for both resident
   statistics kernels a view from row 1 (odd offset), k = 1, the largest k
   whose block fits shared memory and one more (the two-pass form), and a
   NaN row. Value error,
   argmin flips (each must be a near tie) and, for the fused statistics,
   arithmetic error against the reduction recomputed from the kernel's own
   assignment are reported apart; reruns must be bit-identical, and the
   batched argmin must equal a loop of single-tenant launches bit for bit,
   and the one-centre kernel (D^2 seeding) must equal the general tile with
   the centre padded to 64 sentinel rows bit for bit, at the sites' and
   (phase 3) the coreset's shapes. Then time kernel, plain version and a
   PyTorch library yardstick, beside the bound from the shapes, at full
   data and (all three general kernels) at the sites' shape. A sha256
   digest of lloyd_stats' and weiszfeld_stats' outputs at the sites' and
   the coresets' shapes, and of each route's centres, lets two trees be
   compared bit for bit.
3. The main path at full size -- ``graph_distributed_kmeans`` on the
   yearpredictionmsd stand-in (515,345 x 90, k=50), 100 sites on a 10x10
   grid, t = 3 k n = 15,000, flood and BFS-tree routes -- with the cost
   ratio against the centralized baseline, ledgers, wall per phase,
   launches per kernel (counted from zero just before each route), peak
   device memory, a bit-identical second run, and one traced flood run:
   device busy time, idle share, the device time of the seeding kernel
   and of lloyd_stats_kernel over its 16 launches.
4. The whole path with ``backend="cuda"`` against ``backend="torch"`` at
   scale 0.1: ``t_i`` and ledgers equal, centers within tolerance.
5. Path A: the same instance as phase 3 with ``objective="kmedian"`` on
   both routes -- cost ratio against a centralized k-median solve, ledgers
   against the analytic ones, launches (weiszfeld_stats 2 x 8 x 4,
   distance_argmin 2k + 1, lloyd_stats 0), wall per phase, peak memory, a
   bit-identical rerun, and one traced flood run (the same window as phase
   3's): device busy time, idle share, weiszfeld_stats' device time over
   its 64 launches.
6. Path B: one ``ClusterServeEngine`` with 256 tenants (the centres of
   phases 3 and 5 and 254 static ones) serving 20 steps of bursts; every
   result equal bit for bit to a per-tenant ``query_assignments`` on the
   card and within tolerance of the plain version; batched launches equal
   to dispatches; queries per second and step latency, beside the same
   traffic through the per-tenant loop.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# float32 products in full precision everywhere (TF32 flips argmins)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# H100 SXM peaks at 700 W (NVIDIA data sheet): fp32 on the CUDA cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# |kernel - plain| on a squared distance, relative to |p|^2 + |c|^2: both
# evaluate |p|^2 + |c|^2 - 2 p.c in float32 with d-term sums in different
# orders, each term rounded at ~6e-8 of that magnitude
D2_RTOL = 1e-5
# lloyd_stats sums / counts / cost against the same reduction recomputed
# from the kernel's own assignment, relative to the sum of |terms|:
# sequential float32 sums of up to 1024 rows per block (1024 * 2**-24 ~ 6e-5)
SUM_RTOL = 1e-4
# phase 4: centers of the cuda and torch backends, relative to max |center|
CENTER_RTOL = 1e-3
# distributed / centralized cost on the full data (Theorem 1's constant
# factor, with margin: the paper's runs are within a few percent)
MAX_COST_RATIO = 1.35


class CheckFailed(RuntimeError):
    pass


def check(ok, what):
    if not bool(ok):
        raise CheckFailed(what)


def cuda_ms(fn, reps=20):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls
    (CUDA events, after two warm-up calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound(flops, nbytes):
    """Least time (ms) the card could take, and which limit sets it."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def distance_work(S, n, k, d):
    flops = S * n * k * (2 * d + 3) + 2 * S * (n + k) * d
    nbytes = 4 * S * (n * d + k * d) + 8 * S * n
    return flops, nbytes


def lloyd_work(S, n, k, d):
    flops, _ = distance_work(S, n, k, d)
    flops += S * n * (2 * d + 3)
    nbytes = 4 * S * (n * d + n + k * d) + 4 * S * (k * d + k + 1)
    return flops, nbytes


def weiszfeld_work(S, n, k, d):
    """The assignment, the exact-form distance (3 d), the numerators (2 d)
    and the inverse and cost (~8) per point."""
    flops, _ = distance_work(S, n, k, d)
    flops += S * n * (5 * d + 8)
    nbytes = 4 * S * (n * d + n + k * d) + 4 * S * (k * d + k + 1)
    return flops, nbytes


def batched_work(T, m, k_live, d):
    """T tenants of m queries against their live centres only (k_live is
    the total over tenants): what the data needs, not the padded rows."""
    flops = m * k_live * (2 * d + 3) + 2 * (T * m + k_live) * d
    nbytes = 4 * (T * m * d + k_live * d) + 8 * T * m
    return flops, nbytes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.core import clustering, comm, prng
    from repro_torch.core.backend import query_assignments
    from repro_torch.core.coreset import distributed_coreset
    from repro_torch.core.distributed import graph_distributed_kmeans
    from repro_torch.core.objective import WEISZFELD_ITERS
    from repro_torch.core.partition import pad_partition, partition_indices
    from repro_torch.core.topology import bfs_spanning_tree, grid
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import lloyd_update as lu
    from repro_torch.kernels import weiszfeld as wz
    from repro_torch.serve import ClusterServeEngine, StaticCenters

    t_all = time.perf_counter()
    walls = {}
    t_lap = [t_all]

    def lap(name):
        """Record the wall seconds since the previous lap under ``name``."""
        now = time.perf_counter()
        walls[name] = round(now - t_lap[0], 2)
        t_lap[0] = now

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    # -- phase 1: build ---------------------------------------------------
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"phase 1: built {sorted(built)} in "
          f"{time.perf_counter() - t0:.2f} s (per source: "
          f"{json.dumps({n: round(r.seconds, 2) for n, r in built.items()})})")
    for name, r in built.items():
        for line in r.ptxas:
            print(f"  ptxas[{name}]: {line}")
    # ptxas's lines from each one-centre entry function to the next entry
    entry = False
    for line in built["distance_argmin"].ptxas:
        if "entry function" in line:
            entry = "one_center" in line
        if entry:
            print(f"  one-centre kernel: {line}")
    # four kernel entries with their own counters over three libraries
    check(set(built) == {k.library for k in ops.KERNELS}
          and len({k.name for k in ops.KERNELS}) == 4,
          f"built {sorted(built)}, kernels "
          f"{[(k.name, k.library) for k in ops.KERNELS]}")

    def reset_counts():
        for kern in (*ops.KERNELS, da.ONE_CENTER):
            kern.launches = 0

    def counts():
        return {kern.name: kern.launches for kern in ops.KERNELS}

    lap("phase 1")

    # -- data at full size --------------------------------------------------
    t0 = time.perf_counter()
    data, k = paper_dataset("yearpredictionmsd", seed=args.seed)
    g = grid(10, 10)
    idx = partition_indices(data, g.n, "weighted", seed=args.seed + 1,
                            degrees=g.degrees())
    sp_np, sm_np = pad_partition(data, idx)
    t = 3 * k * g.n
    pts = torch.from_numpy(data).to(dev)
    sp = torch.from_numpy(sp_np).to(dev)
    sm = torch.from_numpy(sm_np).to(dev)
    n, d = data.shape
    S, M = sp.shape[0], sp.shape[1]
    print(f"data: yearpredictionmsd stand-in {data.shape} k={k}, {S} sites "
          f"padded to M={M}, t={t} ({time.perf_counter() - t0:.1f} s)")
    gen = torch.Generator(device="cpu").manual_seed(args.seed)

    def rows(x, count):
        """``count`` rows of x (..., m, d) per leading index, as centers."""
        pick = torch.randint(0, x.shape[-2], (count,), generator=gen)
        return x[..., pick.to(x.device), :].contiguous()

    # -- phase 2: kernels against their plain versions ----------------------
    def compare_argmin(label, p, c, md, am, mr, ar):
        """Kernel (md, am) against plain (mr, ar) on the same inputs: the
        value within D2_RTOL where the argmins agree, and every flip a near
        tie under the plain arithmetic. Returns (value error, flips)."""
        c_sel = torch.gather(c, -2, am.long()[..., None].expand(
            *am.shape, c.shape[-1]))
        scale = (p * p).sum(-1) + (c_sel * c_sel).sum(-1)
        tol = D2_RTOL * scale + 1e-6
        agree = am == ar
        err = (md - mr).abs()
        value_err = float(err[agree].max()) if agree.any() else 0.0
        check((err <= tol)[agree].all(), f"{label} value error {value_err}")
        d2_at = torch.clamp_min(scale - 2.0 * (p * c_sel).sum(-1), 0.0)
        gap = (d2_at - mr).abs()
        flips = int((~agree).sum())
        check((gap <= tol)[~agree].all(),
              f"{label} {flips} flips, not all near ties")
        return value_err, flips

    def check_distance(label, p, c):
        md, am = ops.min_dist_argmin(p, c)
        mr, ar = ref.min_dist_argmin_ref(p, c)
        torch.cuda.synchronize()
        value_err, flips = compare_argmin(f"distance_argmin[{label}]", p, c,
                                          md, am, mr, ar)
        print(f"  distance_argmin[{label}] {tuple(p.shape)} k={c.shape[-2]}: "
              f"max |d2 err| {value_err:.3g} on agreeing rows, {flips} "
              f"near-tie flips (gap <= {D2_RTOL:g} (|p|^2+|c|^2))")
        return md, am, ar, value_err

    def weiszfeld_scale(p, c, w, am):
        """The sums of |terms| of the Weiszfeld reduction given an
        assignment: nums, denoms (themselves sums of terms >= 0) and cost."""
        idx = am.long()[..., None].expand(*am.shape, p.shape[-1])
        diff = p - torch.gather(c, -2, idx)
        d2 = (diff * diff).sum(-1)
        inv = w.clamp_min(0.0) / torch.sqrt(d2 + ref.WEISZFELD_ETA2)
        oh = torch.nn.functional.one_hot(am.long(), c.shape[-2]).float()
        na = (oh * inv[..., None]).transpose(-1, -2) @ p.abs()
        return na, (oh * inv[..., None]).sum(-2), (
            w.abs() * torch.sqrt(d2)).sum(-1)

    def check_launches(label, kern, fits, before, c):
        """The resident kernel launched twice (a call and its rerun) where
        its block fits shared memory, and not at all where ops takes the
        two-pass form; returns which."""
        fused = fits(c.shape[-2], c.shape[-1])
        check(kern.launches == before + 2 * fused,
              f"{kern.name}[{label}] launched {kern.launches - before} "
              f"times, expected {2 * fused}")
        return "one pass" if fused else "two-pass form"

    def check_weiszfeld(label, p, c, w):
        """weiszfeld_stats against the plain reduction of the kernel's own
        assignment (arithmetic error, relative to the sums of |terms|) and
        against the plain version (value error, near-tie flips included);
        a rerun must be bit-identical."""
        before = wz.KERNEL.launches
        out = ops.weiszfeld_stats(p, c, w)
        again = ops.weiszfeld_stats(p, c, w)
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"weiszfeld_stats[{label}] differs between two runs")
        route = check_launches(label, wz.KERNEL, wz.fits, before, c)
        # weiszfeld_stats assigns every point bit for bit as distance_argmin
        _, am, ar, _ = check_distance(f"{label}, assignment", p, c)
        nr, dr, cr = ref.weiszfeld_reduce(p, c, w, am)
        na, _, ca = weiszfeld_scale(p, c, w, am)
        plain = ref.weiszfeld_stats_ref(p, c, w)
        torch.cuda.synchronize()
        errs = [(a - b).abs() for a, b in zip(out, (nr, dr, cr))]
        for e, scale, what in zip(errs, (na, dr, ca),
                                  ("nums", "denoms", "cost")):
            check((e <= SUM_RTOL * scale + 1e-6).all(),
                  f"weiszfeld_stats[{label}] {what} error {float(e.max())}")
        value = max(float((a - b).abs().max()) for a, b in zip(out, plain))
        arith = max(float(e.max()) for e in errs[:2])
        print(f"  weiszfeld_stats[{label}] {tuple(p.shape)} k={c.shape[-2]}: "
              f"max |nums err| {float(errs[0].max()):.3g}, max |denoms err| "
              f"{float(errs[1].max()):.3g}, cost rel err "
              f"{float((errs[2] / ca.clamp_min(1e-30)).max()):.2g} (from "
              f"the kernel's assignment); against the plain version "
              f"{value:.3g} with {int((am != ar).sum())} near-tie flips; "
              f"bit-identical rerun; {route}")
        return arith

    def check_lloyd(label, p, c, w):
        """lloyd_stats against the plain reduction of the kernel's own
        assignment and min d2 (arithmetic error, relative to the sums of
        |terms|); a rerun must be bit-identical."""
        before = lu.KERNEL.launches
        sums, counts, cost = ops.lloyd_stats(p, c, w)
        again = ops.lloyd_stats(p, c, w)
        check(all(torch.equal(a, b) for a, b in
                  zip((sums, counts, cost), again)),
              f"lloyd_stats[{label}] differs between two runs")
        route = check_launches(label, lu.KERNEL, lu.fits, before, c)
        # the kernel's own assignment: lloyd_stats assigns every point, and
        # takes its min d2, bit for bit as distance_argmin
        md, am = ops.min_dist_argmin(p, c)
        _, ar = ref.min_dist_argmin_ref(p, c)
        kk = c.shape[-2]
        sr, cr, costr = ref.lloyd_reduce(p, kk, w, md, am)
        sa, ca, costa = ref.lloyd_reduce(p.abs(), kk, w.abs(), md, am)
        torch.cuda.synchronize()
        es = (sums - sr).abs()
        ec = (counts - cr).abs()
        eo = (cost - costr).abs()
        check((es <= SUM_RTOL * sa + 1e-6).all(),
              f"lloyd_stats[{label}] sums error {float(es.max())}")
        check((ec <= SUM_RTOL * ca + 1e-6).all(),
              f"lloyd_stats[{label}] counts error {float(ec.max())}")
        check((eo <= SUM_RTOL * costa + 1e-6).all(),
              f"lloyd_stats[{label}] cost error {float(eo.max())}")
        flips = int((am != ar).sum())
        err = max(float(es.max()), float(ec.max()))
        print(f"  lloyd_stats[{label}] {tuple(p.shape)} k={kk}: max |sums "
              f"err| {float(es.max()):.3g}, max |counts err| "
              f"{float(ec.max()):.3g}, cost rel err "
              f"{float((eo / costa.clamp_min(1e-30)).max()):.2g} (from the "
              f"kernel's assignment); {flips} near-tie flips vs the plain "
              f"assignment; bit-identical rerun; {route}")
        return err

    def check_nan_row(label, p, c, w):
        """One row holding a NaN, through both resident kernels: the row
        is assigned centre 0 (its min d2 is +inf), so it spoils only what
        it adds to -- in weiszfeld_stats nums[0], denoms[0] and the cost;
        in lloyd_stats column j0 of sums[0] and the cost (+inf), while its
        weight and its finite features go to counts[0] and sums[0]. Every
        other entry within SUM_RTOL of the plain reduction of the other
        rows; reruns bit-identical off the NaN."""
        r0, j0 = p.shape[0] // 2, 7
        p = p.clone()
        p[r0, j0] = float("nan")
        kk = c.shape[-2]
        md, am = ops.min_dist_argmin(p, c)
        keep = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
        keep[r0] = False
        pk, wk, mk, ak = p[keep], w[keep], md[keep], am[keep]
        for name in ("lloyd_stats", "weiszfeld_stats"):
            first, second, cost = getattr(ops, name)(p, c, w)
            again = getattr(ops, name)(p, c, w)
            if name == "lloyd_stats":
                nr, dr, _ = ref.lloyd_reduce(pk, kk, wk, mk, ak)
                na, da_, _ = ref.lloyd_reduce(pk.abs(), kk, wk.abs(), mk, ak)
            else:
                nr, dr, _ = ref.weiszfeld_reduce(pk, c, wk, ak)
                na, da_, _ = weiszfeld_scale(pk, c, wk, ak)
            torch.cuda.synchronize()
            what = f"{name}[{label}]"
            check(int(am[r0]) == 0 and float(md[r0]) == float("inf"),
                  f"{what}: the NaN row was not assigned centre 0 at +inf")
            check(torch.equal(first[1:], again[0][1:])
                  and torch.equal(second[1:], again[1][1:]),
                  f"{what} differs between two runs")
            ok = ((first[1:] - nr[1:]).abs() <= SUM_RTOL * na[1:] + 1e-6
                  ).all() and ((second[1:] - dr[1:]).abs()
                               <= SUM_RTOL * da_[1:] + 1e-6).all()
            if name == "lloyd_stats":
                other = torch.arange(p.shape[1], device=dev) != j0
                e0 = (first[0] - nr[0] - w[r0] * p[r0]).abs()
                ok = ok and bool(torch.isnan(first[0, j0])) and bool(
                    (e0 <= SUM_RTOL * (na[0] + w[r0] * p[r0].abs()) + 1e-6
                     )[other].all()) and abs(float(
                         second[0] - dr[0] - w[r0])) <= SUM_RTOL * float(
                             da_[0] + w[r0]) + 1e-6 and not bool(
                                 torch.isfinite(cost))
            else:
                ok = ok and bool(torch.isnan(first[0]).all()) and bool(
                    torch.isnan(second[0])) and bool(torch.isnan(cost))
            check(ok, f"{what}: not the plain reduction off the NaN row")
            print(f"  {what} {tuple(p.shape)} k={kk}: the NaN row spoils "
                  f"only centre 0's entries it adds to and the cost; the "
                  f"rest within SUM_RTOL of the plain reduction of the "
                  f"other rows; bit-identical rerun")

    def digest(*tensors):
        """sha256 of the tensors' bytes, in order (first 16 hex digits)."""
        h = hashlib.sha256()
        for x in tensors:
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    digests = {}

    print("phase 2: kernels against their plain versions on the card")
    c_main = rows(pts, k)
    w_main = torch.rand(n, generator=gen).to(dev)

    def check_one_center(label, p, c1):
        """The one-centre kernel, as D^2 seeding calls it, against the plain
        version, and bit for bit against the general tile with the centre
        padded to CENTER_TILE rows at the sentinel."""
        md, am, _, err = check_distance(label, p, c1)
        p3, c3 = (p, c1) if p.ndim == 3 else (p[None], c1[None])
        pad = c3.new_full((c3.shape[0], da.CENTER_TILE - 1, c3.shape[2]),
                          ref.CENTER_SENTINEL)
        mg, ag = da.distance_argmin(p3, torch.cat([c3, pad], 1))
        torch.cuda.synchronize()
        check(torch.equal(md, mg.view_as(md)) and torch.equal(
            am, ag.view_as(am)), f"one-centre kernel [{label}] differs from "
            f"the general tile")
        print(f"  distance_argmin[{label}]: one-centre kernel equal bit for "
              f"bit to the general tile (centre padded to "
              f"{da.CENTER_TILE} sentinel rows)")
        return err

    def time_one_center(label, p, c1):
        """Print kernel, plain version and library yardstick (ms), bound and
        the kernel's fraction of it, for one seeding step at p's shape."""
        S1, M1 = (p.shape[0], p.shape[1]) if p.ndim == 3 else (1, p.shape[0])
        t = (cuda_ms(lambda: ops.min_dist_argmin(p, c1)),
             cuda_ms(lambda: ref.min_dist_argmin_ref(p, c1)),
             cuda_ms(lambda: torch.cdist(p, c1).min(-1)),
             *bound(*distance_work(S1, M1, 1, p.shape[-1])))
        print(f"  distance_argmin one-centre [{label}] {tuple(p.shape)}: "
              f"kernel {t[0]:.4f}, plain {t[1]:.4f}, library (cdist + min) "
              f"{t[2]:.4f}, bound {t[3]:.4f} ({t[4]}); kernel at "
              f"{t[3] / t[0]:.3f} of the bound")
        return t

    _, _, _, da_err = check_distance("full data", pts, c_main)
    c_seed = rows(sp, 1)
    oc_err = check_one_center("sites, seeding", sp, c_seed)
    c_sites = rows(sp, k)
    check_distance("sites", sp, c_sites)
    ls_err = check_lloyd("full data", pts, c_main, w_main)
    check_lloyd("sites", sp, c_sites, sm.float())
    rng = np.random.default_rng(args.seed)
    for label, (nn, kk, dd) in (("ragged", (1001, 77, 33)),
                                ("d=256", (777, 130, 256))):
        p = torch.tensor(rng.standard_normal((nn, dd)), dtype=torch.float32,
                         device=dev)
        c = torch.tensor(rng.standard_normal((kk, dd)), dtype=torch.float32,
                         device=dev)
        w = torch.tensor(rng.random(nn), dtype=torch.float32, device=dev)
        check_distance(label, p, c)
        check_lloyd(label, p, c, w)
        check_weiszfeld(label, p, c, 2.0 * w - 1.0)
    # forced ties: every center twice, so each point has an exact tie and
    # the lower index must win, as in the plain version
    p = torch.tensor(rng.standard_normal((5000, 12)), dtype=torch.float32,
                     device=dev)
    c = torch.tensor(rng.standard_normal((35, 12)), dtype=torch.float32,
                     device=dev)
    _, am, ar, _ = check_distance("forced ties", p, torch.cat([c, c]))
    check(torch.equal(am, ar) and bool((am < 35).all()),
          "forced ties: the lower index did not win")
    check_lloyd("forced ties", p, torch.cat([c, c]),
                torch.ones(5000, device=dev))
    check_weiszfeld("forced ties", p, torch.cat([c, c]),
                    torch.ones(5000, device=dev))
    # weiszfeld_stats with signed weights on the full data and all sites;
    # the centres are data rows, and in the coincident case every centre is
    # a point of the set, so d2 = 0 and dist = sqrt(eta^2) = 1e-3 there
    w_signed = (2.0 * torch.rand(n, generator=gen) - 1.0).to(dev)
    wz_err = check_weiszfeld("full data", pts, c_main, w_signed)
    check_weiszfeld("sites", sp, c_sites, sm.float())
    p = rows(pts, 20000)
    w = torch.rand(20000, generator=gen).to(dev)
    check_weiszfeld("coincident centres", p, p[:k].clone(), w)
    check_lloyd("coincident centres", p, p[:k].clone(), w)
    # the batched argmin at serving shapes: 256 tenants, k_bucket 64 with
    # 2..64 live rows each (the rest masked to the sentinel), d = 90
    T_srv, KB = 256, 64
    k_live = torch.randint(2, KB + 1, (T_srv,), generator=gen).to(dev)
    live = torch.arange(KB, device=dev)[None, :] < k_live[:, None]
    c_srv = torch.where(live[..., None], rows(pts, T_srv * KB).view(
        T_srv, KB, d), ref.CENTER_SENTINEL)
    q_srv = {}
    for m in (8, 64, 1024):
        q = rows(pts, T_srv * m).view(T_srv, m, d)
        q_srv[m] = q
        md, am = ops.min_dist_argmin_batched(q, c_srv)
        mr, ar = ref.min_dist_argmin_batched_ref(q, c_srv)
        torch.cuda.synchronize()
        b_err, flips = compare_argmin(f"distance_argmin_batched[m={m}]", q,
                                      c_srv, md, am, mr, ar)
        check(bool((am < k_live[:, None]).all()),
              f"distance_argmin_batched[m={m}]: a masked row won")
        for i in range(T_srv):
            md_i, am_i = ops.min_dist_argmin(q[i], c_srv[i])
            check(torch.equal(md_i, md[i]) and torch.equal(am_i, am[i]),
                  f"distance_argmin_batched[m={m}]: tenant {i} differs from "
                  f"its single-tenant launch")
        again = ops.min_dist_argmin_batched(q, c_srv)
        check(torch.equal(again[0], md) and torch.equal(again[1], am),
              f"distance_argmin_batched[m={m}] differs between two runs")
        if m == 64:
            db_err = b_err
        print(f"  distance_argmin_batched[{T_srv} x {m}] k_bucket={KB}: max "
              f"|d2 err| {b_err:.3g} on agreeing rows, {flips} near-tie "
              f"flips; equal bit for bit to {T_srv} single-tenant launches; "
              f"bit-identical rerun")

    # the resident kernels' edge cases (after the cases above, so that
    # their draws leave the earlier inputs as they were): points as a view
    # that starts at row 1 (off a 16-byte boundary at d = 90), one centre,
    # the largest k whose block fits shared memory at d = 90 and one more
    # (the two-pass form), and a NaN row
    check(all(m.fits(256, d) and not m.fits(257, d) for m in (lu, wz)),
          "the shared-memory limit at d = 90 is not k = 256")
    for label, (nn, kk, off) in (("view from row 1", (20001, k, 1)),
                                 ("k=1", (20001, 1, 0)),
                                 ("limit k=256", (3000, 256, 0)),
                                 ("over the limit k=257", (3000, 257, 0))):
        p = rows(pts, nn + off)[off:]
        check(p.is_contiguous() and p.storage_offset() == off * d,
              f"{label}: not a contiguous view from row {off}")
        c = rows(pts, kk)
        w = torch.rand(nn, generator=gen).to(dev)
        check_lloyd(label, p, c, w)
        check_weiszfeld(label, p, c, 2.0 * w - 1.0)
    check_nan_row("NaN row", rows(pts, 20001), rows(pts, k),
                  torch.rand(20001, generator=gen).to(dev))
    # the path's outputs at the sites' shape, to compare trees bit for bit
    digests["lloyd_stats[sites]"] = digest(*ops.lloyd_stats(
        sp, c_sites, sm.float()))
    digests["weiszfeld_stats[sites]"] = digest(*ops.weiszfeld_stats(
        sp, c_sites, sm.float()))

    # -- timing at the main path's cost/solve shape ---------------------------
    p2d, c2d = pts, c_main
    da_ms = cuda_ms(lambda: ops.min_dist_argmin(p2d, c2d))
    da_plain = cuda_ms(lambda: ref.min_dist_argmin_ref(p2d, c2d))
    da_lib = cuda_ms(lambda: torch.cdist(p2d, c2d).min(-1))
    ls_ms = cuda_ms(lambda: ops.lloyd_stats(p2d, c2d, w_main))
    ls_plain = cuda_ms(lambda: ref.lloyd_stats_ref(p2d, c2d, w_main))

    def flat_assign(p, c):
        """The library's assignment (cdist + min, an optional site axis):
        distances, argmins, the argmins as rows of (sites k, ...)
        accumulators, and their number."""
        dist, a = torch.cdist(p, c).min(-1)
        sites = p.shape[0] if p.ndim == 3 else 1
        off = torch.arange(sites, device=dev)[:, None] * c.shape[-2]
        return dist, a, (a.view(sites, -1) + off).reshape(-1), \
            sites * c.shape[-2]

    def lloyd_library(p, c, w):
        """The Lloyd statistics by PyTorch's own calls: cdist + argmin +
        two index_add_."""
        dist, _, flat, nk = flat_assign(p, c)
        dd = c.shape[-1]
        torch.zeros(nk, dd, device=dev).index_add_(
            0, flat, (w[..., None] * p).reshape(-1, dd))
        torch.zeros(nk, device=dev).index_add_(0, flat, w.reshape(-1))
        return (w * dist * dist).sum(-1)

    def weiszfeld_library(p, c, w):
        """The Weiszfeld statistics by PyTorch's own calls: cdist + argmin
        + gather + two index_add_."""
        _, a, flat, nk = flat_assign(p, c)
        dd = c.shape[-1]
        diff = p - torch.gather(c, -2, a[..., None].expand(*a.shape, dd))
        d2 = (diff * diff).sum(-1)
        inv = w.clamp_min(0.0) / torch.sqrt(d2 + ref.WEISZFELD_ETA2)
        torch.zeros(nk, dd, device=dev).index_add_(
            0, flat, (inv[..., None] * p).reshape(-1, dd))
        torch.zeros(nk, device=dev).index_add_(0, flat, inv.reshape(-1))
        return (w * torch.sqrt(d2)).sum(-1)

    ls_lib = cuda_ms(lambda: lloyd_library(p2d, c2d, w_main))
    da_bound, da_by = bound(*distance_work(1, n, k, d))
    ls_bound, ls_by = bound(*lloyd_work(1, n, k, d))
    print(f"  timing at n={n} k={k} d={d} (ms, mean of 20):")
    print(f"  distance_argmin: kernel {da_ms:.4f}, plain {da_plain:.4f}, "
          f"library (cdist + min) {da_lib:.4f}, bound {da_bound:.4f} "
          f"({da_by})")
    print(f"  lloyd_stats: kernel {ls_ms:.4f}, plain {ls_plain:.4f}, library "
          f"(cdist + argmin + index_add_) {ls_lib:.4f}, bound {ls_bound:.4f} "
          f"({ls_by})")
    wz_ms = cuda_ms(lambda: ops.weiszfeld_stats(p2d, c2d, w_signed))
    wz_plain = cuda_ms(lambda: ref.weiszfeld_stats_ref(p2d, c2d, w_signed))

    wz_lib = cuda_ms(lambda: weiszfeld_library(p2d, c2d, w_signed))
    wz_bound, wz_by = bound(*weiszfeld_work(1, n, k, d))
    print(f"  weiszfeld_stats: kernel {wz_ms:.4f}, plain {wz_plain:.4f}, "
          f"library (cdist + argmin + gather + index_add_) {wz_lib:.4f}, "
          f"bound {wz_bound:.4f} ({wz_by})")
    db = {}
    k_sum = int(k_live.sum())
    for m, q in q_srv.items():
        b_ms, b_by = bound(*batched_work(T_srv, m, k_sum, d))
        db[m] = (cuda_ms(lambda: ops.min_dist_argmin_batched(q, c_srv)),
                 cuda_ms(lambda: ref.min_dist_argmin_batched_ref(q, c_srv),
                         reps=5),
                 cuda_ms(lambda: torch.cdist(q, c_srv).min(-1)), b_ms, b_by)
        print(f"  distance_argmin_batched {T_srv} x {m} (k_bucket {KB}, "
              f"{k_sum} live centres): kernel {db[m][0]:.4f}, plain (loop) "
              f"{db[m][1]:.4f}, library (batched cdist + min) "
              f"{db[m][2]:.4f}, bound {b_ms:.4f} ({b_by})")
    oc = time_one_center("sites", sp, c_seed)
    w_sites = sm.float()
    for label, fn, plain, lib, work in (
            ("distance_argmin", lambda: ops.min_dist_argmin(sp, c_sites),
             lambda: ref.min_dist_argmin_ref(sp, c_sites),
             ("cdist + min", lambda: torch.cdist(sp, c_sites).min(-1)),
             distance_work(S, M, k, d)),
            ("lloyd_stats", lambda: ops.lloyd_stats(sp, c_sites, w_sites),
             lambda: ref.lloyd_stats_ref(sp, c_sites, w_sites),
             ("cdist + argmin + index_add_",
              lambda: lloyd_library(sp, c_sites, w_sites)),
             lloyd_work(S, M, k, d)),
            ("weiszfeld_stats", lambda: ops.weiszfeld_stats(
                sp, c_sites, w_sites),
             lambda: ref.weiszfeld_stats_ref(sp, c_sites, w_sites),
             ("cdist + argmin + gather + index_add_",
              lambda: weiszfeld_library(sp, c_sites, w_sites)),
             weiszfeld_work(S, M, k, d))):
        b_ms, b_by = bound(*work)
        ms = cuda_ms(fn)
        print(f"  {label} sites ({S} x {M}): kernel {ms:.4f}, plain "
              f"{cuda_ms(plain, reps=5):.4f}, library (batched {lib[0]}) "
              f"{cuda_ms(lib[1]):.4f}, bound {b_ms:.4f} ({b_by}); kernel at "
              f"{b_ms / ms:.3f} of the bound")

    # -- phase 3: the main path at full size ----------------------------------
    lap("data + phase 2")
    print("phase 3: main path at full size")
    t0 = time.perf_counter()
    _, base_cost = clustering.solve(prng.PRNGKey(args.seed + 7), pts, k,
                                    lloyd_iters=12, restarts=3, device=dev)
    base_cost = float(base_cost)
    print(f"  centralized baseline (3 restarts, 12 Lloyd steps) cost "
          f"{base_cost:.6g} in {time.perf_counter() - t0:.2f} s")
    check(np.isfinite(base_cost) and base_cost > 0, "baseline cost")

    def traced_route(label, run, kernels):
        """Trace one run of a route: wall, device busy time (the union of
        the device operations' spans), idle share, the six kernels with the
        most device time, and for each ``(part, title)`` of ``kernels`` the
        device time and launches of the kernels whose name holds ``part``
        (printed as ``title``)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if not spans:
            print(f"  traced {label} run: idle share not measured (the "
                  f"profiler saw no device events)")
            return
        busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy = (busy + cur_e - cur_s) / 1e6
        print(f"  traced {label} run: wall {traced_wall:.3f} s, device busy "
              f"{busy:.3f} s over {len(spans)} device operations, idle "
              f"share {1 - busy / traced_wall:.3f} (tracing on)")
        top = sorted(prof.key_averages(),
                     key=lambda a: -getattr(a, "device_time_total", 0.0))
        for a in top[:6]:
            print(f"    {getattr(a, 'device_time_total', 0.0) / 1e3:9.2f} ms "
                  f"x{a.count:6d} {a.key[:90]}")
        for part, title in kernels:
            hits = [a for a in top if part in a.key]
            hit_ms = sum(getattr(a, "device_time_total", 0.0)
                         for a in hits) / 1e3
            print(f"  traced {title}: {hit_ms:.2f} ms of device time over "
                  f"{sum(a.count for a in hits)} launches")

    def drive(routing, backend=None, points=sp, mask=sm, times=None):
        return graph_distributed_kmeans(
            prng.PRNGKey(args.seed), points, mask, k, t, g, routing=routing,
            backend=backend, device=dev, phase_times=times)

    drive("flood")   # warm-up: first-use costs of PyTorch's own kernels
    launches = {}
    results = {}
    for routing in ("flood", "bfs"):
        times = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = drive(routing, times=times)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[routing] = counts()
        one_center_launches = da.ONE_CENTER.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        results[routing] = res
        ratio = float(clustering.cost(pts, res.centers, device=dev)) / base_cost
        print(f"  {routing}: cost ratio {ratio:.6f} (bound "
              f"{MAX_COST_RATIO}), wall {wall:.3f} s "
              f"{json.dumps({p: round(s, 4) for p, s in times.items()})}, "
              f"peak device memory {peak:.2f} GiB")
        print(f"  {routing} ledger: "
              f"{json.dumps(res.ledger.as_dict(by_phase=True))}")
        print(f"  {routing} launches: {json.dumps(launches[routing])}")
        check(res.centers.shape == (k, d)
              and bool(torch.isfinite(res.centers).all()),
              f"{routing}: centers not finite of shape ({k}, {d})")
        check(ratio < MAX_COST_RATIO, f"{routing}: cost ratio {ratio}")
        total_w = float(res.coreset.weights.double().sum())
        check(abs(total_w - n) <= 1e-3 * n,
              f"{routing}: coreset weight {total_w} != {n} points")
        # one launch per seeding step and per sensitivity pass over all sites
        # (not per site): k seeding steps + 1 in Round 1, k in the solve
        check(launches[routing]["distance_argmin"] == 2 * k + 1,
              f"{routing}: distance_argmin launches {launches[routing]}")
        # all but the sensitivities' launch take the one-centre kernel
        check(one_center_launches == 2 * k,
              f"{routing}: {one_center_launches} one-centre launches")
        if routing == "flood":
            oc_launches = one_center_launches
        check(launches[routing]["lloyd_stats"] == 2 * 8,
              f"{routing}: lloyd_stats launches {launches[routing]}")
        check(launches[routing]["weiszfeld_stats"] == 0
              and launches[routing]["distance_argmin_batched"] == 0,
              f"{routing}: k-means launched {launches[routing]}")
    check(torch.equal(results["flood"].centers, results["bfs"].centers),
          "flood and BFS routes solved different centers")
    again = drive("flood")
    check(torch.equal(again.centers, results["flood"].centers),
          "second run: centers not bit-identical")
    print("  second run: bit-identical centers")
    flood = results["flood"]
    cs = flood.coreset
    print(f"  coreset {tuple(cs.points.shape)} with "
          f"{int(cs.effective_size())} weighted slots")

    traced_route("flood", lambda: drive("flood"),
                 [("one_center", "one-centre kernel (D^2 seeding)"),
                  ("lloyd_stats_kernel", "lloyd_stats kernel")])

    # the kernels at the coreset's shapes of this run
    check_one_center("coreset seeding", cs.points, rows(cs.points, 1))
    time_one_center("coreset", cs.points, rows(cs.points, 1))
    check_lloyd("coreset", cs.points, flood.centers, cs.weights)
    b_ms, b_by = bound(*lloyd_work(1, cs.points.shape[0], k, d))
    cs_args = (cs.points, flood.centers, cs.weights)
    ls_cs = cuda_ms(lambda: ops.lloyd_stats(*cs_args))
    print(f"  lloyd_stats coreset ({cs.points.shape[0]} rows): kernel "
          f"{ls_cs:.4f} ms, plain "
          f"{cuda_ms(lambda: ref.lloyd_stats_ref(*cs_args)):.4f}, library "
          f"{cuda_ms(lambda: lloyd_library(*cs_args)):.4f}, bound "
          f"{b_ms:.4f} ({b_by})")
    digests["lloyd_stats[coreset]"] = digest(*ops.lloyd_stats(*cs_args))
    for routing in ("flood", "bfs"):
        digests[f"kmeans centres[{routing}]"] = digest(
            results[routing].centers)

    lap("phase 3")

    # -- phase 4: cuda backend against the plain torch backend ---------------
    print("phase 4: backend='cuda' against backend='torch' at scale 0.1")
    data_s, _ = paper_dataset("yearpredictionmsd", seed=args.seed, scale=0.1)
    idx_s = partition_indices(data_s, g.n, "weighted", seed=args.seed + 1,
                              degrees=g.degrees())
    sp_s, sm_s = (torch.from_numpy(a).to(dev)
                  for a in pad_partition(data_s, idx_s))
    runs = {}
    # the Round-1/2 key of graph_distributed_kmeans, for its t_i
    k1 = prng.split(prng.PRNGKey(args.seed))[0]
    for backend in ("cuda", "torch"):
        res = graph_distributed_kmeans(
            prng.PRNGKey(args.seed), sp_s, sm_s, k, t, g, backend=backend,
            device=dev)
        dcs = distributed_coreset(k1, sp_s, sm_s, k, t, lloyd_iters=8,
                                  backend=backend, device=dev)
        runs[backend] = (res, dcs)
    (rc, dc_c), (rt, dc_t) = runs["cuda"], runs["torch"]
    check(torch.equal(dc_c.t_i, dc_t.t_i), "phase 4: t_i differ")
    check(rc.ledger.as_dict(by_phase=True) == rt.ledger.as_dict(by_phase=True),
          "phase 4: ledgers differ")
    cerr = float((rc.centers - rt.centers).abs().max())
    cmax = float(rt.centers.abs().max())
    check(cerr <= CENTER_RTOL * cmax,
          f"phase 4: centers differ by {cerr} (max |center| {cmax})")
    pts_s = torch.from_numpy(data_s).to(dev)
    ratios = [float(clustering.cost(pts_s, r.centers, device=dev,
                                    backend="torch")) for r in (rc, rt)]
    print(f"  n={data_s.shape[0]}: t_i equal (sum {int(dc_c.t_i.sum())}), "
          f"ledgers equal, max |center diff| {cerr:.3g} (max |center| "
          f"{cmax:.3g}), full-data cost cuda/torch {ratios[0] / ratios[1]:.8f}")
    lap("phase 4")

    # -- phase 5: path A, k-median through Algorithms 1 + 2 -------------------
    print("phase 5: k-median (path A) at full size")
    t0 = time.perf_counter()
    _, base_md = clustering.solve(prng.PRNGKey(args.seed + 7), pts, k,
                                  lloyd_iters=12, restarts=3,
                                  objective="kmedian", device=dev)
    base_md = float(base_md)
    print(f"  centralized k-median baseline (3 restarts, 12 steps of "
          f"{WEISZFELD_ITERS} Weiszfeld passes) cost {base_md:.6g} in "
          f"{time.perf_counter() - t0:.2f} s")
    check(np.isfinite(base_md) and base_md > 0, "k-median baseline cost")

    def drive_md(routing, times=None):
        return graph_distributed_kmeans(
            prng.PRNGKey(args.seed), sp, sm, k, t, g, objective="kmedian",
            routing=routing, device=dev, phase_times=times)

    first = drive_md("flood")   # warm-up, and the rerun to compare with
    # the run's t_i (Round 1 and 2 with the pipeline's key), priced by the
    # analytic Theorem 2 / Theorem 3 ledgers
    t_i = distributed_coreset(k1, sp, sm, k, t, objective="kmedian",
                              lloyd_iters=8, device=dev).t_i.cpu().numpy()
    tree = bfs_spanning_tree(g)
    analytic = {
        "flood": comm.flood_cost(g, n_messages=g.n, unit_scalars=1.0).tag(
            "round1").add(comm.flood_portions_cost(g, t_i, k, d).tag(
                "round2")),
        "bfs": comm.tree_allocation_cost(tree).tag("round1").add(
            comm.tree_up_cost(tree, [float(x) + k for x in t_i], dim=d).tag(
                "round2_gather")).add(comm.tree_broadcast_cost(
                    tree, unit_points=float(k), dim=d).tag(
                        "round2_broadcast")),
    }
    md_launches, md_results = {}, {}
    for routing in ("flood", "bfs"):
        times = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = drive_md(routing, times=times)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        md_launches[routing] = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        md_results[routing] = res
        ratio = float(clustering.cost(pts, res.centers, objective="kmedian",
                                      device=dev)) / base_md
        ledger = res.ledger.as_dict(by_phase=True)
        print(f"  {routing}: k-median cost ratio {ratio:.6f} (bound "
              f"{MAX_COST_RATIO}), wall {wall:.3f} s "
              f"{json.dumps({p: round(s, 4) for p, s in times.items()})}, "
              f"peak device memory {peak:.2f} GiB")
        print(f"  {routing} ledger: {json.dumps(ledger)}")
        print(f"  {routing} launches: {json.dumps(md_launches[routing])}")
        check(res.centers.shape == (k, d)
              and bool(torch.isfinite(res.centers).all()),
              f"k-median {routing}: centers not finite of shape ({k}, {d})")
        check(ratio < MAX_COST_RATIO, f"k-median {routing}: cost ratio "
              f"{ratio}")
        check(ledger == analytic[routing].as_dict(by_phase=True),
              f"k-median {routing}: ledger differs from the analytic one")
        total_w = float(res.coreset.weights.double().sum())
        check(abs(total_w - n) <= 1e-3 * n,
              f"k-median {routing}: coreset weight {total_w} != {n} points")
        # one weiszfeld_stats launch per pass over all sites: 8 steps of
        # WEISZFELD_ITERS passes in Round 1 and in the solve
        expect = {"distance_argmin": 2 * k + 1, "lloyd_stats": 0,
                  "weiszfeld_stats": 2 * 8 * WEISZFELD_ITERS,
                  "distance_argmin_batched": 0}
        check(md_launches[routing] == expect,
              f"k-median {routing}: launches {md_launches[routing]}, "
              f"expected {expect}")
    check(torch.equal(md_results["flood"].centers,
                      md_results["bfs"].centers),
          "k-median: flood and BFS routes solved different centers")
    check(torch.equal(first.centers, md_results["flood"].centers),
          "k-median second run: centers not bit-identical")
    print(f"  ledgers equal the analytic ones (t_i sum {int(t_i.sum())}); "
          f"flood and BFS centres bit-identical; second run bit-identical")
    traced_route("k-median flood", lambda: drive_md("flood"),
                 [("weiszfeld_stats_kernel", "weiszfeld_stats kernel")])
    cs_md = md_results["flood"].coreset
    check_weiszfeld("k-median coreset", cs_md.points,
                    md_results["flood"].centers, cs_md.weights)
    digests["weiszfeld_stats[coreset]"] = digest(*ops.weiszfeld_stats(
        cs_md.points, md_results["flood"].centers, cs_md.weights))
    for routing in ("flood", "bfs"):
        digests[f"kmedian centres[{routing}]"] = digest(
            md_results[routing].centers)
    b_ms, b_by = bound(*weiszfeld_work(1, cs_md.points.shape[0], k, d))
    wz_cs = cuda_ms(lambda: ops.weiszfeld_stats(
        cs_md.points, md_results["flood"].centers, cs_md.weights))
    print(f"  weiszfeld_stats coreset ({cs_md.points.shape[0]} rows): kernel "
          f"{wz_cs:.4f} ms, bound {b_ms:.4f} ({b_by})")
    lap("phase 5")

    # -- phase 6: path B, multi-tenant serving --------------------------------
    print(f"phase 6: serving (path B), {T_srv} tenants")
    srv_rng = np.random.default_rng(args.seed + 11)
    tenants = [(results["flood"].centers.cpu().numpy(), "kmeans"),
               (md_results["flood"].centers.cpu().numpy(), "kmedian")]
    for i in range(T_srv - 2):
        kk = int(srv_rng.integers(2, 65))
        tenants.append((data[srv_rng.integers(0, n, kk)],
                        ("kmeans", "kmedian")[i % 2]))
    N_STEPS, BIG = 20, 5000
    traffic = []
    for s in range(N_STEPS):
        burst = []
        for j, tid in enumerate(srv_rng.choice(T_srv, T_srv // 2,
                                               replace=False)):
            m = BIG if (s, j) == (N_STEPS // 2, 0) else int(
                srv_rng.integers(8, 1025))
            burst.append((int(tid), data[srv_rng.integers(0, n, m)]))
        traffic.append(burst)

    def new_engine():
        eng = ClusterServeEngine(min_bucket=8, max_bucket=1024,
                                 max_group=T_srv, device=dev)
        for c, obj in tenants:
            eng.add_tenant(StaticCenters(c), k=c.shape[0], d=d,
                           objective=obj)
        return eng

    warm = new_engine()     # first-use costs of PyTorch's own kernels
    for tid, q in traffic[0]:
        warm.enqueue(tid, q)
    warm.run()
    eng = new_engine()
    tickets, step_s = [], []
    reset_counts()
    for burst in traffic:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tid, q in burst:
            tickets.append((tid, q, eng.enqueue(tid, q)))
        eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    srv_launches = counts()
    st = eng.stats
    check(all(tk.done for _, _, tk in tickets), "serving: a ticket is open")
    check(st.n_queries == sum(q.shape[0] for _, q, _ in tickets),
          "serving: rows served != rows enqueued")
    check(srv_launches == {"distance_argmin": 0, "lloyd_stats": 0,
                           "weiszfeld_stats": 0,
                           "distance_argmin_batched": st.n_dispatches},
          f"serving: launches {srv_launches}, {st.n_dispatches} dispatches")
    big = [tk for _, q, tk in tickets if q.shape[0] == BIG]
    check(len(big) == 1 and big[0].n_padded == 5 * 1024 - BIG,
          "serving: the 5,000-row burst was not split into 5 chunks")
    buckets = {8 << i for i in range(8)}
    check(all(Tp & (Tp - 1) == 0 and Tp <= T_srv and b in buckets
              and kb in (8, 16, 32, 64) and dd == d
              for Tp, b, kb, dd, _ in eng.compiled_shapes),
          "serving: dispatched shapes off the power-of-two grid")
    # the same traffic through a per-tenant loop of query_assignments
    c_dev = [torch.from_numpy(c).to(dev) for c, _ in tenants]
    loop_res, loop_s = [], []
    for burst in traffic:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tid, q in burst:
            a, dist = query_assignments(q, c_dev[tid], tenants[tid][1],
                                        device=dev)
            loop_res.append((a.cpu().numpy(), dist.cpu().numpy()))
        torch.cuda.synchronize()
        loop_s.append(time.perf_counter() - t0)
    check(all(np.array_equal(tk.assign, a) and np.array_equal(tk.dist, dist)
              for (_, _, tk), (a, dist) in zip(tickets, loop_res)),
          "serving: results differ from the per-tenant loop")
    # and the plain version, per tenant over all its rows
    by_tenant = {}
    for tid, q, tk in tickets:
        by_tenant.setdefault(tid, []).append((q, tk))
    srv_err, srv_flips = 0.0, 0
    for tid, items in sorted(by_tenant.items()):
        q = torch.from_numpy(np.concatenate([x for x, _ in items])).to(dev)
        a = torch.from_numpy(np.concatenate([tk.assign for _, tk in items]))
        dist = torch.from_numpy(np.concatenate([tk.dist for _, tk in items]))
        a, dist = a.to(dev), dist.to(dev)
        d2 = dist if tenants[tid][1] == "kmeans" else dist * dist
        mr, ar = ref.min_dist_argmin_ref(q, c_dev[tid])
        e, f = compare_argmin(f"serving[tenant {tid}]", q, c_dev[tid], d2, a,
                              mr, ar)
        srv_err, srv_flips = max(srv_err, e), srv_flips + f
    lat = np.asarray(step_s) * 1e3
    print(f"  {N_STEPS} steps, {st.n_queries} query rows ({st.n_padded} "
          f"padding rows), {len(tickets)} tickets, {st.n_dispatches} "
          f"dispatches for {st.n_tenant_dispatches} tenant-chunks, "
          f"{len(eng.compiled_shapes)} dispatched shapes")
    print(f"  engine: {st.n_queries / sum(step_s):.0f} queries/s, step "
          f"latency p50 {np.percentile(lat, 50):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms")
    print(f"  per-tenant loop, same traffic: {st.n_queries / sum(loop_s):.0f} "
          f"queries/s, {sum(loop_s) / sum(step_s):.3f}x the engine's time")
    print(f"  results equal the per-tenant loop bit for bit; against the "
          f"plain version max |d2 err| {srv_err:.3g}, {srv_flips} near-tie "
          f"flips; batched launches {srv_launches['distance_argmin_batched']}"
          f" == dispatches")
    lap("phase 6")

    print(f"phase walls (s): {json.dumps(walls)}")
    print(f"digests (sha256, first 16 hex digits): {json.dumps(digests)}")
    print(f"total wall {time.perf_counter() - t_all:.1f} s")
    kernels = [
        {"name": "distance_one_center", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:131",
         "launches": oc_launches, "max_abs_err": oc_err, "ms": oc[0],
         "plain_ms": oc[1], "bound_ms": oc[3], "bound_by": oc[4],
         "library_ms": oc[2]},
        {"name": "distance_argmin", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:131",
         "launches": launches["flood"]["distance_argmin"],
         "max_abs_err": da_err, "ms": da_ms, "plain_ms": da_plain,
         "bound_ms": da_bound, "bound_by": da_by, "library_ms": da_lib},
        {"name": "lloyd_stats", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lloyd_stats.cu",
         "replaces": "src/repro/kernels/lloyd_update.py:67",
         "launches": launches["flood"]["lloyd_stats"],
         "max_abs_err": ls_err, "ms": ls_ms, "plain_ms": ls_plain,
         "bound_ms": ls_bound, "bound_by": ls_by, "library_ms": ls_lib},
        {"name": "weiszfeld_stats", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/weiszfeld_stats.cu",
         "replaces": "src/repro/kernels/weiszfeld.py:100",
         "launches": md_launches["flood"]["weiszfeld_stats"],
         "max_abs_err": wz_err, "ms": wz_ms, "plain_ms": wz_plain,
         "bound_ms": wz_bound, "bound_by": wz_by, "library_ms": wz_lib},
        {"name": "distance_argmin_batched", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:92",
         "launches": srv_launches["distance_argmin_batched"],
         "max_abs_err": db_err, "ms": db[64][0], "plain_ms": db[64][1],
         "bound_ms": db[64][3], "bound_by": db[64][4],
         "library_ms": db[64][2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
