#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU. It needs a CUDA device and the CUDA toolkit (nvcc), and no network.

    python3 chip_smoke.py [--seed 0] [--argmin-digests]

``--argmin-digests`` prints only phase 2's digests of distance_argmin (at
the shapes of ``argmin_inputs``) and of the streamed tile and the
two-pass sums (at the shapes of ``two_pass_inputs``) after the build and
exits; it calls only entry points every version of the port has, so a
copy of this file put in the root of an unpacked ``git archive`` of
another commit digests that commit's kernels on the same inputs.

Phases (any failed check raises, and the script exits non-zero):

1. Build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc for
   sm_90a; print build times and ptxas's register / spill lines.
2. Hold each kernel against its plain PyTorch version on the card at the
   paths' shapes (full data, all sites batched, the 1.5M-slot coresets of
   phases 3 and 5, 256 stacked serving tenants) plus ragged, d=256,
   forced-tie and coincident-centre cases, and for both resident
   statistics kernels a view from row 1 (odd offset), k = 1, the largest k
   whose block fits shared memory and one more (the two-pass form: the
   distance_argmin kernel, then lloyd_reduce or weiszfeld_reduce, with no
   plain version running), and a NaN row; wherever lloyd_stats or
   weiszfeld_stats runs fused, lloyd_reduce or weiszfeld_reduce on
   distance_argmin's outputs must equal it bit for bit. Value error,
   argmin flips (each must be a near tie) and, for the fused statistics,
   arithmetic error against the reduction recomputed from the kernel's own
   assignment are reported apart; reruns must be bit-identical, and the
   batched argmin must equal a loop of single-tenant launches bit for bit,
   and the one-centre kernel (D^2 seeding) must equal the resident and the
   general tile with the centre padded to 64 sentinel rows bit for bit, at
   the sites' and (phase 3) the coreset's shapes. The resident
   distance_argmin tile must equal the general tile bit for bit (each
   through its own entry, and the routed entry's output too, whose launch
   must count under the kernel the routing picks) on the full data, the
   sites and the serving buckets m = 8, 16, 32, 64 and 1,024, and the two
   are timed side by side there: CUDA events in turns (resident, tile,
   tile, resident) and the profiler's device time per launch. Then time
   kernel, plain version and a PyTorch library yardstick, beside the bound
   from the shapes, at full data and (all three general kernels) at the
   sites' shape; weiszfeld_reduce at data selection's shape (8 x 2,048 x
   4,096, k = 8) and the sites' with k = 320, first held there through
   weiszfeld_stats (two launches, no plain version) and timed only within
   SUM_RTOL of the plain reduction; distance_argmin's streamed tile (the
   routed entry's kernel above the resident limit) equal to the general
   tile bit for bit at selection's shape, phase 15's and a d that is not a
   multiple of 4, and timed at selection's beside the general tile, the
   plain version, the library call and the bound. A sha256 digest of
   distance_argmin's outputs at those shapes and 30 small ones, of
   lloyd_stats' and weiszfeld_stats' outputs at the sites' and the
   coresets' shapes, of lloyd_reduce's and weiszfeld_reduce's at
   selection's and the sites' with k = 320, and of each route's centres,
   lets two trees be compared bit for bit.
3. The main path at full size -- ``graph_distributed_kmeans`` on the
   yearpredictionmsd stand-in (515,345 x 90, k=50), 100 sites on a 10x10
   grid, t = 3 k n = 15,000, flood and BFS-tree routes -- with the cost
   ratio against the centralized baseline, ledgers, wall per phase,
   launches per kernel (counted from zero just before each route; the
   distance_argmin launches split by the kernel that served them), peak
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
   to dispatches, split between the two tiles as the engine's dispatches
   per shape say; queries per second and step latency, beside the same
   traffic through the per-tenant loop.
7. The paper's comparisons and the remaining core paths on phase 3's
   instance, each with its launches (counted from zero around the run) and
   centre digests: Figure 2's largest setting, ours against COMBINE at t =
   3 k n; Figure 3's, ours against Zhang et al. on the BFS tree at the
   budget 4 k n h (both averaged over two runs, as the paper's figures;
   Zhang's ratio printed, not gated); BFS and min-cost routing on
   ``wan_clusters(10, 10)`` (centres equal phase 3's flood centres,
   ledgers equal the analytic ones, min-cost cheaper in link cost);
   ``kmeans_trimmed(0.01)`` and ``power(1.5)`` against centralized solves
   in their own objectives; the ``cohen_addad`` and ``mapreduce``
   strategies; bit-identical reruns. Then, on phase 4's scale-0.1
   instance, each new path and COMBINE with backend='cuda' against
   backend='torch': t_i, ledgers, and centres or full-data cost to the
   tolerances stated at the top (the power objectives' centres printed
   only, their IRLS step off the data points held). ``--spread N`` repeats Figure 2
   and the trimmed route on N more keys and with the plain backend.
8. The topology execution engine (``engine="exec"``, backend='cuda'), each
   run held to ``engine="sim"`` on the same inputs and key: the flood on
   ``grid(5, 5)`` (the full data in 25 weighted sites, t = 3 k n = 3,750)
   for k-means and k-median (centres, coreset and every ledger axis equal
   to sim's, every node's table, allocation and total equal to node 0's,
   nodes 0, 12 and 24 solving the same centres, complete within the
   diameter, the same launches as sim); the BFS tree on phase 3's sites
   (centres equal to phase 3's BFS centres and digest, ledger equal by
   phase, every node holding the centres); the min-cost tree on
   ``wan_clusters(10, 10)`` (ledger, link cost included, equal to phase
   7's sim). Each run prints its wall beside sim's, its phases, each
   executed primitive's rounds and wall, and its peak device memory.

9. The staged Round-1/Round-2 engine (``staged_distributed_coreset``) on
   phase 8's 25 sites: strict mode (k-means under algorithm1, cohen_addad
   and mapreduce, k-median under algorithm1) bit-equal to
   ``distributed_coreset`` field by field, with each kernel launched 25
   times as often as lockstep (one launch per site); overlap mode (tol =
   1e-3, site buckets) for both objectives: a bit-identical rerun, sum t_i
   = t, the bucket lengths, the cost ratio of a solve on the coreset; the
   kernels held to their plain versions at one site's and one bucket's
   shape; walls of both rounds and peak memory beside lockstep's.
10. The streaming subsystem at full width (k = 50, t = 1,000, d = 90): a
   ``StreamState`` fed the full data in arrivals of 10,000 rows (mass,
   occupancy = the bits of 31, a rerun of the first 14 arrivals
   bit-identical, within 2x the offline pipeline); a ``ClusterQueryService`` on it answering 20 batches
   of 8..4,096 rows and a 10,000-row burst (answers bit-equal to
   ``query_assignments``, ``query_load`` equal to their counts); a
   ``DistributedStream`` on ``grid(5, 5)`` with two resample rounds on
   sim / exec x flood / BFS tree (exec bit-equal to sim, ledgers by phase)
   and a forced union round (the analytic ledger, the data's mass).
11. The SPMD mesh path (``spmd_distributed_kmeans`` on ranks spawned by
   ``repro_torch.core.mesh.launch``) on phase 3's sites and budget, the
   ranks sharing the card over gloo with host staging: W = 4 (25 sites
   merged per rank; k-means under the three collectives and a rerun,
   k-median under two, mapreduce) and W = 10 (k-means under the three and
   a rerun), then W = 1 on nccl against gloo, and an NCCL group of 2 ranks
   on the one card (its refusal printed). Modes, reruns and ranks
   bit-identical; t_i the host allocation of the gathered costs; cost
   ratios; launches and staged bytes per rank as predicted; the kernels
   held to their plain versions at one rank's merged-site shape. Per rank:
   the walls of each round and gather, bytes received, hops, staged bytes,
   peak memory.
12. The asynchronous WAN runtime (``engine="async"``, ``faults=``) and
   data selection. (a) Phase 8's 25 sites on ``wan_clusters(5, 5)`` (max
   degree 7, diameter 3, clock periods up to 16; Round 2's relay table
   0.86 GB): async full mode against exec for k-means and k-median
   (coreset, centres, ledger axes, staleness 0, launches); the clock
   default and random gossip against exec's centres (staleness under
   clock, completion within P x D, a bit-identical random rerun); a fault
   plan F (7 links dropped, node 23 dead, 13 and 18 churning, duplicates)
   under exec and async, each equal to the restricted oracle and its solve
   with no row of site 23; F's quiescence certificates in full (with the
   clustering check), clock and random mode; on phase 10's
   ``DistributedStream`` a union and a resample round in async full mode
   equal to exec and a faulty union round carrying the survivors' mass.
   Each flood prints its rounds, completion, quiescence, staleness and
   wall, each run its wall and peak memory. (b) ``embed_examples`` and
   ``select_coreset`` at llama3-8b's embedding widths (a random-init
   128,256 x 4,096 table, 8 sites x 2,048 examples x 512 tokens, k = 8, t
   = a quarter of the pool): sum t_i = t, the pool's mass, indices in
   range, a bit-identical rerun, ``gather_selected``'s shapes, and the d =
   4,096 routes (one-centre kernel, streamed tile, lloyd_stats' and
   weiszfeld_stats' two-pass forms through the lloyd_reduce and
   weiszfeld_reduce kernels) held to their plain versions, and
   lloyd_reduce timed there beside its plain version, the library's
   index_add_ and its bound.
13. The roofline of the main paths (``repro_torch.roofline``): phase 3's
   k-means and phase 5's k-median flood routes, one serving step of phase
   6, one ``select_coreset`` of phase 12 and a k-median solve of the
   selection's embeddings (d = 4,096: weiszfeld_reduce; held before to
   the same solve by backend='torch', full-data cost within
   DRAW_COST_RTOL, and digested), each under
   ``roofline.record()`` and the profiler: per phase and function calls,
   flops, bytes, bound, device time and bound / device, busy time, idle
   share and a ``RooflineReport``'s three terms; the ledger's calls equal
   the launch counters, every kernel launch under a ledger call, no bound
   / device above 1.05, digests unchanged with recording on; the ledger
   at scale 0.1 equal under backend='cuda' and 'torch'; phase 11's W = 4
   all-gather collectives by phase against the bytes it received.

14. The language-model stack (``repro_torch.models``, ``repro_torch.train
   .loss``), which reaches no kernel of the port: (a) the ten reduced
   configurations on the same seeded params on the card and on the CPU,
   forward, prefill and decode logits and the aux loss, in exactified f32
   (within 2e-4 of max |logit|, digested) and in bf16 (within 5e-2; a MoE
   model's score forward up to each row's first routing flip, each flip at
   a near tie); (b) llama3-8b whole (32 layers, d 4,096, vocab 128,256,
   f32 params): a bf16 score forward at B = 2, L = 2,048 (wall, tokens/s)
   and ``lm_loss`` on it, a prefill of 2,048 tokens into a cache of 2,080,
   32 decode steps (ms per token), and, exactified to f32, prefill and
   decode logits equal to the score forward's within 5e-4 of max |logit|;
   (c) the same for granite-moe-3b (40 experts, top 8), mamba2-370m
   (within 5e-3: the SSD's chunked scan loses ~1e-3 in f32 at its widths),
   recurrentgemma-2b (a prefill past its 2,048-token window: the ring
   cache) and qwen2-vl-2b (M-RoPE) at their published widths; peak memory
   per model; one llama3-8b layer's attention against
   ``scaled_dot_product_attention``.
15. Training and LM serving (``repro_torch.train``, ``optim``,
   ``checkpoint``, ``serve.engine``, ``data.BigramLM``): (a) each reduced
   configuration in f32, one train step (remat "full", the chunked loss)
   on the card against the CPU from the same params -- the loss, every
   gradient leaf (to 1e-4 of its largest) and the params after the step
   under the CPU tests' rules -- and for llama3-8b reduced ``microbatches=2`` and 30 steps with bf16
   params and an f32 master (the loss falls, per-step losses within 2e-2
   of the CPU's); (b) llama3-8b at its published widths cut to 2 layers
   (1.49B params; whole it needs 128 GB of f32 state): a bigram pool of
   512 examples of 2,048 tokens embedded with its table and selected by
   ``select_coreset`` (k = 8, t = 0.25 of the pool: the one-centre kernel,
   the streamed tile at d = 4,096 and ``lloyd_reduce`` launch here), 3
   steps of 2 x 2,048 tokens (walls, tokens/s, losses, peak memory), its
   params saved through ``AsyncCheckpointer``, restored onto the CPU and
   moved back to the card bit for bit; (c) the slot engine on llama3-8b whole
   in f32 (4 slots, 6 requests, 16 new tokens each) equal to ``generate``
   per request, tokens/s and ms per step; (d) mamba2-370m whole: the f32
   loss and gradients held against the CPU (to 1e-5 and 1e-2: its SSD's
   f32 exponents at these widths), then 5 bf16 steps whose loss falls.

16. The launchers (``repro_torch.launch``): (a) ``launch.train.main`` as a
   user calls it -- llama3-8b at its published widths cut to 2 layers,
   2 steps of 2 x 2,048 tokens on the set its ``--data-selection
   coreset`` keeps (the selection's launches held as phase 15 (b)'s, and
   the one-centre kernel, the streamed tile and ``lloyd_reduce`` held
   against their plain versions on its embeddings at d = 4,096; step
   walls, tokens/s, losses); (b) the trainer on mamba2-370m reduced as
   its own process under ``ft.Supervisor``, crashing at
   ``REPRO_FAIL_AT_STEP``, restarted, resumed from its checkpoint, its
   final checkpoint bit-equal to an uninterrupted run's; (c) ``--mesh
   2x1``, two gloo ranks sharing the card, against one process with two
   microbatches on the same global batch; (d) ``launch.serve.main``; (e)
   ``launch.dryrun.run_cell`` for llama3-8b's three cells on the
   single-pod mesh and gemma3-27b's ``long_500k`` (meta tensors, a host
   process of its own started before phase 14; temp bytes and the
   collectives read from rank 0 of the port's sharded step on a
   stand-in of the 16 x 16 grid): bytes, collective counts by kind,
   terms and fits against the card's figures, llama3-8b ``train_4k``
   held to fit; (f) the trainer of (a) on a 1x2 (data,
   model) mesh, two gloo ranks sharing the card, tensor and sequence
   parallel over ``model``, on (a)'s selected batches: losses against
   (a)'s, leaves held by both ranks bit-equal, step walls, each rank's
   peak memory, param and AdamW bytes against (a)'s, staged bytes; (g)
   (c)'s reduced run on a 2x2 mesh, four ranks, twice: losses against
   (c)'s microbatched run, the two runs' final checkpoints digested; (h)
   the trainer on a 1x2 mesh for granite-moe-3b-a800m (experts split over
   ``model``), mamba2-370m (SSD heads) and recurrentgemma-2b (RG-LRU
   channels) at their published widths, cut in depth, 2 steps of 2 x
   1,024 tokens each: losses against each family's 1x1 run on the same
   batches, leaves held by both ranks bit-equal, param and AdamW bytes a
   rank about half of 1x1's, step walls, peak memory and staged bytes a
   rank, a fingerprint of each family's final state; (i) on (h)'s ranks
   and each family's final params, ``models.forward`` with a cache on
   the 1x2 mesh (sequence-parallel prefill of 2 x 2,048 tokens, 16
   flash-decode steps, the KV cache's length cut over ``model``; for
   granite-moe also an int8 KV cache and f32 activations) against the
   same run in one process: logits within a bound, picks equal but at near ties, cache
   bytes a rank the layout's shards', walls and staged bytes, each
   family's picks digested.

Every bound is ``repro_torch.roofline.work``'s on the card's data-sheet
figures (``roofline.report.detect``). It prints a ``{"kernels": [...]}``
line (each entry also with its launches on phases 9, 10, 11, 12, 15 and
16), the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
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
# runs per comparison of phase 7, as the paper's figures average them
PAPER_RUNS = 2
# phase 7 at scale 0.1, cuda against torch backend: the full-data cost of
# the centres, relative, where a path's draws rest on masses' last bits
# (the CPU parity tests' bound for the strategies and COMBINE)
DRAW_COST_RTOL = 1e-3


class CheckFailed(RuntimeError):
    pass


def digest(*tensors):
    """sha256 of the tensors' bytes, in order (first 16 hex digits)."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def fingerprint(*tensors):
    """A digest of the tensors' bits computed on their device: each
    tensor's 32-bit words (16-bit for a 2-byte dtype) weighted by their
    position modulo 65,521 and summed in int64, the sums sha256-hashed
    (first 16 hex digits). Equal inputs give equal fingerprints; a
    changed word changes its tensor's sum. For states too large to copy
    to the host in time."""
    h = hashlib.sha256()
    for x in tensors:
        x = x.detach().contiguous().reshape(-1)
        word = {8: torch.int64, 4: torch.int32, 2: torch.int16,
                1: torch.uint8}[x.element_size()]
        w = x.view(word).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        h.update(str((int((w * pos).sum()), w.numel())).encode())
    return h.hexdigest()[:16]


def argmin_inputs(pts, sp, k, seed, sentinel):
    """The shapes at which distance_argmin's outputs are digested, made from
    ``seed`` with numpy: label -> (batched, points, centres). The full data
    and the sites with ``k`` centres (data rows); serving's 256 tenants, 64
    centre rows each with 2..64 live (the rest at ``sentinel``), against 8,
    16, 32, 64 and 1,024 queries each; and 30 small shapes, 3 sites of
    1,001 rows, d in {1, 3, 33, 90, 256} x k in {2, 50, 64, 65, 256, 320},
    the points a view from one float into their storage with a NaN row."""
    rng = np.random.default_rng(seed)
    dev, (n, d) = pts.device, pts.shape

    def pick(x, count):
        """``count`` random rows of x (..., m, d) per leading index."""
        idx = torch.from_numpy(rng.integers(0, x.shape[-2], count))
        return x[..., idx.to(dev), :].contiguous()

    cases = {"full data": (False, pts[None], pick(pts, k)[None]),
             "sites": (False, sp, pick(sp, k))}
    T, KB = 256, 64
    live = torch.from_numpy(np.arange(KB)[None, :] < rng.integers(
        2, KB + 1, T)[:, None]).to(dev)
    c_srv = torch.where(live[..., None], pick(pts, T * KB).view(T, KB, d),
                        sentinel)
    for m in (8, 16, 32, 64, 1024):
        cases[f"batched m={m}"] = (True, pick(pts, T * m).view(T, m, d),
                                   c_srv)
    for dd in (1, 3, 33, 90, 256):
        for kk in (2, 50, 64, 65, 256, 320):
            p = torch.empty(3 * 1001 * dd + 1, device=dev)[1:].view(
                3, 1001, dd)
            p.copy_(torch.from_numpy(rng.standard_normal(
                (3, 1001, dd), dtype=np.float32)))
            p[2, 500, 0] = float("nan")
            cases[f"d={dd} k={kk}"] = (False, p, torch.from_numpy(
                rng.standard_normal((3, kk, dd), dtype=np.float32)).to(dev))
    return cases


def argmin_digests(cases, ops):
    """Digests of ``(min_d2, argmin)`` at each of :func:`argmin_inputs`'
    shapes, through the entry points every version of the port has."""
    out = {}
    for label, (batched, p, c) in cases.items():
        fn = ops.min_dist_argmin_batched if batched else ops.min_dist_argmin
        out[f"distance_argmin[{label}]"] = digest(*fn(p, c))
    return out


# the streamed tile's shapes besides data selection's: phase 15's 2 sites
# x 256 embeddings, and a d that is not a multiple of 4 (4-byte copies, a
# ragged last chunk) at 65 centres (passes of 16 slots); the CUDA tests
# take more
STREAM_SHAPES = (("training selection", 2, 256, 8, 4096),
                 ("d=4095 k=65", 2, 777, 65, 4095))


def two_pass_inputs(dev, seed, sp, sm):
    """The inputs at which phase 2 holds, times and digests the streamed
    tile and the two-pass form's sums, made from ``seed``: data
    selection's shape (8 sites x 2,048 rows x 4,096 features, k = 8, the
    centres rows of the points, signed weights), the sites ``sp`` with 320
    of their rows as centres and the mask ``sm`` as weights (past the fused
    kernels' limit at d = 90), and :data:`STREAM_SHAPES` (no weights).
    label -> (points, centres, weights or None)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 25)
    p_sel = torch.randn((8, 2048, 4096), generator=gen, device=dev)
    w_sel = torch.rand((8, 2048), generator=gen, device=dev) * 2.0 - 1.0
    pick = torch.randint(0, sp.shape[1], (320,), generator=gen, device=dev)
    cases = {"selection": (p_sel, p_sel[:, :8].clone(), w_sel),
             "sites, k = 320": (sp, sp[:, pick].contiguous(), sm.float())}
    for label, S1, M1, k1, d1 in STREAM_SHAPES:
        p = torch.randn((S1, M1, d1), generator=gen, device=dev)
        cases[label] = (p, p[:, :k1].clone(), None)
    return cases


def two_pass_digests(cases, ops):
    """Digests of ``ops.min_dist_argmin`` at each of
    :func:`two_pass_inputs`' shapes and, where they carry weights, of
    ``ops.weiszfeld_reduce`` and ``ops.lloyd_reduce`` given its assignment
    and min d2: entry points every version of the port has."""
    out = {}
    for label, (p, c, w) in cases.items():
        md, am = ops.min_dist_argmin(p, c)
        out[f"distance_argmin[{label}]"] = digest(md, am)
        if w is not None:
            out[f"weiszfeld_reduce[{label}]"] = digest(
                *ops.weiszfeld_reduce(p, c, w, am))
            out[f"lloyd_reduce[{label}]"] = digest(
                *ops.lloyd_reduce(p, c.shape[-2], w.abs(), md, am))
    return out


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


def expect_launches(label, got, by_kernel, *, argmin_one_center=0,
                    argmin_resident=0, lloyd=0):
    """Hold a run's launches to the counts its path implies: one-centre
    (D^z seeding) and resident-tile distance_argmin launches, lloyd_stats
    launches, and no weiszfeld_stats, batched, lloyd_reduce or
    weiszfeld_reduce launch."""
    want = {"distance_argmin": argmin_one_center + argmin_resident,
            "lloyd_stats": lloyd, "weiszfeld_stats": 0,
            "distance_argmin_batched": 0, "lloyd_reduce": 0,
            "weiszfeld_reduce": 0}
    check(got == want, f"{label}: launches {got}, expected {want}")
    want_by = {"distance_one_center": argmin_one_center,
               "distance_argmin_resident": argmin_resident,
               "distance_argmin_tile": 0, "distance_argmin_stream": 0}
    check(by_kernel == want_by,
          f"{label}: distance_argmin launches by kernel {by_kernel}, "
          f"expected {want_by}")


def phase7(seed, dev, pts, sp, sm, g, k, t, base_cost, flood, counts,
           digests, small, spread=0):
    """The paper's comparisons and the remaining core paths at full width,
    on phase 3's instance (``pts``, sites ``sp`` / ``sm`` on ``g``, budget
    ``t``), its centralized k-means cost ``base_cost`` and its flood
    result ``flood``; then each new path with backend='cuda' against
    backend='torch' on phase 4's instance ``small`` (data, sites, mask).
    ``counts`` is (set every launch count to 0, launches per kernel entry,
    distance_argmin launches by the kernel that served them). With
    ``spread`` > 0, Figure 2 and the trimmed run are also repeated with the
    plain backend at run 0's key and on ``spread`` further keys. Adds its
    digests to ``digests``; any failed check raises. Returns the results
    of the BFS and min-cost routes on ``wan_clusters(10, 10)``, by
    routing."""
    reset_counts, entry_counts, route_counts = counts
    from repro_torch.core import clustering, comm, prng
    from repro_torch.core.backend import get_backend
    from repro_torch.core.baselines import combine, combine_ledger, zhang_tree
    from repro_torch.core.coreset import (distributed_coreset,
                                          proportional_allocation)
    from repro_torch.core.distributed import (_solve_on_coreset,
                                              graph_distributed_kmeans)
    from repro_torch.core.objective import get_objective
    from repro_torch.core.topology import (bfs_spanning_tree, spanning_tree,
                                           wan_clusters)

    n, d = pts.shape
    S = sp.shape[0]
    key = prng.PRNGKey(seed, device=dev)
    # the evaluation averages each comparison over runs on PRNGKey(seed +
    # 100 r) (benchmarks/common.py avg_over_runs; 2 runs in its figures)
    run_keys = [prng.PRNGKey(seed + 100 * r, device=dev)
                for r in range(PAPER_RUNS)]

    def ratio(centers, objective="kmeans", base=base_cost):
        r = float(clustering.cost(pts, centers, objective=objective,
                                  device=dev)) / base
        check(np.isfinite(r) and r > 0, f"cost ratio {r}")
        return r

    def solve(run_key, cs, backend=None):
        """The evaluation's final solve: 12 Lloyd steps on fold_in(key,
        1)."""
        return _solve_on_coreset(prng.fold_in(run_key, 1), cs, k, "kmeans",
                                 12, backend)

    def timed(run):
        """``run()`` with the launch counts from zero, its wall seconds and
        its launches."""
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, entry_counts(), route_counts()

    def tree_ledger(tree, t_i, exchange=True):
        """The Theorem-3 ledger of a tree route for ``t_i``."""
        up = comm.tree_up_cost(tree, [float(x) + k for x in t_i],
                               dim=d).tag("round2_gather")
        led = (comm.tree_allocation_cost(tree).tag("round1").add(up)
               if exchange else up)
        return led.add(comm.tree_broadcast_cost(
            tree, unit_points=float(k), dim=d).tag("round2_broadcast"))

    def compare(label, t_ours, name, baseline, check_baseline):
        """Ours (the coreset with 5 Lloyd steps per site, then the final
        solve) against a baseline over the runs: per run the two cost
        ratios, the baseline's wall and launches (checked by
        ``check_baseline``) and digests; returns the per-run ratios and
        ours' t_i of the first run."""
        rs_ours, rs_base, walls = [], [], []
        for r, run_key in enumerate(run_keys):
            dc = distributed_coreset(run_key, sp, sm, k, t_ours, device=dev)
            c_ours = solve(run_key, dc.flatten())
            cs, wall, launches, by_kernel = timed(lambda: baseline(run_key))
            check_baseline(cs, launches, by_kernel)
            rs_ours.append(ratio(c_ours))
            rs_base.append(ratio(solve(run_key, cs)))
            walls.append(wall)
            if r == 0:
                t_i = dc.t_i.cpu().numpy()
            digests[f"{label} ours centres[run {r}]"] = digest(c_ours)
            digests[f"{name} coreset[run {r}]"] = digest(cs.points,
                                                         cs.weights)
            check(rs_ours[-1] < MAX_COST_RATIO,
                  f"{label} ours, run {r}: cost ratio {rs_ours[-1]}")
        return rs_ours, rs_base, walls, launches, by_kernel, t_i

    def runs(xs):
        return (" / ".join(f"{x:.6f}" for x in xs)
                + f" (mean {float(np.mean(xs)):.6f})")

    print("phase 7: the paper's comparisons and the remaining core paths")
    # -- Figure 2 at its largest setting: ours vs COMBINE --------------------
    s_comb = t // S

    def check_combine(cs, launches, by_kernel):
        check(cs.points.shape == (S * (s_comb + k), d)
              and abs(float(cs.weights.double().sum()) - n) <= 1e-3 * n,
              f"COMBINE coreset {tuple(cs.points.shape)} of weight "
              f"{float(cs.weights.double().sum())}")
        # per step one launch for all sites: k seeding steps, 5 Lloyd
        # steps, one sensitivity pass
        expect_launches("COMBINE", launches, by_kernel, argmin_one_center=k,
                        argmin_resident=1, lloyd=5)

    rs_ours, rs_comb, walls, launches, by_kernel, t_i2 = compare(
        "fig2", t, "combine",
        lambda kr: combine(kr, sp, sm, k, t, device=dev),
        check_combine)
    led_ours = comm.flood_cost(g, n_messages=g.n, unit_scalars=1.0).add(
        comm.flood_portions_cost(g, t_i2, k, d))
    led_comb = combine_ledger(g, S, k, t, d)
    print(f"  Figure 2 (t = {t}, {PAPER_RUNS} runs): ours cost ratio "
          f"{runs(rs_ours)}, COMBINE {runs(rs_comb)}; points sent: ours "
          f"(flood) {led_ours.points:.0f}, COMBINE {led_comb.points:.0f}; "
          f"bytes: ours {led_ours.bytes:.0f}, COMBINE {led_comb.bytes:.0f}")
    print(f"  COMBINE ({S} sites x {s_comb} + {k}): wall "
          f"{' / '.join(f'{w:.3f}' for w in walls)} s, launches per run "
          f"{json.dumps(launches)}; distance_argmin by kernel "
          f"{json.dumps(by_kernel)}")

    # -- Figure 3 at its largest setting: ours vs Zhang et al. ---------------
    tree = bfs_spanning_tree(g, root=0)
    mean_depth = float(np.mean(tree.depth))
    budget = int(4 * k * g.n * max(tree.height, 1))
    t3 = max(int(budget / max(mean_depth, 1e-9) - g.n * k), k)
    s3 = max(int(budget / (g.n - 1) - k), k)
    led_z = {}

    def zhang(run_key):
        cs, led_z["ledger"] = zhang_tree(run_key, sp, sm, tree, k, s3,
                                         device=dev)
        return cs

    def check_zhang(cs, launches, by_kernel):
        check(led_z["ledger"].points == (g.n - 1) * (s3 + k)
              and cs.points.shape == (s3 + k, d)
              and abs(float(cs.weights.double().sum()) - n) <= 1e-3 * n,
              f"Zhang: ledger {led_z['ledger'].points} points, root "
              f"coreset {tuple(cs.points.shape)}")
        # every node builds one coreset: per node k seeding steps, 5 Lloyd
        # steps and one sensitivity pass
        expect_launches("Zhang", launches, by_kernel,
                        argmin_one_center=g.n * k, argmin_resident=g.n,
                        lloyd=5 * g.n)

    rs_ours3, rs_z, walls, launches, by_kernel, t_i3 = compare(
        "fig3", t3, "zhang root", zhang, check_zhang)
    led_ours3 = tree_ledger(tree, t_i3)
    own = sm.sum(1).cpu().numpy()
    rows_at = [int(own[v]) + len(ch) * (s3 + k)
               for v, ch in enumerate(tree.children())]
    padded = max(-(-r // 256) * 256 for r in rows_at)
    print(f"  Figure 3 (BFS tree, root 0, height {tree.height}, mean depth "
          f"{mean_depth:g}; budget {budget} points: ours t = {t3}, Zhang "
          f"s = {s3}; {PAPER_RUNS} runs): ours cost ratio "
          f"{runs(rs_ours3)}, Zhang {runs(rs_z)} (printed, not gated); "
          f"points sent: ours (tree) {led_ours3.points:.0f}, Zhang "
          f"{led_z['ledger'].points:.0f}")
    print(f"  Zhang ({g.n} nodes, leaves to root): wall "
          f"{' / '.join(f'{w:.3f}' for w in walls)} s, launches per run "
          f"{json.dumps(launches)}; distance_argmin by kernel "
          f"{json.dumps(by_kernel)}; node instances {min(rows_at)}.."
          f"{max(rows_at)} rows (largest padded to {padded})")

    # -- min-cost routing on racks joined by expensive links -----------------
    gw = wan_clusters(10, 10)
    t_i = proportional_allocation(flood.local_costs, t).cpu().numpy()
    routed = {}
    for routing in ("bfs", "min_cost"):
        res = graph_distributed_kmeans(key, sp, sm, k, t, gw,
                                       routing=routing, device=dev)
        tr = spanning_tree(gw, routing=routing)
        led = res.ledger.as_dict(by_phase=True)
        check(torch.equal(res.centers, flood.centers),
              f"wan_clusters {routing}: centres differ from phase 3's flood "
              f"centres")
        check(led == tree_ledger(tr, t_i).as_dict(by_phase=True),
              f"wan_clusters {routing}: ledger differs from the analytic one")
        routed[routing] = (res, tr)
        digests[f"kmeans centres[wan_clusters {routing}]"] = digest(
            res.centers)
        print(f"  wan_clusters(10, 10) {routing}: tree height {tr.height}, "
              f"tree link cost {tr.edge_cost_total():g}; ledger points "
              f"{res.ledger.points:.0f}, bytes {res.ledger.bytes:.0f}, "
              f"link cost {res.ledger.link_cost:.0f}; centres equal phase "
              f"3's flood centres, ledger equal the analytic one")
    lc_bfs = routed["bfs"][0].ledger.link_cost
    lc_min = routed["min_cost"][0].ledger.link_cost
    check(lc_min < lc_bfs, f"min-cost link cost {lc_min} >= BFS {lc_bfs}")
    print(f"  min-cost routing prices {lc_min / lc_bfs:.4f}x BFS's link cost")

    # -- the trimmed and power objectives ------------------------------------
    def drive(objective="kmeans", strategy=None, routing="flood"):
        return graph_distributed_kmeans(key, sp, sm, k, t, g,
                                        objective=objective,
                                        strategy=strategy, routing=routing,
                                        device=dev)

    for name, lloyd in (("kmeans_trimmed(0.01)", 16), ("power(1.5)", 0)):
        t0 = time.perf_counter()
        _, base = clustering.solve(prng.PRNGKey(seed + 7), pts, k,
                                   lloyd_iters=12, restarts=3,
                                   objective=name, device=dev)
        base = float(base)
        base_s = time.perf_counter() - t0
        res, wall, launches, by_kernel = timed(lambda: drive(name))
        r = ratio(res.centers, name, base)
        # seeding k one-centre launches twice (Round 1, the solve); one
        # assignment pass per update step (8 + 8) and the sensitivities'
        expect_launches(name, launches, by_kernel, argmin_one_center=2 * k,
                        argmin_resident=2 * 8 + 1, lloyd=lloyd)
        again = drive(name)
        check(torch.equal(again.centers, res.centers),
              f"{name}: a second run gives other centres")
        digests[f"{name} centres"] = digest(res.centers)
        print(f"  {name} (flood): cost ratio {r:.6f} against a centralized "
              f"{name} solve ({base:.6g}, {base_s:.2f} s), wall {wall:.3f} "
              f"s, launches {json.dumps(launches)}; distance_argmin by "
              f"kernel {json.dumps(by_kernel)}; second run bit-identical")
        check(r < MAX_COST_RATIO, f"{name}: cost ratio {r}")

    # -- the cohen_addad and mapreduce strategies -----------------------------
    for name, routing in (("cohen_addad", "flood"), ("mapreduce", "flood")):
        res, wall, launches, by_kernel = timed(
            lambda: drive(strategy=name, routing=routing))
        r = ratio(res.centers)
        expect_launches(name, launches, by_kernel, argmin_one_center=2 * k,
                        argmin_resident=1, lloyd=2 * 8)
        led = res.ledger.as_dict(by_phase=True)
        if name == "mapreduce":
            # no scalar round: the flood route takes the BFS tree
            t_mr = np.full(S, t // S) + (np.arange(S) < t % S)
            check(led == tree_ledger(bfs_spanning_tree(g), t_mr, False
                                     ).as_dict(by_phase=True),
                  f"mapreduce: ledger {led}")
        if name == "cohen_addad":
            again = drive(strategy=name, routing=routing)
            check(torch.equal(again.centers, res.centers),
                  "cohen_addad: a second run gives other centres")
        digests[f"{name} centres"] = digest(res.centers)
        print(f"  {name} ({'BFS tree' if name == 'mapreduce' else routing})"
              f": cost ratio {r:.6f}, ledger bytes {res.ledger.bytes:.0f} "
              f"(phase 3's flood: {flood.ledger.bytes:.0f}), wall "
              f"{wall:.3f} s, launches {json.dumps(launches)}"
              + ("; second run bit-identical" if name == "cohen_addad"
                 else ""))
        check(r < MAX_COST_RATIO, f"{name}: cost ratio {r}")

    # -- the new paths' kernels against their plain versions (scale 0.1) -----
    data_s, sp_s, sm_s = small
    pts_s = torch.from_numpy(data_s).to(dev)
    k1 = prng.split(key)[0]   # graph_distributed_kmeans' Round-1/2 key
    fails = []

    def full_cost(centers, objective="kmeans"):
        return float(clustering.cost(pts_s, centers, objective=objective,
                                     backend="torch", device=dev))

    def gaps(label, c_cuda, c_torch, objective, rtol):
        """Print and hold the two backends' centres: within CENTER_RTOL of
        max |centre| (rtol None), or full-data cost within ``rtol``."""
        err = float((c_cuda - c_torch).abs().max())
        cmax = float(c_torch.abs().max())
        cr = full_cost(c_cuda, objective) / full_cost(c_torch, objective)
        if rtol is None and err > CENTER_RTOL * cmax:
            fails.append(f"{label}: centres differ by {err} (max |centre| "
                         f"{cmax})")
        if rtol is not None and abs(cr - 1.0) > rtol:
            fails.append(f"{label}: full-data cost cuda/torch {cr}")
        return (f"max |centre diff| {err:.3g} (max |centre| {cmax:.3g}), "
                f"full-data cost cuda/torch {cr:.8f}")

    print(f"  backend='cuda' against backend='torch' at scale 0.1 "
          f"(n={data_s.shape[0]}):")
    for name, strategy, rtol in (
            ("kmeans_trimmed(0.01)", None, None),
            ("power(3)", None, math.inf),
            ("power(1.5)", None, math.inf),
            ("kmeans", "cohen_addad", DRAW_COST_RTOL),
            ("kmeans", "mapreduce", DRAW_COST_RTOL)):
        label = strategy or name
        res, t_i = {}, {}
        for b in ("cuda", "torch"):
            res[b] = graph_distributed_kmeans(
                key, sp_s, sm_s, k, t, g, objective=name, strategy=strategy,
                backend=b, device=dev)
            t_i[b] = distributed_coreset(
                k1, sp_s, sm_s, k, t, objective=name, strategy=strategy,
                lloyd_iters=8, backend=b, device=dev).t_i
        t_gap = int((t_i["cuda"] - t_i["torch"]).abs().max())
        same_led = (res["cuda"].ledger.as_dict(by_phase=True)
                    == res["torch"].ledger.as_dict(by_phase=True))
        # cohen_addad's site totals are 1 + the non-empty clusters up to
        # rounding: a last bit can move a site's floor by one and its
        # remainder award by one. The power objectives' centres are not
        # held: seeding leaves centres on data points, where the distance
        # pass's cancellation noise decides the IRLS mass (d2 +
        # 1e-6)^((z-2)/2) -- for z < 2 already in Round 1 (t_i not held
        # either), for z = 3 in the final solve -- and the JAX package's
        # own result moves as much between its distance passes
        # (tests/test_torch_power_passes.py). Their IRLS step away from
        # the data points is held below.
        t_max = {"cohen_addad": 2, "power(1.5)": t}.get(label, 0)
        if t_gap > t_max:
            fails.append(f"{label}: t_i differ by up to {t_gap}")
        if t_gap == 0 and not same_led:
            fails.append(f"{label}: ledgers differ")
        line = gaps(label, res["cuda"].centers, res["torch"].centers, name,
                    rtol)
        print(f"    {label}: t_i max |diff| {t_gap} (sum "
              f"{int(t_i['cuda'].sum())}), ledgers "
              f"{'equal' if same_led else 'differ'}, {line}"
              + (" (not held)" if rtol == math.inf else ""))
    # one IRLS step at every site, the centres a quarter unit off the data
    # points, so no point sits on a centre
    c0 = sp_s[:, :k] + 0.25
    for name in ("power(3)", "power(1.5)"):
        obj = get_objective(name)
        steps = {b: obj.update(get_backend(b), sp_s, sm_s.to(sp_s.dtype),
                               c0) for b in ("cuda", "torch")}
        err = float((steps["cuda"][0] - steps["torch"][0]).abs().max())
        cmax = float(steps["torch"][0].abs().max())
        cost_gap = float(((steps["cuda"][1] - steps["torch"][1]).abs()
                          / steps["torch"][1].abs()).max())
        if err > CENTER_RTOL * cmax or cost_gap > SUM_RTOL:
            fails.append(f"{name} IRLS step: centres differ by {err}, cost "
                         f"by {cost_gap}")
        print(f"    {name}, one IRLS step off the data points at all "
              f"{sp_s.shape[0]} sites: max |centre diff| {err:.3g} (max "
              f"|centre| {cmax:.3g}), max relative cost diff {cost_gap:.3g}")
    cs = {b: combine(key, sp_s, sm_s, k, t, backend=b, device=dev)
          for b in ("cuda", "torch")}
    live = cs["torch"].weights != 0
    same = float((cs["cuda"].points == cs["torch"].points).all(-1)[live]
                 .double().mean())
    line = gaps("COMBINE", solve(key, cs["cuda"], "cuda"),
                solve(key, cs["torch"], "torch"), "kmeans", DRAW_COST_RTOL)
    print(f"    COMBINE: {same:.4f} of the live slots the same point, final "
          f"solve {line}")
    check(not fails, "phase 7 backend parity: " + "; ".join(fails))
    if spread:
        phase7_spread(seed, dev, pts, sp, sm, g, k, t, ratio, solve, spread)
    return {routing: res for routing, (res, _) in routed.items()}


def phase8(seed, dev, data, k, sp, sm, g, t, sim_bfs, sim_wan, counts,
           digests):
    """The topology execution engine (``engine="exec"``) on the card, each
    run with backend='cuda' and held to ``engine="sim"`` on the same inputs
    and key: the flood on ``grid(5, 5)`` (the full ``data``, ``weighted``
    partition, t = 3 k n) for k-means and k-median, both engines run here;
    the BFS tree on phase 3's sites ``sp`` / ``sm`` over ``g`` at budget
    ``t`` against phase 3's BFS result ``sim_bfs``; the min-cost tree on
    ``wan_clusters(10, 10)`` against phase 7's ``sim_wan``. ``counts`` as
    in :func:`phase7`; adds digests to ``digests``; any failed check
    raises. Returns the flood's 25 sites: (row indices per site, padded
    points, mask)."""
    reset_counts, entry_counts, route_counts = counts
    from repro_torch.core import prng
    from repro_torch.core.coreset import Coreset
    from repro_torch.core.distributed import (_solve_on_coreset,
                                              distributed_kmeans_tree,
                                              graph_distributed_kmeans)
    from repro_torch.core.objective import WEISZFELD_ITERS
    from repro_torch.core.partition import pad_partition, partition_indices
    from repro_torch.core.topology import (bfs_spanning_tree, diameter,
                                           grid, wan_clusters)

    key = prng.PRNGKey(seed, device=dev)
    k2 = prng.split(key)[1]   # the final solve's key of every engine
    print("phase 8: the topology execution engine (engine='exec') on the "
          "card, held to engine='sim'")

    def run(fn, *args, **kw):
        """One run with the launch counts from zero and the peak memory
        reset: (result, wall s, phase walls, launches, distance_argmin
        launches by kernel, (peak GiB, peak GiB above the memory allocated
        at the start))."""
        times = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        res = fn(key, *args, backend="cuda", device=dev, phase_times=times,
                 **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        return (res, wall, times, entry_counts(), route_counts(),
                (peak / 2**30, (peak - start) / 2**30))

    def show(label, out):
        res, wall, times, launches, by_kernel, (peak, above) = out
        print(f"  {label}: wall {wall:.3f} s "
              f"{json.dumps({p: round(x, 4) for p, x in times.items()})}, "
              f"peak device memory {peak:.2f} GiB ({above:.2f} above the "
              f"run's start), launches "
              f"{json.dumps(launches)}; distance_argmin by kernel "
              f"{json.dumps(by_kernel)}")
        if res.exec_detail is not None:
            for name, r in res.exec_detail.rounds.items():
                print(f"    {name}: {r.rounds} rounds (complete after "
                      f"{r.rounds_to_complete}), {r.wall_s:.4f} s, "
                      f"{sum(r.per_round_transmissions)} transmissions")

    def same_run(label, ex, sim):
        """exec against sim: centres and coreset bit for bit, every ledger
        axis by phase, and the same launches per kernel."""
        check(torch.equal(ex[0].centers, sim[0].centers),
              f"{label}: exec centres differ from sim's")
        check(torch.equal(ex[0].coreset.points, sim[0].coreset.points)
              and torch.equal(ex[0].coreset.weights, sim[0].coreset.weights),
              f"{label}: exec coreset differs from sim's")
        check(ex[0].ledger.as_dict(by_phase=True)
              == sim[0].ledger.as_dict(by_phase=True),
              f"{label}: measured ledger {ex[0].ledger.as_dict()} differs "
              f"from the analytic {sim[0].ledger.as_dict()}")
        check(ex[3] == sim[3] and ex[4] == sim[4],
              f"{label}: exec launches {ex[3]} {ex[4]}, sim {sim[3]} "
              f"{sim[4]}")
        print(f"  {label}: exec / sim wall {ex[1] / sim[1]:.3f}; centres, "
              f"coreset, ledger and launches equal")

    # -- the flood on grid(5, 5), 25 sites of the full data -------------------
    g25 = grid(5, 5)
    idx = partition_indices(data, g25.n, "weighted", seed=seed + 1,
                            degrees=g25.degrees())
    sp25, sm25 = (torch.from_numpy(a).to(dev)
                  for a in pad_partition(data, idx))
    t25 = 3 * k * g25.n
    print(f"  flood: {g25.n} sites on grid(5, 5) (diameter {diameter(g25)}),"
          f" padded to M={sp25.shape[1]}, t={t25}")
    walls = {}
    for objective in ("kmeans", "kmedian"):
        out = {engine: run(graph_distributed_kmeans, sp25, sm25, k, t25, g25,
                           objective=objective, engine=engine)
               for engine in ("sim", "exec")}
        for engine in ("sim", "exec"):
            show(f"{objective} flood {engine}", out[engine])
        same_run(f"{objective} flood", out["exec"], out["sim"])
        want = ({"lloyd_stats": 2 * 8, "weiszfeld_stats": 0}
                if objective == "kmeans" else
                {"lloyd_stats": 0,
                 "weiszfeld_stats": 2 * 8 * WEISZFELD_ITERS})
        want.update(distance_argmin=2 * k + 1, distance_argmin_batched=0,
                    lloyd_reduce=0, weiszfeld_reduce=0)
        check(out["exec"][3] == want
              and out["exec"][4]["distance_one_center"] == 2 * k
              and out["exec"][4]["distance_argmin_resident"] == 1,
              f"{objective} flood exec: launches {out['exec'][3]} "
              f"{out['exec'][4]}, expected {want}")
        ex = out["exec"][0]
        det = ex.exec_detail
        for v in range(g25.n):
            check(torch.equal(det.node_points[v], det.node_points[0])
                  and torch.equal(det.node_weights[v], det.node_weights[0])
                  and torch.equal(det.node_alloc[v], det.node_alloc[0])
                  and torch.equal(det.node_totals[v], det.node_totals[0]),
                  f"{objective} flood: node {v} holds another instance")
        check(int(det.node_alloc[0].sum()) == t25,
              f"{objective} flood: allocation sums to "
              f"{int(det.node_alloc[0].sum())}")
        for name, r in det.rounds.items():
            check(r.rounds_to_complete <= diameter(g25),
                  f"{objective} flood {name}: complete after "
                  f"{r.rounds_to_complete} rounds")
        for v in (0, 12, 24):
            cs_v = Coreset(det.node_points[v].contiguous(),
                           det.node_weights[v].contiguous())
            check(torch.equal(_solve_on_coreset(k2, cs_v, k, objective, 8,
                                                "cuda"), ex.centers),
                  f"{objective} flood: node {v} solves other centres")
        digests[f"exec {objective} centres[grid(5, 5) flood]"] = digest(
            ex.centers)
        digests[f"exec {objective} node 0 table[grid(5, 5) flood]"] = \
            digest(det.node_points[0], det.node_weights[0])
        walls[objective] = (out["sim"][1], out["exec"][1])
        print(f"  {objective} flood: every node's table, allocation and "
              f"total equal node 0's; nodes 0, 12 and 24 solve the same "
              f"centres")
        del out, ex, det   # free the tables before the next run

    # -- the BFS tree on phase 3's 100 sites ----------------------------------
    tree = bfs_spanning_tree(g, root=0)
    ex = run(distributed_kmeans_tree, sp, sm, k, t, tree, engine="exec")
    show(f"kmeans BFS tree exec ({g.n} sites, height {tree.height})", ex)
    expect_launches("BFS tree exec", ex[3], ex[4], argmin_one_center=2 * k,
                    argmin_resident=1, lloyd=2 * 8)
    check(torch.equal(ex[0].centers, sim_bfs.centers)
          and digest(ex[0].centers) == digests["kmeans centres[bfs]"],
          "BFS tree exec: centres differ from phase 3's BFS sim centres")
    check(ex[0].ledger.as_dict(by_phase=True)
          == sim_bfs.ledger.as_dict(by_phase=True),
          "BFS tree exec: measured ledger differs from the analytic one")
    nc = ex[0].exec_detail.node_centers
    check(all(torch.equal(nc[v], ex[0].centers) for v in range(g.n)),
          "BFS tree exec: a node received other centres")
    digests["exec kmeans centres[bfs tree]"] = digest(ex[0].centers)
    print(f"  BFS tree exec: centres equal phase 3's BFS sim centres "
          f"(digest {digests['kmeans centres[bfs]']}), ledger equal by "
          f"phase, every node holds the centres")

    # -- the min-cost tree on wan_clusters(10, 10) ----------------------------
    del ex, nc
    gw = wan_clusters(10, 10)
    ex = run(graph_distributed_kmeans, sp, sm, k, t, gw, routing="min_cost",
             engine="exec")
    show("kmeans min-cost tree exec on wan_clusters(10, 10)", ex)
    sim = sim_wan["min_cost"]
    check(ex[0].ledger.link_cost == sim.ledger.link_cost
          and ex[0].ledger.as_dict(by_phase=True)
          == sim.ledger.as_dict(by_phase=True),
          f"min-cost tree exec: link cost {ex[0].ledger.link_cost}, phase "
          f"7's sim {sim.ledger.link_cost}")
    check(torch.equal(ex[0].centers, sim.centers),
          "min-cost tree exec: centres differ from phase 7's")
    digests["exec kmeans centres[wan_clusters min_cost]"] = digest(
        ex[0].centers)
    print(f"  min-cost tree exec: link cost {ex[0].ledger.link_cost:.0f} "
          f"equals phase 7's sim ledger (by phase), centres equal; exec / "
          f"sim wall: "
          + ", ".join(f"{o} flood {w[1] / w[0]:.3f}"
                      for o, w in walls.items()))
    return idx, sp25, sm25


def _launched(counts, total, fn):
    """Run ``fn`` with every launch count from zero, add its launches (per
    kernel entry, and distance_argmin's by the kernel that served them) to
    ``total``; returns (fn's result, entry launches, launches by kernel)."""
    reset_counts, entry_counts, route_counts = counts
    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got, by = entry_counts(), route_counts()
    for name, v in (*got.items(), *by.items()):
        total[name] = total.get(name, 0) + v
    return out, got, by


def phase9(seed, dev, pts, k, sites25, base_km, base_md, counts, digests,
           checks):
    """The staged Round-1/Round-2 engine (``staged_distributed_coreset``,
    backend='cuda') on phase 8's instance: ``sites25`` = (row indices,
    padded points, mask) of the full data ``pts`` in 25 weighted sites of
    ``grid(5, 5)``, t = 3 k n, 8 refinement passes. Strict mode (tol = 0, no
    buckets) for k-means under algorithm1, cohen_addad and mapreduce and
    k-median under algorithm1: every field bit-equal to
    ``distributed_coreset``, each kernel launched 25 times as often as in
    the lockstep run (once per site where lockstep launches once for all).
    Overlap mode (tol = 1e-3, site buckets) for both objectives: a
    bit-identical rerun, sum t_i = t, the bucket lengths, and the cost of
    a solve on the coreset within MAX_COST_RATIO of the centralized
    baselines ``base_km`` / ``base_md`` (phases 3 and 5). ``checks`` holds
    phase 2's kernel checks. Adds digests; any failed check raises.
    Returns the staged runs' launches (per entry and by kernel)."""
    from repro_torch.core import clustering, prng
    from repro_torch.core.coreset import (_site_valid_lengths,
                                          distributed_coreset,
                                          staged_distributed_coreset)
    from repro_torch.kernels.ops import site_bucket_lengths

    _, sp25, sm25 = sites25
    n_sites, M = sp25.shape[0], sp25.shape[1]
    t25 = 3 * k * n_sites
    iters = 8
    key = prng.PRNGKey(seed, device=dev)
    fields = ("points", "weights", "t_i", "local_costs")
    print(f"phase 9: the staged engine on grid(5, 5)'s {n_sites} sites "
          f"(M={M}, t={t25}), backend='cuda'")
    lengths = site_bucket_lengths(_site_valid_lengths(sm25), M)
    # the kernels at the staged solves' shapes: one site at the lockstep
    # pad, and the smallest site at its own bucket
    small = int(np.argmin(lengths))
    site_w = sm25.float()
    for label, sl in (("staged site", (slice(0, 1), slice(0, M))),
                      (f"staged bucket {lengths[small]}",
                       (slice(small, small + 1), slice(0, lengths[small])))):
        p1, w1 = sp25[sl], site_w[sl]
        c1 = checks["rows"](p1, k)
        checks["one_center"](f"{label} seeding", p1, checks["rows"](p1, 1))
        checks["distance"](label, p1, c1)
        checks["lloyd"](label, p1, c1, w1)
        checks["weiszfeld"](label, p1, c1, w1)

    def run(fn, **kw):
        """One run: (result, wall s, peak GiB above the run's start)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn(key, sp25, sm25, k, t25, lloyd_iters=iters, backend="cuda",
                 device=dev, **kw)
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                (torch.cuda.max_memory_allocated() - start) / 2**30)

    total = {}
    for objective, strategy in (("kmeans", "algorithm1"),
                                ("kmeans", "cohen_addad"),
                                ("kmeans", "mapreduce"),
                                ("kmedian", "algorithm1")):
        label = f"{objective}/{strategy}"
        times = {}
        lock, lock_n, lock_by = _launched(counts, {}, lambda: run(
            distributed_coreset, objective=objective, strategy=strategy,
            phase_times=times))
        staged, st_n, st_by = _launched(counts, total, lambda: run(
            staged_distributed_coreset, objective=objective,
            strategy=strategy))
        base, (cs, det) = lock[0], staged[0]
        off = {}
        for f in fields:
            a, b = getattr(base, f), getattr(cs, f)
            if not torch.equal(a, b):
                bad = (a != b).reshape(n_sites, -1).any(1).nonzero()
                off[f] = (int((a != b).sum()), bad.flatten().tolist())
        check(not off, f"phase 9 strict {label}: fields differ from "
              f"lockstep (entries, sites): {off}")
        check(det.site_lengths == (M,) * n_sites,
              f"phase 9 strict {label}: lengths {det.site_lengths}")
        check(bool((det.iters_run == iters).all()) and det.host_reads == 0,
              f"phase 9 strict {label}: passes {det.iters_run.tolist()}")
        want = {name: n_sites * v for name, v in lock_n.items()}
        want_by = {name: n_sites * v for name, v in lock_by.items()}
        check(st_n == want and st_by == want_by,
              f"phase 9 strict {label}: launches {st_n} {st_by}, expected "
              f"25 x lockstep's {lock_n} {lock_by}")
        digests[f"staged {label} coreset[grid(5, 5)]"] = digest(cs.points,
                                                                 cs.weights)
        print(f"  strict {label}: points, weights, t_i, local_costs equal "
              f"lockstep bit for bit; staged wall {staged[1]:.3f} s (round 1 "
              f"{det.wall_round1_s:.3f}, round 2 {det.wall_round2_s:.3f}), "
              f"peak {staged[2]:.2f} GiB above its start; lockstep wall "
              f"{lock[1]:.3f} s "
              f"{json.dumps({p: round(x, 4) for p, x in times.items()})}, "
              f"peak {lock[2]:.2f} GiB; launches {json.dumps(st_n)} = "
              f"{n_sites} x lockstep's {json.dumps(lock_n)}; by kernel "
              f"{json.dumps(st_by)}")
        del lock, staged, base, cs
    for objective, base_cost in (("kmeans", base_km), ("kmedian", base_md)):
        label = f"overlap {objective}"
        first, n1, by1 = _launched(counts, total, lambda: run(
            staged_distributed_coreset, objective=objective, tol=1e-3,
            site_buckets=True))
        again = run(staged_distributed_coreset, objective=objective,
                    tol=1e-3, site_buckets=True)
        (cs, det), (cs2, det2) = first[0], again[0]
        for f in fields:
            check(torch.equal(getattr(cs, f), getattr(cs2, f)),
                  f"phase 9 {label}: {f} differs between two runs")
        check(torch.equal(det.iters_run, det2.iters_run),
              f"phase 9 {label}: passes differ between two runs")
        check(int(cs.t_i.sum()) == t25, f"phase 9 {label}: sum t_i "
              f"{int(cs.t_i.sum())}")
        check(det.site_lengths == lengths,
              f"phase 9 {label}: lengths {det.site_lengths}, buckets "
              f"{lengths}")
        flat = cs.flatten()
        c, _ = clustering.solve(key, flat.points, k,
                                weights=torch.clamp_min(flat.weights, 0.0),
                                lloyd_iters=iters, objective=objective,
                                restarts=3, device=dev)
        ratio = float(clustering.cost(pts, c, objective=objective,
                                      device=dev)) / base_cost
        check(ratio < MAX_COST_RATIO, f"phase 9 {label}: cost ratio {ratio}")
        digests[f"staged {label} coreset[grid(5, 5)]"] = digest(cs.points,
                                                                 cs.weights)
        print(f"  {label}: cost ratio {ratio:.6f} (bound {MAX_COST_RATIO}); "
              f"rerun bit-identical; sum t_i {t25}; lengths "
              f"{sorted(set(det.site_lengths))} (lockstep {M}); passes "
              f"{det.iters_run.tolist()}, {det.host_reads} convergence "
              f"reads; wall {first[1]:.3f} s (round 1 "
              f"{det.wall_round1_s:.3f}, round 2 {det.wall_round2_s:.3f}), "
              f"peak {first[2]:.2f} GiB above its start; launches "
              f"{json.dumps(n1)}, by kernel {json.dumps(by1)}")
    return total


def phase10(seed, dev, data, held_out, pts, k, sites25, base_cost, counts,
            digests, checks):
    """The streaming subsystem at full width (k = 50, t = 1,000, d = 90),
    backend='cuda'. (a) A ``StreamState`` fed the full ``data`` in arrivals
    of 10,000 rows (31 batches of 16,384 and a 7,441-row tail): mass,
    occupancy = the bits of 31, a rerun of the first 14 arrivals
    bit-identical, and a solve on the summary within 2x the offline
    ``build_coreset`` pipeline at equal size.
    (b) A ``ClusterQueryService`` on it: 20 batches of 8..4,096 rows of
    ``held_out`` and one 10,000-row burst, every answer bit-equal to
    ``query_assignments`` with the cached centres, ``query_load`` equal to
    the counts of those answers and, but for near ties, to the plain
    ``lloyd_stats``. (c) A ``DistributedStream`` on ``grid(5, 5)`` with
    ``sites25``'s rows pushed in arrivals of 4,096, two resample rounds
    (after half the data and at the end), each on sim/flood, exec/flood,
    sim/BFS tree and exec/BFS tree from the same state (exec bit-equal to
    sim per transport, ledger by phase included), then a forced union
    round on the flood (ledger the analytic one, mass the data's).
    ``base_cost`` is phase 3's centralized k-means cost. Adds digests;
    any failed check raises. Returns the phase's launches and the
    distributed stream after its rounds."""
    import copy
    from repro_torch.core import clustering, prng
    from repro_torch.core.backend import query_assignments
    from repro_torch.core.coreset import build_coreset
    from repro_torch.core.topology import grid
    from repro_torch.kernels import ref
    from repro_torch.stream import (ClusterQueryService, DistributedStream,
                                    StreamState, TreeConfig)

    n, d = data.shape
    key = prng.PRNGKey(seed, device=dev)
    total = {}
    print("phase 10: the streaming subsystem at full width, backend='cuda'")

    # -- (a) one site, the whole stream ---------------------------------------
    cfg = TreeConfig(k=k, t=1000, d=d, batch_size=16384, levels=12,
                     backend="cuda")
    arrival = 10_000
    # the rerun replays the first 14 arrivals (8 batches, 131,072 rows,
    # and 8,928 pending) and is held to the first run's summary there
    n_arrivals = -(-n // arrival)
    replay = min(14, n_arrivals)

    def feed(arrivals):
        """A new stream fed ``arrivals`` arrivals of the data: (stream,
        digest of its summary after ``replay`` arrivals)."""
        state, mark = StreamState(cfg, key=key, device=dev), None
        for j, off in enumerate(range(0, n, arrival)[:arrivals]):
            state.push(data[off:off + arrival])
            if j + 1 == replay:
                mark = digest(*dataclasses.astuple(state.summary()))
        return state, mark

    t0 = time.perf_counter()
    (state, mark), n_a, by_a = _launched(counts, total,
                                         lambda: feed(n_arrivals))
    wall_a = time.perf_counter() - t0
    again, _ = feed(replay)
    check(digest(*dataclasses.astuple(again.summary())) == mark,
          f"phase 10a: the rerun's summary after {replay} arrivals differs")
    s = state.summary()
    n_batches = n // cfg.batch_size
    check(state.tree.n_batches == n_batches
          and state.pending() == n - n_batches * cfg.batch_size,
          f"phase 10a: {state.tree.n_batches} batches, {state.pending()} "
          f"pending")
    occupied = [size > 0 for size in state.tree.bucket_sizes()]
    check(occupied == [bool(n_batches >> i & 1) for i in range(cfg.levels)],
          f"phase 10a: occupancy {occupied} is not the bits of {n_batches}")
    mass = float(s.weights.double().sum())
    check(abs(mass - n) <= 1e-4 * n, f"phase 10a: summary mass {mass}")
    for label, p1 in (("stream leaf", pts[:cfg.batch_size]),
                      ("stream merge", s.points[:2 * cfg.slot])):
        c1 = checks["rows"](p1, k)
        checks["one_center"](f"{label} seeding", p1, checks["rows"](p1, 1))
        checks["lloyd"](label, p1, c1, torch.ones_like(p1[:, 0]))
    c_stream, _ = clustering.solve(key, s.points, k, weights=s.weights,
                                   lloyd_iters=10, device=dev)
    stream_cost = float(clustering.cost(pts, c_stream, device=dev))
    eff = int(s.effective_size())
    off = build_coreset(key, pts, k, eff - k, device=dev)
    c_off, _ = clustering.solve(key, off.points, k, weights=off.weights,
                                lloyd_iters=10, device=dev)
    offline_cost = float(clustering.cost(pts, c_off, device=dev))
    check(stream_cost <= 2.0 * offline_cost,
          f"phase 10a: stream cost {stream_cost} > 2 x offline "
          f"{offline_cost}")
    digests["stream summary[full data]"] = digest(s.points, s.weights)
    print(f"  (a) {n} rows in arrivals of {arrival}: {n_batches} batches + "
          f"{state.pending()} pending, {state.tree.occupied_levels()} levels "
          f"occupied, {eff} weighted slots of {s.size}, mass {mass:.3f}; "
          f"rerun of the first {replay} arrivals bit-identical; stream / "
          f"offline cost "
          f"{stream_cost / offline_cost:.6f} (bound 2), stream / "
          f"centralized {stream_cost / base_cost:.6f}; ingest wall "
          f"{wall_a:.3f} s; launches {json.dumps(n_a)}, by kernel "
          f"{json.dumps(by_a)}")
    del again, off

    # -- (b) the query service on (a) -----------------------------------------
    svc = ClusterQueryService(state, k=k, staleness_frac=0.1,
                              max_bucket=4096, backend="cuda")
    rng = np.random.default_rng(seed + 13)
    sizes = [int(m) for m in rng.integers(8, 4097, 20)]
    sizes.insert(10, 10_000)
    batches = [held_out[rng.integers(0, held_out.shape[0], m)]
               for m in sizes]
    # the first solve (k-means++ and Lloyd, 2 restarts, on the summary);
    # nothing is pushed while the queries run, so they reuse its centres
    _, n_r, _ = _launched(counts, total, svc.refresh)
    t0 = time.perf_counter()
    answers, n_q, by_q = _launched(counts, total, lambda: [svc.query(q)
                                                           for q in batches])
    wall_q = time.perf_counter() - t0
    centers = svc.cached_centers()
    eng = svc._engine
    check(n_q["distance_argmin_batched"] == eng.stats.n_dispatches
          and n_q["lloyd_stats"] == 0 and n_q["weiszfeld_stats"] == 0,
          f"phase 10b: launches {n_q}, {eng.stats.n_dispatches} dispatches")
    loads, n_l, _ = _launched(counts, total, lambda: [svc.query_load(q)
                                                      for q in batches])
    n_chunks = sum(-(-m // svc.max_bucket) for m in sizes)
    check(n_l["lloyd_stats"] == n_chunks and n_l["distance_argmin"] == 0,
          f"phase 10b: query_load launches {n_l}, {n_chunks} chunks")
    flips = 0
    for q, (a, dist), load in zip(batches, answers, loads):
        qd = torch.from_numpy(q).to(dev)
        a2, d2 = query_assignments(qd, centers, device=dev)
        check(torch.equal(a, a2) and torch.equal(dist, d2),
              f"phase 10b: answers to {q.shape[0]} rows differ from "
              f"query_assignments")
        check(torch.equal(load, torch.bincount(a.long(), minlength=k).float()),
              "phase 10b: query_load differs from the answers' counts")
        mr, ar = ref.min_dist_argmin_ref(qd, centers)
        _, f = checks["compare"](f"service[{q.shape[0]} rows]", qd, centers,
                                 dist, a, mr, ar)
        _, counts_plain, _ = ref.lloyd_stats_ref(qd, centers)
        check(float((load - counts_plain).abs().sum()) <= 2 * f,
              f"phase 10b: query_load off the plain counts beyond its {f} "
              f"near-tie flips")
        flips += f
    for m in (8, 64, 512, 4096):
        q = torch.from_numpy(held_out[:m]).to(dev)
        checks["lloyd"](f"query_load bucket {m}", q, centers,
                        torch.ones_like(q[:, 0]))
    st = svc.stats
    print(f"  (b) {len(batches)} query batches, {st.n_queries} rows "
          f"({st.n_padded_queries} padding rows), {eng.stats.n_dispatches} "
          f"dispatches, {st.n_refreshes} refresh ({st.refresh_s:.3f} s); "
          f"{st.n_queries / st.assign_s:.0f} queries/s on assignment, "
          f"{st.n_queries / wall_q:.0f} with the refresh; answers equal "
          f"query_assignments bit for bit, query_load equal to their counts "
          f"({flips} near-tie flips against the plain version); launches "
          f"{json.dumps(n_q)}, by kernel {json.dumps(by_q)}; query_load "
          f"{json.dumps(n_l)}; the refresh {json.dumps(n_r)}")
    del state, svc, answers, s

    # -- (c) the distributed stream on grid(5, 5) ---------------------------
    idx, _, _ = sites25
    g = grid(5, 5)
    t_round = 3 * k * g.n
    cfg_c = TreeConfig(k=k, t=1000, d=d, batch_size=8192, levels=12,
                       backend="cuda")
    ds = DistributedStream(g, cfg_c, key=key, device=dev)
    site_rows = [data[ix] for ix in idx]
    cursor = [0] * g.n
    pushed = [0]
    arrival_c = 4096

    def push_until(limit):
        """Round-robin arrivals of 4,096 rows until ``limit`` rows."""
        while pushed[0] < limit:
            for i in range(g.n):
                b = site_rows[i][cursor[i]:cursor[i] + arrival_c]
                if len(b):
                    ds.push(i, b)
                    cursor[i] += len(b)
                    pushed[0] += len(b)

    def rounds(label, mode, combos):
        """One round on each (engine, transport) from copies of the same
        state; the stream then carries on from the first combo's copy."""
        nonlocal ds
        out = {}
        for engine, transport in combos:
            run = copy.deepcopy(ds)
            t0 = time.perf_counter()
            res, n_r, _ = _launched(counts, total, lambda: run.aggregate(
                k=k, t=t_round, mode=mode, engine=engine,
                transport=transport, routing="bfs"))
            out[engine, transport] = (run, res, time.perf_counter() - t0,
                                      n_r)
        for transport in dict.fromkeys(tr for _, tr in combos):
            sim, ex = out["sim", transport][1], out["exec", transport][1]
            check(torch.equal(sim.coreset.points, ex.coreset.points)
                  and torch.equal(sim.coreset.weights, ex.coreset.weights)
                  and torch.equal(sim.centers, ex.centers),
                  f"phase 10c {label} {transport}: exec differs from sim")
            check(sim.ledger.as_dict(by_phase=True)
                  == ex.ledger.as_dict(by_phase=True),
                  f"phase 10c {label} {transport}: measured ledger "
                  f"{ex.ledger.as_dict()} differs from the analytic "
                  f"{sim.ledger.as_dict()}")
            ratio = float(clustering.cost(pts, sim.centers,
                                          device=dev)) / base_cost
            mass = float(sim.coreset.weights.double().sum())
            check(abs(mass - pushed[0]) <= 1e-3 * pushed[0],
                  f"phase 10c {label} {transport}: mass {mass} for "
                  f"{pushed[0]} rows")
            digests[f"stream {label} {transport} centres"] = digest(
                sim.centers)
            print(f"  (c) {label} {transport}: {pushed[0]} rows pushed, "
                  f"full-data cost ratio {ratio:.6f}, mass {mass:.3f}; "
                  f"wall sim {out['sim', transport][2]:.3f} s, exec "
                  f"{out['exec', transport][2]:.3f} s; exec equal to sim "
                  f"(coreset, centres, ledger by phase "
                  f"{json.dumps(ex.ledger.as_dict())}); launches "
                  f"{json.dumps(out['exec', transport][3])}")
        ds = out[combos[0]][0]
        return out

    t0 = time.perf_counter()
    _launched(counts, total, lambda: push_until(n // 2))
    combos = [("sim", "flood"), ("exec", "flood"), ("sim", "tree"),
              ("exec", "tree")]
    rounds("round 0", "resample", combos)
    _launched(counts, total, lambda: push_until(n))
    check(pushed[0] == n and abs(ds.total_weight() - n) == 0,
          f"phase 10c: {pushed[0]} rows pushed, total weight "
          f"{ds.total_weight()}")
    rounds("round 1", "resample", combos)
    out = rounds("union", "union", combos[:2])
    sim = out["sim", "flood"][1]
    sum_eff = float(sum((st_.summary().weights != 0).sum().item()
                        for st_ in ds.sites))
    led = sim.ledger.as_dict()
    check(led["points"] == 2.0 * g.m * sum_eff
          and led["messages"] == 2.0 * g.m * g.n and led["scalars"] == 0.0,
          f"phase 10c union: ledger {led}, {sum_eff} weighted slots")
    print(f"  (c) stream wall {time.perf_counter() - t0:.3f} s; union "
          f"round: {int(sum_eff)} weighted slots flooded, ledger equals the "
          f"analytic 2 m x slots")
    return total, ds


def phase7_spread(seed, dev, pts, sp, sm, g, k, t, ratio, solve, spread):
    """Witnesses for phase 7's Figure 2 and trimmed readings: ours, COMBINE
    and the trimmed route on the keys seed + 100 r, r < PAPER_RUNS +
    ``spread`` (phase 7's runs first), and at r = 0 with the plain backend
    as well (phase 7's ``ratio`` and ``solve``)."""
    from repro_torch.core import clustering, prng
    from repro_torch.core.baselines import combine
    from repro_torch.core.coreset import distributed_coreset
    from repro_torch.core.distributed import graph_distributed_kmeans

    trim = "kmeans_trimmed(0.01)"
    _, base_trim = clustering.solve(prng.PRNGKey(seed + 7), pts, k,
                                    lloyd_iters=12, restarts=3,
                                    objective=trim, device=dev)
    base_trim = float(base_trim)

    def readings(r, backend="cuda"):
        """(ours, COMBINE, trimmed) cost ratios at key seed + 100 r: r = 0
        is phase 7's key for all three."""
        run_key = prng.PRNGKey(seed + 100 * r, device=dev)
        dc = distributed_coreset(run_key, sp, sm, k, t, backend=backend,
                                 device=dev)
        cs = combine(run_key, sp, sm, k, t, backend=backend, device=dev)
        res = graph_distributed_kmeans(run_key, sp, sm, k, t, g,
                                       objective=trim, backend=backend,
                                       device=dev)
        return (ratio(solve(run_key, dc.flatten(), backend)),
                ratio(solve(run_key, cs, backend)),
                ratio(res.centers, trim, base_trim))

    print(f"phase 7 spread: Figure 2 (ours, COMBINE) and {trim} cost ratios "
          f"on {PAPER_RUNS + spread} keys")
    t0 = time.perf_counter()
    rows = [readings(r) for r in range(PAPER_RUNS + spread)]
    plain = readings(0, "torch")
    for r, row in enumerate(rows):
        print(f"  key seed + {100 * r}: ours {row[0]:.6f}, COMBINE "
              f"{row[1]:.6f}, {trim} {row[2]:.6f}")
    print(f"  key seed + 0, backend='torch': ours {plain[0]:.6f}, COMBINE "
          f"{plain[1]:.6f}, {trim} {plain[2]:.6f}")
    cols = np.asarray(rows)
    for j, label in enumerate(("ours", "COMBINE", trim)):
        print(f"  {label}: mean {cols[:, j].mean():.6f}, min "
              f"{cols[:, j].min():.6f}, max {cols[:, j].max():.6f}")
    print(f"  ours below COMBINE on {int((cols[:, 0] < cols[:, 1]).sum())} "
          f"of {len(rows)} keys; {time.perf_counter() - t0:.1f} s")


# the SPMD runs of phase 11, per world size W: (label, keyword arguments
# of spmd_distributed_kmeans); the runs of one objective must agree bit for
# bit, and each W's all-gather reruns after the ring and the torus, warm
SPMD_RUNS = {
    4: [("kmeans all_gather", {}),
        ("kmeans neighbor_rounds", {"collectives": "neighbor_rounds"}),
        ("kmeans torus_2d", {"collectives": "torus_2d"}),
        ("kmeans all_gather rerun", {}),
        ("kmedian all_gather", {"objective": "kmedian"}),
        ("kmedian torus_2d", {"objective": "kmedian",
                              "collectives": "torus_2d"}),
        ("mapreduce all_gather", {"strategy": "mapreduce"})],
    10: [("kmeans all_gather", {}),
         ("kmeans neighbor_rounds", {"collectives": "neighbor_rounds"}),
         ("kmeans torus_2d", {"collectives": "torus_2d"}),
         ("kmeans all_gather rerun", {})],
    1: [("kmeans all_gather", {})],
}
# the mesh's phases, in order, as spmd_distributed_kmeans records them
SPMD_PHASES = ("round1", "round1_gather", "sample", "round2_gather",
               "solve", "output_gather")


def phase11_rank(mesh, spec):
    """One rank of phase 11 (run by ``repro_torch.core.mesh.launch`` in a
    spawned process): every run of ``SPMD_RUNS[spec["world"]]`` on the
    global sites memory-mapped from ``spec["points"]`` / ``spec["mask"]``,
    each with every launch count from zero just before it and read just
    after, and the collectives it issued by phase
    (``roofline.trace.collective_phase_analysis`` of the collectives
    recorded around the run).
    The kernels were built by the parent: a rank loads the libraries
    ``spec["libraries"]`` and never builds. Returns host values."""
    # a spawned process starts with PyTorch's defaults: TF32 off here too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import prng
    from repro_torch.core.distributed import spmd_distributed_kmeans
    from repro_torch.kernels import ops
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.roofline.trace import (collective_phase_analysis,
                                            record)
    missing = [p for p in spec["libraries"] if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(f"rank {mesh.rank}: kernels not built: "
                                f"{missing}")
    cuda = mesh.device.type == "cuda"
    sp = np.load(spec["points"], mmap_mode="r")
    sm = np.load(spec["mask"], mmap_mode="r")
    out = []
    for label, kw in SPMD_RUNS[spec["world"]]:
        for kern in (*ops.KERNELS, *da.ROUTES):
            kern.launches = 0
        if cuda:
            torch.cuda.synchronize(mesh.device)
            torch.cuda.reset_peak_memory_stats(mesh.device)
        staged = mesh.staged_bytes
        times = {}
        t0 = time.perf_counter()
        with record() as led:
            c, lc, t_i = spmd_distributed_kmeans(
                mesh, "sites", prng.PRNGKey(spec["seed"],
                                            device=mesh.device),
                sp, sm, spec["k"], spec["t"],
                lloyd_iters=spec["lloyd_iters"], phase_times=times, **kw)
        if cuda:
            torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
        out.append({
            "label": label, "centers": c.cpu().numpy(),
            "local_costs": lc.cpu().numpy(), "t_i": t_i.cpu().numpy(),
            "times": times, "wall": wall,
            "launches": {kern.name: kern.launches for kern in ops.KERNELS},
            "by_kernel": {kern.name: kern.launches for kern in da.ROUTES},
            "staged": mesh.staged_bytes - staged,
            "collectives": {
                phase: (a.collective_counts, a.collective_bytes_by_kind)
                for phase, a in collective_phase_analysis(
                    led.collectives).items()},
            "peak_gib": (torch.cuda.max_memory_allocated(mesh.device) / 2**30
                         if cuda else 0.0)})
    return out


def staged_bytes(kw, world, t_buffer, k, d, backend, dev):
    """The bytes one rank stages through pinned host memory in one run
    (both ways): a gloo all-gather copies its payload out and the W
    gathered ones back; a ring or torus hop copies its buffer out and the
    received one back. The payloads: the Round-1 scalar (unless the
    strategy exchanges none), the Round-2 portion's points and weights, and
    the output gather's two scalars. nccl, and gloo on the CPU, stage
    nothing."""
    if backend != "gloo" or dev.type != "cuda":
        return 0
    rows = t_buffer + k
    payloads = [4 * rows * d, 4 * rows]
    if kw.get("strategy") != "mapreduce":
        payloads.append(4)
    mode = kw.get("collectives", "all_gather")
    if mode == "all_gather":
        per = lambda x: x * (1 + world)
    elif mode == "neighbor_rounds":
        per = lambda x: 2 * (world - 1) * x
    else:
        from repro_torch.core.message_passing import torus_mesh_shape
        R, C = kw.get("mesh_shape") or torus_mesh_shape(world)
        per = lambda x: 2 * (C - 1) * x + 2 * (R - 1) * C * x
    return sum(per(x) for x in payloads) + 2 * 4 * (1 + world)


def nccl_probe_rank(mesh):
    """One rank of a gloo mesh that opens an NCCL group over the same ranks
    (all on one GPU) and all-reduces one float through it; returns the
    error NCCL gives, or None if it ran."""
    import torch.distributed as dist
    try:
        group = dist.new_group(backend="nccl")
        x = torch.ones(1, device=mesh.device)
        dist.all_reduce(x, group=group)
        torch.cuda.synchronize(mesh.device)
    except Exception as e:   # the error is what this probe reads
        return f"{type(e).__name__}: {e}"
    return None


def phase11(seed, dev, pts, sp, sm, k, t, base_km, base_md, libraries,
            digests, checks):
    """The SPMD mesh path (``spmd_distributed_kmeans`` through
    ``repro_torch.core.mesh.launch``) at full width: phase 3's sites ``sp``
    / ``sm`` (host arrays, 100 sites of the full data ``pts``), budget
    ``t``, 8 Lloyd steps, W ranks sharing the card ``dev`` over gloo with
    host staging: W = 4 (25 sites merged per rank) and W = 10 (10 per
    rank) under the runs of ``SPMD_RUNS``, then W = 1 on gloo and on nccl
    (bit-equal) and a probe of an NCCL group of 2 ranks on the one card
    (its error printed). Checks, any failure
    fatal: within each W the k-means runs (modes, rerun) and the k-median
    runs bit-identical; every rank's outputs bit-equal to rank 0's; t_i the
    host allocation of the gathered costs, sum t, within the default
    buffer, uniform under mapreduce; the cost ratio of the centres against
    ``base_km`` / ``base_md`` (phases 3 and 5) below MAX_COST_RATIO;
    launches per kernel per rank as the path predicts. ``checks`` holds
    phase 2's kernel checks, run here at one rank's merged-site shape.
    ``libraries`` are the built kernels' paths. Adds digests; returns the
    launches of rank 0 over the W = 4 k-means and k-median all_gather
    runs (per entry and by kernel), and rank 0's record of the W = 4
    k-means all_gather run (for phase 13)."""
    import tempfile
    from repro_torch.core import clustering
    from repro_torch.core.coreset import proportional_allocation
    from repro_torch.core.mesh import launch
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    n_sites, M, d = sp.shape
    print(f"phase 11: the SPMD mesh path, {n_sites} sites (M={M}) merged "
          f"per rank, t={t}, ranks sharing {dev} over gloo (host staging)")
    # the kernels at one rank's merged-site shape (W = 4: 25 sites)
    p = torch.from_numpy(sp[:n_sites // 4]).to(dev).reshape(1, -1, d)
    w = torch.from_numpy(sm[:n_sites // 4]).to(dev).reshape(1, -1).float()
    c = checks["rows"](p, k)
    checks["one_center"]("merged site seeding", p, checks["rows"](p, 1))
    checks["distance"]("merged site", p, c)
    checks["lloyd"]("merged site", p, c, w)
    checks["weiszfeld"]("merged site", p, c, w)
    digests["distance_argmin[merged site]"] = digest(
        *ops.min_dist_argmin(p, c))
    digests["lloyd_stats[merged site]"] = digest(*ops.lloyd_stats(p, c, w))
    digests["weiszfeld_stats[merged site]"] = digest(
        *ops.weiszfeld_stats(p, c, w))
    del p, w, c

    def predicted(kw):
        """Launches per rank of one run: D^z seeding (k one-centre launches)
        in Round 1 and in the final solve, one sensitivity pass on the
        resident tile, and 8 + 10 update steps (WEISZFELD_ITERS passes each
        for k-median)."""
        from repro_torch.core.objective import WEISZFELD_ITERS
        steps = 8 + 10
        kmedian = kw.get("objective") == "kmedian"
        return ({"distance_argmin": 2 * k + 1,
                 "lloyd_stats": 0 if kmedian else steps,
                 "weiszfeld_stats": WEISZFELD_ITERS * steps if kmedian
                 else 0, "distance_argmin_batched": 0, "lloyd_reduce": 0,
                 "weiszfeld_reduce": 0},
                {"distance_one_center": 2 * k,
                 "distance_argmin_resident": 1, "distance_argmin_tile": 0,
                 "distance_argmin_stream": 0})

    total = {}
    with tempfile.TemporaryDirectory(prefix="phase11-") as tmp:
        spec = {"seed": seed, "k": k, "t": t, "lloyd_iters": 8,
                "libraries": libraries,
                "points": os.path.join(tmp, "sites.npy"),
                "mask": os.path.join(tmp, "mask.npy")}
        np.save(spec["points"], sp)
        np.save(spec["mask"], sm)
        results = {}
        for world, backend in ((4, "gloo"), (10, "gloo"), (1, "gloo"),
                               (1, "nccl")):
            t0 = time.perf_counter()
            ranks = launch("chip_smoke:phase11_rank", world,
                           (dict(spec, world=world),), backend=backend,
                           device=dev, timeout=300)
            launch_wall = time.perf_counter() - t0
            results[(world, backend)] = ranks
            runs = SPMD_RUNS[world]
            buffer = max(4 * t // world, 64)
            print(f"  W={world} {backend}: {len(runs)} runs in "
                  f"{launch_wall:.1f} s of launch wall (spawn, data, runs); "
                  f"{n_sites // world} sites = {n_sites // world * M} rows "
                  f"per rank, t_buffer {buffer}, union "
                  f"{world * (buffer + k)} rows")
            for j, (label, kw) in enumerate(runs):
                what = f"phase 11 W={world} {backend} {label}"
                r0 = ranks[0][j]
                for r, rank in enumerate(ranks):
                    got = rank[j]
                    for f in ("centers", "local_costs", "t_i"):
                        check(got[f].tobytes() == r0[f].tobytes(),
                              f"{what}: rank {r}'s {f} differ from rank 0's")
                    want, want_by = predicted(kw)
                    want_staged = staged_bytes(kw, world, buffer, k, d,
                                               backend, dev)
                    check(got["staged"] == want_staged,
                          f"{what}: rank {r} staged {got['staged']} bytes, "
                          f"expected {want_staged}")
                    check(got["launches"] == want
                          and got["by_kernel"] == want_by,
                          f"{what}: rank {r} launched {got['launches']} "
                          f"{got['by_kernel']}, expected {want} {want_by}")
                t_i, lc = r0["t_i"], r0["local_costs"]
                if kw.get("strategy") == "mapreduce":
                    host = proportional_allocation(torch.ones(world), t)
                else:
                    host = proportional_allocation(torch.from_numpy(lc), t)
                check(np.array_equal(t_i, host.numpy())
                      and int(t_i.sum()) == t and (t_i <= buffer).all(),
                      f"{what}: t_i {t_i.tolist()}, host allocation "
                      f"{host.tolist()}, buffer {buffer}")
                objective = kw.get("objective", "kmeans")
                base = base_md if objective == "kmedian" else base_km
                ratio = float(clustering.cost(
                    pts, torch.from_numpy(r0["centers"]).to(dev),
                    objective=objective, device=dev)) / base
                check(np.isfinite(r0["centers"]).all()
                      and r0["centers"].shape == (k, d)
                      and ratio < MAX_COST_RATIO,
                      f"{what}: cost ratio {ratio}")
                digests[f"spmd W={world} {backend} {label}"] = digest(
                    torch.from_numpy(r0["centers"]))
                per_rank = {name: [round(rank[j]["times"][name], 4)
                                   for rank in ranks]
                            for name in SPMD_PHASES}
                per_rank["wall"] = [round(rank[j]["wall"], 4)
                                    for rank in ranks]
                per_rank["peak_gib"] = [round(rank[j]["peak_gib"], 3)
                                        for rank in ranks]
                tm = r0["times"]
                print(f"  {label}: cost ratio {ratio:.6f}, t_i "
                      f"{t_i.tolist()}; ranks "
                      f"bit-equal; launches per rank {json.dumps(r0['launches'])}"
                      f"; bytes received: round 1 "
                      f"{tm.get('round1_gather_bytes', 0)}, round 2 "
                      f"{tm['round2_gather_bytes']}, output "
                      f"{tm['output_gather_bytes']}; {tm['gathers']} gathers "
                      f"of {tm['hops']} hops; staged host bytes per rank "
                      f"{[rank[j]['staged'] for rank in ranks]}; per rank (s) "
                      f"{json.dumps(per_rank)}")
                if (world, backend, label) == (4, "gloo",
                                               "kmeans all_gather"):
                    w4_gather = r0
                if world == 4 and label in ("kmeans all_gather",
                                            "kmedian all_gather"):
                    for name, v in (*r0["launches"].items(),
                                    *r0["by_kernel"].items()):
                        total[name] = total.get(name, 0) + v
            # within W, each objective's runs agree bit for bit
            for objective in ("kmeans", "kmedian"):
                same = [j for j, (label, _) in enumerate(runs)
                        if label.startswith(objective + " ")]
                for j in same[1:]:
                    for f in ("centers", "local_costs", "t_i"):
                        check(ranks[0][j][f].tobytes()
                              == ranks[0][same[0]][f].tobytes(),
                              f"phase 11 W={world}: {runs[j][0]} {f} differ "
                              f"from {runs[same[0]][0]}")
                if len(same) > 1:
                    print(f"  W={world} {objective}: "
                          f"{', '.join(runs[j][0] for j in same)} bit-equal")
        a, b = results[(1, "gloo")][0][0], results[(1, "nccl")][0][0]
        check(all(a[f].tobytes() == b[f].tobytes()
                  for f in ("centers", "local_costs", "t_i")),
              "phase 11 W=1: nccl and gloo results differ")
        print("  W=1: nccl and gloo results bit-equal")
        refused = None
        try:
            launch("chip_smoke:nccl_probe_rank", 2, backend="nccl",
                   device="cuda:0")
        except ValueError as e:
            refused = str(e)
        check(refused is not None,
              "phase 11: the launcher ran a nccl mesh of 2 ranks on cuda:0")
        print(f"  a nccl mesh of 2 ranks on cuda:0: the launcher refuses: "
              f"{refused}")
        try:
            errs = launch("chip_smoke:nccl_probe_rank", 2,
                          device="cuda:0", timeout=120)
            print(f"  an NCCL group of 2 ranks on cuda:0: "
                  f"{json.dumps(errs)}")
        except RuntimeError as e:     # the probe's ranks may not return
            print(f"  an NCCL group of 2 ranks on cuda:0: the probe's "
                  f"launch failed: {str(e)[-600:]}")
    print(f"  phase 11 wall {time.perf_counter() - t_phase:.1f} s")
    return total, w4_gather


# llama3-8b's embedding widths (src/repro/configs/llama3_8b.py) and the
# launcher's selection settings (src/repro/launch/train.py:169-170) for
# phase 12's data selection: a pool of 8 sites x 2,048 examples x 512 tokens
LLAMA3_8B_VOCAB = 128_256
LLAMA3_8B_D_MODEL = 4096
SELECT_SITES, SELECT_EXAMPLES, SELECT_TOKENS = 8, 2048, 512
SELECT_K, SELECT_FRACTION = 8, 0.25
LEDGER_UNITS = ("scalars", "points", "messages", "bytes", "link_cost")


def phase12(seed, dev, k, sites25, stream25, counts, digests, checks, hw):
    """The asynchronous WAN runtime and data selection (backend='cuda').

    (a) ``sites25`` (phase 8's 25 weighted sites of the full data) on
    ``wan_clusters(5, 5)``, t = 3 k n: ``engine="async"`` in full mode
    against ``engine="exec"`` for k-means and k-median (coreset and centres
    bit for bit, every ledger axis, staleness 0, the same launches as phase
    8's exec runs); the clock default and random gossip (p = 0.5) for
    k-means (centres equal exec's, staleness under clock, completion within
    horizon + P x D, a bit-identical rerun); plan F (``random_fault_plan``
    seed 0 with its churn set to node 23 dead and nodes 13 and 18
    rejoining) under exec and async, each equal to the restricted oracle
    and its solve bit for bit with no row of the dead site; the quiescence
    certificates of F in all three modes (with the clustering check in
    full mode); and on phase 10's ``DistributedStream`` ``stream25`` a
    union and a resample round in async full mode equal to exec, then a
    faulty union round whose mass is the survivors'. (b) Data selection at
    llama3-8b's embedding widths: a random-init float32 table of
    128,256 x 4,096 made from ``seed``, 8 x 2,048 examples of 512 tokens,
    ``embed_examples`` in 2 GB chunks, ``select_coreset`` with k = 8 and t
    = 0.25 of the pool, ``gather_selected``; the d = 4,096 routes (the
    one-centre kernel, the streamed tile, lloyd_stats' two-pass form through
    lloyd_reduce) held to their plain versions, and lloyd_reduce timed
    (:func:`time_reduce`) on the card ``hw``. ``counts`` as in
    :func:`phase7`; adds digests; any failed check raises. Returns the
    phase's launches (the async, faulty, certificate, stream and selection
    runs; not the exec runs they are held to), lloyd_reduce's kernels-line
    fields and (key, embeddings, mask, t) of the selection, for phase
    13."""
    import copy
    from repro_torch.core import prng, topology
    from repro_torch.core.coreset import Coreset
    from repro_torch.core.distributed import (_solve_on_coreset,
                                              graph_distributed_kmeans)
    from repro_torch.core.objective import WEISZFELD_ITERS
    from repro_torch.data import (embed_examples, gather_selected,
                                  select_coreset)
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.wan import (certify_quiescence, random_fault_plan,
                                 restricted_sim_coreset)
    from repro_torch.wan.schedules import wan_schedule

    t_phase = time.perf_counter()
    idx, sp25, sm25 = sites25
    g = topology.wan_clusters(5, 5)
    t25 = 3 * k * g.n
    key = prng.PRNGKey(seed, device=dev)
    k1, k2 = prng.split(key)
    diam, period = topology.diameter(g), wan_schedule(g).max_period
    total = {}
    print("phase 12: the asynchronous WAN runtime and data selection, "
          "backend='cuda'")
    print(f"  (a) {g.n} sites of the full data (M={sp25.shape[1]}) on "
          f"wan_clusters(5, 5): {g.m} links, max degree "
          f"{int(max(g.degrees()))}, diameter {diam}, clock periods up to "
          f"{period}; t={t25}")

    def floods(res):
        for name, r in res.exec_detail.rounds.items():
            if hasattr(r, "rounds_to_quiesce"):
                print(f"      {name}: {r.rounds} rounds, complete after "
                      f"{r.rounds_to_complete}, quiescent after "
                      f"{r.rounds_to_quiesce}, staleness "
                      f"{r.ledger.staleness:.4f}, "
                      f"{sum(r.per_round_transmissions)} transmissions, "
                      f"wall_s {r.wall_s:.4f}")
            else:
                print(f"      {name}: {r.rounds} rounds, complete after "
                      f"{r.rounds_to_complete}, wall_s {r.wall_s:.4f}")

    def run(label, new=True, **kw):
        """One graph_distributed_kmeans run on the 25 sites with its launches
        counted (added to the phase's when ``new``): (result, wall s,
        launches, by kernel)."""
        times = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res, n, by = _launched(counts, total if new else {}, lambda: (
            graph_distributed_kmeans(key, sp25, sm25, k, t25, g,
                                     backend="cuda", device=dev,
                                     phase_times=times, **kw)))
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - start) / 2**30
        print(f"    {label}: wall {wall:.3f} s "
              f"{json.dumps({p: round(x, 4) for p, x in times.items()})}, "
              f"peak device memory {peak:.2f} GiB above its start; launches "
              f"{json.dumps(n)}, by kernel {json.dumps(by)}")
        floods(res)
        return res, wall, n, by

    def same(label, a, b):
        check(torch.equal(a.centers, b.centers)
              and torch.equal(a.coreset.points, b.coreset.points)
              and torch.equal(a.coreset.weights, b.coreset.weights),
              f"phase 12 {label}: coreset or centres differ")

    # -- 1. full mode against exec, both objectives ---------------------------
    exec_km = None
    for objective in ("kmeans", "kmedian"):
        ex = run(f"{objective} exec", new=False, objective=objective,
                 engine="exec")
        asy = run(f"{objective} async full", objective=objective,
                  engine="async", wan_mode="full")
        same(f"{objective} async full", asy[0], ex[0])
        ea, eb = ex[0].ledger.as_dict(), asy[0].ledger.as_dict()
        check(all(ea[u] == eb[u] for u in LEDGER_UNITS)
              and eb["staleness"] == 0.0,
              f"phase 12 {objective} async full: ledger {eb}, exec {ea}")
        want = ({"lloyd_stats": 2 * 8, "weiszfeld_stats": 0}
                if objective == "kmeans" else
                {"lloyd_stats": 0,
                 "weiszfeld_stats": 2 * 8 * WEISZFELD_ITERS})
        want.update(distance_argmin=2 * k + 1, distance_argmin_batched=0,
                    lloyd_reduce=0, weiszfeld_reduce=0)
        want_by = {da.ONE_CENTER.name: 2 * k, da.RESIDENT.name: 1,
                   da.TILE.name: 0, da.STREAM.name: 0}
        check(asy[2] == ex[2] == want and asy[3] == ex[3] == want_by,
              f"phase 12 {objective} async full: launches {asy[2]} "
              f"{asy[3]}, exec {ex[2]} {ex[3]}, expected {want} {want_by}")
        digests[f"wan async {objective} centres[wan_clusters(5, 5)]"] = \
            digest(asy[0].centers)
        print(f"    {objective}: async full equals exec (coreset, centres, "
              f"ledger, staleness 0, launches); wall async / exec "
              f"{asy[1] / ex[1]:.3f}")
        if objective == "kmeans":
            exec_km = ex
        del ex, asy

    # -- 2. the clock default and random gossip -------------------------------
    clock = run("kmeans async clock", engine="async")
    rand = run("kmeans async random", engine="async", wan_mode="random",
               wan_p=0.5)
    again = run("kmeans async random, rerun", engine="async",
                wan_mode="random", wan_p=0.5)
    for label, r in (("clock", clock), ("random", rand)):
        check(torch.equal(r[0].centers, exec_km[0].centers),
              f"phase 12 async {label}: centres differ from exec's")
    check(clock[0].ledger.staleness > 0.0,
          f"phase 12 async clock: staleness {clock[0].ledger.staleness}")
    for name, r in clock[0].exec_detail.rounds.items():
        check(r.rounds_to_complete <= period * diam,
              f"phase 12 async clock {name}: complete after "
              f"{r.rounds_to_complete} > P x D = {period * diam}")
    same("async random rerun", again[0], rand[0])
    check(rand[0].ledger.as_dict(by_phase=True)
          == again[0].ledger.as_dict(by_phase=True)
          and all(a.per_round_transmissions == b.per_round_transmissions
                  for a, b in zip(rand[0].exec_detail.rounds.values(),
                                  again[0].exec_detail.rounds.values())),
          "phase 12 async random rerun: ledger or rounds differ")
    print(f"    clock and random: centres equal exec's; clock staleness "
          f"{clock[0].ledger.staleness:.4f}, complete within P x D = "
          f"{period * diam}; random rerun bit-identical; wall / exec clock "
          f"{clock[1] / exec_km[1]:.3f}, random {rand[1] / exec_km[1]:.3f}")
    del clock, rand, again

    # -- 3. plan F: exec and async against the restricted oracle --------------
    base = random_fault_plan(g, seed=0, drop_frac=0.1, n_churn=3,
                             dead_frac=0.34, dup_rate=0.2)
    plan = dataclasses.replace(base, churn=((13, 3, 6), (18, 3, 4),
                                            (23, 3, -1)))
    surv = plan.surviving_nodes(g.n)
    sub, _ = plan.surviving_graph(g)
    check(plan.dead_nodes() == (23,) and surv.size == 24,
          f"phase 12: plan F kills {plan.dead_nodes()}")
    print(f"  plan F: {len(plan.drop)} links dropped {list(plan.drop)}, "
          f"churn {list(plan.churn)}, dup_rate {plan.dup_rate}; "
          f"{surv.size} survivors, survivor diameter {topology.diameter(sub)},"
          f" horizon {plan.horizon()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (pts_o, w_o, _, _), _, _ = _launched(counts, total, lambda: (
        restricted_sim_coreset(k1, sp25, sm25, k, t25, t25, "kmeans", 8,
                               False, "cuda", surv, device=dev)))
    c_o = _solve_on_coreset(k2, Coreset(pts_o, w_o), k, "kmeans", 8, "cuda")
    torch.cuda.synchronize()
    print(f"    restricted oracle + solve: wall "
          f"{time.perf_counter() - t0:.3f} s")
    dead_rows = {r.tobytes() for r in sp25[23][sm25[23]].cpu().numpy()}
    for engine in ("exec", "async"):
        res = run(f"kmeans {engine} under F", faults=plan, engine=engine)[0]
        check(torch.equal(res.coreset.points, pts_o)
              and torch.equal(res.coreset.weights, w_o)
              and torch.equal(res.centers, c_o),
              f"phase 12 {engine} under F: differs from the restricted "
              f"oracle")
        live = res.coreset.points[res.coreset.weights != 0].cpu().numpy()
        from_dead = sum(r.tobytes() in dead_rows for r in live)
        check(23 not in res.exec_detail.surviving and from_dead == 0,
              f"phase 12 {engine} under F: {from_dead} rows of site 23")
        digests[f"wan {engine} F centres[wan_clusters(5, 5)]"] = digest(
            res.centers)
        print(f"    {engine} under F: coreset ({res.coreset.points.shape[0]}"
              f" rows) and centres equal the restricted oracle's; no row "
              f"of site 23")
        del res

    # -- 4. certificates of F ------------------------------------------------
    for mode in ("full", "clock", "random"):
        extra = (dict(check_clustering=True, key=key, site_points=sp25,
                      site_mask=sm25, k=k, t=t25, backend="cuda")
                 if mode == "full" else {})
        t0 = time.perf_counter()
        cert, _, _ = _launched(counts, total, lambda: certify_quiescence(
            g, plan, mode=mode, seed=seed, device=dev, **extra))
        check(cert.ok, f"phase 12 certificate {mode}: {cert}")
        print(f"    certificate {mode}: ok; "
              f"{json.dumps(dataclasses.asdict(cert))}; wall "
              f"{time.perf_counter() - t0:.3f} s")

    # -- 5. the distributed stream of phase 10 -------------------------------
    gs = stream25.graph
    t_round = 3 * k * gs.n
    print(f"  stream: phase 10's DistributedStream on grid(5, 5) "
          f"({stream25.total_weight():.0f} rows pushed, {stream25.rounds} "
          f"rounds run)")

    def aggregate(label, new=True, **kw):
        ds = copy.deepcopy(stream25)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res, n, _ = _launched(counts, total if new else {},
                              lambda: ds.aggregate(k=k, t=t_round, **kw))
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - start) / 2**30
        print(f"    {label}: wall {wall:.3f} s, peak device memory "
              f"{peak:.2f} GiB above its start; launches {json.dumps(n)}")
        return ds, res, wall

    for mode in ("union", "resample"):
        _, ex, w_ex = aggregate(f"{mode} exec", new=False, mode=mode,
                                engine="exec")
        _, asy, w_as = aggregate(f"{mode} async full", mode=mode,
                                 engine="async", wan_mode="full")
        same(f"stream {mode} async full", asy, ex)
        ea, eb = ex.ledger.as_dict(), asy.ledger.as_dict()
        check(all(ea[u] == eb[u] for u in LEDGER_UNITS)
              and eb["staleness"] == 0.0,
              f"phase 12 stream {mode}: ledger {eb}, exec {ea}")
        digests[f"wan stream {mode} centres"] = digest(asy.centers)
        print(f"    stream {mode}: async full equals exec (coreset, "
              f"centres, ledger); wall async / exec {w_as / w_ex:.3f}")
        del ex, asy
    splan = random_fault_plan(gs, seed=2, drop_frac=0.1, n_churn=2,
                              dead_frac=0.5)
    ssurv = splan.surviving_nodes(gs.n)
    ds, res, _ = aggregate("union async under a fault plan", mode="union",
                           engine="async", faults=splan)
    mass = float(res.coreset.weights.double().sum())
    want = sum(float(ds.sites[int(v)].summary().weights.double().sum())
               for v in ssurv)
    check(abs(mass - want) <= 1e-5 * want,
          f"phase 12 stream under faults: mass {mass}, survivors' {want}")
    print(f"    stream union under {splan}: {ssurv.size} survivors, mass "
          f"{mass:.3f} = the survivors' {want:.3f}; staleness "
          f"{res.ledger.staleness:.4f}")
    del ds, res

    # -- (b) data selection at llama3-8b's embedding widths -------------------
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((LLAMA3_8B_VOCAB, LLAMA3_8B_D_MODEL), generator=gen,
                        device=dev)
    tokens = torch.randint(0, LLAMA3_8B_VOCAB,
                           (SELECT_SITES, SELECT_EXAMPLES, SELECT_TOKENS),
                           generator=gen, device=dev)
    pool = SELECT_SITES * SELECT_EXAMPLES
    t_sel = int(SELECT_FRACTION * pool)
    print(f"  (b) selection: table {tuple(table.shape)} float32 "
          f"({table.numel() * 4 / 1e9:.2f} GB, random init), pool "
          f"{tuple(tokens.shape)} tokens, k={SELECT_K}, t={t_sel}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    emb = embed_examples(table, tokens, device=dev)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    embed_peak = (torch.cuda.max_memory_allocated() - start) / 2**30
    first = table[tokens[0, :4]].mean(-2)
    check(torch.allclose(emb[0, :4], first, rtol=1e-6, atol=1e-6),
          "phase 12 embed_examples: the first chunk differs")
    mask = torch.ones(emb.shape[:2], dtype=torch.bool, device=dev)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sel, n_sel, by_sel = _launched(counts, total, lambda: select_coreset(
        key, emb, mask, SELECT_K, t_sel, backend="cuda", device=dev))
    select_s = time.perf_counter() - t0
    select_peak = (torch.cuda.max_memory_allocated() - start) / 2**30
    again = select_coreset(key, emb, mask, SELECT_K, t_sel, backend="cuda",
                           device=dev)
    check(all(torch.equal(getattr(sel, f), getattr(again, f)) for f in
              ("indices", "weights", "t_i", "local_costs")),
          "phase 12 select_coreset: a rerun differs")
    mass = check_selection("phase 12", sel, n_sel, by_sel, t_sel,
                           SELECT_EXAMPLES)
    out = gather_selected(tokens, sel)
    slots = SELECT_SITES * (t_sel + SELECT_K)
    check(tuple(out["tokens"].shape) == (slots, SELECT_TOKENS)
          and tuple(out["weights"].shape) == (slots,),
          f"phase 12 gather_selected: {tuple(out['tokens'].shape)} "
          f"{tuple(out['weights'].shape)}")
    digests["selection[llama3-8b widths]"] = digest(sel.indices,
                                                    sel.weights)
    print(f"    embed wall {embed_s:.3f} s (peak {embed_peak:.2f} GiB above "
          f"its start), select wall {select_s:.3f} s (peak "
          f"{select_peak:.2f} GiB); sum t_i {t_sel}, mass {mass:.3f} for "
          f"{pool} examples; rerun bit-identical; gather_selected "
          f"{tuple(out['tokens'].shape)}; launches {json.dumps(n_sel)}, by "
          f"kernel {json.dumps(by_sel)}")
    c8 = checks["rows"](emb, SELECT_K)
    checks["distance"]("selection seeding (one centre)", emb,
                       checks["rows"](emb, 1))
    checks["distance"]("selection", emb, c8)
    checks["lloyd"]("selection", emb, c8, mask.float())
    checks["weiszfeld"]("selection", emb, c8, mask.float())
    reduce_row = time_reduce(dev, "lloyd_reduce", emb, c8, mask.float(), hw)
    del table, tokens, sel, again, out
    print(f"  phase 12 wall {time.perf_counter() - t_phase:.1f} s")
    return total, reduce_row, (key, emb, mask, t_sel)


def check_selection(label, sel, n_sel, by_sel, t_sel, per_site):
    """A ``select_coreset`` run at d = 4,096 with every example live: sum
    t_i is ``t_sel``, the weights' mass is the pool's size (within 1e-3),
    every index lies in its site, and the kernels launched as the
    selection calls them -- k seeding launches of the one-centre kernel,
    one assignment on the streamed tile per Lloyd step (5) and one for the
    nearest-example search, each step's sums through lloyd_reduce.
    Returns the mass."""
    from repro_torch.kernels import distance_argmin as da
    pool = sel.weights.shape[0] * per_site
    mass = float(sel.weights.double().sum())
    check(int(sel.t_i.sum()) == t_sel and abs(mass - pool) <= 1e-3 * pool
          and int(sel.indices.min()) >= 0
          and int(sel.indices.max()) < per_site,
          f"{label} select_coreset: sum t_i {int(sel.t_i.sum())}, mass "
          f"{mass}, indices in [{int(sel.indices.min())}, "
          f"{int(sel.indices.max())}]")
    want = {"distance_argmin": SELECT_K + 5 + 1, "lloyd_stats": 0,
            "weiszfeld_stats": 0, "distance_argmin_batched": 0,
            "lloyd_reduce": 5, "weiszfeld_reduce": 0}
    want_by = {da.ONE_CENTER.name: SELECT_K, da.RESIDENT.name: 0,
               da.TILE.name: 0, da.STREAM.name: 5 + 1}
    check(n_sel == want and by_sel == want_by,
          f"{label} select_coreset: launches {n_sel} {by_sel}, expected "
          f"{want} {want_by}")
    return mass


# substrings of the port's kernel names: every device operation that holds
# one was launched by a kernel wrapper
PORT_KERNELS = ("distance_", "lloyd_", "weiszfeld_", "partials_reduce")


def ledger_launches(ledger):
    """The launches each kernel entry makes for a ledger's calls, by the
    routing rule of ``kernels.ops``: a statistics call whose block does not
    fit shared memory runs distance_argmin and its reduction kernel; and
    the one-centre launches (the calls with k = 1)."""
    from repro_torch.kernels import lloyd_update as lu
    from repro_torch.kernels import weiszfeld as wz
    want = {"distance_argmin": 0, "lloyd_stats": 0, "weiszfeld_stats": 0,
            "distance_argmin_batched": 0, "lloyd_reduce": 0,
            "weiszfeld_reduce": 0}
    one_center = 0
    for call in ledger:
        _, _, k, d = call.sizes()
        if call.function == "min_dist_argmin":
            want["distance_argmin"] += 1
            one_center += k == 1
        elif call.function == "min_dist_argmin_batched":
            want["distance_argmin_batched"] += 1
        else:
            fits = (lu if call.function == "lloyd_stats" else wz).fits(k, d)
            if fits:
                want[call.function] += 1
            else:
                want["distance_argmin"] += 1
                want[call.function.replace("_stats", "_reduce")] += 1
    return want, one_center


def phase13(seed, dev, hw, runs, counts, small, w4_gather, digests):
    """The roofline of the main paths at full width: each of ``runs``
    (label -> (run, digest key or None)) once under
    ``repro_torch.roofline.record()`` and ``torch.profiler``, with every
    launch count from zero around it. Per phase and function: calls,
    flops, bytes, bound, device time and bound / device; the device's busy
    time and idle share; the three terms of a ``RooflineReport``. Checks:
    the ledger's calls give the launch counters exactly
    (:func:`ledger_launches`); every device operation of the port's
    kernels ran under a ledger call; every function's device time is
    measured and no bound / device exceeds 1.05; a run with a digest key
    gives that digest with recording on. Then the ledger of phase 4's
    scale-0.1 instance (``small``: data, sites, mask, graph, k, t) equal
    under backend='cuda' and 'torch', and phase 11's W = 4 all_gather run
    (``w4_gather``): its collectives by phase, each gather's link bytes
    equal to the bytes the run recorded receiving. Returns each run's
    launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import roofline
    from repro_torch.core import prng
    from repro_torch.core.distributed import graph_distributed_kmeans
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.roofline import report, trace

    t_phase = time.perf_counter()
    reset_counts, entry_counts, route_counts = counts
    print(f"phase 13: the roofline of the main paths on {hw.name} figures "
          f"(fp32 {hw.fp32_flops / 1e12:g} TFLOP/s, memory "
          f"{hw.hbm_bytes_per_s / 1e12:g} TB/s; this card's power limit "
          f"{hw.power_limit_w:g} W)")
    launched = {}
    for label, (run, digest_key) in runs.items():
        # a trace in which a function with ledger calls has no device time
        # lost the profiler's device events (seen once on an H100: 28,717
        # of ~39,700 operations, the solve's weiszfeld_stats gone): it
        # measures nothing, so the route is traced again, at most twice
        for attempt in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with roofline.record() as led:
                    out = run()
                    torch.cuda.synchronize()
            spans = trace.device_spans(prof.events(),
                                       {c.phase for c in led if c.phase})
            roof = trace.analyze(led, spans, hw)
            lost = [f"{r.phase} {r.function}" for r in roof.rows
                    if not r.device_ms]
            if not lost:
                break
            print(f"  {label}: the trace lost the device events of "
                  f"{lost} (attempt {attempt + 1}); traced again")
        got, by = entry_counts(), route_counts()
        launched[label] = got
        peak = torch.cuda.max_memory_allocated()
        print(f"  {label}: {len(led)} calls, wall "
              f"{roof.wall_ms:.3f} ms (tracing on), launches "
              f"{json.dumps(got)}")
        for line in roof.lines():
            print(f"    {line}")
        rep = report.build_report(label, "full width", "1 card", None,
                                  "cluster", 0, 0, 1, roof.analysis(), None,
                                  float(peak), hw, precision="fp32")
        print(f"    three terms: compute {rep.compute_s * 1e3:.4f} ms, "
              f"memory {rep.memory_s * 1e3:.4f} ms, collective "
              f"{rep.collective_s * 1e3:.4f} ms ({rep.bottleneck}); peak "
              f"device memory {peak / 2**30:.2f} GiB")
        want, one_center = ledger_launches(led)
        check(got == want and by[da.ONE_CENTER.name] == one_center
              and sum(by.values()) == want["distance_argmin"]
              + want["distance_argmin_batched"],
              f"phase 13 {label}: launches {got} {by}, the ledger's calls "
              f"give {want} and {one_center} one-centre")
        stray = sorted({s.name[:60] for s in spans if s.function is None
                        and any(x in s.name for x in PORT_KERNELS)})
        check(not stray, f"phase 13 {label}: kernels launched outside every "
              f"ledger call: {stray}")
        for row in roof.rows:
            check(row.device_ms and row.share <= 1.05,
                  f"phase 13 {label}: {row.phase} {row.function} bound "
                  f"{row.bound_ms:.4f} ms against device "
                  f"{row.device_ms} ms")
        if digest_key is not None:
            got_digest = digest(*out)
            check(got_digest == digests[digest_key],
                  f"phase 13 {label}: digest {got_digest} with recording on, "
                  f"{digests[digest_key]} without")
            print(f"    digest equals {digest_key}'s with recording on")
    # the ledger does not depend on the backend that serves the calls
    data_s, sp_s, sm_s, g, k, t = small
    leds = {}
    for backend in ("cuda", "torch"):
        with roofline.record() as led:
            graph_distributed_kmeans(prng.PRNGKey(seed), sp_s, sm_s, k, t, g,
                                     backend=backend, device=dev)
        leds[backend] = [(c.function, c.sizes(), c.phase) for c in led]
    check(leds["cuda"] == leds["torch"],
          "phase 13: the scale-0.1 ledger differs between backend='cuda' "
          "and 'torch'")
    print(f"  scale 0.1 (n={data_s.shape[0]}): the ledger's "
          f"{len(leds['cuda'])} calls equal under backend='cuda' and "
          f"'torch'")
    # the collectives of the SPMD path, by phase
    times = w4_gather["times"]
    print(f"  phase 11 W=4 kmeans all_gather, rank 0: collectives by phase "
          f"{json.dumps(w4_gather['collectives'])}")
    for phase in ("round1", "round2"):
        link = w4_gather["collectives"][phase][1].get("all-gather", 0.0)
        want = times[f"{phase}_gather_bytes"]
        check(abs(link - want) <= 1e-9 * want,
              f"phase 13: W=4 {phase} all-gather link bytes {link}, the run "
              f"received {want}")
    print("  each round's all-gather link bytes equal the bytes the run "
          "received in that round")
    print(f"  phase 13 wall {time.perf_counter() - t_phase:.1f} s")
    return launched


# -- phase 14: the language-model stack ----------------------------------------

# (a) the reduced configs, CUDA against the CPU on the same params: batch,
# sequence and prefill lengths of tests/test_models.py
LM_B, LM_L, LM_LP = 2, 32, 24
# exactified f32: |CUDA - CPU| <= LM_F32_RTOL * max |logit| (the CPU tests'
# tolerance against the JAX package: the same f32 math in other orders)
LM_F32_RTOL = 2e-4
# default bf16: a few bf16 roundings (2^-8 relative) per layer, as the CPU
# tests hold the port against the JAX package
LM_BF16_RTOL = 5e-2
# a MoE router's top-k set may differ between the two devices only at a
# near tie (the k-th and the next probability closer than this) or at or
# after a position of its row that differed before; each row's logits are
# held up to its first flip (tests/test_torch_models.py)
LM_NEAR_TIE = 4e-3
# prefill and decode against the score forward (tests/test_models.py)
LM_DECODE_RTOL = 5e-4
# ... except for the SSD: its chunked scan (the JAX package's formula)
# takes exp of differences of running sums of dt * A within a chunk, which
# at mamba2-370m's widths reach ~1e4 (A down to -32, chunks of 256), so f32
# loses ~1e-3 in each exponent; prefill (chunk 256) and the score forward
# (chunk 208 at L = 1,040) round differently, and decode (the exact
# recurrence) differs from both. Measured 1.7e-3 / 5.3e-4 of max |logit|
LM_SSD_DECODE_RTOL = 5e-3
# (b) and (c): (architecture, batch, prefill length, decode steps) at the
# published widths, each model whole. llama3-8b: a 2,048-token prefill into
# a cache of 2,080; recurrentgemma: a prefill past its 2,048-token window
# (the ring cache)
LM_FULL = (("llama3_8b", 2, 2048, 32), ("granite_moe_3b_a800m", 2, 1024, 16),
           ("mamba2_370m", 2, 1024, 16), ("recurrentgemma_2b", 2, 2304, 16),
           ("qwen2_vl_2b", 2, 1024, 16))


def lm_leaves(tree):
    """The leaves of a params / optimizer / cache tree, in
    ``jax.tree_util``'s order (``repro_torch.tree``)."""
    from repro_torch import tree as tree_mod
    return tree_mod.leaves(tree)


def lm_exactify(cfg):
    """f32 activations and drop-free MoE, so that prefill and decode equal
    the score forward (tests/test_models.py's ``_exactify``)."""
    cf = cfg.capacity_factor
    if cfg.n_experts:
        cf = float(cfg.n_experts) / cfg.top_k
    return dataclasses.replace(cfg, dtype="float32", capacity_factor=cf)


class recorded_routes:
    """Within the block, every MoE layer's router probabilities and top-k
    experts (host copies), in call order."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route, self.seen = moe, moe.route, []

        def spy(p, x, cfg):
            out = self.route(p, x, cfg)
            self.seen.append((out[0].float().cpu(), out[2].cpu()))
            return out

        moe.route = spy
        return self.seen

    def __exit__(self, *exc):
        self.moe.route = self.route
        return False


def lm_modes(tc, params, tok, prefill, routes=False):
    """Score forward on ``tok``, prefill of ``prefill`` tokens into a cache
    of ``tok``'s length, then decode to the end, on ``tok``'s device:
    logits, aux, prefill logits, decode logits (B, steps, V) and, with
    ``routes``, the score forward's MoE routing."""
    from repro_torch.models import forward, init_cache, make_positions
    out = {}
    with torch.inference_mode():
        with recorded_routes() as seen:
            out["logits"], _, aux = forward(params, tok,
                                            make_positions(tok, tc), tc)
        out["aux"], out["routes"] = float(aux), seen
        cache = init_cache(tc, tok.shape[0], tok.shape[1], tok.device)
        out["prefill"], cache, _ = forward(
            params, tok[:, :prefill], make_positions(tok[:, :prefill], tc),
            tc, cache=cache)
        steps = []
        for s in range(prefill, tok.shape[1]):
            ls, cache, _ = forward(params, tok[:, s:s + 1], make_positions(
                tok[:, s:s + 1], tc, offset=s), tc, cache=cache)
            steps.append(ls[:, 0])
        out["decode"] = torch.stack(steps, dim=1)
    return out


def rows_before_first_flip(tc, routes_a, routes_b, length):
    """(B, L) mask of each row's positions before its first MoE routing
    difference between two runs; fails on a difference at no near tie."""
    first = [length] * routes_a[0][1].shape[0]
    for (probs, idx_a), (_, idx_b) in zip(routes_a, routes_b):
        top = torch.sort(probs, dim=-1, descending=True).values
        gap = top[..., tc.top_k - 1] - top[..., tc.top_k]
        flips = (torch.sort(idx_a, -1).values
                 != torch.sort(idx_b, -1).values).any(-1)
        for b, pos in torch.nonzero(flips).tolist():
            check(pos >= first[b] or float(gap[b, pos]) < LM_NEAR_TIE,
                  f"{tc.name}: routing differs at row {b} position {pos}, "
                  f"gap {float(gap[b, pos]):.3g} is no near tie")
            first[b] = min(first[b], pos)
    return torch.arange(length)[None] < torch.tensor(first)[:, None]


def lm_reduced(seed, dev, digests):
    """Phase 14 (a): every reduced architecture on the same seeded params
    on the card and on the CPU, in exactified f32 and in the default bf16:
    forward, prefill and decode logits and the aux loss. f32 within
    LM_F32_RTOL; bf16 within LM_BF16_RTOL (a MoE model's score forward up
    to each row's first routing flip, flips only at near ties; its prefill
    and decode are held in f32). The f32 logits are digested."""
    from repro_torch import configs
    from repro_torch.models import init_params
    worst = {}
    for arch in configs.ARCH_IDS:
        for exact in (True, False):
            tc = configs.get_reduced(arch)
            tc = lm_exactify(tc) if exact else tc
            tok = torch.from_numpy(np.random.default_rng(seed + 1).integers(
                0, tc.vocab_size, (LM_B, LM_L)).astype(np.int32))
            runs = {}
            for where in ("cpu", dev):
                params = init_params(torch.Generator().manual_seed(seed), tc,
                                     where)
                runs[str(where)] = lm_modes(tc, params, tok.to(where), LM_LP)
            ref, got = runs["cpu"], runs[str(dev)]
            scale = float(ref["logits"].abs().max())
            errs = {k: float((got[k].cpu() - ref[k]).abs().max()) / scale
                    for k in ("logits", "prefill", "decode")}
            label = f"{arch} {'f32' if exact else 'bf16'}"
            for k, e in errs.items():
                check(math.isfinite(e), f"phase 14 {label}: {k} not finite")
            if exact:
                check(max(errs.values()) <= LM_F32_RTOL,
                      f"phase 14 {label}: |cuda - cpu| / max|logit| {errs}")
                check(abs(got["aux"] - ref["aux"])
                      <= LM_F32_RTOL * max(abs(ref["aux"]), 1e-6),
                      f"phase 14 {label}: aux {got['aux']} {ref['aux']}")
                digests[f"lm[{arch}] f32 logits"] = digest(
                    got["logits"], got["prefill"], got["decode"])
            elif tc.n_experts:
                rows = rows_before_first_flip(tc, ref["routes"],
                                              got["routes"], LM_L)
                per_pos = (got["logits"].cpu() - ref["logits"]).abs().amax(
                    -1) / scale
                errs = {"logits (rows before their first flip)":
                        float(per_pos[rows].max()),
                        "positions held": int(rows.sum())}
                check(errs["positions held"] >= LM_L // 2
                      and errs["logits (rows before their first flip)"]
                      <= LM_BF16_RTOL, f"phase 14 {label}: {errs}")
                check(abs(got["aux"] - ref["aux"])
                      <= LM_BF16_RTOL * abs(ref["aux"]),
                      f"phase 14 {label}: aux {got['aux']} {ref['aux']}")
            else:
                check(max(errs.values()) <= LM_BF16_RTOL,
                      f"phase 14 {label}: |cuda - cpu| / max|logit| {errs}")
            worst[label] = errs
    return worst


def lm_full(seed, dev, arch, batch, prefill, steps, smi, digests,
            get=None):
    """Phase 14 (b) and (c): one model at its published widths, whole,
    random f32 params from a seed on the card. The default bf16 score
    forward (timed, tokens/s) and ``lm_loss`` on it, a bf16 prefill of
    ``prefill`` tokens into a cache of ``prefill + steps`` and ``steps``
    decode steps (timed); then, exactified to f32, the score forward over
    all ``prefill + steps`` tokens, the prefill and each decode step, whose
    logits must equal the score forward's within LM_DECODE_RTOL * max
    |logit| (LM_SSD_DECODE_RTOL for the SSD). Returns the numbers it
    prints."""
    from repro_torch import configs
    from repro_torch.models import (forward, init_cache, init_params,
                                    make_positions)
    from repro_torch.train import lm_loss
    cfg = (get or configs.get)(arch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         dev)
    n_params = sum(x.numel() for x in lm_leaves(params))
    check(n_params == cfg.param_count(),
          f"phase 14 {arch}: {n_params} params, the config counts "
          f"{cfg.param_count()}")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    L = prefill + steps
    tok = torch.randint(0, cfg.vocab_size, (batch, L), generator=gen,
                        device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    row = {"arch": arch, "params": n_params, "batch": batch,
           "prefill": prefill, "decode_steps": steps,
           "init_s": round(time.perf_counter() - t0, 3)}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    with torch.inference_mode():
        # the default bf16: score forward and its loss, prefill, decode
        x = tok[:, :prefill]
        (logits, _, aux), wall = timed(lambda: forward(
            params, x, make_positions(x, cfg), cfg))
        row["score_s"] = round(wall, 4)
        row["score_tokens_per_s"] = round(batch * prefill / wall, 1)
        loss, metrics = lm_loss(logits[:, :-1], x[:, 1:], cfg,
                                aux=aux if cfg.n_experts else None)
        row["loss"] = float(loss)
        row["ce"] = float(metrics["ce"])
        check(math.isfinite(row["loss"]) and bool(torch.isfinite(
            logits).all()), f"phase 14 {arch}: bf16 loss {row['loss']}")
        del logits
        cache = init_cache(cfg, batch, L, dev)
        _, wall = timed(lambda: forward(params, x, make_positions(x, cfg),
                                        cfg, cache=cache))
        row["prefill_s"] = round(wall, 4)

        def decode():
            for s in range(prefill, L):
                forward(params, tok[:, s:s + 1], make_positions(
                    tok[:, s:s + 1], cfg, offset=s), cfg, cache=cache)

        _, wall = timed(decode)
        row["decode_ms_per_token"] = round(1e3 * wall / steps, 3)
        del cache
        # exactified f32: prefill and decode against the score forward
        c32 = lm_exactify(cfg)
        (ref, _, _), wall = timed(lambda: forward(
            params, tok, make_positions(tok, c32), c32))
        row["f32_score_s"] = round(wall, 4)
        scale = float(ref.abs().max())
        cache = init_cache(c32, batch, L, dev)
        got, _, _ = forward(params, x, make_positions(x, c32), c32,
                            cache=cache)
        err = float((got - ref[:, :prefill]).abs().max()) / scale
        del got
        errs = [err]
        for s in range(prefill, L):
            ls, cache, _ = forward(params, tok[:, s:s + 1], make_positions(
                tok[:, s:s + 1], c32, offset=s), c32, cache=cache)
            errs.append(float((ls[:, 0] - ref[:, s]).abs().max()) / scale)
        row["f32_prefill_err"] = errs[0]
        row["f32_decode_err"] = max(errs[1:])
        tol = LM_SSD_DECODE_RTOL if "ssd" in cfg.pattern else LM_DECODE_RTOL
        check(bool(torch.isfinite(ref).all()) and max(errs) <= tol,
              f"phase 14 {arch}: f32 prefill / decode against the score "
              f"forward, / max|logit|: {errs[0]:.3g} / {max(errs[1:]):.3g}")
        digests[f"lm[{arch}] f32 last logits"] = digest(ref[:, -1])
        del ref, cache
    row["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
    del params
    torch.cuda.empty_cache()
    print(f"  {arch} ({n_params / 1e9:.3f}B params, B={batch}, prefill "
          f"{prefill}, {steps} decode steps; {smi}): bf16 score "
          f"{row['score_s']:.3f} s ({row['score_tokens_per_s']:.0f} tokens/s),"
          f" loss {row['loss']:.4f} (ce {row['ce']:.4f}), prefill "
          f"{row['prefill_s']:.3f} s, decode {row['decode_ms_per_token']:.2f}"
          f" ms/token; f32 prefill / decode against the score forward "
          f"{row['f32_prefill_err']:.3g} / {row['f32_decode_err']:.3g} of "
          f"max|logit|; peak {row['peak_gib']:.2f} GiB")
    return row


def sdpa_yardstick(seed, dev, smi, get=None, batch=2, length=2048):
    """One llama3-8b layer's attention at (batch, length): the port's path
    (q, k, v in bf16 -> ``flash_attention`` in f32, the online softmax in
    torch ops) against ``torch.nn.functional.scaled_dot_product_attention``
    (causal, GQA) on the same bf16 inputs; CUDA-event ms."""
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.models.flash import flash_attention
    cfg = (get or configs.get)("llama3_8b")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((batch, length, h, hd), generator=gen, device=dev,
                           dtype=torch.bfloat16) for h in (H, KV, KV))
    pos = torch.arange(length, device=dev, dtype=torch.int32)
    qg = q.reshape(batch, length, KV, H // KV, hd)

    def port():
        return flash_attention(qg, k, v, pos, pos, 2048, 4096)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    with torch.inference_mode():
        a = port().reshape(batch, length, H, hd).float()
        b = library().transpose(1, 2).float()
        # both round the output to bf16: two of its ulps, relative
        err = float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
        ms = {"port_ms": cuda_ms(port, reps=5),
              "sdpa_ms": cuda_ms(library, reps=20)}
    check(err <= 2 ** -7, f"phase 14: the port's attention against sdpa "
          f"{err}")
    print(f"  one llama3-8b layer's attention (B={batch}, L={length}, "
          f"{H}/{KV} heads, bf16 in; {smi}): the port's flash_attention "
          f"{ms['port_ms']:.4f} ms, scaled_dot_product_attention "
          f"{ms['sdpa_ms']:.4f} ms (max |diff| / max(1, |sdpa|) {err:.3g})")
    return dict(ms, max_rel_diff=err)


def phase14(seed, dev, smi, digests, get=None):
    """The language-model stack (``repro_torch.models``, ``repro_torch.train
    .loss``): (a) the ten reduced configs, CUDA against the CPU; (b)
    llama3-8b whole; (c) the MoE, SSD, RG-LRU and M-RoPE models at their
    published widths; the SDPA yardstick. ``get`` replaces
    ``configs.get`` (a CPU rehearsal passes the reduced configs)."""
    t_phase = time.perf_counter()
    print(f"phase 14: the LM stack ({smi})")
    worst = lm_reduced(seed, dev, digests)
    for label, errs in worst.items():
        print(f"  {label}: |cuda - cpu| / max|logit| "
              f"{json.dumps({k: round(v, 9) for k, v in errs.items()})}")
    t_a = time.perf_counter() - t_phase
    rows = [lm_full(seed, dev, arch, b, lp, n, smi, digests, get)
            for arch, b, lp, n in LM_FULL]
    sdpa = sdpa_yardstick(seed, dev, smi, get)
    out = {"card": smi, "reduced_s": round(t_a, 2), "models": rows,
           "attention_layer": sdpa,
           "wall_s": round(time.perf_counter() - t_phase, 2)}
    print(f"phase 14: {json.dumps(out)}")
    return out


# -- phase 15: training and LM serving ------------------------------------------

# the CPU tests' rules against the JAX package (tests/_train_rules.py,
# imported by train_rules below), held here between the card and the CPU
# on the same params: the f32 loss and metrics within LOSS_RTOL; every
# gradient leaf within CARD_GRAD_RTOL of its largest magnitude; the params
# after one AdamW step from zero moments under its first-step rule
# the reference's bf16-params test (tests/test_train_loss.py): 30 steps of
# lr 1e-3 on bigram batches of 4 x 32, the loss falls by 0.005; the two
# devices' per-step losses within TRAIN_BF16_LOSS_RTOL (bf16 params move
# apart by bf16 roundings, as the CPU tests hold the port to the JAX
# package)
TRAIN_BF16_STEPS = 30
TRAIN_BF16_LOSS_RTOL = 2e-2
# (b) llama3-8b at its published widths cut to TRAIN_FULL_LAYERS layers
# (8.03B params x 16 bytes of f32 params, gradients and AdamW moments is
# 128 GB; 2 layers are 1.49B params, 23.8 GB; 4 before the MoE, SSD and
# RG-LRU families' mesh runs of phase 16 (h)), B x L tokens a step, remat
# "full" and the chunked loss; the launcher's selection of its training
# set (src/repro/launch/train.py:157-193): a bigram pool of 512 examples
# on max(data axis, 2) = 2 sites, k = 8, t = 0.25 of the pool
TRAIN_FULL_LAYERS = 2
TRAIN_FULL_B, TRAIN_FULL_L, TRAIN_FULL_STEPS = 2, 2048, 3
TRAIN_LOSS_CHUNK = 512
TRAIN_POOL, TRAIN_SITES = 512, 2
# (c) the slot engine on llama3-8b whole (f32 params and activations):
# 4 slots, 6 requests of 24-64 prompt tokens, 16 new tokens each
SERVE_SLOTS, SERVE_REQUESTS, SERVE_NEW = 4, 6, 16
# a token may differ from generate's only where generate's two best
# logits are closer than this times the largest |logit| (the engine
# decodes 4 rows at once, generate one, and the matmuls round by batch)
SERVE_NEAR_TIE = 4e-4
# (d) mamba2-370m whole: the f32 loss and gradients of 1 x 64 tokens held
# card against CPU, then TRAIN_SSD_STEPS steps of 2 x 1,024 bigram
# tokens. At its published widths the SSD's chunked scan (the JAX
# package's formula) takes exp of differences of running sums of dt * A,
# and f32 loses ~1e-3 in those exponents (ROADMAP C): the loss agrees to
# 1.2e-6 and the gradient leaves to 3.7e-3 of their largest, so the loss
# is held to TRAIN_SSD_LOSS_RTOL and the gradients to TRAIN_SSD_GRAD_RTOL,
# and the params after a step are not held entry by entry (the
# first-step rule needs gradients clear of their noise)
TRAIN_SSD_CHECK_L = 64
TRAIN_SSD_LOSS_RTOL = 1e-5
TRAIN_SSD_GRAD_RTOL = 1e-2
TRAIN_SSD_B, TRAIN_SSD_L, TRAIN_SSD_STEPS = 2, 1024, 5

def train_step_once(tc, train_cfg, where, seed, batch, length, step=True):
    """One ``make_train_step`` step on ``where`` from ``init_params`` of a
    CPU generator seeded ``seed`` (the same params on every device) and
    numpy tokens: (loss, gradients, params before, params after,
    metrics), host copies; with ``step=False`` only the loss and the
    gradients."""
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import value_and_grad
    params = init_params(torch.Generator().manual_seed(seed), tc, where)
    rng = np.random.default_rng(seed + 1)
    b = {k: torch.from_numpy(rng.integers(0, tc.vocab_size, (batch, length))
                             .astype(np.int32)).to(where)
         for k in ("tokens", "labels")}
    (loss, _), grads = value_and_grad(params, b["tokens"], b["labels"], tc,
                                      train_cfg)
    grads = [g.cpu() for g in grads]
    if not step:
        return float(loss), grads
    p0 = [p.cpu().clone() for p in lm_leaves(params)]
    opt = adamw.init(params)
    _, _, m = make_train_step(tc, train_cfg)(params, opt, b, 0)
    return (float(loss), grads, p0, [p.cpu() for p in lm_leaves(params)],
            {k: float(v) for k, v in m.items()})


def train_rules():
    """``tests/_train_rules.py`` beside this script (JAX-free): the one
    copy of the train step's tolerances and checks."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import _train_rules
    return _train_rules


def ruled(label, fn, *args, **kw):
    """``fn`` of the rules, its failed assertion turned into a failed
    check."""
    try:
        return fn(*args, **kw)
    except AssertionError as e:
        raise CheckFailed(f"{label}: {e.args}") from None


def worst_grad(label, grads, want, rtol):
    """Holds the gradient leaves to ``rtol`` of their largest |g| (the
    rules' ``assert_grads``); returns the largest |card - cpu| over it."""
    ruled(label, train_rules().assert_grads, grads, want, label, rtol)
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(grads, want))


def check_train_step(label, got, want):
    """``got`` (the card's :func:`train_step_once`) against ``want`` (the
    CPU's) under the rules above; returns the worst errors."""
    rules = train_rules()
    loss, grads, p0, p1, m = got
    wloss, wgrads, wp0, wp1, wm = want
    check(all(torch.equal(a, b) for a, b in zip(p0, wp0)),
          f"{label}: the two devices start from other params")
    worst = {"loss": abs(loss - wloss) / abs(wloss)}
    check(math.isfinite(loss) and worst["loss"] <= rules.LOSS_RTOL,
          f"{label}: loss {loss} against {wloss}")
    for k, v in wm.items():
        check(abs(m[k] - v) <= rules.LOSS_RTOL * abs(v) + 1e-7,
              f"{label}: metric {k} {m[k]} against {v}")
    worst["grad"] = worst_grad(label, grads, wgrads, rules.CARD_GRAD_RTOL)
    worst["params_within_noise"] = ruled(
        label, rules.assert_first_step, wp0, p1, wp1, wgrads, wm["lr"],
        min(1.0, 1.0 / wm["grad_norm"]), label,
        grad_rtol=rules.CARD_GRAD_RTOL)
    return worst


def train_reduced(seed, dev, digests):
    """Phase 15 (a): every reduced config in f32, one train step (remat
    "full", the chunked loss) on the card against the CPU; llama3-8b
    reduced also with microbatches=2, and the reference's bf16-params run
    (30 steps on the same bigram batches on both devices)."""
    from repro_torch import configs
    from repro_torch.data import BigramLM
    from repro_torch.train import TrainConfig, init_state, make_train_step
    kw = dict(remat="full", loss_chunk=8, warmup_steps=0, peak_lr=1e-3)
    worst = {}
    for arch in configs.ARCH_IDS:
        tc = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
        runs = [train_step_once(tc, TrainConfig(**kw), where, seed, LM_B,
                                LM_L) for where in ("cpu", dev)]
        worst[arch] = check_train_step(f"phase 15 {arch}", runs[1], runs[0])
        digests[f"train[{arch}] f32 step"] = digest(*runs[1][1],
                                                    *runs[1][3])
    tc = dataclasses.replace(configs.get_reduced("llama3_8b"),
                             dtype="float32")
    mb = {n: [train_step_once(tc, TrainConfig(microbatches=n, **kw), where,
                              seed, 4, LM_L) for where in ("cpu", dev)]
          for n in (1, 2)}
    worst["llama3_8b microbatches=2"] = check_train_step(
        "phase 15 llama3_8b microbatches=2", mb[2][1], mb[2][0])
    for k in ("ce", "z_loss", "loss"):
        check(abs(mb[2][1][4][k] - mb[1][1][4][k])
              <= train_rules().LOSS_RTOL * abs(mb[1][1][4][k]),
              f"phase 15 microbatches=2 against one batch: {k}")
    # bf16 params with an f32 master, as tests/test_train_loss.py runs them
    tc = configs.get_reduced("llama3_8b")
    bkw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=TRAIN_BF16_STEPS,
               remat="none", bf16_params=True, loss_chunk=16)
    data = BigramLM(tc.vocab_size, device="cpu")
    batches = [data.batch(s, 4, 32) for s in range(TRAIN_BF16_STEPS)]
    losses = {}
    for where in ("cpu", dev):
        params, opt = init_state(torch.Generator().manual_seed(seed), tc,
                                 TrainConfig(**bkw), device=where)
        step = make_train_step(tc, TrainConfig(**bkw))
        out = []
        for s, b in enumerate(batches):
            params, opt, m = step(params, opt, {k: v.to(where) for k, v in
                                                b.items()}, s)
            out.append(float(m["ce"]))
        check({x.dtype for x in lm_leaves(params)} == {torch.bfloat16}
              and {x.dtype for x in lm_leaves(opt["master"])}
              == {torch.float32}, f"phase 15 bf16 params on {where}: "
              f"dtypes changed")
        check(out[-1] < out[0] - 0.005, f"phase 15 bf16 params on {where}: "
              f"the loss did not fall: {out[::6]}")
        losses[str(where)] = out
    err = max(abs(a - b) / abs(b) for a, b in zip(losses[str(dev)],
                                                  losses["cpu"]))
    check(err <= TRAIN_BF16_LOSS_RTOL, f"phase 15 bf16 params: per-step "
          f"losses card against cpu {err:.3g}")
    worst["llama3_8b bf16 params"] = {
        "loss": err, "first_last_cuda": [losses[str(dev)][0],
                                         losses[str(dev)][-1]]}
    return worst


def train_full(seed, dev, smi, counts, total, checks, get=None):
    """Phase 15 (b): llama3-8b at its published widths, depth cut to
    TRAIN_FULL_LAYERS, trained on a coreset-selected bigram set as the
    launcher builds it (the selection held as phase 12 holds it, and
    each kernel it launched held against its plain version on its
    embeddings); then its params saved through ``AsyncCheckpointer``,
    restored onto the CPU and moved back to the card, bit for bit.
    Returns the numbers it prints."""
    import tempfile
    from repro_torch import configs
    from repro_torch.checkpoint import AsyncCheckpointer, restore
    from repro_torch.core import prng
    from repro_torch.data import (BigramLM, embed_examples, gather_selected,
                                  select_coreset)
    from repro_torch.train import TrainConfig, init_state, make_train_step
    cfg = dataclasses.replace((get or configs.get)("llama3_8b"),
                              n_layers=TRAIN_FULL_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt = init_state(torch.Generator(device=dev).manual_seed(seed),
                             cfg, device=dev)
    n_params = sum(x.numel() for x in lm_leaves(params))
    check(n_params == cfg.param_count(), f"phase 15 (b): {n_params} params, "
          f"the config counts {cfg.param_count()}")
    row = {"arch": f"llama3_8b, {TRAIN_FULL_LAYERS} of "
                   f"{(get or configs.get)('llama3_8b').n_layers} layers",
           "params": n_params, "batch": TRAIN_FULL_B, "seq": TRAIN_FULL_L}
    # the training set: a bigram pool, embedded with the model's table and
    # selected by Algorithm 1 over the embeddings
    data = BigramLM(cfg.vocab_size, device=dev)
    pool = data.batch(10_000_019, TRAIN_POOL, TRAIN_FULL_L)
    per = TRAIN_POOL // TRAIN_SITES
    site = {k: v[:per * TRAIN_SITES].reshape(TRAIN_SITES, per, -1)
            for k, v in pool.items()}
    emb = embed_examples(params["embed"]["table"], site["tokens"],
                         device=dev)
    mask = torch.ones(emb.shape[:2], dtype=torch.bool, device=dev)
    t_sel = max(int(SELECT_FRACTION * per * TRAIN_SITES), 8)
    sel, n_sel, by_sel = _launched(counts, total, lambda: select_coreset(
        prng.PRNGKey(1, device=dev), emb, mask, SELECT_K, t_sel,
        backend="cuda", device=dev))
    mass = check_selection("phase 15 (b)", sel, n_sel, by_sel, t_sel, per)
    # the selection's kernels at its own shape: the one-centre kernel, the
    # streamed tile and lloyd_reduce against their plain versions
    checks["distance"]("phase 15 selection seeding (one centre)", emb,
                       checks["rows"](emb, 1))
    c8 = checks["rows"](emb, SELECT_K)
    checks["distance"]("phase 15 selection", emb, c8)
    checks["lloyd"]("phase 15 selection", emb, c8, mask.float())
    chosen = gather_selected(site["tokens"], sel)
    keep = chosen["weights"] > 0
    toks = chosen["tokens"][keep]
    labs = gather_selected(site["labels"], sel)["tokens"][keep]
    n_batches = len(toks) // TRAIN_FULL_B
    check(n_batches >= TRAIN_FULL_STEPS, f"phase 15 (b): {len(toks)} "
          f"selected examples")
    row.update(pool=TRAIN_POOL, sites=TRAIN_SITES, t=t_sel, mass=mass,
               selected=int(keep.sum()), selection_launches=n_sel,
               selection_by_kernel=by_sel)
    del pool, site, emb, mask, chosen, c8
    torch.cuda.synchronize()
    row["setup_s"] = round(time.perf_counter() - t0, 3)
    step = make_train_step(cfg, TrainConfig(
        remat="full", loss_chunk=TRAIN_LOSS_CHUNK, warmup_steps=0,
        total_steps=TRAIN_FULL_STEPS))
    walls, losses = [], []
    for s in range(TRAIN_FULL_STEPS):
        b = {"tokens": toks[s * TRAIN_FULL_B:(s + 1) * TRAIN_FULL_B],
             "labels": labs[s * TRAIN_FULL_B:(s + 1) * TRAIN_FULL_B]}
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, b, s)
        loss = float(m["loss"])
        walls.append(round(time.perf_counter() - t, 4))
        losses.append(loss)
        check(math.isfinite(loss) and math.isfinite(float(m["grad_norm"])),
              f"phase 15 (b) step {s}: loss {loss}")
    row.update(step_s=walls, losses=losses,
               tokens_per_s=[round(TRAIN_FULL_B * TRAIN_FULL_L / w, 1)
                             for w in walls],
               peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    del toks, labs, m
    # the params and the step, through the async writer
    tree = {"params": params, "step": opt["step"]}
    with tempfile.TemporaryDirectory(prefix="phase15-") as tmp:
        ck = AsyncCheckpointer(tmp)
        t = time.perf_counter()
        ck.save(TRAIN_FULL_STEPS, tree)
        row["ckpt_snapshot_s"] = round(time.perf_counter() - t, 3)
        ck.wait()
        ck.close()
        row["ckpt_write_s"] = round(time.perf_counter() - t, 3)
        row["ckpt_gb"] = round(sum(
            os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tmp)
            for f in fs) / 1e9, 3)
        t = time.perf_counter()
        on_cpu, got_step = restore(tmp, target=tree, shardings="cpu")
        row["restore_cpu_s"] = round(time.perf_counter() - t, 3)
        # and back onto the card, leaf by leaf, against the trained tree
        check(got_step == TRAIN_FULL_STEPS and all(
            a.device.type == "cpu" and a.dtype == b.dtype
            and torch.equal(a.to(dev), b) for a, b in zip(
                lm_leaves(on_cpu), lm_leaves(tree))),
            "phase 15 (b): the checkpoint restored on the CPU differs")
        del on_cpu
    del params, opt, tree
    torch.cuda.empty_cache()
    print(f"  (b) {row['arch']} ({n_params / 1e9:.3f}B params; {smi}): "
          f"selection kept {row['selected']} of {TRAIN_POOL} examples "
          f"(launches {json.dumps(n_sel)}, by kernel {json.dumps(by_sel)}); "
          f"steps of {TRAIN_FULL_B} x {TRAIN_FULL_L} tokens {walls} s "
          f"({row['tokens_per_s']} tokens/s), losses "
          f"{[round(x, 4) for x in losses]}, peak {row['peak_gib']:.2f} GiB; "
          f"checkpoint {row['ckpt_gb']} GB written in "
          f"{row['ckpt_write_s']} s (snapshot {row['ckpt_snapshot_s']} s), "
          f"restored on the CPU in {row['restore_cpu_s']} s, bit-equal back "
          f"on the card")
    return row


def serve_full(seed, dev, smi, digests, get=None):
    """Phase 15 (c): the slot engine on llama3-8b whole, f32 params and
    activations: its outputs equal ``generate``'s per request (up to a
    near tie of generate's logits, SERVE_NEAR_TIE)."""
    from repro_torch import configs
    from repro_torch.models import forward, init_params, make_positions
    from repro_torch.serve import Engine, Request, generate
    cfg = lm_exactify((get or configs.get)("llama3_8b"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         dev)
    rng = np.random.default_rng(seed + 2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in rng.integers(24, 65, SERVE_REQUESTS)]
    eng = Engine(params, cfg, n_slots=SERVE_SLOTS,
                 max_len=max(map(len, prompts)) + SERVE_NEW)
    n_steps = [0]
    engine_step = eng.step

    def counted_step():
        n_steps[0] += 1
        engine_step()

    eng.step = counted_step
    torch.cuda.synchronize()
    t = time.perf_counter()
    done = eng.run([Request(prompt=p, max_new=SERVE_NEW) for p in prompts])
    engine_s = time.perf_counter() - t
    t = time.perf_counter()
    want = [generate(params, cfg, torch.from_numpy(p[None]).to(dev),
                     SERVE_NEW)[0].cpu().numpy() for p in prompts]
    generate_s = time.perf_counter() - t
    flips = 0
    for r, w in zip(done, want):
        diff = np.nonzero(r.out != w)[0]
        check(len(r.out) == len(w), "phase 15 (c): output lengths differ")
        if len(diff):
            seq = torch.from_numpy(w[None]).to(dev)
            with torch.inference_mode():
                logits, _, _ = forward(params, seq, make_positions(seq, cfg),
                                       cfg)
            top = torch.topk(logits[0, diff[0] - 1, :cfg.vocab_size], 2)
            gap = float(top.values[0] - top.values[1])
            scale = float(logits.abs().max())
            check(gap <= SERVE_NEAR_TIE * scale, f"phase 15 (c): the engine "
                  f"differs from generate at {diff[0]}, gap {gap / scale}")
            flips += 1
    digests["serve[llama3_8b engine tokens]"] = digest(*(
        torch.from_numpy(r.out) for r in done))
    row = {"arch": "llama3_8b", "slots": SERVE_SLOTS,
           "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW,
           "prompt_tokens": [len(p) for p in prompts],
           "engine_s": round(engine_s, 3), "engine_steps": n_steps[0],
           "engine_ms_per_step": round(1e3 * engine_s / n_steps[0], 3),
           "engine_tokens_per_s": round(
               SERVE_REQUESTS * SERVE_NEW / engine_s, 1),
           "generate_s": round(generate_s, 3),
           "generate_tokens_per_s": round(
               SERVE_REQUESTS * SERVE_NEW / generate_s, 1),
           "requests_at_a_near_tie": flips,
           "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}
    del params, eng
    torch.cuda.empty_cache()
    print(f"  (c) llama3-8b whole, f32 ({smi}): Engine {SERVE_SLOTS} slots, "
          f"{SERVE_REQUESTS} requests x {SERVE_NEW} new tokens in "
          f"{row['engine_s']} s ({row['engine_steps']} steps, "
          f"{row['engine_ms_per_step']} ms/step, "
          f"{row['engine_tokens_per_s']} tokens/s); generate per request "
          f"{row['generate_s']} s ({row['generate_tokens_per_s']} tokens/s); "
          f"outputs equal ({flips} at a near tie); peak "
          f"{row['peak_gib']:.2f} GiB")
    return row


def train_ssd(seed, dev, smi, digests, get=None):
    """Phase 15 (d): mamba2-370m whole (48 SSD layers): the f32 loss and
    gradients held card against CPU (TRAIN_SSD_LOSS_RTOL,
    TRAIN_SSD_GRAD_RTOL), then TRAIN_SSD_STEPS steps of bigram batches in
    the default bf16, whose loss must fall."""
    from repro_torch import configs
    from repro_torch.data import BigramLM
    from repro_torch.train import TrainConfig, init_state, make_train_step
    cfg = (get or configs.get)("mamba2_370m")
    kw = dict(remat="full", loss_chunk=32)
    c32 = dataclasses.replace(cfg, dtype="float32")
    (loss, grads), (wloss, wgrads) = [
        train_step_once(c32, TrainConfig(**kw), where, seed, 1,
                        TRAIN_SSD_CHECK_L, step=False)
        for where in (dev, "cpu")]
    worst = {"loss": abs(loss - wloss) / abs(wloss)}
    check(math.isfinite(loss) and worst["loss"] <= TRAIN_SSD_LOSS_RTOL,
          f"phase 15 (d) mamba2_370m: loss {loss} against {wloss}")
    worst["grad"] = worst_grad("phase 15 (d) mamba2_370m", grads, wgrads,
                               TRAIN_SSD_GRAD_RTOL)
    digests["train[mamba2_370m f32 loss and gradients]"] = digest(
        torch.tensor([loss]), *grads)
    del grads, wgrads
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_state(torch.Generator(device=dev).manual_seed(seed),
                             cfg, device=dev)
    step = make_train_step(cfg, TrainConfig(
        remat="full", loss_chunk=256, warmup_steps=0, peak_lr=1e-3,
        total_steps=TRAIN_SSD_STEPS))
    data = BigramLM(cfg.vocab_size, device=dev)
    walls, losses = [], []
    for s in range(TRAIN_SSD_STEPS):
        b = data.batch(s, TRAIN_SSD_B, TRAIN_SSD_L)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, b, s)
        losses.append(float(m["loss"]))
        walls.append(round(time.perf_counter() - t, 4))
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"phase 15 (d): the loss did not fall: {losses}")
    row = {"arch": "mamba2_370m", "params": sum(
        x.numel() for x in lm_leaves(params)), "held_step": worst,
        "batch": TRAIN_SSD_B, "seq": TRAIN_SSD_L, "step_s": walls,
        "losses": losses,
        "tokens_per_s": [round(TRAIN_SSD_B * TRAIN_SSD_L / w, 1)
                         for w in walls],
        "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}
    del params, opt
    torch.cuda.empty_cache()
    print(f"  (d) mamba2-370m whole ({row['params'] / 1e6:.1f}M params; "
          f"{smi}): the f32 loss and gradients of 1 x {TRAIN_SSD_CHECK_L} "
          f"tokens against the CPU {json.dumps(worst)}; {TRAIN_SSD_STEPS} "
          f"steps of "
          f"{TRAIN_SSD_B} x {TRAIN_SSD_L} tokens {walls} s, losses "
          f"{[round(x, 4) for x in losses]}, peak {row['peak_gib']:.2f} GiB")
    return row


def phase15(seed, dev, smi, counts, digests, checks, get=None):
    """Training and LM serving (``repro_torch.train``, ``optim``,
    ``checkpoint``, ``serve.engine``, ``data.BigramLM``): (a) the reduced
    configs, CUDA against the CPU; (b) llama3-8b at its published widths,
    2 layers, trained on a coreset-selected set, its checkpoint restored
    bit-equal; (c) the slot engine on llama3-8b whole; (d) mamba2-370m
    whole. ``checks`` are phase 2's kernel checks (``main``'s dict).
    ``get`` replaces ``configs.get`` (a CPU rehearsal passes the reduced
    configs). Returns each kernel's launches in (b)'s selection."""
    t_phase = time.perf_counter()
    print(f"phase 15: training and LM serving ({smi})")
    worst = train_reduced(seed, dev, digests)
    for label, errs in worst.items():
        print(f"  (a) {label}: card against cpu {json.dumps(errs)}")
    t_a = time.perf_counter() - t_phase
    total = {}
    out = {"card": smi, "reduced_s": round(t_a, 2),
           "train": train_full(seed, dev, smi, counts, total, checks,
                               get),
           "serve": serve_full(seed, dev, smi, digests, get),
           "train_ssd": train_ssd(seed, dev, smi, digests, get),
           "wall_s": round(time.perf_counter() - t_phase, 2)}
    print(f"phase 15: {json.dumps(out)}")
    return total


# -- phase 16: the launchers ---------------------------------------------------
# (a) the training launcher as a user calls it: llama3-8b at its published
# widths with the depth cut to 2 layers (1.49B params), 2 steps of 2 x
# 2,048 tokens on the set its own coreset selection keeps (a bigram pool
# of 512 examples on 2 sites, k = 8, t = 0.25 of the pool)
LAUNCH_TRAIN_ARGV = ["--arch", "llama3_8b", "--layers", "2", "--batch", "2",
                     "--seq", "2048", "--steps", "2",
                     "--data-selection", "coreset"]
# (b) a reduced config under ft.Supervisor: the first process crashes at
# step FT_FAIL_AT, the restart resumes from the checkpoint of step 3
FT_ARGV = ["--arch", "mamba2_370m", "--reduced", "--steps", "8",
           "--batch", "4", "--seq", "64", "--ckpt-every", "3",
           "--log-every", "1"]
FT_FAIL_AT = 5
# (c) two gloo ranks sharing the card against one process with two
# microbatches on the same global batch
MESH_ARGV = ["--arch", "llama3_8b", "--reduced", "--steps", "4",
             "--batch", "4", "--seq", "64", "--log-every", "1"]
# (e) the dry run's cells: llama3-8b's three on the single-pod mesh and
# one long-context decode
DRYRUN_CELLS = (("llama3_8b", "train_4k"), ("llama3_8b", "prefill_32k"),
                ("llama3_8b", "decode_32k"), ("gemma3_27b", "long_500k"))
# the dry run runs on the host (meta tensors, nothing on the card): a
# process of its own started before phase 14, read in phase 16
DRYRUN_CHILD = """
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
from repro_torch.roofline.report import Hardware
hw = Hardware(**json.loads(sys.argv[1]))
out = {}
for arch, shape in json.loads(sys.argv[2]):
    out[f"{arch} {shape}"] = dryrun.run_cell(arch, shape, "single", "",
                                             verbose=False, hardware=hw)
with open(sys.argv[3], "w") as f:
    json.dump(out, f)
"""


def launcher_env(**extra):
    """A launcher process's environment: the checkout's ``src`` on its
    path and one PYTHONHASHSEED (``BigramLM`` hashes a string, which
    Python salts per process)."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    return {**os.environ, "PYTHONPATH": src, "PYTHONHASHSEED": "0",
            **extra}


class FailOnce(dict):
    """An environment whose REPRO_FAIL_AT_STEP reaches only the first
    process started with it (``subprocess`` reads ``env.items()`` once
    per start): the restarted trainer runs clean, as after a node
    failure."""

    def items(self):
        out = list(super().items())
        self.pop("REPRO_FAIL_AT_STEP", None)
        return out


def dryrun_start(hw, tmp):
    """Start the dry run of DRYRUN_CELLS for the card ``hw``; returns
    (process, the file it writes)."""
    path = os.path.join(tmp, "dryrun.json")
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CHILD,
         json.dumps(dataclasses.asdict(hw)), json.dumps(DRYRUN_CELLS), path],
        env=launcher_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, path


def final_checkpoint(ckpt, cfg):
    """The last checkpoint of a launcher run (params and AdamW state),
    restored onto the CPU: (step, leaves)."""
    from repro_torch import tree as tree_mod
    from repro_torch.checkpoint import restore
    from repro_torch.models import param_spec
    from repro_torch.optim import adamw
    shapes = param_spec(cfg)
    tree, step = restore(ckpt, target=(shapes, adamw.init(shapes)),
                         shardings="cpu")
    return step, tree_mod.leaves(tree)


def launch_train_full(dev, smi, counts, total, checks, keep):
    """Phase 16 (a): ``launch.train.main`` at llama3-8b's widths, 2
    layers, with --data-selection coreset. The selection's launches are
    held as phase 15 (b)'s, and the one-centre kernel, the streamed tile
    and lloyd_reduce against their plain versions on its embeddings; the
    losses are finite. Returns the numbers it prints; the batches the
    selection kept go to ``keep["batches"]`` (on the host)."""
    from repro_torch.launch import train as launch_train
    seen, walls = {}, []
    real = {k: getattr(launch_train, k) for k in
            ("select_coreset", "embed_examples", "make_train_step",
             "_coreset_pool")}

    def pool(*a, **kw):
        out = real["_coreset_pool"](*a, **kw)
        keep["batches"] = [{k: v.cpu() for k, v in b.items()} for b in out]
        return out

    def select(*a, **kw):
        seen["sel"], seen["t"] = real["select_coreset"](*a, **kw), kw["t"]
        return seen["sel"]

    def embed(*a, **kw):
        seen["emb"] = real["embed_examples"](*a, **kw)
        return seen["emb"]

    def timed(cfg, tc, grad_sync=None):
        step = real["make_train_step"](cfg, tc, grad_sync)

        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            walls.append(round(time.perf_counter() - t, 4))
            return out
        return run

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launch_train.select_coreset, launch_train.embed_examples = select, embed
    launch_train.make_train_step, launch_train._coreset_pool = timed, pool
    t0 = time.perf_counter()
    try:
        log, n_sel, by_sel = _launched(counts, total, lambda: launch_train.main(
            LAUNCH_TRAIN_ARGV + ["--device", str(dev)]))
    finally:
        for k, v in real.items():
            setattr(launch_train, k, v)
    wall = time.perf_counter() - t0
    emb = seen["emb"]
    mask = torch.ones(emb.shape[:2], dtype=torch.bool, device=emb.device)
    mass = check_selection("phase 16 (a)", seen["sel"], n_sel, by_sel,
                           seen["t"], emb.shape[1])
    checks["distance"]("phase 16 selection seeding (one centre)", emb,
                       checks["rows"](emb, 1))
    c8 = checks["rows"](emb, SELECT_K)
    checks["distance"]("phase 16 selection", emb, c8)
    checks["lloyd"]("phase 16 selection", emb, c8, mask.float())
    losses = [m["loss"] for m in log]
    check(len(log) == 2 and all(math.isfinite(x) for x in losses)
          and all(math.isfinite(m["grad_norm"]) for m in log),
          f"phase 16 (a): metrics {log}")
    tokens = int(LAUNCH_TRAIN_ARGV[LAUNCH_TRAIN_ARGV.index("--batch") + 1]) \
        * int(LAUNCH_TRAIN_ARGV[LAUNCH_TRAIN_ARGV.index("--seq") + 1])
    row = {"argv": " ".join(LAUNCH_TRAIN_ARGV), "embeddings":
           list(emb.shape), "t": seen["t"], "mass": mass,
           "selection_launches": n_sel, "selection_by_kernel": by_sel,
           "step_s": walls, "tokens_per_s": [round(tokens / w, 1)
                                             for w in walls],
           "losses": losses, "wall_s": round(wall, 3),
           "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}
    del seen, emb, mask, c8
    torch.cuda.empty_cache()
    print(f"  (a) launch.train {row['argv']} ({smi}): selection "
          f"{json.dumps(n_sel)}, by kernel {json.dumps(by_sel)}, kernels "
          f"held against their plain versions on its {row['embeddings']} "
          f"embeddings; steps {walls} s ({row['tokens_per_s']} tokens/s), "
          f"losses {[round(x, 4) for x in losses]}, wall {row['wall_s']} s, "
          f"peak {row['peak_gib']:.2f} GiB")
    return row


def launch_ft_and_mesh(dev, smi, keep, get=None):
    """Phase 16 (b) and (c): the supervised crash and resume, its final
    checkpoint bit-equal to an uninterrupted run's (each its own
    process); ``--mesh 2x1`` as two gloo ranks sharing the card against
    one process with ``--microbatches 2`` on the same global batch. The
    uninterrupted and the microbatched runs go alongside; the
    microbatched run's log goes to ``keep["mb2"]``."""
    import tempfile
    import threading
    from repro_torch import configs
    from repro_torch.launch import ft
    from repro_torch.launch import train as launch_train
    rules = train_rules()
    get = get or configs.get_reduced
    cmd = [sys.executable, "-m", "repro_torch.launch.train"]
    row = {}
    with tempfile.TemporaryDirectory(prefix="phase16-") as tmp:
        ft_argv = cmd + FT_ARGV + ["--device", str(dev)]
        alongside = {
            "whole": subprocess.Popen(
                ft_argv + ["--ckpt-dir", f"{tmp}/whole", "--metrics-out",
                           f"{tmp}/whole.json"], env=launcher_env(),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            "mb2": subprocess.Popen(
                cmd + MESH_ARGV + ["--device", str(dev), "--microbatches",
                                   "2", "--ckpt-dir", f"{tmp}/mb2",
                                   "--metrics-out", f"{tmp}/mb2.json"],
                env=launcher_env(), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)}
        sup = ft.Supervisor(
            ft_argv + ["--ckpt-dir", f"{tmp}/sup", "--heartbeat",
                       f"{tmp}/hb.json", "--metrics-out", f"{tmp}/sup.json"],
            ft.SupervisorConfig(heartbeat_path=f"{tmp}/hb.json",
                                heartbeat_timeout_s=300.0, backoff_s=0.5),
            env=FailOnce(launcher_env(REPRO_FAIL_AT_STEP=str(FT_FAIL_AT))))
        supervised = {}

        def supervise():
            t = time.perf_counter()
            supervised["ret"] = sup.run()
            row["supervised_s"] = round(time.perf_counter() - t, 3)

        # the supervisor waits on its processes: a thread of its own while
        # this one drives the two ranks
        thread = threading.Thread(target=supervise)
        thread.start()
        try:
            t = time.perf_counter()
            two = launch_train.main(MESH_ARGV + [
                "--device", str(dev), "--mesh", "2x1", "--ckpt-dir",
                f"{tmp}/two"])
            row["mesh_2x1_s"] = round(time.perf_counter() - t, 3)
            thread.join(timeout=900)
            check(not thread.is_alive() and supervised.get("ret") == 0
                  and sup.restarts == 1
                  and sup.events == ["restart-1(ret=42)", "clean-exit"],
                  f"phase 16 (b): supervisor {supervised}, events "
                  f"{sup.events}")
            for name, p in alongside.items():
                out, _ = p.communicate(timeout=900)
                check(p.returncode == 0, f"phase 16: the {name} run failed "
                      f"({p.returncode}):\n{out[-3000:]}")
        finally:
            thread.join(timeout=900)
            for p in alongside.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        steps = int(FT_ARGV[FT_ARGV.index("--steps") + 1])
        with open(f"{tmp}/sup.json") as f:
            resumed = json.load(f)
        with open(f"{tmp}/whole.json") as f:
            whole = {m["step"]: m for m in json.load(f)}
        with open(f"{tmp}/hb.json") as f:
            beat = json.load(f)["step"]
        cfg = get("mamba2_370m")
        (s1, got), (s2, want) = (final_checkpoint(f"{tmp}/sup", cfg),
                                 final_checkpoint(f"{tmp}/whole", cfg))
        check(s1 == s2 == steps and beat == steps - 1
              and resumed[0]["step"] == 3 and resumed[-1]["step"] == steps - 1
              and all(m == whole[m["step"]] for m in resumed),
              f"phase 16 (b): resumed at {resumed[0]['step']}, steps "
              f"{s1} / {s2}, heartbeat {beat}")
        check(len(got) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, want)),
            "phase 16 (b): the resumed run's final checkpoint differs from "
            "the uninterrupted run's")
        row["resumed_from"] = resumed[0]["step"]
        row["checkpoint_digest"] = digest(*got)
        with open(f"{tmp}/mb2.json") as f:
            mb2 = keep["mb2"] = json.load(f)
        worst = 0.0
        for a, b in zip(two, mb2):
            check(a.keys() == b.keys() and a["step"] == b["step"],
                  f"phase 16 (c): {a} against {b}")
            for k in a:
                if k == "ppl_proxy":
                    # exp of the global batch's ce (the reference's global
                    # step), where two microbatches average two exps
                    want = math.exp(min(a["ce"], 20.0))
                    check(abs(a[k] - want) <= rules.LOSS_RTOL * want,
                          f"phase 16 (c) step {a['step']}: 2x1 ppl_proxy "
                          f"{a[k]} against exp(ce) {want}")
                    continue
                err = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                worst = max(worst, err)
                check(err <= rules.LOSS_RTOL or abs(a[k] - b[k]) <= 1e-7,
                      f"phase 16 (c) step {a['step']} {k}: 2x1 {a[k]}, "
                      f"1x1 with 2 microbatches {b[k]}")
        check(len(two) == len(mb2) == int(
            MESH_ARGV[MESH_ARGV.index("--steps") + 1]),
            f"phase 16 (c): {len(two)} and {len(mb2)} steps logged")
        llama = get("llama3_8b")
        (_, p2), (_, p1) = (final_checkpoint(f"{tmp}/two", llama),
                            final_checkpoint(f"{tmp}/mb2", llama))
        gap = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(p2, p1))
        row.update(mesh_worst_metric_rtol=worst, mesh_params_max_diff=gap,
                   mesh_bit_equal=gap == 0.0 and worst == 0.0)
    print(f"  (b) launch.train under ft.Supervisor ({smi}): crashed at step "
          f"{FT_FAIL_AT}, restarted, resumed from step {row['resumed_from']}"
          f", finished in {row['supervised_s']} s; final checkpoint bit-equal"
          f" to the uninterrupted run's ({row['checkpoint_digest']})")
    print(f"  (c) --mesh 2x1, two gloo ranks on the card, against 1x1 with "
          f"2 microbatches: metrics but ppl_proxy (exp of the global ce) "
          f"worst rtol {worst:.3g}, params max |diff|"
          f" {gap:.3g} (bit-equal {row['mesh_bit_equal']}), "
          f"{row['mesh_2x1_s']} s")
    return row


def launch_serve_main(dev, smi):
    """Phase 16 (d): ``launch.serve.main`` on the card: the reference's
    request count and output lengths, tokens in the vocabulary."""
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    t = time.perf_counter()
    done = launch_serve.main(["--device", str(dev)])
    wall = time.perf_counter() - t
    vocab = configs.get_reduced("llama3_8b").vocab_size
    check(len(done) == 6 and all(len(r.out) == 8 + 16 for r in done)
          and all(0 <= int(r.out.min()) and int(r.out.max()) < vocab
                  for r in done),
          f"phase 16 (d): {[len(r.out) for r in done]}")
    print(f"  (d) launch.serve.main ({smi}): 6 requests x 16 new tokens, "
          f"wall {wall:.3f} s")
    return {"requests": len(done), "wall_s": round(wall, 3)}


def launch_dryrun_read(proc, path, hw, smi):
    """Phase 16 (e): the dry run's cells (started before phase 14): each
    reports, its bytes and terms printed, fits taken against ``hw``."""
    out, _ = proc.communicate(timeout=1200)
    check(proc.returncode == 0, f"phase 16 (e): the dry run failed "
          f"({proc.returncode}):\n{out[-3000:]}")
    with open(path) as f:
        cells = json.load(f)
    check(list(cells) == [f"{a} {s}" for a, s in DRYRUN_CELLS],
          f"phase 16 (e): cells {list(cells)}")
    rows = {}
    for name, r in cells.items():
        peak = (r["temp_bytes"] + r["arg_bytes"] + r["out_bytes"]
                - r["alias_bytes"])
        check(r["status"] == "ok" and r["hlo_dot_flops"] > 0
              and r["arg_bytes"] > 0 and r["hardware"] == hw.name
              and r["fits_hbm"] == (peak <= hw.memory_bytes),
              f"phase 16 (e) {name}: {r}")
        rows[name] = {k: r[k] for k in (
            "arg_bytes", "out_bytes", "temp_bytes", "alias_bytes",
            "peak_memory_bytes", "fits_hbm", "hlo_dot_flops", "ici_bytes",
            "dcn_bytes", "collective_counts", "compute_s", "memory_s",
            "collective_s", "bottleneck", "lower_s", "compile_s")}
        print(f"  (e) dry run {name} on the single-pod mesh: per device "
              f"args {r['arg_bytes'] / 1e9:.3f} GB, out "
              f"{r['out_bytes'] / 1e9:.3f} GB, temp "
              f"{r['temp_bytes'] / 1e9:.3f} GB ({r['temp_bytes']:.0f} B, "
              f"rank 0 of the sharded step), aliased "
              f"{r['alias_bytes'] / 1e9:.3f} GB, fits {r['fits_hbm']} "
              f"({hw.name}, {smi}); collectives by kind "
              f"{json.dumps(r['collective_counts'], sort_keys=True)}, link "
              f"{r['ici_bytes'] / 1e6:.1f} MB; compute {r['compute_s']:.4g} "
              f"s, memory {r['memory_s']:.4g} s, collective "
              f"{r['collective_s']:.4g} s -> {r['bottleneck']}; "
              f"{r['lower_s'] + r['compile_s']:.1f} s on the host")
    train = cells.get("llama3_8b train_4k")
    check(train is None or train["fits_hbm"],
          f"phase 16 (e): llama3-8b train_4k does not fit {hw.name}: "
          f"{train and train['peak_memory_bytes']}")
    return rows


# (f) (a)'s trainer on a 1x2 mesh: two gloo ranks sharing the card, tensor
# and sequence parallel over "model", on (a)'s selected batches; each
# step's loss within F_LOSS_RTOL of (a)'s (both steps run the initial
# params: the schedule's learning rate is 0 at step 0). In bf16 the
# row-parallel sums round once from f32 where one process's GEMM rounds
# them in its own order; the few flipped values spread through the next
# layer's attention, and over 24 batches at these widths the two losses
# lay 7.6e-8 to 1.8e-5 apart (scripts/torch_tp_loss_spread.py)
F_MESH = (1, 2)
F_LOSS_RTOL = 5e-5
# (g) (c)'s run on a 2x2 mesh, twice, each writing its final checkpoint.
# Steps 0 and 1 run the initial params (lr 0 at step 0): their losses are
# held to (c)'s microbatched run's within LOSS_RTOL. Steps 2 and 3 follow
# two updates from gradients whose model-axis partial sums were rounded
# to bf16 per rank (the activations' dtype) where one process rounds the
# whole sum once -- gradient norms 3e-4 apart on the CPU -- and are held
# within G_LOSS_RTOL
G_MESH = (2, 2)
G_LOSS_RTOL = 1e-4
# (h) the MoE, SSD and RG-LRU families on a 1x2 mesh, each at its
# published widths cut in depth (architecture, layers, loss tolerance):
# granite-moe's 40 experts 20 a rank, mamba2's 32 SSD heads 16 a rank,
# recurrentgemma's lru_width of 2,560 1,280 a rank (one period: rglru,
# rglru, local). Rank 0 first runs launch.train's own 1x1 path on the same
# argv in its own process (so the same bigram batches), then both ranks
# run the mesh. Both steps run the initial params (lr 0 at step 0), so
# the losses differ by bf16 TP's spread alone: over 16 batches of 2 x
# 1,024 tokens at these depths the 1x2 forward loss lay up to 6.75e-5
# (granite-moe: top-8 flips at near ties), 2.61e-5 (mamba2) and 1.64e-5
# (recurrentgemma) from one process's (scripts/torch_tp_loss_spread.py,
# NVIDIA H100 80GB HBM3, 700.00 W); each is held to about 3x its largest
H_MESH = (1, 2)
H_RUNS = (("granite_moe_3b_a800m", 2, 2e-4), ("mamba2_370m", 4, 1e-4),
          ("recurrentgemma_2b", 3, 5e-5))
H_ARGV = ["--batch", "2", "--seq", "1024", "--steps", "2", "--log-every",
          "1"]
# a rank holds its shards under param_specs: half of every leaf cut over
# "model", the replicated ones (norms, the router, biases) whole
H_HELD_MAX = 0.51
# (i) prefill and decode on the (h) ranks, on the params each family's
# (h) run leaves: B = 2 rows of a 2,048-token prompt from the seed, 16
# greedy decode steps, a cache of 2,064 slots (1,032 a rank; the local
# layer's ring of 2,048 wraps in decode), with tensor and sequence
# parallel prefill and flash-decode over "model", held to the same run in
# one process (rank 0); granite-moe also with an int8 KV cache and with
# f32 activations. The decode steps of both runs take the 1x1 run's
# picks, so every step is compared on the same sequence. max |dlogit| /
# max |logit| is held to I_BOUND, about 3x the largest 1x2-against-1x1
# spread of scripts/torch_tp_decode_spread.py over 8 prompts (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md): in bf16 granite-moe's top-8 routing
# flips at near ties and moves a token's logits by up to 0.50 of their
# largest (int8 0.37), mamba2 lay up to 2.2e-2, recurrentgemma 1.2e-3;
# in f32 the routing holds and granite-moe lay up to 2.8e-6. A pick may
# differ only where the 1x1 run's top two lie within twice the bound
I_SERVE = (2, 2048, 16)          # batch, prompt, decode steps
I_SEED = 32
I_INT8 = ("granite_moe_3b_a800m",)
I_F32 = ("granite_moe_3b_a800m",)
I_BOUND = {"granite_moe_3b_a800m": 1.5, "granite_moe_3b_a800m int8": 1.1,
           "granite_moe_3b_a800m f32": 1e-5, "mamba2_370m": 7e-2,
           "recurrentgemma_2b": 4e-3}


def serve_run(params, cfg, prompt, new, grid=None, feed=None):
    """Prefill ``prompt`` (B, P) into a cache of P + ``new`` slots, then
    ``new`` greedy decode steps, with ``models.forward``: on ``grid``
    (bound under layout "tp"; ``params`` this rank's shards under the
    training layout) or in one process. With ``feed`` (B, new) decode
    step i takes ``feed[:, i]`` in place of the last pick, so two runs
    decode one sequence. Returns the full-vocab logits (B, new + 1, V) f32
    of the prompt's last position and of each step, their picks, the
    prefill's wall, the mean ms a decode step, the cache bytes this rank
    holds, and the bytes a decode step staged through host memory."""
    from repro_torch.models import (forward, init_cache, make_positions,
                                    sharding)
    dev = prompt.device
    B, P = prompt.shape

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def full(lg):                       # (B, V / M) -> (B, V)
        return lg if grid is None else sharding.unshard_leaf(
            lg, (None, "model"), grid)

    with torch.no_grad(), sharding.set_mesh(grid, "tp"):
        cache = init_cache(cfg, B, P + new, dev)
        sync()
        t = time.perf_counter()
        lg, cache, _ = forward(params, prompt, make_positions(prompt, cfg),
                               cfg, cache=cache)
        logits = [full(lg[:, -1])]
        sync()
        prefill_s = time.perf_counter() - t
        staged = grid.staged_bytes if grid is not None else 0
        t = time.perf_counter()
        for i in range(new):
            tok = logits[-1].argmax(-1) if feed is None else feed[:, i]
            tok = tok.to(prompt.dtype)[:, None]
            lg, cache, _ = forward(params, tok,
                                   make_positions(tok, cfg, offset=P + i),
                                   cfg, cache=cache)
            logits.append(full(lg[:, 0]))
        sync()
        step_ms = (time.perf_counter() - t) * 1e3 / new
        staged = (grid.staged_bytes - staged) // new if grid is not None \
            else 0
    logits = torch.stack(logits, 1).float()
    return {"logits": logits, "picks": logits.argmax(-1),
            "prefill_s": prefill_s, "step_ms": step_ms,
            "cache_bytes": sum(x.nbytes for c in cache for x in c.values()),
            "staged": staged}


def serve_compare(one, got):
    """``got`` (a grid's :func:`serve_run` fed ``one``'s picks) against
    ``one``: max |dlogit| / max |logit| at each position, whether the
    picks are equal, and at each position where they differ the 1x1 run's
    top-two gap over its max |logit|."""
    scale = one["logits"].abs().amax(dim=(0, 2))              # (new + 1,)
    err = ((got["logits"] - one["logits"]).abs().amax(dim=(0, 2))
           / scale).tolist()
    top = one["logits"].topk(2, dim=-1).values
    differ = got["picks"] != one["picks"]                     # (B, new + 1)
    gap = torch.where(differ, (top[..., 0] - top[..., 1]) / scale, 0.0
                      ).amax(dim=0).tolist()
    at = differ.any(dim=0).tolist()
    return {"err": err, "equal": not any(at),
            "ties": {i: gap[i] for i, d in enumerate(at) if d}}


def serve_family(grid, cfg, shards, serve=I_SERVE, int8=False, f32=False):
    """Phase 16 (i) for one family on this rank: the (h) run's final
    ``shards`` gathered, rank 0 runs :func:`serve_run` in one process,
    then every rank on the grid fed rank 0's picks (bf16 activations and
    KV cache; with ``int8`` an int8 KV cache too, with ``f32`` f32
    activations and cache too). Host values: per variant the
    comparison (rank 0), walls, cache and staged bytes, the layout's
    cache bytes a rank and the grid run's picks' digest."""
    from repro_torch.launch import specs as specs_mod
    from repro_torch.models import cache_spec, sharding
    from repro_torch.models.model import shard_specs
    B, P, new = serve
    dev = grid.device
    full = sharding.unshard(shards, shard_specs(cfg, grid, "tp"), grid)
    if grid.rank:
        full = None
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=torch.
                           Generator().manual_seed(I_SEED)).to(dev)
    out = {}
    variants = [("bf16", cfg)]
    if int8:
        variants.append(("int8", dataclasses.replace(
            cfg, kv_cache_dtype="int8")))
    if f32:
        variants.append(("f32", dataclasses.replace(cfg, dtype="float32")))
    for name, c in variants:
        one = serve_run(full, c, prompt, new) if grid.rank == 0 else None
        picks = one["picks"] if one else torch.zeros(
            (B, new + 1), dtype=torch.int64, device=dev)
        feed = grid.world.all_gather(picks)[0]
        got = serve_run(shards, c, prompt, new, grid, feed)
        whole = cache_spec(c, B, P + new)
        row = {"prefill_s": round(got["prefill_s"], 4),
               "step_ms": round(got["step_ms"], 3),
               "cache_bytes": got["cache_bytes"], "staged": got["staged"],
               "layout_bytes": specs_mod.tree_bytes(
                   whole, sharding.cache_specs(whole, grid), grid),
               "tokens": digest(got["picks"])}
        if one:
            row.update(serve_compare(one, got))
            row.update(one_prefill_s=round(one["prefill_s"], 4),
                       one_step_ms=round(one["step_ms"], 3),
                       one_cache_bytes=one["cache_bytes"])
        del one, got
        out[name] = row
    return out


def phase16_rank(mesh, spec):
    """One rank of phase 16 (f), (g) or (h) and (i) (``core.mesh.launch``'s
    target, a spawned process): ``launch.train``'s own rank entry
    (``_rank``) on ``spec["argv"]``, once per entry of ``spec["runs"]``
    (extra argv, the config built from both), its ``mesh_train_step``
    timed step by step (walls, staged bytes, the digests of the leaves of
    params and moments some rank beside it holds too, and a fingerprint
    of all of them after the last step), and with ``spec["batches"]`` in
    place of the selection's. With ``spec["one"]`` rank 0 first runs
    ``launch.train``'s 1x1 path (``_train`` without a mesh) on the same
    argv in this process: the same bigram batches. With ``spec["serve"]``
    each run goes on to (i) on its final params (:func:`serve_family`).
    Returns host values: per run the log, walls, staged bytes, digests,
    the param and AdamW state bytes this rank held and its peak memory
    (and the 1x1 run's log, walls and peak, and (i)'s numbers); this
    rank's peak memory over the runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import tree as tree_mod
    from repro_torch.launch import train as launch_train
    from repro_torch.models import sharding
    from repro_torch.models.model import shard_specs
    cuda = mesh.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(mesh.device)

    runs = []
    last = {}                  # the mesh run's newest params
    real = launch_train.mesh_train_step
    real_one = launch_train.make_train_step

    def timed_one(cfg, tc, grad_sync=None):
        step = real_one(cfg, tc, grad_sync)

        def run(*a):
            sync()
            t = time.perf_counter()
            out = step(*a)
            sync()
            runs[-1]["one_walls"].append(round(time.perf_counter() - t, 4))
            return out
        return run

    def timed(cfg, tc, mesh_, layout="tp"):
        step = real(cfg, tc, mesh_, layout)
        # a leaf (of params, m, v) whose shard some other rank holds too:
        # one not cut over every axis of more than one rank
        cut = [sharding.cut_axes(s) for s in sharding.spec_leaves(
            shard_specs(cfg, mesh_, layout))] * 3
        shared = [any(mesh_.shape[a] > 1 and a not in c
                      for a in mesh_.axis_names) for c in cut]

        def run(params, opt, batch, i):
            cur = runs[-1]
            last["params"] = params
            if not cur["held"]:
                cur["held"]["params"] = sum(x.nbytes for x in
                                            tree_mod.leaves(params))
                cur["held"]["state"] = sum(x.nbytes for x in
                                           tree_mod.leaves(opt))
            sync()
            staged, t = mesh.staged_bytes, time.perf_counter()
            out = step(params, opt, batch, i)
            last["params"] = out[0]
            sync()
            cur["walls"].append(round(time.perf_counter() - t, 4))
            cur["staged"].append(mesh.staged_bytes - staged)
            leaves = tree_mod.leaves((out[0], out[1]["m"], out[1]["v"]))
            cur["digests"].append([digest(x) if keep else None
                                   for x, keep in zip(leaves, shared)])
            cur["fingerprint"] = fingerprint(*leaves)
            return out
        return run

    launch_train.mesh_train_step = timed
    launch_train.make_train_step = timed_one
    if spec.get("batches"):
        batches = [{k: v.to(mesh.device) for k, v in b.items()}
                   for b in spec["batches"]]
        launch_train._coreset_pool = lambda *a, **kw: batches
    def peak():
        return torch.cuda.max_memory_allocated(mesh.device) if cuda else 0

    for extra in spec["runs"]:
        runs.append({"walls": [], "staged": [], "digests": [], "held": {},
                     "one_walls": []})
        args = launch_train.parse_args(spec["argv"] + extra)
        cfg = launch_train.build_cfg(args)
        if spec.get("one") and mesh.rank == 0:
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(mesh.device)
            runs[-1]["one_log"] = launch_train._train(args, cfg,
                                                      mesh.device)
            runs[-1]["one_peak"] = peak()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(mesh.device)
        runs[-1]["log"] = launch_train._rank(mesh, vars(args), cfg, None)
        runs[-1]["peak"] = peak()
        if spec.get("serve"):
            runs[-1]["serve"] = serve_family(
                mesh, cfg, last.pop("params"), spec["serve"],
                int8=extra[1] in I_INT8, f32=extra[1] in I_F32)
    return {"coords": mesh.coords, "runs": runs,
            "peak": max(r["peak"] for r in runs)}


def _shared_leaves_equal(label, ranks, run=0):
    """Every leaf digested (one some other rank holds too) is the same
    bits on every rank, after every step of run ``run``."""
    for step in range(len(ranks[0]["runs"][run]["digests"])):
        got = [r["runs"][run]["digests"][step] for r in ranks]
        for j, ds in enumerate(zip(*got)):
            check(ds[0] is None or len(set(ds)) == 1,
                  f"{label}: leaf {j} differs across ranks after step "
                  f"{step}: {ds}")


def launch_train_mesh(dev, smi, batches, a_row, mb2, digests, get=None):
    """Phase 16 (f) and (g): ``launch.train``'s ranks on (data, model)
    meshes sharing the card (``phase16_rank``). (f) llama3-8b's widths,
    2 layers, on (a)'s selected batches at F_MESH against (a)'s losses;
    (g) (c)'s reduced run at G_MESH twice against (c)'s microbatched run,
    its final checkpoints digested. (g) runs beside (f), its ranks
    launched from a thread of their own: its walls are taken beside
    (f)'s. Returns the numbers it prints."""
    import tempfile
    import threading
    from repro_torch import configs
    from repro_torch import tree as tree_mod
    from repro_torch.core.mesh import launch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import param_spec
    get = get or configs.get_reduced
    row, got = {}, {}

    def run_g(tmp):
        try:
            t = time.perf_counter()
            got["g"] = launch(
                "chip_smoke:phase16_rank", G_MESH[0] * G_MESH[1],
                ({"argv": MESH_ARGV + ["--device", str(dev), "--mesh",
                                       "x".join(map(str, G_MESH))],
                  "runs": [["--ckpt-dir", f"{tmp}/g{i}"]
                           for i in range(2)]},),
                axis_name=("data", "model"), shape=G_MESH, device=dev,
                timeout=600)
            got["g_wall"] = time.perf_counter() - t
        except Exception as e:     # raised below, in this thread
            got["g"] = e

    argv = LAUNCH_TRAIN_ARGV + ["--device", str(dev), "--mesh",
                                "x".join(map(str, F_MESH))]
    # the ranks draw their bigram batches under (c)'s hash seed
    with tempfile.TemporaryDirectory(prefix="phase16g-") as tmp, \
            launch_train._hash_seed():
        thread = threading.Thread(target=run_g, args=(tmp,))
        thread.start()
        try:
            t = time.perf_counter()
            ranks = launch("chip_smoke:phase16_rank",
                           F_MESH[0] * F_MESH[1],
                           ({"argv": argv, "runs": [[]],
                             "batches": batches},),
                           axis_name=("data", "model"), shape=F_MESH,
                           device=dev, timeout=600)
            wall = time.perf_counter() - t
        finally:
            thread.join()
        if isinstance(got["g"], Exception):
            raise got["g"]
        llama = get("llama3_8b")
        finals = [final_checkpoint(f"{tmp}/g{i}", llama) for i in range(2)]
    log = ranks[0]["runs"][0]["log"]
    losses = [m["loss"] for m in log]
    errs = [abs(x - y) / abs(y) for x, y in zip(losses, a_row["losses"])]
    check(len(losses) == len(a_row["losses"]) and all(
        e <= F_LOSS_RTOL for e in errs),
        f"phase 16 (f): losses {losses} against (a)'s {a_row['losses']}")
    _shared_leaves_equal("phase 16 (f)", ranks)
    full = param_spec(launch_train.build_cfg(
        launch_train.parse_args(LAUNCH_TRAIN_ARGV)))
    whole = sum(x.numel() * x.element_size() for x in tree_mod.leaves(full))
    row["f"] = {"mesh": "x".join(map(str, F_MESH)), "losses": losses,
                "loss_rtol": errs, "step_s": ranks[0]["runs"][0]["walls"],
                "peak_gib": [round(r["peak"] / 2**30, 3) for r in ranks],
                "param_gb": [round(r["runs"][0]["held"]["params"] / 1e9, 3)
                             for r in ranks],
                "state_gb": [round(r["runs"][0]["held"]["state"] / 1e9, 3)
                             for r in ranks],
                "a_param_gb": round(whole / 1e9, 3),
                "a_state_gb": round(2 * whole / 1e9, 3),
                "a_peak_gib": a_row["peak_gib"],
                "staged_mb_per_step": [
                    [round(b / 1e6, 1) for b in r["runs"][0]["staged"]]
                    for r in ranks],
                "wall_s": round(wall, 3)}
    f = row["f"]
    print(f"  (f) launch.train --mesh {f['mesh']} at llama3-8b's widths, 2 "
          f"layers, two gloo ranks on the card ({smi}), on (a)'s selected "
          f"batches: losses {[round(x, 6) for x in losses]} (rtol "
          f"{max(errs):.3g} against (a)'s), steps {f['step_s']} s, peak "
          f"{f['peak_gib']} GiB a rank (a: {a_row['peak_gib']} GiB), params "
          f"{f['param_gb']} GB and AdamW state {f['state_gb']} GB a rank "
          f"(a: {f['a_param_gb']} and {f['a_state_gb']}), staged "
          f"{f['staged_mb_per_step']} MB a step, wall {f['wall_s']} s")
    ranks = got["g"]
    logs = [ranks[0]["runs"][i]["log"] for i in range(2)]
    check(logs[0] == logs[1], f"phase 16 (g): two runs' metrics differ: "
          f"{logs}")
    rules = train_rules()
    errs = []
    for m, want in zip(logs[0], mb2):
        err = abs(m["loss"] - want["loss"]) / abs(want["loss"])
        errs.append(err)
        tol = rules.LOSS_RTOL if m["step"] < 2 else G_LOSS_RTOL
        check(m["step"] == want["step"] and err <= tol,
              f"phase 16 (g) step {m['step']}: loss {m['loss']} against "
              f"(c)'s microbatched {want['loss']} (tolerance {tol})")
    check(len(logs[0]) == len(mb2) == 4, f"phase 16 (g): {len(logs[0])} "
          f"steps logged")
    for i in range(2):
        _shared_leaves_equal(f"phase 16 (g) run {i}", ranks, i)
    (s0, p0), (s1, p1) = finals
    d0, d1 = digest(*p0), digest(*p1)
    check(s0 == s1 == 4 and d0 == d1,
          f"phase 16 (g): final checkpoints {s0} {d0} and {s1} {d1}")
    digests["launch.train 2x2 final state"] = d0
    row["g"] = {"mesh": "x".join(map(str, G_MESH)),
                "losses": [m["loss"] for m in logs[0]], "loss_rtol": errs,
                "step_s": ranks[0]["runs"][1]["walls"],
                "staged_mb_per_step": [round(b / 1e6, 3) for b in
                                       ranks[0]["runs"][1]["staged"]],
                "final_digest": d0, "wall_s": round(got["g_wall"], 3)}
    g = row["g"]
    print(f"  (g) launch.train --mesh {g['mesh']} on (c)'s reduced run, four "
          f"gloo ranks on the card ({smi}), twice, beside (f): losses "
          f"{[round(x, 6) for x in g['losses']]} (rtol "
          f"{[float(f'{e:.3g}') for e in errs]} against (c)'s microbatched "
          f"run), the two runs' metrics and final states equal "
          f"({d0}), steps {g['step_s']} s, staged "
          f"{g['staged_mb_per_step']} MB a step, wall {g['wall_s']} s")
    return row


def serve_check(arch, ranks, smi, digests, bounds, serve=I_SERVE):
    """Phase 16 (i) of one family, read from the ranks' ``serve``
    results: per variant the cache bytes a rank its layout shards' and
    under one process's, every position's logits within the variant's
    bound (``bounds``, by tag) of the 1x1 run's, picks equal but at near
    ties (a top-two gap within twice the bound), every rank's picks the
    same; the grid's picks go to ``digests``. Returns the numbers it
    prints."""
    out = {}
    for name, r0 in ranks[0].items():
        tag = arch if name == "bf16" else f"{arch} {name}"
        label = f"phase 16 (i) {tag}"
        bound = bounds[tag]
        rs = [r[name] for r in ranks]
        check(all(r["cache_bytes"] == r["layout_bytes"] for r in rs)
              and r0["cache_bytes"] < r0["one_cache_bytes"],
              f"{label}: cache bytes {[r['cache_bytes'] for r in rs]} a "
              f"rank against the layout's {r0['layout_bytes']} and 1x1's "
              f"{r0['one_cache_bytes']}")
        check(all(math.isfinite(e) and e <= bound for e in r0["err"]),
              f"{label}: max |dlogit| / max |logit| {r0['err']} (bound "
              f"{bound})")
        check(all(g <= 2 * bound for g in r0["ties"].values()),
              f"{label}: picks differ from the 1x1 run's at positions "
              f"{r0['ties']} (top-two gap over max |logit|), beyond near "
              f"ties of {2 * bound}")
        check(len({r["tokens"] for r in rs}) == 1,
              f"{label}: the ranks' picks differ")
        digests[f"serve 1x2 {tag} tokens"] = r0["tokens"]
        out[name] = {k: r0[k] for k in (
            "prefill_s", "one_prefill_s", "step_ms", "one_step_ms",
            "cache_bytes", "one_cache_bytes", "layout_bytes", "staged",
            "err", "equal", "ties", "tokens")}
        out[name]["rank_step_ms"] = [r["step_ms"] for r in rs]
        first = min(r0["ties"]) if r0["ties"] else None
        print(f"  (i) {tag}: prefill of {serve[0]} x {serve[1]} tokens "
              f"and {serve[2]} decode steps on 1x2 ({smi}): prefill "
              f"{r0['prefill_s']} s (1x1 {r0['one_prefill_s']} s), "
              f"{out[name]['rank_step_ms']} ms a decode step a rank (1x1 "
              f"{r0['one_step_ms']}), cache {r0['cache_bytes'] / 1e6:.3f} "
              f"MB a rank (1x1 {r0['one_cache_bytes'] / 1e6:.3f}; the "
              f"layout's shard {r0['layout_bytes'] / 1e6:.3f}), staged "
              f"{r0['staged'] / 1e6:.3f} MB a decode step a rank; max "
              f"|dlogit| / max |logit| prefill {r0['err'][0]:.3g}, decode "
              f"steps {[float(f'{e:.3g}') for e in r0['err'][1:]]} (bound "
              f"{bound}); picks "
              + ("equal" if r0["equal"] else
                 f"first differ at position {first} (top-two gap "
                 f"{r0['ties'][first]:.3g})")
              + f"; tokens {r0['tokens']}")
    return out


def launch_train_mixers(dev, smi, digests, runs=H_RUNS, argv=H_ARGV,
                        beside=None, serve=I_SERVE, bounds=None):
    """Phase 16 (h): ``launch.train``'s ranks on an H_MESH mesh sharing
    the card (``phase16_rank``) for each (architecture, layers) of
    ``runs`` at its published widths on ``argv``, rank 0 running the
    family's 1x1 path first: each step's loss within the run's tolerance
    of the 1x1's, every rank's log the same, leaves some rank beside it holds
    bit-equal, the param and AdamW bytes a rank its shards' and at most
    H_HELD_MAX of 1x1's; a fingerprint of each family's final state
    (every rank's leaves, in rank order) goes to ``digests``. Then (i)
    on the same ranks and params, with ``serve`` (batch, prompt, decode
    steps; :func:`serve_family`, :func:`serve_check`, ``bounds`` by tag
    in place of I_BOUND). The ranks are launched from a thread of their own
    while ``beside()`` (if given) runs here, and are read after it.
    Returns (the numbers it prints, what ``beside`` returned)."""
    import threading
    from repro_torch import tree as tree_mod
    from repro_torch.core.mesh import launch
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import param_spec, sharding
    from repro_torch.models.model import shard_specs
    mesh_arg = "x".join(map(str, H_MESH))
    grid = make_mesh(H_MESH, ("data", "model"))
    spec = {"argv": argv + ["--device", str(dev), "--mesh", mesh_arg],
            "runs": [["--arch", a, "--layers", str(n)] for a, n, _ in runs],
            "one": True, "serve": serve}
    got = {}

    def run():
        try:
            t = time.perf_counter()
            got["ranks"] = launch(
                "chip_smoke:phase16_rank", H_MESH[0] * H_MESH[1], (spec,),
                axis_name=("data", "model"), shape=H_MESH, device=dev,
                timeout=600)
            got["wall"] = time.perf_counter() - t
        except Exception as e:     # raised below, in this thread
            got["ranks"] = e

    # the ranks draw their bigram batches under one hash seed
    with launch_train._hash_seed():
        thread = threading.Thread(target=run)
        thread.start()
        try:
            other = beside() if beside is not None else None
        finally:
            thread.join()
    if isinstance(got["ranks"], Exception):
        raise got["ranks"]
    ranks, wall = got["ranks"], got["wall"]
    rows = []
    for i, (extra, (_, _, rtol)) in enumerate(zip(spec["runs"], runs)):
        label = f"phase 16 (h) {extra[1]}"
        args = launch_train.parse_args(spec["argv"] + extra)
        cfg = launch_train.build_cfg(args)
        mine = [r["runs"][i] for r in ranks]
        log, one = mine[0]["log"], mine[0]["one_log"]
        check(all(m["log"] == log for m in mine),
              f"{label}: the ranks' logs differ")
        losses, want = [m["loss"] for m in log], [m["loss"] for m in one]
        errs = [abs(x - y) / abs(y) for x, y in zip(losses, want)]
        check(len(losses) == len(want) == args.steps and all(
            e <= rtol for e in errs),
            f"{label}: losses {losses} against the 1x1 run's {want} "
            f"(tolerance {rtol})")
        check(all(math.isfinite(m[k]) for m in log for k in m),
              f"{label}: metrics {log}")
        _shared_leaves_equal(label, ranks, i)
        full = tree_mod.leaves(param_spec(cfg))
        specs = sharding.spec_leaves(shard_specs(cfg, grid, "tp"))
        whole = sum(x.numel() * x.element_size() for x in full)
        cut = [x.numel() * x.element_size() // math.prod(
            grid.shape[a] for a in sharding.cut_axes(s_))
            for x, s_ in zip(full, specs)]
        share = [m["held"]["params"] / whole for m in mine]
        # the state: two moments of the params' shapes and a step counter
        check(all(m["held"]["params"] == sum(cut)
                  and 0 <= m["held"]["state"] - 2 * sum(cut) <= 8
                  for m in mine) and max(share) <= H_HELD_MAX,
              f"{label}: params {[m['held'] for m in mine]} a rank against "
              f"{sum(cut)} (its shards) and {whole} (1x1)")
        fp = hashlib.sha256("".join(
            m["fingerprint"] for m in mine).encode()).hexdigest()[:16]
        digests[f"launch.train {mesh_arg} {extra[1]} final state"] = fp
        rows.append({"arch": extra[1], "layers": int(extra[3]),
                     "losses": losses, "one_losses": want,
                     "loss_rtol": errs, "tolerance": rtol, "step_s": mine[0]["walls"],
                     "one_step_s": mine[0]["one_walls"],
                     "peak_gib": [round(m["peak"] / 2**30, 3)
                                  for m in mine],
                     "one_peak_gib": round(mine[0]["one_peak"] / 2**30, 3),
                     "param_share": [round(x, 4) for x in share],
                     "param_gb": round(sum(cut) / 1e9, 3),
                     "one_param_gb": round(whole / 1e9, 3),
                     "staged_mb_per_step": [
                         [round(b / 1e6, 1) for b in m["staged"]]
                         for m in mine],
                     "final_state": fp})
        r = rows[-1]
        print(f"  (h) launch.train --mesh {mesh_arg} {extra[1]}, "
              f"{extra[3]} layers at its published widths, two gloo ranks "
              f"on the card ({smi}): losses {[round(x, 6) for x in losses]}"
              f" (rtol {[float(f'{e:.3g}') for e in errs]} against 1x1's), "
              f"steps {r['step_s']} s (1x1 {r['one_step_s']} s), peak "
              f"{r['peak_gib']} GiB a rank (1x1 {r['one_peak_gib']}), "
              f"params {r['param_gb']} GB a rank (1x1 {r['one_param_gb']}, "
              f"share {r['param_share']}), staged "
              f"{r['staged_mb_per_step']} MB a step a rank, final state "
              f"{fp}")
        r["serve"] = serve_check(extra[1], [m["serve"] for m in mine], smi,
                                 digests,
                                 I_BOUND if bounds is None else bounds,
                                 serve)
    print(f"  (h) and (i) wall {wall:.3f} s"
          + (" (beside (b) and (c))" if beside is not None else ""))
    return {"runs": rows, "wall_s": round(wall, 3)}, other


def phase16(seed, dev, smi, counts, checks, dry, hw, digests, get=None):
    """The launchers (``repro_torch.launch``): (a) the trainer at
    llama3-8b's widths with its coreset selection, (b) the supervised
    crash and resume, (c) two ranks, (d) the serving launcher, (e) the dry
    run (``dry``: :func:`dryrun_start`'s process and file), (f) and (g)
    the trainer on (data, model) meshes (:func:`launch_train_mesh`; adds
    a digest), (h) the MoE, SSD and RG-LRU families on a 1x2 mesh and
    (i) their prefill and decode there (:func:`launch_train_mixers`; adds
    two digests a family, and granite-moe's int8 and f32 runs' two).
    ``get`` replaces ``configs.get_reduced`` where (b), (c) and (g)
    restore their checkpoints. Returns each kernel's launches in (a)."""
    t_phase = time.perf_counter()
    print(f"phase 16: the launchers ({smi})")
    total, keep = {}, {}
    out = {"card": smi,
           "train": launch_train_full(dev, smi, counts, total, checks, keep)}
    # (h)'s ranks beside (b) and (c), whose processes leave the card idle
    # most of the time
    out["mixers"], out["ft_mesh"] = launch_train_mixers(
        dev, smi, digests,
        beside=lambda: launch_ft_and_mesh(dev, smi, keep, get))
    out["serve"] = launch_serve_main(dev, smi)
    out["dryrun"] = launch_dryrun_read(*dry, hw, smi)
    out["mesh"] = launch_train_mesh(dev, smi, keep["batches"], out["train"],
                                    keep["mb2"], digests, get)
    out["wall_s"] = round(time.perf_counter() - t_phase, 2)
    print(f"phase 16: {json.dumps(out)}")
    return total


def weiszfeld_scale(p, c, w, am):
    """The sums of |terms| of the Weiszfeld reduction given an assignment:
    nums, denoms (themselves sums of terms >= 0) and cost."""
    from repro_torch.kernels import ref
    idx = am.long()[..., None].expand(*am.shape, p.shape[-1])
    diff = p - torch.gather(c, -2, idx)
    d2 = (diff * diff).sum(-1)
    inv = w.clamp_min(0.0) / torch.sqrt(d2 + ref.WEISZFELD_ETA2)
    oh = torch.nn.functional.one_hot(am.long(), c.shape[-2]).float()
    na = (oh * inv[..., None]).transpose(-1, -2) @ p.abs()
    return na, (oh * inv[..., None]).sum(-2), (
        w.abs() * torch.sqrt(d2)).sum(-1)


def time_reduce(dev, name, p, c, w, hw):
    """One reduction kernel of the two-pass form (``name``: lloyd_reduce or
    weiszfeld_reduce) at ``p``'s shape, given distance_argmin's assignment:
    its largest deviation from the plain reduction (sums and counts),
    which must lie within SUM_RTOL of the sums of |terms|, and the kernel,
    the plain version (a one-hot product) and the library's index_add_
    timed beside the bound on ``hw``. Returns the kernels-line fields."""
    from repro_torch.kernels import ops, ref
    from repro_torch.roofline import work
    S, M, d = p.shape
    kk = c.shape[-2]
    md, am = ops.min_dist_argmin(p, c)
    flat = (am.long() + torch.arange(S, device=dev)[:, None] * kk).view(-1)
    if name == "lloyd_reduce":
        args = (p, kk, w, md, am)

        def library():
            """The same statistics by PyTorch's own calls: two index_add_
            and a sum."""
            torch.zeros(S * kk, d, device=dev).index_add_(
                0, flat, (w[..., None] * p).view(-1, d))
            torch.zeros(S * kk, device=dev).index_add_(0, flat, w.view(-1))
            return (w * md).sum(-1)
    else:
        args = (p, c, w, am)

        def library():
            """The same statistics by PyTorch's own calls: the assigned
            centre's exact distance, two index_add_ and a sum."""
            diff = p - torch.gather(c, -2, am.long()[..., None].expand(
                *am.shape, d))
            d2 = (diff * diff).sum(-1)
            inv = w.clamp_min(0.0) / torch.sqrt(d2 + ref.WEISZFELD_ETA2)
            torch.zeros(S * kk, d, device=dev).index_add_(
                0, flat, (inv[..., None] * p).view(-1, d))
            torch.zeros(S * kk, device=dev).index_add_(0, flat,
                                                       inv.view(-1))
            return (w * torch.sqrt(d2)).sum(-1)
    kernel, plain_fn = getattr(ops, name), getattr(ref, name)
    out = kernel(*args)
    plain = plain_fn(*args)
    scale = (ref.lloyd_reduce(p.abs(), kk, w.abs(), md, am)
             if name == "lloyd_reduce" else weiszfeld_scale(p, c, w, am))
    torch.cuda.synchronize()
    errs = [(a - b).abs() for a, b in zip(out[:2], plain[:2])]
    for e, sa, what in zip(errs, scale[:2], ("sums", "counts")):
        check((e <= SUM_RTOL * sa + 1e-6).all(),
              f"{name} {tuple(p.shape)} k={kk}: {what} error "
              f"{float(e.max())} against the plain reduction")
    err = max(float(e.max()) for e in errs)
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain_fn(*args), reps=5)
    library_ms = cuda_ms(library)
    b_ms, b_by = work.bound(*getattr(work, name)(S, M, kk, d), hw)
    print(f"    {name} {tuple(p.shape)} k={kk} (ms, mean of 20): kernel "
          f"{ms:.4f}, plain (one-hot product) {plain_ms:.4f}, library "
          f"(index_add_) {library_ms:.4f}, bound {b_ms:.4f} ({b_by}); "
          f"kernel at {b_ms / ms:.3f} of the bound; max |err| against the "
          f"plain reduction {err:.3g}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spread", type=int, default=0, metavar="N",
                    help="after phase 7, repeat Figure 2 and the trimmed "
                    "route on N more keys and with the plain backend")
    ap.add_argument("--argmin-digests", action="store_true",
                    help="print only the digests of distance_argmin and "
                    "the two-pass sums and exit; "
                    "a copy of this file in the root of another checkout "
                    "digests that checkout's kernels")
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
    from repro_torch.data import select_coreset
    from repro_torch.data.synthetic import paper_dataset
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import lloyd_update as lu
    from repro_torch.kernels import weiszfeld as wz
    from repro_torch.roofline import report as rf_report
    from repro_torch.roofline import trace as rf_trace
    from repro_torch.roofline import work as rwork
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
    # the card's data-sheet figures (refuses a card it has none for)
    hw = rf_report.detect(0)

    def bound(flops, nbytes):
        """Least time (ms) the card could take, and which limit sets it."""
        return rwork.bound(flops, nbytes, hw)

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
    # six kernel entries with their own counters over four libraries
    check(set(built) == {k.library for k in ops.KERNELS}
          and len({k.name for k in ops.KERNELS}) == 6,
          f"built {sorted(built)}, kernels "
          f"{[(k.name, k.library) for k in ops.KERNELS]}")

    def reset_counts():
        for kern in (*ops.KERNELS, *da.ROUTES):
            kern.launches = 0

    def route_counts():
        """Launches of both distance_argmin entries by the kernel that
        served them (one-centre, resident, general or streamed tile)."""
        return {kern.name: kern.launches for kern in da.ROUTES}

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
    argmin_cases = argmin_inputs(pts, sp, k, args.seed + 2,
                                 ref.CENTER_SENTINEL)
    if args.argmin_digests:
        print(f"argmin digests: "
              f"{json.dumps(argmin_digests(argmin_cases, ops))}")
        two = two_pass_inputs(dev, args.seed, sp, sm)
        print(f"two-pass digests: {json.dumps(two_pass_digests(two, ops))}")
        return 0
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

    def check_launches(label, kern, fits, before, c):
        """The resident kernel launched twice (a call and its rerun) where
        its block fits shared memory, and not at all where ops takes the
        two-pass form; returns which."""
        fused = fits(c.shape[-2], c.shape[-1])
        check(kern.launches == before + 2 * fused,
              f"{kern.name}[{label}] launched {kern.launches - before} "
              f"times, expected {2 * fused}")
        return "one pass" if fused else "two-pass form"

    def without_plain(fn):
        """``fn()`` with the plain Weiszfeld versions refusing to run: what
        it computes on the card, it computes by kernels."""
        saved = ref.weiszfeld_reduce, ref.weiszfeld_stats_ref

        def refuse(*args, **kw):
            raise CheckFailed("a plain Weiszfeld version ran on the card")

        ref.weiszfeld_reduce = ref.weiszfeld_stats_ref = refuse
        try:
            return fn()
        finally:
            ref.weiszfeld_reduce, ref.weiszfeld_stats_ref = saved

    def check_weiszfeld(label, p, c, w):
        """weiszfeld_stats against the plain reduction of the kernel's own
        assignment (arithmetic error, relative to the sums of |terms|) and
        against the plain version (value error, near-tie flips included);
        a rerun must be bit-identical, and no plain version may run. The
        two-pass form launches weiszfeld_reduce twice (a call and its
        rerun); where the fused kernel runs, weiszfeld_reduce on
        distance_argmin's assignment must equal it bit for bit."""
        before = wz.KERNEL.launches
        reduce_before = wz.REDUCE.launches
        out, again = without_plain(lambda: (ops.weiszfeld_stats(p, c, w),
                                            ops.weiszfeld_stats(p, c, w)))
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"weiszfeld_stats[{label}] differs between two runs")
        route = check_launches(label, wz.KERNEL, wz.fits, before, c)
        two_pass = route == "two-pass form"
        check(wz.REDUCE.launches == reduce_before + 2 * two_pass,
              f"weiszfeld_reduce[{label}] launched "
              f"{wz.REDUCE.launches - reduce_before} times, expected "
              f"{2 * two_pass}")
        # weiszfeld_stats assigns every point bit for bit as distance_argmin
        _, am, ar, _ = check_distance(f"{label}, assignment", p, c)
        if not two_pass:
            route += ", equal bit for bit to distance_argmin + " \
                "weiszfeld_reduce"
            check(all(torch.equal(a, b) for a, b in zip(
                out, ops.weiszfeld_reduce(p, c, w, am))),
                  f"weiszfeld_reduce[{label}] differs from the fused kernel")
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
        |terms|) and, where no argmin flips, the plain version's sums and
        counts to the same bound; a rerun must be bit-identical. The
        two-pass form launches lloyd_reduce twice (a call and its rerun);
        where the fused kernel runs, lloyd_reduce on distance_argmin's
        outputs must equal it bit for bit."""
        before = lu.KERNEL.launches
        reduce_before = lu.REDUCE.launches
        sums, counts, cost = ops.lloyd_stats(p, c, w)
        again = ops.lloyd_stats(p, c, w)
        check(all(torch.equal(a, b) for a, b in
                  zip((sums, counts, cost), again)),
              f"lloyd_stats[{label}] differs between two runs")
        route = check_launches(label, lu.KERNEL, lu.fits, before, c)
        two_pass = route == "two-pass form"
        check(lu.REDUCE.launches == reduce_before + 2 * two_pass,
              f"lloyd_reduce[{label}] launched "
              f"{lu.REDUCE.launches - reduce_before} times, expected "
              f"{2 * two_pass}")
        # the kernel's own assignment: lloyd_stats assigns every point, and
        # takes its min d2, bit for bit as distance_argmin
        md, am = ops.min_dist_argmin(p, c)
        _, ar = ref.min_dist_argmin_ref(p, c)
        kk = c.shape[-2]
        if not two_pass:
            route += ", equal bit for bit to distance_argmin + lloyd_reduce"
            check(all(torch.equal(a, b) for a, b in zip(
                (sums, counts, cost), ops.lloyd_reduce(p, kk, w, md, am))),
                  f"lloyd_reduce[{label}] differs from the fused kernel")
        sr, cr, costr = ref.lloyd_reduce(p, kk, w, md, am)
        sa, ca, costa = ref.lloyd_reduce(p.abs(), kk, w.abs(), md, am)
        sp_, cp_, _ = ref.lloyd_stats_ref(p, c, w)
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
        ps, pc = (sums - sp_).abs(), (counts - cp_).abs()
        if flips == 0:
            check((ps <= SUM_RTOL * sa + 1e-6).all()
                  and (pc <= SUM_RTOL * ca + 1e-6).all(),
                  f"lloyd_stats[{label}] against the plain version: sums "
                  f"{float(ps.max())}, counts {float(pc.max())}")
        print(f"  lloyd_stats[{label}] {tuple(p.shape)} k={kk}: max |sums "
              f"err| {float(es.max()):.3g}, max |counts err| "
              f"{float(ec.max()):.3g}, cost rel err "
              f"{float((eo / costa.clamp_min(1e-30)).max()):.2g} (from the "
              f"kernel's assignment); against the plain version max |sums "
              f"err| {float(ps.max()):.3g}, |counts err| "
              f"{float(pc.max()):.3g} with {flips} near-tie flips; "
              f"bit-identical rerun; {route}")
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

    digests = {}

    print("phase 2: kernels against their plain versions on the card")
    c_main = rows(pts, k)
    w_main = torch.rand(n, generator=gen).to(dev)

    def check_one_center(label, p, c1):
        """The one-centre kernel, as D^2 seeding calls it, against the plain
        version, and bit for bit against the resident and the general tile
        with the centre padded to CENTER_TILE rows at the sentinel."""
        md, am, _, err = check_distance(label, p, c1)
        p3, c3 = (p, c1) if p.ndim == 3 else (p[None], c1[None])
        pad = c3.new_full((c3.shape[0], da.CENTER_TILE - 1, c3.shape[2]),
                          ref.CENTER_SENTINEL)
        padded = torch.cat([c3, pad], 1)
        for entry in (da.distance_argmin_resident, da.distance_argmin_tile):
            mg, ag = entry(p3, padded)
            torch.cuda.synchronize()
            check(torch.equal(md, mg.view_as(md)) and torch.equal(
                am, ag.view_as(am)), f"one-centre kernel [{label}] differs "
                f"from {entry.__name__}")
        print(f"  distance_argmin[{label}]: one-centre kernel equal bit for "
              f"bit to the resident and the general tile (centre padded to "
              f"{da.CENTER_TILE} sentinel rows)")
        return err

    def time_one_center(label, p, c1):
        """Print kernel, plain version and library yardstick (ms), bound and
        the kernel's fraction of it, for one seeding step at p's shape."""
        S1, M1 = (p.shape[0], p.shape[1]) if p.ndim == 3 else (1, p.shape[0])
        t = (cuda_ms(lambda: ops.min_dist_argmin(p, c1)),
             cuda_ms(lambda: ref.min_dist_argmin_ref(p, c1)),
             cuda_ms(lambda: torch.cdist(p, c1).min(-1)),
             *bound(*rwork.min_dist_argmin(S1, M1, 1, p.shape[-1])))
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
    k_sum = int(k_live.sum())
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

    def device_ms(fn, reps=10):
        """The profiler's device time per launch of each kernel ``fn``
        launches, by kernel name (per launch the profiler recorded: it may
        drop a few of a run's events)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return {a.key: getattr(a, "device_time_total", 0.0) / 1e3 / a.count
                for a in prof.key_averages()
                if getattr(a, "device_time_total", 0.0) > 0}

    # distance_argmin's digests at argmin_inputs' shapes; at the paths'
    # shapes the resident tile against the general tile: the routed entry
    # reports the kernel the routing picks (the general tile's 8-point
    # shape for serving's 8-row bucket, else the resident tile), the three outputs are equal bit for bit, and the two kernels
    # are timed side by side
    digests.update(argmin_digests(argmin_cases, ops))
    for label, (batched, p, c) in argmin_cases.items():
        if label.startswith("d="):
            continue
        c = ops.pad_centers(c)
        S1, M1 = p.shape[:2]
        entry = da.distance_argmin_batched if batched else da.distance_argmin
        served = da.TILE if batched and M1 <= 8 else da.RESIDENT
        before = route_counts()
        md, am = entry(p, c)
        torch.cuda.synchronize()
        moved = {name: n_ - before[name] for name, n_ in
                 route_counts().items()}
        check(moved == {kern.name: int(kern is served)
                        for kern in da.ROUTES},
              f"distance_argmin[{label}]: launches by kernel {moved}, "
              f"expected one on {served.name}")
        mr, ar = da.distance_argmin_resident(p, c)
        mt, at = da.distance_argmin_tile(p, c)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in
                  ((md, mt), (am, at), (mr, mt), (ar, at))),
              f"distance_argmin[{label}]: the resident tile differs from "
              f"the general tile")
        if batched:
            live = int((c[..., 0] != ref.CENTER_SENTINEL).sum())
            work = rwork.min_dist_argmin_batched(S1, M1, live, d)
        else:
            work = rwork.min_dist_argmin(S1, M1, k, d)
        b_ms, b_by = bound(*work)
        res, tile = da.distance_argmin_resident, da.distance_argmin_tile
        tt = [cuda_ms(lambda: fn(p, c)) for fn in (res, tile, tile, res)]
        dev_res = sum(device_ms(lambda: res(p, c)).values())
        dev_tile = sum(device_ms(lambda: tile(p, c)).values())
        lib = cuda_ms(lambda: torch.cdist(p, c).min(-1))
        print(f"  distance_argmin[{label}] {tuple(p.shape)} k_pad="
              f"{c.shape[1]}: resident tile equal bit for bit to the general "
              f"tile (the entry launched {served.name}); resident "
              f"{tt[0]:.4f} / {tt[3]:.4f} ms (device {dev_res:.4f}), general "
              f"tile {tt[1]:.4f} / {tt[2]:.4f} ms (device {dev_tile:.4f}); "
              f"bound {b_ms:.4f} ({b_by}), library (cdist + min) {lib:.4f}; "
              f"resident at {2 * b_ms / (tt[0] + tt[3]):.3f} of the bound")

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
    da_bound, da_by = bound(*rwork.min_dist_argmin(1, n, k, d))
    ls_bound, ls_by = bound(*rwork.lloyd_stats(1, n, k, d))
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
    wz_bound, wz_by = bound(*rwork.weiszfeld_stats(1, n, k, d))
    print(f"  weiszfeld_stats: kernel {wz_ms:.4f}, plain {wz_plain:.4f}, "
          f"library (cdist + argmin + gather + index_add_) {wz_lib:.4f}, "
          f"bound {wz_bound:.4f} ({wz_by})")
    db = {}
    for m, q in q_srv.items():
        b_ms, b_by = bound(*rwork.min_dist_argmin_batched(T_srv, m, k_sum, d))
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
             rwork.min_dist_argmin(S, M, k, d)),
            ("lloyd_stats", lambda: ops.lloyd_stats(sp, c_sites, w_sites),
             lambda: ref.lloyd_stats_ref(sp, c_sites, w_sites),
             ("cdist + argmin + index_add_",
              lambda: lloyd_library(sp, c_sites, w_sites)),
             rwork.lloyd_stats(S, M, k, d)),
            ("weiszfeld_stats", lambda: ops.weiszfeld_stats(
                sp, c_sites, w_sites),
             lambda: ref.weiszfeld_stats_ref(sp, c_sites, w_sites),
             ("cdist + argmin + gather + index_add_",
              lambda: weiszfeld_library(sp, c_sites, w_sites)),
             rwork.weiszfeld_stats(S, M, k, d))):
        b_ms, b_by = bound(*work)
        ms = cuda_ms(fn)
        print(f"  {label} sites ({S} x {M}): kernel {ms:.4f}, plain "
              f"{cuda_ms(plain, reps=5):.4f}, library (batched {lib[0]}) "
              f"{cuda_ms(lib[1]):.4f}, bound {b_ms:.4f} ({b_by}); kernel at "
              f"{b_ms / ms:.3f} of the bound")

    def check_stream(label, p, c, timed=False):
        """The streamed tile at a shape above the resident limit: the
        routed entry with ``live = k`` (as ops calls it) launches it
        (counted under it), its output, the streamed tile's own entry's
        over every row and the general tile's are equal bit for bit, and
        within D2_RTOL of the plain version (check_distance); ``timed``:
        the kernel (the routed entry on the padded centres, live = k),
        the general tile, the plain version and the library call timed
        beside the bound; returns the kernels-line fields."""
        c_pad = ops.pad_centers(c)
        S1, M1, d1 = p.shape
        check(da.route(M1, c_pad.shape[1], d1) is da.STREAM,
              f"stream [{label}]: route() is not the streamed tile")
        k1 = c.shape[-2]
        before = route_counts()
        md, am = da.distance_argmin(p, c_pad, live=k1)
        torch.cuda.synchronize()
        moved = {name: n_ - before[name] for name, n_ in
                 route_counts().items()}
        check(moved == {kern.name: int(kern is da.STREAM)
                        for kern in da.ROUTES},
              f"stream [{label}]: launches by kernel {moved}")
        ms_, as_ = da.distance_argmin_stream(p, c_pad)
        mt, at = da.distance_argmin_tile(p, c_pad)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in
                  ((md, mt), (am, at), (ms_, mt), (as_, at))),
              f"stream [{label}]: differs from the general tile")
        _, _, _, err = check_distance(f"stream, {label}", p, c)
        print(f"  distance_argmin[stream, {label}] {tuple(p.shape)} k_pad="
              f"{c_pad.shape[1]}: the routed entry launched "
              f"{da.STREAM.name}, equal bit for bit to the general tile")
        if not timed:
            return None
        t = (cuda_ms(lambda: da.distance_argmin(p, c_pad, live=k1)),
             cuda_ms(lambda: da.distance_argmin_tile(p, c_pad)),
             cuda_ms(lambda: ref.min_dist_argmin_ref(p, c), reps=5),
             cuda_ms(lambda: torch.cdist(p, c).min(-1)))
        dev_ms = device_ms(lambda: da.distance_argmin(p, c_pad, live=k1))
        b_ms, b_by = bound(*rwork.min_dist_argmin(S1, M1, k1, d1))
        print(f"    streamed tile {tuple(p.shape)} k={k1} (ms, mean of 20): "
              f"kernel {t[0]:.4f} (device {json.dumps(dev_ms)}), general "
              f"tile {t[1]:.4f}, plain {t[2]:.4f}, library (cdist + min) "
              f"{t[3]:.4f}, bound {b_ms:.4f} ({b_by}); kernel at "
              f"{b_ms / t[0]:.3f} of the bound")
        return {"max_abs_err": err, "ms": t[0], "plain_ms": t[2],
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": t[3],
                "tile_ms": t[1]}

    # the streamed tile and the two-pass form's sums at data selection's
    # shape (8 sites x 2,048 rows x 4,096 features, k = 8) and at the sites'
    # with k = 320, past the fused kernels' limit at d = 90: weiszfeld_reduce
    # held through weiszfeld_stats and timed, the streamed tile held to the
    # general tile and timed, at the streamed tile's other shapes held too;
    # every output digested. Drawn from a generator of their own, so the
    # later phases draw what they drew
    two = two_pass_inputs(dev, args.seed, sp, sm)
    p_sel, c_sel, w_sel = two["selection"]
    check(not wz.fits(8, 4096), "k = 8 at d = 4,096 fits weiszfeld_stats")
    check_weiszfeld("selection's shape", p_sel, c_sel, w_sel)
    wr_row = time_reduce(dev, "weiszfeld_reduce", p_sel, c_sel, w_sel, hw)
    stream_row = check_stream("selection", p_sel, c_sel, timed=True)
    for label, *_ in STREAM_SHAPES:
        check_stream(label, *two[label][:2])
    check(not wz.fits(320, d), "k = 320 at d = 90 fits weiszfeld_stats")
    c_pick = two["sites, k = 320"][1]
    check_weiszfeld("sites, k = 320", sp, c_pick, w_sites)
    time_reduce(dev, "weiszfeld_reduce", sp, c_pick, w_sites, hw)
    digests.update(two_pass_digests(two, ops))
    del two, p_sel, c_sel, w_sel, c_pick

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
        the device operations' spans, ``roofline.trace.busy_us``), idle
        share, the six kernels with the
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
        # the device's operations, not the phases' annotations
        spans = rf_trace.device_spans(prof.events(), ())
        if not spans:
            print(f"  traced {label} run: idle share not measured (the "
                  f"profiler saw no device events)")
            return
        busy = rf_trace.busy_us(spans) / 1e6
        print(f"  traced {label} run: wall {traced_wall:.3f} s, device busy "
              f"{busy:.3f} s over {len(spans)} device operations, idle "
              f"share {1 - busy / traced_wall:.3f} (tracing on)")
        notes = {e.name for e in prof.events()
                 if getattr(e, "is_user_annotation", False)}
        top = sorted((a for a in prof.key_averages() if a.key not in notes),
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
        by_kernel = route_counts()
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
        print(f"  {routing} launches: {json.dumps(launches[routing])}; "
              f"distance_argmin by kernel: {json.dumps(by_kernel)}")
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
        # all but the sensitivities' launch take the one-centre kernel, and
        # that one (k = 50 at d = 90) the resident tile
        check(by_kernel == {da.ONE_CENTER.name: 2 * k, da.RESIDENT.name: 1,
                            da.TILE.name: 0, da.STREAM.name: 0},
              f"{routing}: distance_argmin launches by kernel {by_kernel}")
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
    b_ms, b_by = bound(*rwork.lloyd_stats(1, cs.points.shape[0], k, d))
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
        md_by_kernel = route_counts()
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
        print(f"  {routing} launches: {json.dumps(md_launches[routing])}; "
              f"distance_argmin by kernel: {json.dumps(md_by_kernel)}")
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
                  "distance_argmin_batched": 0, "lloyd_reduce": 0,
                  "weiszfeld_reduce": 0}
        check(md_launches[routing] == expect,
              f"k-median {routing}: launches {md_launches[routing]}, "
              f"expected {expect}")
        check(md_by_kernel == {da.ONE_CENTER.name: 2 * k,
                               da.RESIDENT.name: 1, da.TILE.name: 0,
                               da.STREAM.name: 0},
              f"k-median {routing}: distance_argmin launches by kernel "
              f"{md_by_kernel}")
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
    b_ms, b_by = bound(*rwork.weiszfeld_stats(1, cs_md.points.shape[0], k, d))
    wz_args = (cs_md.points, md_results["flood"].centers, cs_md.weights)
    wz_cs = cuda_ms(lambda: ops.weiszfeld_stats(*wz_args))
    print(f"  weiszfeld_stats coreset ({cs_md.points.shape[0]} rows): kernel "
          f"{wz_cs:.4f} ms, plain "
          f"{cuda_ms(lambda: ref.weiszfeld_stats_ref(*wz_args)):.4f}, "
          f"library "
          f"{cuda_ms(lambda: weiszfeld_library(*wz_args)):.4f}, bound "
          f"{b_ms:.4f} ({b_by})")
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
    srv_by_kernel = route_counts()
    st = eng.stats
    check(all(tk.done for _, _, tk in tickets), "serving: a ticket is open")
    check(st.n_queries == sum(q.shape[0] for _, q, _ in tickets),
          "serving: rows served != rows enqueued")
    check(srv_launches == {"distance_argmin": 0, "lloyd_stats": 0,
                           "weiszfeld_stats": 0,
                           "distance_argmin_batched": st.n_dispatches,
                           "lloyd_reduce": 0, "weiszfeld_reduce": 0},
          f"serving: launches {srv_launches}, {st.n_dispatches} dispatches")
    # every dispatch pads its centres to 64 rows at d = 90: the general
    # tile's 8-point shape for the 8-row bucket, else the resident tile, by
    # the engine's own count of dispatches per shape
    check(sum(eng.dispatches_by_shape.values()) == st.n_dispatches,
          f"serving: dispatches by shape {eng.dispatches_by_shape}")
    narrow = sum(count for shape, count in eng.dispatches_by_shape.items()
                 if shape[1] <= 8)
    check(srv_by_kernel == {da.ONE_CENTER.name: 0,
                            da.RESIDENT.name: st.n_dispatches - narrow,
                            da.TILE.name: narrow, da.STREAM.name: 0},
          f"serving: distance_argmin launches by kernel {srv_by_kernel}")
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
          f" == dispatches ({srv_by_kernel[da.RESIDENT.name]} on the "
          f"resident tile, {srv_by_kernel[da.TILE.name]} on the general "
          f"tile)")
    lap("phase 6")

    # -- phase 7: the paper's comparisons and the remaining core paths -------
    wan = phase7(args.seed, dev, pts, sp, sm, g, k, t, base_cost,
                 results["flood"], (reset_counts, counts, route_counts),
                 digests, (data_s, sp_s, sm_s), args.spread)
    lap("phase 7")

    # -- phase 8: the topology execution engine -------------------------------
    sites25 = phase8(args.seed, dev, data, k, sp, sm, g, t, results["bfs"],
                     wan, (reset_counts, counts, route_counts), digests)
    lap("phase 8")

    # -- phases 9 and 10: the staged engine and the streaming subsystem ------
    checks = {"rows": rows, "distance": check_distance,
              "one_center": check_one_center, "lloyd": check_lloyd,
              "weiszfeld": check_weiszfeld, "compare": compare_argmin}
    new_paths = {"phase 9": phase9(
        args.seed, dev, pts, k, sites25, base_cost, base_md,
        (reset_counts, counts, route_counts), digests, checks)}
    lap("phase 9")
    new_paths["phase 10"], stream25 = phase10(
        args.seed, dev, data, data_s, pts, k, sites25, base_cost,
        (reset_counts, counts, route_counts), digests, checks)
    lap("phase 10")
    new_paths["phase 11"], w4_gather = phase11(
        args.seed, dev, pts, sp_np, sm_np, k, t, base_cost, base_md,
        [str(r.path) for r in built.values()], digests, checks)
    lap("phase 11")
    new_paths["phase 12"], reduce_row, selection = phase12(
        args.seed, dev, k, sites25, stream25,
        (reset_counts, counts, route_counts), digests, checks, hw)
    del stream25
    lap("phase 12")

    # -- phase 13: the roofline of the main paths ----------------------------
    sel_key, emb, sel_mask, t_sel = selection
    eng13 = new_engine()

    def serve_step():
        """One step of the engine on phase 6's first burst."""
        for tid, q in traffic[0]:
            eng13.enqueue(tid, q)
        eng13.step()

    def select():
        sel = select_coreset(sel_key, emb, sel_mask, SELECT_K, t_sel,
                             backend="cuda", device=dev)
        return sel.indices, sel.weights

    def kmedian_embeddings(backend="cuda"):
        """k-median of the selection's 16,384 embeddings of 4,096 features
        (k = 8): weiszfeld_stats' two-pass form, through weiszfeld_reduce."""
        return clustering.solve(prng.PRNGKey(args.seed),
                                emb.reshape(-1, emb.shape[-1]), SELECT_K,
                                lloyd_iters=4, objective="kmedian",
                                backend=backend, device=dev)

    # the k-median of the embeddings held to the same solve by the plain
    # versions: the full-data cost of the centres within DRAW_COST_RTOL
    # (near-tie flips over four Weiszfeld steps move the centres' last
    # bits); its digest is held again with recording on in phase 13
    flat_emb = emb.reshape(-1, emb.shape[-1])
    md_cuda, md_torch = kmedian_embeddings(), kmedian_embeddings("torch")
    full = [float(torch.sqrt(ref.min_dist_argmin_ref(
        flat_emb, cs)[0].clamp_min(0.0)).sum()) for cs, _ in
        (md_cuda, md_torch)]
    centre_gap = float((md_cuda[0] - md_torch[0]).abs().max())
    check(np.isfinite(full).all() and abs(full[0] / full[1] - 1.0)
          <= DRAW_COST_RTOL,
          f"k-median of the selection embeddings: full-data cost "
          f"cuda/torch {full[0] / full[1]}")
    digests["kmedian[selection embeddings]"] = digest(*md_cuda)
    print(f"  k-median of the selection embeddings {tuple(flat_emb.shape)} "
          f"k={SELECT_K}: full-data cost cuda/torch "
          f"{full[0] / full[1]:.8f}, max |centre diff| {centre_gap:.3g} "
          f"(max |centre| {float(md_torch[0].abs().max()):.3g})")
    del md_cuda, md_torch, flat_emb

    launched13 = phase13(
        args.seed, dev, hw,
        {"k-means flood": (lambda: (drive("flood").centers,),
                           "kmeans centres[flood]"),
         "k-median flood": (lambda: (drive_md("flood").centers,),
                            "kmedian centres[flood]"),
         "serving step": (serve_step, None),
         "selection": (select, "selection[llama3-8b widths]"),
         "k-median, selection embeddings": (
             kmedian_embeddings, "kmedian[selection embeddings]")},
        (reset_counts, counts, route_counts), (data_s, sp_s, sm_s, g, k, t),
        w4_gather, digests)
    wr_launches = launched13["k-median, selection embeddings"][
        "weiszfeld_reduce"]
    check(wr_launches > 0, "phase 13: weiszfeld_reduce never launched")
    del emb, sel_mask, eng13
    lap("phase 13")

    # phase 16's dry run runs on the host, alongside phases 14 to 16
    import tempfile
    dry_tmp = tempfile.mkdtemp(prefix="phase16-dryrun-")
    dry = dryrun_start(hw, dry_tmp)
    try:
        # -- phase 14: the language-model stack -----------------------------
        torch.cuda.empty_cache()
        phase14(args.seed, dev, smi, digests)
        lap("phase 14")

        # -- phase 15: training and LM serving ------------------------------
        torch.cuda.empty_cache()
        new_paths["phase 15"] = phase15(args.seed, dev, smi,
                                        (reset_counts, counts, route_counts),
                                        digests, checks)
        lap("phase 15")

        # -- phase 16: the launchers ----------------------------------------
        torch.cuda.empty_cache()
        new_paths["phase 16"] = phase16(args.seed, dev, smi,
                                        (reset_counts, counts, route_counts),
                                        checks, dry, hw, digests)
        lap("phase 16")
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].wait()
        shutil.rmtree(dry_tmp, ignore_errors=True)
    for phase, got in new_paths.items():
        for name in ("distance_argmin", "lloyd_stats", "weiszfeld_stats",
                     da.ONE_CENTER.name):
            if phase == "phase 10" and name == "weiszfeld_stats":
                continue
            # the training path's selection at d = 4,096: two-pass sums
            if phase in ("phase 15", "phase 16") and name in (
                    "lloyd_stats", "weiszfeld_stats"):
                continue
            check(got.get(name, 0) > 0, f"{phase}: {name} never launched")
    check(new_paths["phase 10"].get("distance_argmin_batched", 0) > 0,
          "phase 10: distance_argmin_batched never launched")
    for phase in ("phase 12", "phase 15", "phase 16"):
        for name in ("lloyd_reduce", da.STREAM.name):
            check(new_paths[phase].get(name, 0) > 0,
                  f"{phase}: {name} never launched")

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
        # its main path is data selection (phase 12): launches there
        {"name": "lloyd_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lloyd_reduce.cu",
         "replaces": "src/repro/kernels/lloyd_update.py:67",
         "launches": new_paths["phase 12"].get("lloyd_reduce", 0),
         **reduce_row},
        # weiszfeld_stats' two-pass form: no route of the reference takes
        # it, so its launches come from a k-median solve of the selection's
        # embeddings that this script drives (phase 13); timed at
        # selection's shape
        {"name": "weiszfeld_reduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lloyd_reduce.cu",
         "replaces": "src/repro/kernels/weiszfeld.py:100",
         "launches": wr_launches,
         "launches_from": "synthetic: k-median of phase 12's selection "
                          "embeddings (16,384 x 4,096, k = 8), not a route "
                          "of the reference",
         **wr_row},
        # distance_argmin's streamed tile (blocks above the resident
        # limit): its main path is data selection (phase 12), launches
        # there; timed at its shape
        {"name": da.STREAM.name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/distance_argmin.cu",
         "replaces": "src/repro/kernels/distance_argmin.py:131",
         "launches": new_paths["phase 12"].get(da.STREAM.name, 0),
         **stream_row},
    ]
    # each kernel's launches on the staged (phase 9), streaming (phase 10),
    # SPMD (phase 11: rank 0 of W = 4, k-means and k-median), WAN and
    # selection (phase 12), training-set selection (phase 15) and
    # training-launcher (phase 16) paths, counted from zero around every run
    # of those phases
    for entry, name in zip(kernels, (da.ONE_CENTER.name, "distance_argmin",
                                     "lloyd_stats", "weiszfeld_stats",
                                     "distance_argmin_batched",
                                     "lloyd_reduce", "weiszfeld_reduce",
                                     da.STREAM.name)):
        entry["launches_new_paths"] = {
            phase: got.get(name, 0) for phase, got in new_paths.items()}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
