"""Prefill and decode with a cache on a (data, model) grid of gloo ranks
on the CPU (``models.forward(..., cache=...)`` under
``sharding.set_mesh(grid, "tp")``): the KV cache's length cut over
``model`` (flash-decode: each rank attends every head over its slots,
the softmax partials merged across ranks), the local layers' ring, int8
payloads, the SSD's conv slice and heads, the RG-LRU's channels, the
experts split over ``model``, and the batch over ``data``.

* Against the reference's unsharded forward on its own parameters
  (``interop``), in exactified f32 (``_lm_parity``): at 1x2 every
  reduced configuration and an int8 KV cache on a global and on a
  local-window model; at 2x2 and 1x4 llama3-8b (GQA: two kv heads do not
  split over four ranks, so K and V are gathered), gemma3-27b (the ring
  wrapped: the prompt is longer than the window), recurrentgemma-2b
  (MQA, RG-LRU, ring), mamba2-370m, qwen2-vl-2b (M-RoPE) and
  granite-moe, and at 1x2 and 1x4 a prompt of odd length, whose
  sequence runs whole on every rank (granite-moe, gemma3, mamba2). The
  prefill's last-position logits (gathered over the vocab and the
  batch) and its cache (``sharding.unshard_cache``; int8 payloads and
  ``pos`` exactly, floats to F32_RTOL of the leaf's largest), the MoE's
  load-balance loss (the ranks' mean, as training takes it), and every
  decode step's logits to F32_RTOL of max |logit| (INT8_FLIP_RTOL after
  the first int8 flip, as ``test_torch_models_decode.py`` holds them).
* Shapes: every rank's cache leaves are their shards under
  ``sharding.cache_specs`` (``launch.specs.shard_shape``): no rank holds
  the whole KV cache where its length splits.
* The reference's serving cells of ``tests/test_dryrun_small.py`` --
  gemma3 prefill, recurrentgemma decode, qwen2-vl decode -- run for real
  through ``launch.specs.build_cell(...).fn`` on a 2x2 grid, the
  parameters in the reference's stacked serving layout (replicated over
  ``data``) and sharded as the cell's specs say.
* ``launch.train --mesh 2x1`` and ``--mesh 2x2`` with ``--microbatches
  2`` against the reference's launcher on forced host devices, every
  metric of every step, ``ppl_proxy`` (a mean of per-microbatch exps)
  among them: a rank's microbatch i is its share of the global
  microbatch i (``sharding.batch_rows``).

Each mesh's cases run in one ``core.mesh.launch`` (a thread each),
beside the reference's forwards (a thread a configuration) and the
launchers' subprocesses."""
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (F32_RTOL, LP, _jitted, assert_cache_equal,
                        configs_for, port_params, reference_params,
                        reference_run, tokens)
from repro.models import init_cache as jinit_cache
from repro.models import make_positions as jmake_positions
from repro_torch import configs
from repro_torch.core.mesh import launch
from repro_torch.launch import specs
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import (cache_spec, forward, init_cache,
                                make_positions, sharding)
from repro_torch.models.model import shard_specs
from test_torch_launch_train import _assert_metrics
from test_torch_models_decode import INT8_FLIP_RTOL, _int8_payloads_differ
from test_torch_sharded_train import launcher_runs, start_launcher_parity

torch.set_num_threads(1)

MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
# name: (architecture, config changes, prompt length)
VARIANTS = {arch: (arch, {}, LP) for arch in configs.ARCH_IDS}
VARIANTS.update({
    "llama3_8b-int8": ("llama3_8b", {"kv_cache_dtype": "int8"}, LP),
    "gemma3_27b-int8": ("gemma3_27b", {"kv_cache_dtype": "int8"}, LP),
    # a prompt that does not split over the model axis runs whole on
    # every rank (the MoE's combine and aux loss, the ring, the SSD)
    "granite_moe_3b_a800m-odd": ("granite_moe_3b_a800m", {}, LP - 1),
    "gemma3_27b-odd": ("gemma3_27b", {}, LP - 1),
    "mamba2_370m-odd": ("mamba2_370m", {}, LP - 1),
})
ODD = [n for n in VARIANTS if n.endswith("-odd")]
WIDE = ("llama3_8b", "gemma3_27b", "recurrentgemma_2b", "mamba2_370m",
        "qwen2_vl_2b", "granite_moe_3b_a800m")
CASES = {"1x2": list(VARIANTS), "2x2": list(WIDE), "1x4": list(WIDE) + ODD}
# the reference's serving cells of tests/test_dryrun_small.py, on 2x2
CELLS = (("gemma3_27b", "prefill"), ("recurrentgemma_2b", "decode"),
         ("qwen2_vl_2b", "decode"))
CELL_MESH = "2x2"
C2_MESHES = {"2x1": 2, "2x2": 4}
C2_ARGV = ["--arch", "llama3_8b", "--reduced", "--microbatches", "2",
           "--steps", "3", "--batch", "4", "--seq", "32", "--log-every",
           "1"]


def _full(x, grid, spec):
    """A tensor gathered from every rank's shard under ``spec``."""
    return sharding.unshard_leaf(x, spec, grid)


def _host(cache):
    """A gathered cache as numpy (what a rank sends back)."""
    return [{k: v.numpy() for k, v in c.items()} for c in cache]


def _tensors(cache):
    return [{k: torch.from_numpy(v) for k, v in c.items()} for c in cache]


def _case(grid, tc, params, tok, prompt, trace):
    """One configuration on this rank: prefill ``prompt`` tokens, decode to
    the end. Rank 0 keeps the gathered logits and caches."""
    B, L = tok.shape
    t = torch.from_numpy(tok)
    out = {"decode": [], "caches": []}
    with torch.no_grad(), sharding.set_mesh(grid, "tp"):
        shards = sharding.shard(params, shard_specs(tc, grid, "tp"), grid)
        t = t[sharding.batch_rows(B)]
        cache = init_cache(tc, B, L, "cpu")
        out["shapes"] = [{k: tuple(v.shape) for k, v in c.items()}
                         for c in cache]
        lp, cache, aux = forward(shards, t[:, :prompt],
                                 make_positions(t[:, :prompt], tc), tc,
                                 cache=cache)
        out["aux"] = float(aux)
        out["prefill"] = _full(lp, grid, ("data", None, "model")).numpy()
        whole = sharding.unshard_cache(cache, grid)
        again = sharding.shard_cache(whole, grid)
        out["round_trip"] = all(torch.equal(a[k], b[k]) for a, b in
                                zip(again, cache) for k in a)
        out["cache"] = _host(whole)
        for s in range(prompt, L):
            ls, cache, _ = forward(
                shards, t[:, s:s + 1],
                make_positions(t[:, s:s + 1], tc, offset=s), tc,
                cache=cache)
            out["decode"].append(_full(ls[:, 0], grid,
                                       ("data", "model")).numpy())
            if trace:
                out["caches"].append(_host(sharding.unshard_cache(cache,
                                                                  grid)))
    if grid.rank:
        return {k: out[k] for k in ("shapes", "aux", "round_trip")}
    out["decode"] = np.stack(out["decode"], axis=1)
    return out


def _cell(grid, arch, kind, tc, params, tok):
    """A serving cell of ``launch.specs.build_cell`` run for real: the
    port's params stacked as the reference's, this rank's shards under the
    cell's specs, its rows of ``tok``. prefill: L = the whole prompt;
    decode: the prefill cell of a cache of L slots on LP tokens, then the
    decode cell to the end."""
    B, L = tok.shape
    stacked = specs.stacked_params(params, tc)
    seq = L if kind == "decode" else LP
    pre = specs.build_cell(arch, ShapeSpec("t", "prefill", seq, B), grid,
                           cfg_override=tc)
    shards = sharding.shard(stacked, pre.specs[0], grid)
    with sharding.set_mesh(grid, "tp"):
        t = torch.from_numpy(tok)[sharding.batch_rows(B)]
    with torch.no_grad():
        last, cache = pre.fn(shards, t[:, :LP])
        out = {"prefill": _full(last, grid, ("data", "model")).numpy(),
               "decode": []}
        if kind == "prefill":
            out["cache"] = _host(sharding.unshard_cache(cache, grid))
            return out if grid.rank == 0 else None
        dec = specs.build_cell(arch, ShapeSpec("t", "decode", L, B), grid,
                               cfg_override=tc)
        assert sharding.spec_leaves(dec.specs[0]) == \
            sharding.spec_leaves(pre.specs[0])
        for s in range(LP, L):
            pos = torch.full((t.shape[0],), s, dtype=torch.int32)
            logits, cache = dec.fn(shards, t[:, s:s + 1], pos, cache)
            out["decode"].append(_full(logits, grid,
                                       ("data", "model")).numpy())
    out["decode"] = np.stack(out["decode"], axis=1)
    return out if grid.rank == 0 else None


def rank_cases(grid, cases, cells):
    """``core.mesh.launch``'s target: every case of one mesh, then its
    serving cells."""
    torch.set_num_threads(1)
    return {"cases": [_case(grid, *case) for case in cases],
            "cells": [_cell(grid, *cell) for cell in cells]}


def _reference_prefill(jc, jparams, tok, length):
    """The reference's prefill of ``tok[:, :length]`` into a cache of
    ``length`` slots: last-position logits and the cache, as numpy."""
    t = jnp.asarray(tok[:, :length])
    logits, cache, _ = _jitted()(jparams, t, jmake_positions(t, jc), cfg=jc,
                                 cache=jinit_cache(jc, tok.shape[0], length))
    return {"prefill": np.asarray(logits[:, -1]),
            "cache": jax.tree.map(np.asarray, cache)}


@pytest.fixture(scope="module")
def runs():
    """Every mesh's launch (a thread each) beside the reference's forwards
    and the C2 launchers' subprocesses."""
    launchers = {m: start_launcher_parity(C2_ARGV + ["--mesh", m], n)
                 for m, n in C2_MESHES.items()}

    def made(name):
        arch, changes, _ = VARIANTS[name]
        jc, tc = configs_for(arch, **changes)
        jp = reference_params(jc)
        return jc, tc, jp, tokens(jc), port_params(jp, tc)

    # XLA compiles outside the GIL: a thread a configuration
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        inputs = dict(zip(VARIANTS, pool.map(made, VARIANTS)))
    port = {}

    def run(mesh_name, shape):
        cases = [(inputs[n][1], inputs[n][4], inputs[n][3], VARIANTS[n][2],
                  inputs[n][1].kv_cache_dtype == "int8")
                 for n in CASES[mesh_name]]
        cells = [(arch, kind, inputs[arch][1], inputs[arch][4],
                  inputs[arch][3]) for arch, kind in CELLS
                 ] if mesh_name == CELL_MESH else []
        try:
            port[mesh_name] = launch(
                "test_torch_sharded_decode:rank_cases", shape[0] * shape[1],
                (cases, cells), axis_name=("data", "model"), shape=shape,
                device="cpu", timeout=600)
        except Exception as e:     # raised in the test that reads it
            port[mesh_name] = e

    threads = [threading.Thread(target=run, args=item)
               for item in MESHES.items()]
    for thread in threads:
        thread.start()

    def reference(name):
        jc, _, jp, tok, _ = inputs[name]
        out = reference_run(jc, jp, tok, prefill=VARIANTS[name][2],
                            trace=jc.kv_cache_dtype == "int8")
        if name in dict(CELLS) and dict(CELLS)[name] == "prefill":
            out["cell"] = _reference_prefill(jc, jp, tok, LP)
        return out

    try:
        with ThreadPoolExecutor(len(inputs)) as pool:
            ref = dict(zip(inputs, pool.map(reference, inputs)))
    finally:
        for thread in threads:
            thread.join()
        c2 = {m: launcher_runs(p) for m, p in launchers.items()}
    return {"port": port, "ref": ref, "c2": c2,
            "cfg": {n: inputs[n][1] for n in inputs}}


def _ranks(runs, mesh_name):
    got = runs["port"][mesh_name]
    if isinstance(got, Exception):
        raise got
    return got


PARAMS = [(m, n) for m in MESHES for n in CASES[m]]


@pytest.mark.parametrize("mesh_name, name", PARAMS)
def test_prefill_is_the_references(runs, mesh_name, name):
    """The prefill's last-position logits, its cache gathered from the
    ranks' shards, and (MoE) the load-balance loss: the ranks' mean."""
    ranks = _ranks(runs, mesh_name)
    i = CASES[mesh_name].index(name)
    got, ref, tc = ranks[0]["cases"][i], runs["ref"][name], \
        runs["cfg"][name]
    scale = np.abs(ref["logits"]).max()
    np.testing.assert_allclose(got["prefill"][:, -1], ref["prefill"][:, -1],
                               rtol=0, atol=F32_RTOL * scale)
    assert_cache_equal(_tensors(got["cache"]), ref["cache"], tc)
    aux = np.mean([r["cases"][i]["aux"] for r in ranks])
    np.testing.assert_allclose(aux, ref["prefill_aux"], rtol=F32_RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("mesh_name, name", PARAMS)
def test_decode_is_the_references(runs, mesh_name, name):
    """Every decode step's logits (INT8_FLIP_RTOL once an int8 payload has
    rounded apart from the reference's, every difference one step)."""
    got = _ranks(runs, mesh_name)[0]["cases"][CASES[mesh_name].index(name)]
    ref, tc = runs["ref"][name], runs["cfg"][name]
    scale = np.abs(ref["logits"]).max()
    flipped = False
    for s in range(got["decode"].shape[1]):
        if tc.kv_cache_dtype == "int8":
            flipped |= _int8_payloads_differ(_tensors(got["caches"][s]),
                                             ref["caches"][s], tc)
        np.testing.assert_allclose(
            got["decode"][:, s], ref["decode"][:, s], rtol=0,
            atol=(INT8_FLIP_RTOL if flipped else F32_RTOL) * scale,
            err_msg=f"decode step {s}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_shards_are_the_layouts(runs, mesh_name):
    """Each rank's cache leaves have the shapes ``launch.specs``'
    ``shard_shape`` gives under the shared rule (``cache_specs``, the
    dry run's too), a KV cache's length is cut over ``model``, and
    ``shard_cache`` of the gathered prefill cache gives each rank its
    shards back."""
    ranks = _ranks(runs, mesh_name)
    shape = dict(zip(("data", "model"), MESHES[mesh_name]))
    grid = _Grid(shape)
    for i, name in enumerate(CASES[mesh_name]):
        tc = runs["cfg"][name]
        full = cache_spec(tc, 2, 32)
        layout = specs.cache_specs(full, grid)
        want = [{k: specs.shard_shape(v.shape, layout[j][k], grid)
                 for k, v in c.items()} for j, c in enumerate(full)]
        for r in ranks:
            assert r["cases"][i]["shapes"] == want, (name, mesh_name)
            assert r["cases"][i]["round_trip"], (name, mesh_name)
        for c, w in zip(full, want):
            if "pos" in c:
                assert w["pos"][1] * shape["model"] == c["pos"].shape[1]


class _Grid:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = shape


@pytest.mark.parametrize("arch, kind", CELLS)
def test_serving_cell_is_the_references(runs, arch, kind):
    """A serving cell run through ``build_cell(...).fn`` on 2x2: the
    prefill cell's last logits and cache against the reference's prefill
    of as many slots; the decode cell's steps against the reference's
    decode after a prefill of LP tokens."""
    got = _ranks(runs, CELL_MESH)[0]["cells"][
        [c[0] for c in CELLS].index(arch)]
    ref, tc = runs["ref"][arch], runs["cfg"][arch]
    scale = np.abs(ref["logits"]).max()
    if kind == "prefill":
        want = ref["cell"]
        np.testing.assert_allclose(got["prefill"], want["prefill"], rtol=0,
                                   atol=F32_RTOL * scale)
        assert_cache_equal(_tensors(got["cache"]), want["cache"], tc)
        return
    np.testing.assert_allclose(got["prefill"], ref["prefill"][:, -1],
                               rtol=0, atol=F32_RTOL * scale)
    np.testing.assert_allclose(got["decode"], ref["decode"], rtol=0,
                               atol=F32_RTOL * scale)


@pytest.mark.parametrize("mesh_name", list(C2_MESHES))
def test_microbatched_launcher_is_the_references(runs, mesh_name):
    """``launch.train --mesh {2x1, 2x2} --microbatches 2``: every step's
    metrics within LOSS_RTOL of the reference's launcher on as many host
    devices, ``ppl_proxy`` included."""
    got, want = runs["c2"][mesh_name]["port"], runs["c2"][mesh_name]["ref"]
    assert len(got) == 3
    _assert_metrics(got, want)
