"""The dry run read from one rank of the port's sharded step
(``launch.dryrun``: ``rank_run`` on ``core.mesh.MeshGrid.stand_in``), and
the step on attention heads that do not split over ``model``.

* A stand-in rank records what a real rank records: every rank of a real
  2x2 gloo launch (``core.mesh.launch``, ``device="cpu"``) runs
  ``dryrun.rank_run``'s program on real tensors under
  ``roofline.record()``, and its collective records -- kind, group
  ranks, result bytes, phase, in order -- equal those of the stand-in of
  its rank running it on meta tensors: a reduced llama3-8b train step
  with two microbatches and a reduced recurrentgemma-2b decode step, and
  the train step on a real (pod, data, model) = (2, 1, 2) grid, whose
  batch is cut over the joint ("pod", "data") axis.
* Heads that do not split over ``model`` (1x4, f32): llama3-8b with 6
  heads (``wq``'s columns cut inside a head, gathered), llama3-8b with 5
  heads of 18 and one kv head (``wq``'s and ``wo``'s 90 columns / rows
  stay whole) and granite-moe with 6 heads. The sharded step against the
  reference's unsharded step (``test_torch_sharded_train.assert_step``:
  metrics within LOSS_RTOL, gradients within 2 GRAD_RTOL of the leaf's
  largest, the first-step rule), and the sharded prefill and decode
  against the reference's unsharded forward in exactified f32
  (``test_torch_sharded_decode``'s tolerances: F32_RTOL of max |logit|).
* Production widths cut in depth run through ``dryrun.run_cell`` on the
  single-pod mesh: granite-moe (24 heads), qwen2-vl (12) and
  recurrentgemma (10, with its local attention layer) over a model axis
  of 16.
* A reduced multi-pod cell on (2, 2, 2) counts network bytes: the
  step's gradient all-reduce over a group that crosses the pods.

Every launch and the reference's compiles run on threads beside each
other; alone the file takes about a minute.
"""
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _lm_parity import (F32_RTOL, LP, assert_cache_equal, configs_for,
                        port_params, reference_params, reference_run,
                        to_numpy, tokens)
from _train_parity import port_batch, reference_step
from repro.train import train_step as jtrain_step
from repro_torch import configs, interop
from repro_torch import tree as tree_mod
from repro_torch.core.mesh import MeshGrid, launch
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import sharding
from repro_torch.roofline.report import H100_SXM
from repro_torch.roofline.trace import crosses, record
from repro_torch.train import TrainConfig
from test_torch_sharded_decode import _case as decode_case
from test_torch_sharded_decode import _tensors
from test_torch_sharded_train import STEP_KW
from test_torch_sharded_train import _case as train_case
from test_torch_sharded_train import _inputs, assert_step, port_ranks

torch.set_num_threads(1)

# -- records: a stand-in rank against a real one --------------------------------

RECORD_MESHES = {
    "2x2": ((2, 2), ("data", "model"), (
        ("llama3_8b", ShapeSpec("t", "train", 32, 8),
         TrainConfig(microbatches=2, remat="full")),
        ("recurrentgemma_2b", ShapeSpec("t", "decode", 32, 4), None))),
    "2x1x2": ((2, 1, 2), ("pod", "data", "model"), (
        ("llama3_8b", ShapeSpec("t", "train", 32, 8),
         TrainConfig(microbatches=2, remat="full")),)),
}


def _real(tree):
    """A meta tree's tensors as real ones of the same shapes and dtypes
    on the CPU (zeros: the records do not depend on values)."""
    if isinstance(tree, sharding.GridCache):
        return sharding.GridCache(_real(list(tree)), tree.specs)
    if isinstance(tree, dict):
        return {k: _real(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_real(v) for v in tree)
    return torch.zeros(tree.shape, dtype=tree.dtype)


def _records(grid, shape, names, cells, real):
    """Each cell's collective records on this rank of ``grid``: the
    cell built on the logical mesh as ``run_cell`` builds it, then
    ``dryrun.rank_run`` on the grid (on real tensors where ``real``)."""
    out = []
    for arch, spec, tc in cells:
        cell = specs.build_cell(arch, spec, make_mesh(shape, names), tc=tc,
                                cfg_override=configs.get_reduced(arch))
        fn, args = dryrun.rank_run(cell, grid)
        if real:
            args = _real(args)
        with record() as led:
            fn(*args)
        out.append([(r.kind, r.ranks, r.result_bytes, r.phase)
                    for r in led.collectives])
    return out


def rank_records(grid, mesh_name):
    """``core.mesh.launch``'s target: this rank's records."""
    torch.set_num_threads(1)
    shape, names, cells = RECORD_MESHES[mesh_name]
    return _records(grid, shape, names, cells, real=True)


# -- heads that do not split over model ----------------------------------------

# name: (architecture, config changes)
HEADS = {
    "llama3_8b/6 heads": ("llama3_8b", {"n_heads": 6}),
    "llama3_8b/5 heads of 18": ("llama3_8b", {"n_heads": 5, "n_kv_heads": 1,
                                               "head_dim": 18}),
    "granite_moe_3b_a800m/6 heads": ("granite_moe_3b_a800m",
                                     {"n_heads": 6}),
}
HEADS_MESH = (1, 4)


def rank_heads(grid, train_cases, decode_cases):
    """``core.mesh.launch``'s target: the train cases (one step each,
    ``test_torch_sharded_train._case``), then the decode cases
    (``test_torch_sharded_decode._case``)."""
    torch.set_num_threads(1)
    return {"train": [train_case(grid, cfg, layout, params, b, 1)
                      for cfg, layout, params, b in train_cases],
            "decode": [decode_case(grid, *case) for case in decode_cases]}


def _reference_step(inputs):
    """The reference's unsharded step as ``test_torch_sharded_train``'s
    ``drive`` reads it (its gradients from the first moment)."""
    jc, tc, jparams, b = inputs
    params, opt, metrics = reference_step(
        jc, jtrain_step.TrainConfig(**STEP_KW), jparams, b)
    clip = min(1.0, 1.0 / metrics["grad_norm"])
    grads = [torch.from_numpy((m.double() / (0.1 * clip)).float().numpy())
             for m in tree_mod.leaves(interop.model_params(opt["m"], tc,
                                                           "cpu"))]
    return {"p0": tree_mod.leaves(interop.model_params(
                to_numpy(jparams), tc, "cpu")),
            "grads": grads, "metrics": metrics, "clip": clip,
            "params": tree_mod.leaves(interop.model_params(params, tc,
                                                           "cpu")),
            "tc": tc}


def _forward_inputs(name):
    arch, changes = HEADS[name]
    jc, tc = configs_for(arch, **changes)
    jp = reference_params(jc)
    return jc, tc, jp, tokens(jc), port_params(jp, tc)


@pytest.fixture(scope="module")
def runs():
    """The records launches, the heads launch and the reference's steps
    and forwards, on threads beside each other."""
    port = {}

    def run(key, target, world, args, names, shape):
        try:
            port[key] = launch(target, world, args, axis_name=names,
                               shape=shape, device="cpu", timeout=600)
        except Exception as e:      # raised in the test that reads it
            port[key] = e

    train = {name: _inputs(arch, **changes)
             for name, (arch, changes) in HEADS.items()}
    with ThreadPoolExecutor(len(HEADS)) as pool:
        fwd = dict(zip(HEADS, pool.map(_forward_inputs, HEADS)))
    train_cases = [(tc, "tp", interop.model_params(to_numpy(jp), tc, "cpu"),
                    port_batch(b)) for _, tc, jp, b in train.values()]
    decode_cases = [(tc, params, tok, LP, False)
                    for _, tc, _, tok, params in fwd.values()]
    jobs = [(name, "test_torch_dryrun_step:rank_records",
             int(np.prod(shape)), (name,), names, shape)
            for name, (shape, names, _) in RECORD_MESHES.items()]
    jobs.append(("heads", "test_torch_dryrun_step:rank_heads",
                 int(np.prod(HEADS_MESH)), (train_cases, decode_cases),
                 ("data", "model"), HEADS_MESH))
    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for thread in threads:
        thread.start()
    try:
        # XLA compiles outside the GIL: a thread a configuration
        with ThreadPoolExecutor(2 * len(HEADS)) as pool:
            steps = pool.map(_reference_step, train.values())
            fwds = pool.map(lambda n: reference_run(
                fwd[n][0], fwd[n][2], fwd[n][3], prefill=LP), HEADS)
            ref = dict(zip(HEADS, steps))
            ref_fwd = dict(zip(HEADS, fwds))
    finally:
        for thread in threads:
            thread.join()
    return {"port": port, "ref": ref, "fwd": ref_fwd,
            "cfg": {n: fwd[n][1] for n in HEADS}}


@pytest.mark.parametrize("mesh_name", list(RECORD_MESHES))
def test_a_stand_in_rank_records_what_a_real_rank_records(runs, mesh_name):
    """Every rank's records, cell by cell, equal its stand-in's."""
    got = port_ranks(runs["port"], mesh_name)
    shape, names, cells = RECORD_MESHES[mesh_name]
    for rank, real in enumerate(got):
        grid = MeshGrid.stand_in(names, shape, rank=rank)
        want = _records(grid, shape, names, cells, real=False)
        for (arch, spec, _), a, b in zip(cells, real, want):
            assert a, (arch, spec.kind)
            assert a == b, (mesh_name, rank, arch, spec.kind)
    kinds = {r[0] for cell in got[0] for r in cell}
    assert kinds == {"all-gather", "reduce-scatter", "all-reduce"}, kinds


def _heads(runs):
    return port_ranks(runs["port"], "heads")[0]


@pytest.mark.parametrize("name", list(HEADS))
def test_step_on_heads_that_do_not_split(runs, name):
    """The 1x4 step against the reference's unsharded step."""
    i = list(HEADS).index(name)
    assert_step(_heads(runs)["train"][i], runs["ref"][name], f"{name} 1x4")


@pytest.mark.parametrize("name", list(HEADS))
def test_prefill_and_decode_on_heads_that_do_not_split(runs, name):
    """The 1x4 prefill's last logits, its gathered cache and (MoE) the
    load-balance loss, and every decode step's logits, against the
    reference's unsharded forward."""
    ranks = port_ranks(runs["port"], "heads")
    i = list(HEADS).index(name)
    got, ref, tc = ranks[0]["decode"][i], runs["fwd"][name], \
        runs["cfg"][name]
    scale = np.abs(ref["logits"]).max()
    np.testing.assert_allclose(got["prefill"][:, -1], ref["prefill"][:, -1],
                               rtol=0, atol=F32_RTOL * scale)
    assert_cache_equal(_tensors(got["cache"]), ref["cache"], tc)
    aux = np.mean([r["decode"][i]["aux"] for r in ranks])
    np.testing.assert_allclose(aux, ref["prefill_aux"], rtol=F32_RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(got["decode"], ref["decode"], rtol=0,
                               atol=F32_RTOL * scale)


@pytest.mark.parametrize("name, cut", [("llama3_8b/6 heads", True),
                                       ("llama3_8b/5 heads of 18", False)])
def test_query_columns_cut_inside_a_head_or_whole(name, cut):
    """At 1x4, 6 heads of 16 have ``wq``'s 96 columns cut 24 a rank (one
    and a half heads) and ``wo``'s rows likewise; 5 heads of 18 leave
    ``wq``'s 90 columns and ``wo``'s rows whole."""
    arch, changes = HEADS[name]
    cfg = dataclasses.replace(configs.get_reduced(arch), **changes)
    from repro_torch.models.model import shard_specs
    attn = shard_specs(cfg, make_mesh(HEADS_MESH, ("data", "model")),
                       "tp")["layers"][0]["attn"]
    assert (attn["wq"]["w"][1] == "model") == cut
    assert (attn["wo"]["w"][0] == "model") == cut
    sharding.check_model(cfg, 4, 32)


# -- the dry run on production widths -------------------------------------------

PRODUCTION = [("granite_moe_3b_a800m", "train_4k"),
              ("qwen2_vl_2b", "prefill_32k"),
              ("recurrentgemma_2b", "decode_32k")]


@pytest.mark.parametrize("arch, shape", PRODUCTION)
def test_production_cells_whose_heads_do_not_split_run(arch, shape):
    """Published widths, cut to 2 layers (recurrentgemma to 3, so that
    its local attention layer runs), on the single-pod mesh: their heads
    (24, 12, 10) do not split over 16, and the step runs them."""
    cfg = configs.get(arch)
    assert cfg.n_heads % 16
    cfg = dataclasses.replace(cfg, n_layers=max(2, len(cfg.pattern)))
    r = dryrun.run_cell(arch, shape, "single", "", verbose=False,
                        hardware=H100_SXM, cfg_override=cfg)
    assert r["status"] == "ok" and r["fits_hbm"]
    assert r["temp_bytes"] > 0 and r["ici_bytes"] > 0
    assert r["dcn_bytes"] == 0.0


def test_a_multi_pod_cell_counts_network_bytes():
    """A reduced train cell on (pod, data, model) = (2, 2, 2): the
    step's gradient all-reduce runs over a group that crosses the pods
    (network bytes), the rest within a pod."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = configs.get_reduced("llama3_8b")
    shape = ShapeSpec("t", "train", 64, 8)
    specs.SHAPES["t"] = shape
    try:
        r = dryrun.run_cell("llama3_8b", "t", "multi", "", verbose=False,
                            hardware=H100_SXM, cfg_override=cfg, mesh=mesh,
                            network_bytes_per_s=50e9)
    finally:
        specs.SHAPES.pop("t", None)
    assert r["status"] == "ok" and r["dcn_bytes"] > 0 and r["ici_bytes"] > 0
    grid = MeshGrid.stand_in(mesh.axis_names, (2, 2, 2))
    cell = specs.build_cell("llama3_8b", shape, mesh, cfg_override=cfg)
    fn, args = dryrun.rank_run(cell, grid)
    with record() as led:
        fn(*args)
    across = [rec for rec in led.collectives if crosses(rec.ranks, 4)]
    assert across and {rec.kind for rec in across} == {"all-reduce"}
    assert grid.joint[("pod", "data")].ranks in {rec.ranks
                                                  for rec in across}
