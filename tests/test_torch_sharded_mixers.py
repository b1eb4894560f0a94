"""Tensor and expert parallelism for the MoE, SSD and RG-LRU mixers
(``models.moe``, ``models.ssd``, ``models.rglru`` under
``sharding.model_axis()``): the port's train step on a (data, model) mesh
of gloo ranks on the CPU, layout "tp", for dbrx and granite-moe (experts
split over ``model``), mamba2 (SSD heads; the packed ``in_proj`` columns
cut off the heads and gathered) and recurrentgemma (RG-LRU channels,
beside local attention with one kv head), at 1x2, 2x2 and 1x4, and a
granite-moe variant with 6 experts at 1x4, whose experts stay whole on
every rank.

* Against the reference's unsharded step from the same params and batch
  (``test_torch_sharded_train.assert_step``): every metric within
  LOSS_RTOL (``ppl_proxy`` and ``moe_aux`` among them), every gathered
  gradient within 2 GRAD_RTOL of its leaf's largest -- ``router/w``'s,
  which a load-balance loss taken on every rank of ``model`` would count
  M times, and the SSD's ``norm_scale``'s and ``in_proj``'s, which a
  gated norm whose mean square's gradient is not summed over ``model``
  would get wrong -- and the params after one step under the first-step
  rule.
* Bit-stability: after each of two steps the ranks that hold the same
  shard of a leaf hold it bit for bit, and two runs end bit-equal.
* Memory: the param and moment bytes a rank holds are its shards' under
  ``param_specs``.
* The launcher: ``repro.launch.train --arch granite_moe_3b_a800m
  --reduced --mesh 1x2`` (JAX on two forced host devices) against the
  port's (two gloo ranks) from the same state on the same batches, every
  step's metrics within LOSS_RTOL.

Each mesh's cases run in one ``core.mesh.launch`` (a thread each),
beside the reference's compiles (``test_torch_sharded_train.drive``) and
the launchers' subprocess."""
import pytest
import torch

from repro_torch.models import sharding
from repro_torch.models.model import shard_specs
from test_torch_sharded_train import (MESHES, _Grid, _inputs, assert_bits,
                                      assert_bytes, assert_step, drive,
                                      launcher_runs, port_ranks, rank_cases,
                                      start_launcher_parity)

torch.set_num_threads(1)

ARCHS = ("dbrx_132b", "granite_moe_3b_a800m", "mamba2_370m",
         "recurrentgemma_2b")
# granite-moe with experts that do not split over a model axis of 4
WHOLE_EXPERTS = "granite_moe_3b_a800m/6 experts"
VARIANTS = {WHOLE_EXPERTS: ("granite_moe_3b_a800m", {"n_experts": 6})}
LAUNCHER_ARGV = ["--arch", "granite_moe_3b_a800m", "--reduced", "--mesh",
                 "1x2", "--steps", "4", "--batch", "4", "--seq", "32",
                 "--log-every", "1"]


def _cases(mesh_name):
    out = [(arch, "tp") for arch in ARCHS]
    if mesh_name == "1x4":
        out.append((WHOLE_EXPERTS, "tp"))
    return out


def rank_mixers(mesh, cases):
    """``core.mesh.launch``'s target (``test_torch_sharded_train``'s
    :func:`rank_cases`, importable from this module)."""
    return rank_cases(mesh, cases)


@pytest.fixture(scope="module")
def runs():
    inputs = {arch: _inputs(arch) for arch in ARCHS}
    for key, (arch, changes) in VARIANTS.items():
        inputs[key] = _inputs(arch, **changes)
    launcher = start_launcher_parity(LAUNCHER_ARGV, 2)
    try:
        port, ref = drive(inputs, {m: _cases(m) for m in MESHES}, MESHES,
                          "test_torch_sharded_mixers:rank_mixers")
    finally:
        launchers = launcher_runs(launcher)
    return {"port": port, "ref": ref, "launchers": launchers}


def _configs(runs, mesh_name):
    return [(runs["ref"][key]["tc"], layout)
            for key, layout in _cases(mesh_name)]


@pytest.mark.parametrize("mesh_name, key", [
    (m, key) for m in MESHES for key, _ in _cases(m)])
def test_step_is_the_references_unsharded_step(runs, mesh_name, key):
    """The sharded step's metrics, gathered gradients and params after
    one step against the reference's unsharded step."""
    ranks = port_ranks(runs["port"], mesh_name)
    i = [k for k, _ in _cases(mesh_name)].index(key)
    assert_step(ranks[0]["cases"][i], runs["ref"][key],
                f"{key} tp {mesh_name}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_replicated_leaves_are_bit_equal_and_runs_repeat(runs, mesh_name):
    """After each of two steps, the ranks that hold the same shard of a
    param or moment hold it bit for bit; the first case run twice ends
    bit-equal; every rank's metrics are the same bits."""
    assert_bits(port_ranks(runs["port"], mesh_name),
                _configs(runs, mesh_name), MESHES[mesh_name])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_a_rank_holds_its_shards_bytes(runs, mesh_name):
    """The param and AdamW moment bytes each rank holds are its shards'
    under ``param_specs``: fewer than one process's."""
    assert_bytes(port_ranks(runs["port"], mesh_name),
                 _configs(runs, mesh_name), MESHES[mesh_name])


@pytest.mark.parametrize("key, experts_cut", [
    ("granite_moe_3b_a800m", True), (WHOLE_EXPERTS, False)])
def test_experts_split_over_model_where_they_divide(runs, key,
                                                     experts_cut):
    """At 1x4 granite-moe's 8 experts are cut over ``model`` (2 a rank)
    and the variant's 6 stay whole on every rank (``param_specs``' fallback,
    the JAX package's), its ``d`` still cut over ``data``."""
    tc = runs["ref"][key]["tc"]
    specs = shard_specs(tc, _Grid({"data": 1, "model": 4}), "tp")
    for layer in specs["layers"]:
        for name, spec in layer["moe"]["experts"].items():
            assert (spec[0] == "model") == experts_cut, (key, name, spec)
            assert "data" in spec, (key, name, spec)
    assert sharding.cut_axes(specs["layers"][0]["moe"]["router"]["w"]) \
        <= {"data"}


def test_launcher_1x2_is_the_references(runs):
    """``--arch granite_moe_3b_a800m --reduced --mesh 1x2``: two gloo
    ranks (experts split over ``model``) against the reference's two
    host devices, each of the four steps' metrics within LOSS_RTOL
    (``test_torch_launch_train._assert_metrics``), ``moe_aux`` and
    ``ppl_proxy`` among them."""
    from test_torch_launch_train import _assert_metrics
    got, want = runs["launchers"]["port"], runs["launchers"]["ref"]
    assert len(got) == 4
    _assert_metrics(got, want)
