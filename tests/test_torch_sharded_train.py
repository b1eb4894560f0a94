"""The port's train step on a (data, model) mesh of gloo ranks on the CPU
(``train_step.mesh_train_step``, ``models.sharding``): tensor and
sequence parallelism over ``model`` with FSDP over ``data`` (layout
"tp"), and ZeRO-3 over both axes (layout "fsdp").

* Against the reference's unsharded step from the same params and batch
  (``interop``): at 1x2, 2x2 and 1x4 under "tp" for llama3, granite-34b
  (MQA: its one kv head's columns split inside the head), gemma3 (local
  windows, q / k norms, post-norms) and qwen2-vl (M-RoPE), and at 2x2
  under "fsdp" for every family (MoE, SSD and RG-LRU among them): the
  step's metrics within LOSS_RTOL, ``ppl_proxy`` among them (exp of the
  global batch's ce, as the reference's global step takes it, also where
  the batch is split), every gradient (gathered from the shards) within 2
  GRAD_RTOL of its leaf's largest, the params after one step under the
  first-step rule at that gradient tolerance (``_train_rules``). The
  reference's gradients are read back from its first moment after the
  step (m = 0.1 g, g clipped: one multiply each way, within two ulps), so
  one compile per config serves both.
* Bit-stability: after each of two steps every leaf of params and
  moments is bit-equal on the ranks that hold the same shard of it, and
  two runs end bit-equal.
* Memory: the param and moment bytes a rank holds are its shards' under
  ``param_specs``.
* The launcher: ``repro.launch.train --mesh 2x2`` (JAX on four forced
  host devices) against ``repro_torch.launch.train --mesh 2x2`` (four
  gloo ranks) from the same state on the same batches, every step's
  metrics within LOSS_RTOL.

All cases of one mesh run in one ``core.mesh.launch``, beside the
reference's compiles on a thread of their own; the reference launcher
runs as a subprocess alongside. ``test_torch_sharded_mixers.py`` drives
the MoE, SSD and RG-LRU families through the same helpers
(:func:`drive`, :func:`assert_step`, :func:`assert_bits`,
:func:`assert_bytes`)."""
import hashlib
import json
import os
import subprocess
import sys
import textwrap
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from _lm_parity import to_numpy
from _train_parity import batch, cfgs, port_batch, reference_step
from _train_rules import (GRAD_RTOL, LOSS_RTOL, assert_first_step,
                          assert_grads)
from repro.models import init_params as jinit_params
from repro.train import train_step as jtrain_step
from repro_torch import configs, interop
from repro_torch import tree as tree_mod
from repro_torch.core.mesh import launch
from repro_torch.models import sharding
from repro_torch.models.model import shard_specs
from repro_torch.optim import adamw
from repro_torch.train import TrainConfig, train_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
TP_ARCHS = ("llama3_8b", "granite_34b", "gemma3_27b", "qwen2_vl_2b")
FSDP_ARCHS = tuple(configs.ARCH_IDS)
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
STEP_KW = dict(remat="full", loss_chunk=8, warmup_steps=0, peak_lr=1e-3)


def _cases(mesh_name):
    out = [(arch, "tp") for arch in TP_ARCHS]
    if mesh_name == "2x2":
        out += [(arch, "fsdp") for arch in FSDP_ARCHS]
    return out


def _digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


def _case(mesh, cfg, layout, params, b, steps):
    """One case on this rank: the synced gradients and the params after
    the first step gathered (rank 0), and each step's metrics, leaf
    digests and held bytes."""
    tc = TrainConfig(**STEP_KW)
    specs = shard_specs(cfg, mesh, layout)
    paths = sharding.spec_leaves(specs)
    shards = sharding.shard(params, specs, mesh)
    with sharding.set_mesh(mesh, layout):
        rows = sharding.batch_rows(B, tc.microbatches)
        mine = {k: v[rows] for k, v in b.items()}
        (_, _), grads = train_step.value_and_grad(
            shards, mine["tokens"], mine["labels"], cfg, tc)
        grads, _ = train_step._mesh_sync(paths, mesh, layout)(grads, {})
        grads = sharding.unshard(tree_mod.unflatten(shards, grads), specs,
                                 mesh)
    opt = adamw.init(shards)
    step = train_step.mesh_train_step(cfg, tc, mesh, layout)
    out = {"metrics": [], "digests": [], "grads": None, "params": None,
           "bytes": sum(x.nbytes for x in tree_mod.leaves(
               (shards, opt["m"], opt["v"])))}
    for i in range(steps):
        shards, opt, m = step(shards, opt, mine, i)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["digests"].append([_digest(x) for x in tree_mod.leaves(
            (shards, opt["m"], opt["v"]))])
        if i == 0:
            full = sharding.unshard(shards, specs, mesh)
            if mesh.rank == 0:
                out["params"] = [x.clone().numpy()
                                 for x in tree_mod.leaves(full)]
    if mesh.rank == 0:
        out["grads"] = [x.numpy() for x in tree_mod.leaves(grads)]
    return out


def rank_cases(mesh, cases):
    """``core.mesh.launch``'s target: every case of one mesh, in order;
    the first case runs twice (two runs must end bit-equal)."""
    torch.set_num_threads(1)
    out = [_case(mesh, cfg, layout, params, b, 2)
           for cfg, layout, params, b in cases]
    cfg, layout, params, b = cases[0]
    out.append(_case(mesh, cfg, layout, params, b, 2))
    return {"coords": mesh.coords, "cases": out}


def _inputs(arch, **changes):
    jc, tc = cfgs(arch, **changes)
    jparams = jinit_params(jax.random.PRNGKey(0), jc)
    b = batch(tc, batch_size=B)
    return jc, tc, jparams, b


def drive(inputs, cases, meshes, target):
    """Each mesh's launch of ``target`` (a thread each) on its cases
    (``cases[mesh]``: (key of ``inputs``, layout) pairs; ``inputs[key]``
    is :func:`_inputs`' tuple) beside the reference's unsharded step of
    every key (compiled on a thread each). Returns (port, ref): each
    mesh's ranks' results (or the exception, raised in the test that
    reads it) and each key's reference step."""
    port = {}

    def run(name, shape):
        mine = [(inputs[key][1], layout,
                 interop.model_params(to_numpy(inputs[key][2]),
                                      inputs[key][1], "cpu"),
                 port_batch(inputs[key][3]))
                for key, layout in cases[name]]
        try:
            port[name] = launch(
                target, shape[0] * shape[1], (mine,),
                axis_name=("data", "model"), shape=shape, device="cpu",
                timeout=600)
        except Exception as e:   # raised in the test that reads it
            port[name] = e

    threads = [threading.Thread(target=run, args=item)
               for item in meshes.items()]
    for thread in threads:
        thread.start()
    jtc = jtrain_step.TrainConfig(**STEP_KW)

    def reference(key):
        jc, tc, jparams, b = inputs[key]
        params, opt, metrics = reference_step(jc, jtc, jparams, b)
        clip = min(1.0, 1.0 / metrics["grad_norm"])
        grads = [torch.from_numpy((m.double() / (0.1 * clip)).float()
                                  .numpy())
                 for m in tree_mod.leaves(interop.model_params(
                     opt["m"], tc, "cpu"))]
        return {"p0": tree_mod.leaves(interop.model_params(
                    to_numpy(jparams), tc, "cpu")),
                "grads": grads, "metrics": metrics, "clip": clip,
                "params": tree_mod.leaves(interop.model_params(
                    params, tc, "cpu")), "tc": tc}

    try:
        # XLA compiles outside the GIL: one thread a config
        with ThreadPoolExecutor(len(inputs)) as pool:
            ref = dict(zip(inputs, pool.map(reference, inputs)))
    finally:
        for thread in threads:
            thread.join()
    return port, ref


@pytest.fixture(scope="module")
def runs():
    """Every mesh's launch beside the reference's compiles
    (:func:`drive`) and its ``--mesh 2x2`` launcher run (a
    subprocess)."""
    archs = sorted(set(TP_ARCHS) | set(FSDP_ARCHS))
    inputs = {arch: _inputs(arch) for arch in archs}
    launcher = start_launcher_parity(LAUNCHER_ARGV, 4)
    try:
        port, ref = drive(inputs, {m: _cases(m) for m in MESHES}, MESHES,
                          "test_torch_sharded_train:rank_cases")
    finally:
        launchers = launcher_runs(launcher)
    return {"port": port, "ref": ref, "launchers": launchers}


def port_ranks(port, mesh_name):
    """One mesh's ranks' results, or its launch's exception raised."""
    got = port[mesh_name]
    if isinstance(got, Exception):
        raise got
    return got


def _port(runs, mesh_name):
    return port_ranks(runs["port"], mesh_name)


@pytest.mark.parametrize("mesh_name, arch, layout", [
    (m, a, layout) for m in MESHES for a, layout in _cases(m)])
def test_step_is_the_references_unsharded_step(runs, mesh_name, arch,
                                                layout):
    """The sharded step's metrics, gathered gradients and params after
    one step against the reference's unsharded step."""
    ranks = _port(runs, mesh_name)
    i = _cases(mesh_name).index((arch, layout))
    assert_step(ranks[0]["cases"][i], runs["ref"][arch],
                f"{arch} {layout} {mesh_name}")


def assert_step(got, ref, label):
    """One case's first step (rank 0's :func:`_case`) against the
    reference's unsharded step: every metric within LOSS_RTOL, every
    gathered gradient within 2 GRAD_RTOL of its leaf's largest, the
    params under the first-step rule."""
    m = got["metrics"][0]
    assert m.keys() == ref["metrics"].keys(), label
    for k, v in m.items():
        np.testing.assert_allclose(v, ref["metrics"][k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=f"{label} {k}")
    assert_grads([torch.from_numpy(g) for g in got["grads"]], ref["grads"],
                 label, rtol=2 * GRAD_RTOL)
    assert_first_step(ref["p0"], [torch.from_numpy(p)
                                  for p in got["params"]],
                      ref["params"], ref["grads"], ref["metrics"]["lr"],
                      ref["clip"], label, grad_rtol=2 * GRAD_RTOL)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_replicated_leaves_are_bit_equal_and_runs_repeat(runs, mesh_name):
    """After each of two steps, the ranks that hold the same shard of a
    param or moment (their coordinates equal on the axes it is cut over)
    hold it bit for bit; the first case run twice ends bit-equal; every
    rank's metrics are the same bits."""
    assert_bits(_port(runs, mesh_name), [
        (runs["ref"][arch]["tc"], layout) for arch, layout in
        _cases(mesh_name)], MESHES[mesh_name])


def assert_bits(ranks, cases, mesh_shape):
    """The check above on the ranks of one launch, ``cases`` its
    (config, layout) pairs in order."""
    shape = dict(zip(("data", "model"), mesh_shape))
    for i, (tc, layout) in enumerate(cases):
        arch = tc.name
        specs = sharding.spec_leaves(
            shard_specs(tc, _Grid(shape), layout)) * 3   # params, m, v
        for step in range(2):
            for j, spec in enumerate(specs):
                held = sharding.cut_axes(spec)
                seen = {}
                for r in ranks:
                    key = tuple(r["coords"][a] for a in sorted(held))
                    d = r["cases"][i]["digests"][step][j]
                    assert seen.setdefault(key, d) == d, (
                        arch, layout, mesh_shape, step, j)
            metrics = {json.dumps(r["cases"][i]["metrics"][step],
                                  sort_keys=True) for r in ranks}
            assert len(metrics) == 1, (arch, layout, step)
    for r in ranks:
        assert r["cases"][-1]["digests"] == r["cases"][0]["digests"]


class _Grid:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = shape


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_a_rank_holds_its_shards_bytes(runs, mesh_name):
    """The param and AdamW moment bytes each rank holds: three times the
    sum over leaves of the leaf's bytes over the ranks it is cut over."""
    assert_bytes(_port(runs, mesh_name), [
        (runs["ref"][arch]["tc"], layout) for arch, layout in
        _cases(mesh_name)], MESHES[mesh_name])


def assert_bytes(ranks, cases, mesh_shape):
    """The check above on the ranks of one launch, ``cases`` its
    (config, layout) pairs in order."""
    shape = dict(zip(("data", "model"), mesh_shape))
    for i, (tc, layout) in enumerate(cases):
        arch = tc.name
        want = 0
        from repro_torch.models import param_spec
        full = tree_mod.leaves(param_spec(tc))
        specs = sharding.spec_leaves(shard_specs(tc, _Grid(shape), layout))
        for x, spec in zip(full, specs):
            ways = 1
            for a in sharding.cut_axes(spec):
                ways *= shape[a]
            want += 3 * x.numel() * x.element_size() // ways
        whole = 3 * sum(x.numel() * x.element_size() for x in full)
        for r in ranks:
            assert r["cases"][i]["bytes"] == want, (arch, layout, mesh_shape)
        if layout == "fsdp" or shape["data"] * shape["model"] > 1:
            assert want < whole, (arch, layout, mesh_shape)


# both launchers in one process under PYTHONHASHSEED 0 (the same bigram
# batches), both configs in f32, JAX on as many forced host devices as
# the mesh has: the reference's --mesh run, then the port's from the
# reference's initial state carried across (``main``'s ``state=``)
LAUNCHER_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import jax
    import torch
    torch.set_num_threads(1)
    from _lm_parity import to_numpy
    from repro.launch import train as jtrain
    from repro.models import init_params as jinit_params
    from repro.optim import adamw as jadamw
    from repro_torch import interop
    from repro_torch.launch import train

    for mod in (train, jtrain):
        build = mod.build_cfg
        mod.build_cfg = lambda args, build=build: dataclasses.replace(
            build(args), dtype="float32")
    argv = json.loads(sys.argv[1])
    want = jtrain.main(argv)
    jc = jtrain.build_cfg(jtrain.parse_args(argv))
    jparams = jinit_params(jax.random.PRNGKey(0), jc)
    tc = train.build_cfg(train.parse_args(argv))
    state = (interop.model_params(to_numpy(jparams), tc, "cpu"),
             interop.opt_state(to_numpy(jadamw.init(jparams)), tc, "cpu"))
    got = train.main(argv + ["--device", "cpu"], state=state)
    print("LAUNCHERS " + json.dumps({"port": got, "ref": want}))
""")
LAUNCHER_ARGV = ["--arch", "llama3_8b", "--reduced", "--mesh", "2x2",
                 "--steps", "4", "--batch", "4", "--seq", "32",
                 "--log-every", "1"]


def start_launcher_parity(argv, devices):
    """Both launchers on ``argv`` (:data:`LAUNCHER_SCRIPT`), JAX on
    ``devices`` forced host devices: a subprocess, read by
    :func:`launcher_runs`."""
    env = {**os.environ, "PYTHONPATH": "src" + os.pathsep + "tests",
           "PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "1",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    return subprocess.Popen([sys.executable, "-c", LAUNCHER_SCRIPT,
                             json.dumps(argv)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def launcher_runs(proc):
    """{"port": its metrics log, "ref": the reference's}."""
    out, err = proc.communicate(timeout=600)
    assert "LAUNCHERS " in out, out[-2000:] + err[-3000:]
    return json.loads(out.split("LAUNCHERS ")[1])


def test_launcher_2x2_is_the_references(runs):
    """``--mesh 2x2``: four gloo ranks against the reference's four host
    devices, each of the four steps' metrics within LOSS_RTOL
    (``test_torch_launch_train._assert_metrics``), ``ppl_proxy`` among
    them: exp of the global batch's ce on both sides."""
    from test_torch_launch_train import _assert_metrics
    got, want = runs["launchers"]["port"], runs["launchers"]["ref"]
    assert len(got) == 4
    _assert_metrics(got, want)
