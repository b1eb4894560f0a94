"""The port's checkpoint manager (``repro_torch.checkpoint``): every case of
the reference's ``test_checkpoint.py`` (atomic saves, restore, the async
writer, retention GC, elastic restore -- here onto other devices than the
saving ones), bf16 and int32 leaves bit for bit, the async snapshot held
against an in-place update made right after ``save``, and the on-disk
layout shared with the JAX package: each restores what the other
saved. Across meshes of ranks: a ``--mesh 2x2`` training run's checkpoints
(gathered, written by rank 0) have a 1x1 run's files, shapes and dtypes,
restore bit-equal at 1x1 and in the reference, and resume at 1x2."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro_torch import tree as tree_mod
from repro_torch.checkpoint import (AsyncCheckpointer, gc, latest_step,
                                    restore, save, steps)
from repro_torch.models import init_params
from repro_torch.optim import adamw

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.tensor(rng.standard_normal((4, 8)).astype(np.float32)),
            "nested": {"b": torch.arange(10), "c": torch.tensor(1.5)}}


_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(x):
    """Floats as their bits, so NaN payloads and -0.0 compare too."""
    return x.view(_BITS[x.element_size()]) if x.is_floating_point() else x


def _assert_trees_equal(got, want):
    assert [p for p, _ in tree_mod.paths(got)] == [
        p for p, _ in tree_mod.paths(want)]
    for a, b in zip(tree_mod.leaves(got), tree_mod.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 7, t)
    got, step = restore(str(tmp_path), target=t)
    assert step == 7
    _assert_trees_equal(got, t)


def test_latest_and_gc(tmp_path):
    t = _tree()
    for s in (1, 5, 9, 13):
        save(str(tmp_path), s, t)
    assert latest_step(str(tmp_path)) == 13
    removed = gc(str(tmp_path), keep_last=2)
    assert removed == [1, 5]
    assert steps(str(tmp_path)) == [9, 13]


def test_incomplete_checkpoint_ignored(tmp_path):
    t = _tree()
    save(str(tmp_path), 3, t)
    # simulate a crashed write: step dir without COMMIT
    bad = tmp_path / "step_00000009"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) == 3
    got, step = restore(str(tmp_path), target=t)
    assert step == 3
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), step=9, target=t)


def test_async_checkpointer(tmp_path):
    t = _tree()
    ck = AsyncCheckpointer(str(tmp_path), keep_last=2)
    for s in range(1, 6):
        ck.save(s, tree_mod.map(lambda x: x + s, t))
    ck.wait()
    assert steps(str(tmp_path)) == [4, 5]
    got, _ = restore(str(tmp_path), target=t)
    np.testing.assert_allclose(got["a"].numpy(), t["a"].numpy() + 5)
    ck.close()
    assert not ck._thread.is_alive()


def test_async_snapshot_is_taken_at_save(tmp_path):
    """``save`` copies the tree before it returns: an in-place update made
    right after it (as the train step makes) does not reach the file, even
    on the CPU, where ``tensor.to("cpu")`` is the tensor itself."""
    t = {"w": torch.arange(1 << 16, dtype=torch.float32),
         "step": torch.zeros((), dtype=torch.int32)}
    want = tree_mod.map(lambda x: x.clone(), t)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, t)
    t["w"].mul_(-1.0)
    t["step"].add_(1)
    ck.wait()
    ck.close()
    got, _ = restore(str(tmp_path), target=t)
    _assert_trees_equal(got, want)


def test_async_errors_surface_on_the_next_call(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, _tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.close()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int32,
                                   torch.float16, torch.int8, torch.bool])
def test_leaves_round_trip_bit_for_bit(tmp_path, dtype):
    """bf16 leaves go to disk as their int16 bits (numpy has no bfloat16
    without ml_dtypes), every leaf's dtype in tree.json: NaN payloads,
    -0.0, infinities and subnormals come back as they left."""
    rng = np.random.default_rng(4)
    bits = rng.integers(-2 ** 15, 2 ** 15, (33, 7)).astype(np.int16)
    if dtype == torch.bfloat16:
        x = torch.from_numpy(bits).view(torch.bfloat16)
        x[0, :4] = torch.tensor([-0.0, float("inf"), float("-inf"), 1e-40])
    elif dtype == torch.float16:
        x = torch.from_numpy(bits).view(torch.float16)
    elif dtype == torch.bool:
        x = torch.from_numpy(bits > 0)
    else:
        x = torch.from_numpy(bits.astype(np.int64)).to(dtype)
    t = {"params": [{"w": x, "b": torch.ones(3)}],
         "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    save(str(tmp_path), 2, t)
    meta = json.loads((tmp_path / "step_00000002" / "tree.json").read_text())
    assert meta["dtypes"] == ["int32", "float32", str(dtype)[6:]]
    assert meta["treedef"] == ["opt/step", "params/0/b", "params/0/w"]
    got, _ = restore(str(tmp_path), target=t)
    _assert_trees_equal(got, t)


def test_elastic_restore_onto_other_devices(tmp_path):
    """The checkpoint is device-agnostic: ``restore`` places each leaf on
    its target leaf's device, or where ``shardings`` says (one device or a
    tree); a target of meta tensors gives structure, shapes and dtypes
    only. Shapes and dtypes that differ from the target's raise."""
    t = {"w": torch.arange(32.0), "k": torch.arange(4, dtype=torch.int32)}
    save(str(tmp_path), 1, t)
    meta_target = tree_mod.map(lambda x: torch.empty_like(x, device="meta"),
                               t)
    for shardings in ("cpu", {"w": "cpu", "k": torch.device("cpu")}):
        got, step = restore(str(tmp_path), target=meta_target,
                            shardings=shardings)
        assert step == 1 and got["w"].device.type == "cpu"
        _assert_trees_equal(got, t)
    with pytest.raises(ValueError):
        restore(str(tmp_path), target=meta_target)
    with pytest.raises(ValueError):
        restore(str(tmp_path), target={"w": torch.arange(31.0),
                                       "k": t["k"]})
    with pytest.raises(ValueError):
        restore(str(tmp_path), target={"w": t["w"].double(), "k": t["k"]})
    with pytest.raises(ValueError):
        restore(str(tmp_path), target={"w": t["w"]})


def test_the_layout_is_the_references(tmp_path):
    """The port restores the JAX package's checkpoint, bf16 leaves (which
    numpy writes as 2-byte void) bit for bit, and the JAX package the
    port's, bf16 leaves as their int16 bits: the same file names,
    ``leaf_<i>`` in the same (sorted-key) order, COMMIT last."""
    rng = np.random.default_rng(1)
    bits = rng.integers(-2 ** 15, 2 ** 15, (4, 3)).astype(np.int16)
    arrays = {"z": rng.standard_normal((3, 5)).astype(np.float32),
              "a": {"i": np.arange(6, dtype=np.int32),
                    "f": np.float32(2.5) * np.ones((2,), np.float32)}}
    jtree = jax.tree.map(jnp.asarray, arrays)
    jtree["h"] = jax.lax.bitcast_convert_type(jnp.asarray(bits),
                                              jnp.bfloat16)
    ttree = tree_mod.map(lambda a: torch.from_numpy(np.array(a)), arrays)
    ttree["h"] = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    jcheckpoint.save(str(tmp_path / "ref"), 4, jtree)
    got, step = restore(str(tmp_path / "ref"), target=ttree)
    assert step == 4
    _assert_trees_equal(got, ttree)
    save(str(tmp_path / "port"), 5, ttree)
    back, step = jcheckpoint.restore(str(tmp_path / "port"), target=jtree)
    assert step == 5
    assert back["h"].dtype == jnp.int16
    np.testing.assert_array_equal(np.asarray(back["h"]), bits)
    back["h"] = jtree["h"]
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), back, jtree)
    assert sorted(os.listdir(tmp_path / "port" / "step_00000005")) == \
        sorted(os.listdir(tmp_path / "ref" / "step_00000004"))


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_ARGS = ["--arch", "llama3_8b", "--reduced", "--batch", "4", "--seq",
             "32", "--log-every", "1", "--device", "cpu"]
# one process under PYTHONHASHSEED 0 (every run draws the same batches),
# the config in f32 (the ranks take the parent's), one thread a rank:
# a 2x2 run of four steps checkpointing at 2 and 4; its step-2 checkpoint
# resumed at 1x2; a 2x2 run of no steps (its checkpoint: the initial
# state, gathered from the 2x2 shards) resumed at 1x2 for four steps
# beside an uninterrupted 1x2 run; a 1x1 run of one step
MESH_CKPT_SCRIPT = textwrap.dedent("""
    import dataclasses, json, shutil, sys
    from repro_torch.launch import train
    build = train.build_cfg
    train.build_cfg = lambda args: dataclasses.replace(build(args),
                                                       dtype="float32")
    argv, root = json.loads(sys.argv[1]), sys.argv[2]

    def run(name, *extra, ckpt=True):
        more = ["--ckpt-dir", f"{root}/{name}"] if ckpt else []
        return train.main(argv + list(extra) + more)

    if __name__ == "__main__":
        out = {"2x2": run("m22", "--mesh", "2x2", "--steps", "4",
                          "--ckpt-every", "2")}
        shutil.copytree(f"{root}/m22/step_00000002",
                        f"{root}/resumed/step_00000002")
        out["resumed"] = run("resumed", "--mesh", "1x2", "--steps", "4")
        run("init", "--mesh", "2x2", "--steps", "0")
        shutil.copytree(f"{root}/init/step_00000000",
                        f"{root}/from_init/step_00000000")
        out["from_init"] = run("from_init", "--mesh", "1x2", "--steps", "4")
        out["whole"] = run("whole", "--mesh", "1x2", "--steps", "4",
                           ckpt=False)
        run("one", "--steps", "1")
        print("RUNS " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_ckpt")
    env = {**os.environ, "PYTHONPATH": "src", "PYTHONHASHSEED": "0",
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", MESH_CKPT_SCRIPT,
                        json.dumps(MESH_ARGS), str(root)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert "RUNS " in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return root, json.loads(r.stdout.split("RUNS ")[1])


def _llama_state():
    from repro_torch import configs
    params = init_params(0, configs.get_reduced("llama3_8b"), "cpu")
    return params, adamw.init(params)


def test_a_2x2_checkpoint_has_the_1x1_layout(mesh_runs):
    """The files of a 2x2 run's checkpoint, its leaves' paths, shapes and
    dtypes are a 1x1 run's."""
    root, _ = mesh_runs
    a, b = root / "m22" / "step_00000004", root / "one" / "step_00000001"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    ma, mb = (json.loads((d / "tree.json").read_text()) for d in (a, b))
    assert (ma["treedef"], ma["dtypes"], ma["n_leaves"]) == (
        mb["treedef"], mb["dtypes"], mb["n_leaves"])
    with np.load(a / "arrays.npz") as x, np.load(b / "arrays.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert (x[k].shape, x[k].dtype) == (y[k].shape, y[k].dtype), k


def test_a_2x2_checkpoint_restores_at_1x1_and_in_the_reference(mesh_runs):
    """The 2x2 run's checkpoint restores at 1x1 and in the reference
    (``repro.checkpoint.restore``, the port's tree as structure donor)
    bit for bit alike; the checkpoint of no steps, gathered from the 2x2
    shards, is the initial state bit for bit."""
    root, _ = mesh_runs
    target = _llama_state()
    got, step = restore(str(root / "m22"), target=target)
    back, jstep = jcheckpoint.restore(str(root / "m22"), target=target)
    assert step == jstep == 4
    for a, b in zip(tree_mod.leaves(got), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype
    init, step = restore(str(root / "init"), target=target)
    assert step == 0
    _assert_trees_equal(init, target)


def test_a_2x2_checkpoint_resumes_at_1x2(mesh_runs):
    """The 2x2 run's step-2 checkpoint resumed at 1x2: steps 2 and 3
    within LOSS_RTOL of the 2x2 run's own (the two meshes round their
    sums apart); the initial state gathered from 2x2 shards and resumed
    at 1x2 gives an uninterrupted 1x2 run's four steps bit for bit."""
    from _train_rules import LOSS_RTOL
    _, runs = mesh_runs
    resumed, whole22 = runs["resumed"], runs["2x2"]
    assert [m["step"] for m in resumed] == [2, 3]
    for a, b in zip(resumed, whole22[2:]):
        for k in ("loss", "ce", "z_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL)
    assert len(runs["whole"]) == 4
    assert runs["from_init"] == runs["whole"]
