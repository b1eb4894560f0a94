"""The port's training launcher (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``): ``build_cfg`` equal for
``--reduced``, ``--width`` and ``--layers``; both launchers run five steps
of a reduced config in f32 from the same initial state (the reference's
params and AdamW state carried across with ``interop``, through
``main``'s ``state=``) on the same bigram batches (one process under one
hash seed), and each step's metrics are held to ``_train_rules``'
LOSS_RTOL; with ``--data-selection coreset`` the selected token rows and
their labels equal the reference's, but for a centre's tied nearest
example. ``--mesh 2x1`` (two gloo ranks) computes what one process
computes with two microbatches on the same global batch but
``ppl_proxy``, and matches the plain ``1x1`` run's metrics within
LOSS_RTOL, ``ppl_proxy`` among them (exp of the global batch's ce, as the
reference's global step takes it); a mesh the port cannot run raises
before any rank starts, naming the width that does not split (``--mesh
DxM`` with M > 1 runs: ``test_torch_sharded_train.py`` and
``test_torch_sharded_mixers.py``)."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _train_rules import LOSS_RTOL
from repro.launch import train as jtrain
from repro_torch import tree as tree_mod
from repro_torch.checkpoint import restore
from repro_torch.data import BigramLM
from repro_torch.launch import train
from repro_torch.models import init_params
from repro_torch.optim import adamw

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--arch", "llama3_8b", "--reduced", "--steps", "5", "--batch", "4",
        "--seq", "32", "--log-every", "1"]
# the metrics but ppl_proxy, which is exp(min(ce, 20)) of each
# microbatch's ce averaged over the microbatches: one exp of the global
# ce on D data ranks (as on one process with one microbatch, and in the
# reference's global step), the mean of two exps with two microbatches
LOSS_METRICS = ("loss", "ce", "z_loss", "moe_aux", "grad_norm", "lr")


@pytest.mark.parametrize("argv", [
    ["--arch", "llama3_8b", "--reduced"],
    ["--arch", "mamba2_370m", "--reduced", "--layers", "3"],
    ["--arch", "recurrentgemma_2b", "--width", "256"],
    ["--arch", "gemma3_27b", "--reduced", "--width", "128", "--layers", "2"],
    ["--arch", "mamba2_370m"],
])
def test_build_cfg_is_the_references(argv):
    got = train.build_cfg(train.parse_args(argv))
    want = jtrain.build_cfg(jtrain.parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_parse_args_has_the_references_options():
    got, want = vars(train.parse_args([])), vars(jtrain.parse_args([]))
    assert set(got) == set(want) | {"device"}
    assert {k: got[k] for k in want} == want and got["device"] == "cuda"


# both launchers in one process under PYTHONHASHSEED 0, so that the bigram
# pool and batches are the same on every run of the test (Python salts
# the string hash ``BigramLM`` keys on per process), both configs in f32:
# five steps of each launcher with and without the coreset selection, from
# the reference's initial state carried across (``main``'s ``state=``);
# the selections, embeddings and batches the launchers made, and the port's
# centres recomputed as ``selection._local_solves`` makes them
PARITY_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, numpy as np, torch
    torch.set_num_threads(1)
    from _lm_parity import to_numpy
    from repro.launch import train as jtrain
    from repro.models import init_params as jinit_params
    from repro.optim import adamw as jadamw
    from repro_torch import interop
    from repro_torch.core import backend, clustering, objective, prng
    from repro_torch.launch import train

    seen = {"port": {}, "ref": {}}
    for mod, side in ((train, "port"), (jtrain, "ref")):
        build = mod.build_cfg
        mod.build_cfg = lambda args, build=build: dataclasses.replace(
            build(args), dtype="float32")
        for name in ("select_coreset", "embed_examples", "_coreset_pool"):
            def spy(*a, real=getattr(mod, name), side=side, name=name,
                    **kw):
                seen[side][name] = out = real(*a, **kw)
                return out
            setattr(mod, name, spy)

    argv0 = json.loads(sys.argv[1])
    out = {}
    for selection in ("none", "coreset"):
        argv = argv0 + ["--data-selection", selection]
        want = jtrain.main(argv)
        jc = jtrain.build_cfg(jtrain.parse_args(argv))
        jparams = jinit_params(jax.random.PRNGKey(0), jc)
        tc = train.build_cfg(train.parse_args(argv))
        state = (interop.model_params(to_numpy(jparams), tc, "cpu"),
                 interop.opt_state(to_numpy(jadamw.init(jparams)), tc,
                                   "cpu"))
        out[selection] = {"port": train.main(argv + ["--device", "cpu"],
                                             state=state),
                          "ref": want}
    port, ref = seen["port"], seen["ref"]
    emb = port["embed_examples"]
    S, M, _ = emb.shape
    w = torch.ones((S, M))
    keys = prng.split(prng.PRNGKey(1, device="cpu"), 2 * S).reshape(S, 2, 2)
    obj = objective.get_objective("kmeans")
    b = backend.get_backend(None, emb.device)
    c = clustering._kmeans_pp_init(keys[:, 0], emb, w, 8, obj, b)
    c, _ = clustering._lloyd(emb, c, w, 5, obj, b)
    sel, jsel = port["select_coreset"], ref["select_coreset"]
    out["selection"] = {
        "t_i": [sel.t_i.tolist(), np.asarray(jsel.t_i).tolist()],
        "indices": [sel.indices.tolist(), np.asarray(jsel.indices).tolist()],
        "weights": [sel.weights.tolist(), np.asarray(jsel.weights).tolist()],
        "centre_d2": clustering.pairwise_sq_dists(c, emb,
                                                  device="cpu").tolist(),
        "embeddings": float(np.abs(np.asarray(ref["embed_examples"])
                                   - emb.numpy()).max()),
        "batches": [[{k: v.tolist() for k, v in bt.items()}
                     for bt in port["_coreset_pool"]],
                    [{k: np.asarray(v).tolist() for k, v in bt.items()}
                     for bt in ref["_coreset_pool"]]]}
    print("PARITY " + json.dumps(out))
""")
# a centre's nearest example may be a tie: a cluster of two has its centre
# at their midpoint, and rounding picks either (in either package); the two
# squared distances must then agree to this share of their size
TIE_RTOL = 1e-5


@pytest.fixture(scope="module")
def parity():
    env = {**os.environ, "PYTHONPATH": "src" + os.pathsep + "tests",
           "PYTHONHASHSEED": "0"}
    r = subprocess.run([sys.executable, "-c", PARITY_SCRIPT,
                        json.dumps(ARGS)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    assert "PARITY " in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.split("PARITY ")[1])


def _assert_metrics(got, want, keys=None):
    """Each step's metrics within LOSS_RTOL (``ppl_proxy`` = exp(ce)
    within LOSS_RTOL x ce: exp turns ce's relative error into an absolute
    one of ce's size)."""
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in keys or g:
            rtol = LOSS_RTOL * (max(w["ce"], 1.0) if k == "ppl_proxy"
                                else 1.0)
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-7,
                                       err_msg=f"step {g['step']} {k}")


@pytest.mark.parametrize("selection", ["none", "coreset"])
def test_five_steps_are_the_references(parity, selection):
    """Both launchers' five steps from the same state on the same batches
    (with the coreset: the selection's batches, equal in both launchers
    under this hash seed, the test below holding them)."""
    got, want = parity[selection]["port"], parity[selection]["ref"]
    assert len(got) == 5
    if selection == "coreset":
        mine, theirs = parity["selection"]["batches"]
        assert mine[:5] == theirs[:5]
    _assert_metrics(got, want)


def test_coreset_selection_is_the_references(parity):
    """The launcher's selection against the reference's: t_i, every
    sampled slot's index exactly and its weight to 1e-5; every centre
    slot's example exactly, or at a tie of the centre's two nearest
    examples (TIE_RTOL); the selected token rows and their labels, batch
    by batch, equal the reference's but for rows from tied slots (the
    port gathers the labels by the selected indices, the reference looks
    them up by the tokens)."""
    sel = parity["selection"]
    assert sel["embeddings"] <= 1e-6
    assert sel["t_i"][0] == sel["t_i"][1]
    (idx, jidx), (w, jw) = (np.asarray(x) for x in sel["indices"]), (
        np.asarray(x) for x in sel["weights"])
    d2 = np.asarray(sel["centre_d2"])                   # (S, k, M)
    k = d2.shape[1]
    t_buffer = idx.shape[1] - k
    np.testing.assert_array_equal(idx[:, :t_buffer], jidx[:, :t_buffer])
    np.testing.assert_allclose(w, jw, rtol=1e-5, atol=1e-5)
    # the recomputed centres pick the port's centre examples
    np.testing.assert_array_equal(d2.argmin(-1), idx[:, t_buffer:])
    tied = set()
    for s, j in np.argwhere(idx != jidx):
        a, b = d2[s, j - t_buffer, idx[s, j]], d2[s, j - t_buffer, jidx[s, j]]
        assert abs(a - b) <= TIE_RTOL * max(a, b), (s, j, a, b)
        tied.add((s, j))
    # rows in slot order, site by site, where the weight is positive
    rows = [(s, j) for s in range(idx.shape[0]) for j in range(idx.shape[1])
            if w[s, j] > 0]
    mine, theirs = sel["batches"]
    assert len(mine) == len(theirs) >= 5
    B = len(mine[0]["tokens"])
    for i, (g, t) in enumerate(zip(mine, theirs)):
        for r in range(B):
            if rows[i * B + r] in tied:
                continue
            assert g["tokens"][r] == t["tokens"][r], (i, r)
            assert g["labels"][r] == t["labels"][r], (i, r)


# one process under PYTHONHASHSEED 0 (the ranks' seed, so every run draws
# the same batches), the config in f32 for all three runs: the ranks get
# the parent's config
MESH_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.launch import train
    build = train.build_cfg
    train.build_cfg = lambda args: dataclasses.replace(build(args),
                                                       dtype="float32")
    argv, root = json.loads(sys.argv[1]), sys.argv[2]
    out = {}
    for name, extra in (("mesh2", ["--mesh", "2x1"]),
                        ("mb2", ["--microbatches", "2"]), ("one", [])):
        out[name] = train.main(argv + ["--ckpt-dir", f"{root}/{name}"]
                               + extra)
    print("RUNS " + json.dumps(out))
""")


def _final(ckpt):
    from repro_torch import configs
    cfg = configs.get_reduced("llama3_8b")
    params = init_params(0, cfg, "cpu")
    tree, step = restore(str(ckpt), target=(params, adamw.init(params)))
    assert step == 5
    return tree_mod.leaves(tree)


def test_mesh_2x1_matches_1x1(tmp_path):
    """Two gloo ranks, each on two of the four rows, gradients averaged
    before the update: the same as one process with two microbatches on
    the same global batch (metrics but ``ppl_proxy`` within LOSS_RTOL,
    params after five steps to a few ulp), and the metrics of the plain
    1x1 run within LOSS_RTOL, ``ppl_proxy`` among them."""
    env = {**os.environ, "PYTHONPATH": "src", "PYTHONHASHSEED": "0"}
    r = subprocess.run([sys.executable, "-c", MESH_SCRIPT,
                        json.dumps(ARGS + ["--device", "cpu"]),
                        str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert "RUNS " in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    runs = json.loads(r.stdout.split("RUNS ")[1])
    _assert_metrics(runs["mesh2"], runs["mb2"], LOSS_METRICS)
    _assert_metrics(runs["mesh2"], runs["one"],
                    LOSS_METRICS + ("ppl_proxy",))
    for a, b in zip(_final(tmp_path / "mesh2"), _final(tmp_path / "mb2")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("argv, match", [
    # a width that does not split over the model axis is named: the SSD
    # heads, the RG-LRU width, the sequence (granite-moe's 4 attention
    # heads over 3 run, each rank running every head: its 32 tokens do
    # not split)
    (["--arch", "mamba2_370m", "--mesh", "1x3"], "ssm_nheads 8"),
    (["--arch", "recurrentgemma_2b", "--width", "42", "--mesh", "1x4"],
     "lru_width 42"),
    (["--arch", "dbrx_132b", "--mesh", "1x4", "--seq", "30"],
     "sequence 30"),
    (["--arch", "granite_moe_3b_a800m", "--mesh", "1x3"], "sequence 32"),
    (["--mesh", "3x1"], "split"),
    (["--mesh", "2x1", "--microbatches", "3"], "in 3 microbatches"),
    (["--mesh", "2"], "DATAxMODEL"),
    (["--mesh", "0x2"], "positive"),
])
def test_mesh_with_a_model_axis_raises(argv, match):
    """Meshes the port cannot run raise ValueError before any rank
    starts: a width that does not split over the model ranks, a batch
    that does not split over the data ranks, a malformed ``--mesh``."""
    with pytest.raises(ValueError, match=match):
        train.main(ARGS + ["--reduced", "--device", "cpu"] + argv)


def test_the_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(ARGS)


def test_grad_sync_sees_the_gradients_before_the_update():
    """``make_train_step``'s hook gets every gradient leaf and the loss
    metrics before the clip, and the step goes on with what it returns:
    zero gradients leave the params unmoved but for weight decay."""
    from repro_torch import configs
    from repro_torch.train import TrainConfig, make_train_step
    cfg = dataclasses.replace(configs.get_reduced("llama3_8b"),
                              dtype="float32")
    params = init_params(0, cfg, "cpu")
    opt = adamw.init(params)
    seen = {}

    def zero(grads, metrics):
        seen["n"], seen["keys"] = len(grads), set(metrics)
        return [torch.zeros_like(g) for g in grads], metrics

    before = [p.clone() for p in tree_mod.leaves(params)]
    b = BigramLM(cfg.vocab_size, device="cpu").batch(0, 2, 16)
    tc = TrainConfig(warmup_steps=0, peak_lr=1e-3,
                     adamw=adamw.AdamWConfig(weight_decay=0.0))
    _, _, m = make_train_step(cfg, tc, zero)(params, opt, b, 0)
    assert seen["n"] == len(before) and "loss" in seen["keys"]
    assert float(m["grad_norm"]) == 0.0
    for a, p in zip(before, tree_mod.leaves(params)):
        assert torch.equal(a, p)
