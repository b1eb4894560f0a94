"""The port's optimizer (``repro_torch.optim``) against the JAX package's:
every case of the reference's ``test_optim.py`` on the same inputs through
both packages, AdamW's update from the same state and gradients within
ADAM_ULPS of its terms, the schedule, int8 quantization and top-k masks
equal, the weight-decay mask leaf for leaf at every reduced config, and
``compressed_psum`` on 4 gloo ranks against the reference's on 4 forced
host devices."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jinit_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro.optim import schedule as jschedule
from repro_torch import configs, interop
from repro_torch import tree as tree_mod
from repro_torch.core import mesh as mesh_mod
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, adamw, compression, schedule

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
# AdamW from the same state and gradients: each new moment and param within
# ADAM_ULPS float32 ulps of the sum of its terms' magnitudes. XLA's CPU
# code contracts b * m + (1 - b) * g into one FMA, which the port's
# rounded ops do not, and with clipping the clip scale comes from a norm
# summed in another order, which v's g^2 counts twice (observed: m 3.3,
# v 6.4, params 1.0 ulps)
ADAM_ULPS = 8.0
# the schedule: XLA's and PyTorch's float32 cos differ in the last place
SCHEDULE_RTOL = 4 * EPS32


def _t(tree):
    return tree_mod.map(lambda a: torch.tensor(np.array(a)), tree)


def _j(tree):
    """Copies: the JAX package may alias a numpy buffer that the port's
    in-place update writes later."""
    return tree_mod.map(lambda a: jnp.array(np.array(a), copy=True), tree)


def _np(tree):
    return tree_mod.map(lambda a: np.array(a), tree)


def _quadratic_problem(seed=0, d=20):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((d, d)).astype(np.float32)
    A = A @ A.T / d + np.eye(d, dtype=np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    x_star = np.linalg.solve(A, b)
    return A, b, x_star


def _grad(A, b, x):
    """The gradient of 0.5 x A x - b x, as ``jax.grad`` gives it."""
    return 0.5 * (A + A.T) @ x - b


def _assert_update_is_the_references(params, state, grads, lr, jcfg, cfg):
    """One update through both packages from the same params, state and
    gradients, held within ADAM_ULPS of each value's terms."""
    p0, m0, v0 = _np(params), _np(state["m"]), _np(state["v"])
    jstate = {"m": _j(m0), "v": _j(v0),
              "step": jnp.asarray(int(state["step"]), jnp.int32)}
    jp, jstate, jm = jax.block_until_ready(jax.jit(
        jadamw.update, static_argnums=4)(_j(grads), jstate, _j(p0),
                                         jnp.float32(lr), jcfg))
    params, state, metrics = adamw.update(_t(grads), state, params,
                                          torch.tensor(lr), cfg)
    clip = 1.0
    if cfg.grad_clip_norm > 0:
        clip = min(1.0, cfg.grad_clip_norm / max(float(jm["grad_norm"]),
                                                 1e-12))
    gs = [clip * np.asarray(g, np.float32) for g in tree_mod.leaves(grads)]
    checks = zip(tree_mod.leaves(p0), tree_mod.leaves(m0),
                 tree_mod.leaves(v0), gs, tree_mod.leaves(jp),
                 tree_mod.leaves(jstate["m"]), tree_mod.leaves(jstate["v"]),
                 tree_mod.leaves(params), tree_mod.leaves(state["m"]),
                 tree_mod.leaves(state["v"]))
    for p, m, v, g, jpi, jmi, jvi, tp, tm, tv in checks:
        terms = {"m": (np.abs(cfg.b1 * m) + (1 - cfg.b1) * np.abs(g), jmi, tm),
                 "v": (np.abs(cfg.b2 * v) + (1 - cfg.b2) * g * g, jvi, tv),
                 "p": (np.abs(p) + lr, jpi, tp)}
        for name, (sc, want, got) in terms.items():
            err = np.abs(np.asarray(want) - got.numpy())
            assert (err <= ADAM_ULPS * EPS32 * sc).all(), (
                name, float((err / (EPS32 * sc)).max()))
    assert int(state["step"]) == int(jstate["step"])
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm["grad_norm"]), rtol=4 * EPS32)
    return params, state


def test_adamw_matches_reference_math():
    """One step against a hand-rolled numpy AdamW and against the
    reference's update."""
    jcfg = JAdamWConfig(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                        grad_clip_norm=0.0)
    cfg = AdamWConfig(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                      grad_clip_norm=0.0)
    w = np.array([1.0, -2.0, 3.0], np.float32)
    params = {"w": torch.tensor(w)}
    state = adamw.init(params)
    grads = {"w": np.array([0.1, -0.2, 0.3], np.float32)}
    new_params, _ = _assert_update_is_the_references(
        params, state, grads, 0.01, jcfg, cfg)
    g = np.array([0.1, -0.2, 0.3])
    m = 0.1 * g
    v = 0.001 * g * g
    mhat = m / (1 - 0.9)
    vhat = v / (1 - 0.999)
    want = np.array([1.0, -2.0, 3.0]) - 0.01 * mhat / (np.sqrt(vhat) + 1e-8)
    np.testing.assert_allclose(new_params["w"].numpy(), want, rtol=1e-5)
    assert new_params is params


@pytest.mark.parametrize("cfg_kw", [{}, {"grad_clip_norm": 0.0},
                                    {"weight_decay": 0.0, "b2": 0.999}])
def test_adamw_update_is_the_references_from_the_same_state(cfg_kw):
    """20 updates of a mixed tree (decayed and undecayed leaves, gradients
    over eight decades), each from the port's own state fed to both."""
    rng = np.random.default_rng(0)
    shapes = {"w": np.empty((64, 33)), "layer": [{
        "b": np.empty(33), "scale": np.empty(33), "k": np.empty((5, 7, 3))}]}
    draw = lambda f: tree_mod.map(lambda a: f(a.shape), shapes)
    params = _t(draw(lambda s: rng.standard_normal(s).astype(np.float32)))
    state = adamw.init(params)
    for step in range(20):
        grads = draw(lambda s: (rng.standard_normal(s) * 10.0 ** rng.integers(
            -6, 2, s)).astype(np.float32))
        lr = float(np.float32(1e-2 * (step + 1) / 20))
        params, state = _assert_update_is_the_references(
            params, state, grads, lr, JAdamWConfig(**cfg_kw),
            AdamWConfig(**cfg_kw))


def test_adamw_converges_on_quadratic():
    A, b, x_star = _quadratic_problem()
    params = {"x": torch.zeros(20)}
    state = adamw.init(params)
    cfg = AdamWConfig(weight_decay=0.0, grad_clip_norm=0.0, b2=0.999)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    for i in range(800):
        g = {"x": _grad(At, bt, params["x"])}
        params, state, _ = adamw.update(g, state, params,
                                        torch.tensor(0.05), cfg)
    np.testing.assert_allclose(params["x"].numpy(), x_star, atol=0.05)


def test_grad_clip():
    grads = {"a": torch.full((10,), 10.0)}
    clipped, norm = adamw.clip_by_global_norm(grads, 1.0)
    np.testing.assert_allclose(float(adamw.global_norm(clipped)), 1.0,
                               rtol=1e-5)
    assert float(norm) > 30.0
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((7, 5)).astype(np.float32),
         "b": [rng.standard_normal(9).astype(np.float32)]}
    for max_norm in (0.5, 100.0):
        jc, jn = jadamw.clip_by_global_norm(_j(g), max_norm)
        tc, tn = adamw.clip_by_global_norm(_t(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=2 * EPS32)
        for x, y in zip(tree_mod.leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                       rtol=4 * EPS32)


def test_weight_decay_skips_norms_and_biases():
    cfg = AdamWConfig()
    params = {"layer": {"w": torch.ones((4, 4)), "b": torch.ones((4,)),
                        "scale": torch.ones((4,))}}
    mask = adamw._decay_mask(params, cfg)
    assert mask["layer"]["w"] == 1.0
    assert mask["layer"]["b"] == 0.0
    assert mask["layer"]["scale"] == 0.0


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_decay_mask_is_the_references_leaf_for_leaf(arch):
    """The JAX package tests its rule on its stacked path names
    (``layers/scan/<run>/...``) and stacked leaves; the port on
    ``layers/<i>/...`` and per-layer leaves. Both give the same mask."""
    jc, tc = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jshapes = jax.eval_shape(lambda k: jinit_params(k, jc),
                             jax.random.PRNGKey(0))
    jmask = jadamw._decay_mask(jshapes, JAdamWConfig())
    # the reference's mask, unstacked as interop unstacks params
    want = interop.model_params(
        jax.tree.map(lambda p, m: np.full(p.shape, m, np.float32), jshapes,
                     jmask), tc, "cpu")
    params = init_params(0, tc, "cpu")
    got = adamw._decay_mask(params, AdamWConfig())
    pairs = list(zip(tree_mod.paths(got), tree_mod.leaves(want)))
    assert len(pairs) == len(tree_mod.leaves(params))
    for (path, m), w in pairs:
        assert (w.numpy() == m).all(), ("/".join(path), m)
    assert 0.0 in tree_mod.leaves(got) and 1.0 in tree_mod.leaves(got)


def test_warmup_cosine_schedule():
    lr0 = float(schedule.warmup_cosine(0, 1e-3, 100, 1000, device="cpu"))
    lr_peak = float(schedule.warmup_cosine(100, 1e-3, 100, 1000,
                                           device="cpu"))
    lr_end = float(schedule.warmup_cosine(1000, 1e-3, 100, 1000,
                                          device="cpu"))
    assert lr0 == 0.0
    np.testing.assert_allclose(lr_peak, 1e-3, rtol=1e-5)
    np.testing.assert_allclose(lr_end, 1e-4, rtol=1e-4)
    for step in (0, 1, 37, 99, 100, 101, 550, 999, 1000, 1500):
        for args in ((1e-3, 100, 1000), (3e-4, 0, 10), (0.1, 7, 7, 0.25)):
            got = schedule.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                         *args)
            want = jschedule.warmup_cosine(jnp.int32(step), *args)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want),
                                       rtol=SCHEDULE_RTOL, atol=0)
    assert float(schedule.constant(5, 2e-4, device="cpu")) == float(
        jschedule.constant(5, 2e-4))
    # a Python step runs where entry points run: CUDA unless asked
    if not torch.cuda.is_available():
        for fn in (lambda: schedule.warmup_cosine(3, 1e-3, 100, 1000),
                   lambda: schedule.constant(3, 2e-4)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn()


def test_int8_quantization_bounded_error():
    rng = np.random.default_rng(0)
    g = rng.standard_normal(1000).astype(np.float32)
    back = compression.qdq_int8(torch.from_numpy(g))
    max_err = float(torch.max(torch.abs(back - torch.from_numpy(g))))
    assert max_err <= float(np.abs(g).max()) / 127.0 + 1e-6
    q, s = compression.quantize_int8(torch.from_numpy(g))
    jq, js = jcompression.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jcompression.qdq_int8(
                                      jnp.asarray(g))))


def test_topk_keeps_largest():
    g = np.arange(100, dtype=np.float32) - 50
    m = compression.topk_mask(torch.from_numpy(g), 0.1)
    kept = np.nonzero(m.numpy())[0]
    assert len(kept) >= 10
    assert 0 in kept and 99 in kept  # largest magnitudes
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(jcompression.topk_mask(jnp.asarray(g), 0.1)))


@pytest.mark.parametrize("scheme,frac,seed,steps,atol",
                         [("int8", 0.01, 1, 1500, 0.05),
                          ("topk", 0.25, 2, 4000, 0.08)])
def test_error_feedback_convergence(scheme, frac, seed, steps, atol):
    """SGD with compressed grads + error feedback reaches the optimum of a
    quadratic; the first 20 compressions (grads and the carried errors)
    equal the reference's."""
    A, b, x_star = _quadratic_problem(seed=seed)
    x = {"x": torch.zeros(20)}
    err = None
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    for i in range(steps):
        g = {"x": _grad(At, bt, x["x"])}
        if i < 20:
            jcomp, jerr = jcompression.compress_with_feedback(
                _j(_np(g)), None if err is None else _j(_np(err)),
                scheme=scheme, topk_frac=frac)
        comp, err = compression.compress_with_feedback(
            g, err, scheme=scheme, topk_frac=frac)
        if i < 20:
            np.testing.assert_array_equal(comp["x"].numpy(),
                                          np.asarray(jcomp["x"]))
            np.testing.assert_array_equal(err["x"].numpy(),
                                          np.asarray(jerr["x"]))
        x = tree_mod.map(lambda p, c: p - 0.02 * c, x, comp)
    np.testing.assert_allclose(x["x"].numpy(), x_star, atol=atol)


# -- compressed_psum on a mesh axis ------------------------------------------

PSUM_RANKS = 4
REFERENCE_PSUM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.optim.compression import compressed_psum
    sys.path.insert(0, "tests")
    from test_torch_optim import psum_payload

    mesh = jax.make_mesh((4,), ("pod",))
    xs = [psum_payload(r) for r in range(4)]
    tree = {k: jnp.asarray(np.stack([x[k] for x in xs])) for k in xs[0]}
    f = shard_map(lambda t: jax.tree.map(
        lambda a: a[None], compressed_psum(jax.tree.map(lambda a: a[0], t),
                                           "pod")),
        mesh=mesh, in_specs=P("pod"), out_specs=P("pod"))
    out = jax.jit(f)(tree)
    np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
""")


def psum_payload(rank):
    """Rank ``rank``'s gradients: scales over four decades."""
    rng = np.random.default_rng(100 + rank)
    return {"w": (rng.standard_normal((6, 5)) * 10.0 ** (rank - 2)).astype(
                np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}


def run_compressed_psum(mesh):
    torch.set_num_threads(1)
    grads = {k: torch.from_numpy(v) for k, v in
             psum_payload(mesh.rank).items()}
    return {k: v.numpy() for k, v in
            compression.compressed_psum(grads, mesh.axis_name).items()}


def test_compressed_psum_is_the_references(tmp_path):
    """Every rank gets the reference's sum: int32 sums of the int8
    payloads exactly, times the mean of the ranks' scales (summed in rank
    order; the reference's all-reduce may sum in another, so within two
    ulps)."""
    path = tmp_path / "psum.npz"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE_PSUM,
                             str(path)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    try:
        ranks = mesh_mod.launch(f"{__name__}:run_compressed_psum",
                                PSUM_RANKS, axis_name="pod", device="cpu",
                                timeout=240)
        log, _ = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, log
    want = dict(np.load(path))
    for r, got in enumerate(ranks):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], want[k][r], rtol=2 * EPS32,
                                       atol=0, err_msg=f"rank {r} {k}")
            np.testing.assert_array_equal(got[k], ranks[0][k])
