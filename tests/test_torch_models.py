"""The port's language-model stack (``repro_torch.models``) against the JAX
package's on the reference's own parameters, carried across with
``repro_torch.interop.model_params``, at every reduced configuration of
``ARCH_IDS``: the score forward's logits and MoE aux loss in exactified f32
and in the default bf16; the params' structure, count and init
distributions; the sharding rules; positions and the cache's spec. The
prefill and decode modes are in ``test_torch_models_decode.py``."""
import dataclasses
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _lm_routes import rows_before_first_flip
from _lm_parity import (ARCHS, F32_RTOL, configs_for, leaves, port_params,
                        port_run, reference_params, reference_run,
                        to_numpy, tokens)
from repro.models import blocks as jblocks
from repro.models import cache_spec as jcache_spec
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import make_positions as jmake_positions
from repro.models import sharding as jsharding
from repro_torch import interop
from repro_torch.models import (cache_spec, forward, init_cache,
                                init_params, layers, make_positions, moe,
                                sharding)

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

# default bf16, |port - reference| <= BF16_RTOL * max |logit|: bf16 keeps 8
# significant bits (spacing 2^-8 relative), and XLA's CPU backend fuses
# chains of bf16 elementwise ops and rounds once per fusion where torch
# rounds after every op, so activations drift by a few bf16 ulps per layer
# (observed <= 2.8e-2 over the ten reduced configs)
BF16_RTOL = 5e-2
# ... except where a MoE router's bf16 probabilities sit at a near tie
# across the top-k boundary: one side picks another expert, and from that
# token on the row differs (its capacity slots are a cumulative count over
# the row, and attention is causal). So the chosen sets are compared layer
# by layer (the order inside the top k moves no capacity slot): a set may
# differ only at a near tie -- the port's gap between the k-th and the next
# probability below NEAR_TIE (the jitted reference and the port differ
# there by up to ~2e-3; the flips seen sat at gaps of 6e-4 and 1.6e-3) --
# or at or after a position of its row that differed before. Each row's
# logits are held up to its first flip, and the aux loss to BF16_RTOL
# relative
NEAR_TIE = 4e-3


@pytest.fixture(scope="module")
def runs():
    """Each architecture's reference and port score forwards, in exactified
    f32 and in bf16, on the reference's parameters."""
    out = {}
    for arch in ARCHS:
        for exact in (True, False):
            jc, tc = configs_for(arch, exact)
            jp = reference_params(jc)
            tok = tokens(jc)
            out[arch, exact] = (
                reference_run(jc, jp, tok, decode=False),
                port_run(tc, port_params(jp, tc), tok, decode=False))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference_in_f32(runs, arch):
    ref, port = runs[arch, True]
    scale = np.abs(ref["logits"]).max()
    assert port["logits"].shape == ref["logits"].shape
    np.testing.assert_allclose(port["logits"], ref["logits"], rtol=0,
                               atol=F32_RTOL * scale)
    np.testing.assert_allclose(port["aux"], ref["aux"], rtol=F32_RTOL,
                               atol=1e-7)
    if configs_for(arch)[1].n_experts:
        assert port["aux"] > 0.0


def _routed_runs(arch, monkeypatch):
    """Both packages' bf16 forwards with every MoE layer's routing
    recorded: (reference logits, its top-k experts per layer), (port
    logits, its probabilities and top-k experts per layer)."""
    jc, tc = configs_for(arch, exact=False)
    jp = reference_params(jc)
    tok = tokens(jc)
    ref_idx, port_routes = [], []
    ref_moe, port_route = jblocks.moe_apply, moe.route

    def ref_spy(p, x, cfg):
        logits = (x @ p["router"]["w"].astype(x.dtype)).astype(jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
        jax.debug.callback(lambda i: ref_idx.append(np.asarray(i)), idx,
                           ordered=True)
        return ref_moe(p, x, cfg)

    def port_spy(p, x, cfg):
        out = port_route(p, x, cfg)
        port_routes.append((out[0].numpy(), out[2].numpy()))
        return out

    monkeypatch.setattr(jblocks, "moe_apply", ref_spy)
    monkeypatch.setattr(moe, "route", port_spy)
    t = jnp.asarray(tok)
    ref_logits, _, _ = jax.jit(lambda p, t: jforward(
        p, t, jmake_positions(t, jc), jc))(jp, t)
    jax.effects_barrier()
    port = port_run(tc, port_params(jp, tc), tok, decode=False)
    return np.asarray(ref_logits), ref_idx, port["logits"], port_routes


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference_in_bf16(runs, arch, monkeypatch):
    tc = configs_for(arch, False)[1]
    if not tc.n_experts:
        ref, port = runs[arch, False]
        scale = np.abs(ref["logits"]).max()
        err = np.abs(port["logits"] - ref["logits"]).max()
        assert err <= BF16_RTOL * scale, err / scale
        assert port["aux"] == ref["aux"] == 0.0
        return
    ref_logits, ref_idx, logits, routes = _routed_runs(arch, monkeypatch)
    assert len(ref_idx) == len(routes) == tc.n_layers
    L = logits.shape[1]
    rows = rows_before_first_flip([p for p, _ in routes],
                                  [i for _, i in routes], ref_idx, tc.top_k,
                                  NEAR_TIE)
    assert rows.sum() >= L // 2, rows.sum()
    scale = np.abs(ref_logits).max()
    held = np.abs(logits - ref_logits).max(axis=-1) <= BF16_RTOL * scale
    assert np.isfinite(logits).all() and held[rows].all(), np.argwhere(
        rows & ~held)
    np.testing.assert_allclose(runs[arch, False][1]["aux"],
                               runs[arch, False][0]["aux"], rtol=BF16_RTOL)


# -- params -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    """The reference's reduced params (numpy) and the port's own init."""
    out = {}
    for arch in ARCHS:
        jc, tc = configs_for(arch, exact=False)
        out[arch] = (to_numpy(reference_params(jc)),
                     init_params(0, tc, "cpu"))
    return out


def _named_leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, path + (str(k),))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, path + (str(i),))]
    return [("/".join(path), tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_is_the_configs(params, arch):
    tc = configs_for(arch, exact=False)[1]
    assert sum(x.numel() for x in leaves(params[arch][1])) \
        == tc.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_params_are_the_references_layer_by_layer(params, arch):
    """The port's init has the structure, shapes and dtypes of the
    reference's params unstacked into layers, and the same distributions:
    deterministic leaves (norms, biases, A_log, D, dt_bias) equal, random
    ones with the reference's spread."""
    tc = configs_for(arch, exact=False)[1]
    ref = dict(_named_leaves(interop.model_params(params[arch][0], tc,
                                                  "cpu")))
    ours = dict(_named_leaves(params[arch][1]))
    assert ours.keys() == ref.keys()
    for name, x in ours.items():
        y = ref[name]
        assert x.shape == y.shape and x.dtype == y.dtype, name
        x, y = x.numpy(), y.numpy()
        if y.std() == 0 or name.endswith("A_log"):
            np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=name)
        elif name.endswith("Lambda"):
            # log(exp(-log(u) / 16) - 1) of u uniform in (0.9^2, 0.999^2):
            # a long-tailed spread, so the draws' range is held
            for lam in (x, y):
                u = np.exp(-16.0 * np.log1p(np.exp(lam.astype(np.float64))))
                assert (u > 0.9 ** 2 - 1e-6).all() and (u < 0.999 ** 2
                                                        + 1e-6).all()
        else:
            assert 0.7 < x.std() / y.std() < 1.3, (name, x.std(), y.std())
            assert abs(x.mean() - y.mean()) < 0.5 * y.std(), name


def test_init_params_is_seeded_and_a_cpu_generator_moves():
    tc = configs_for("recurrentgemma_2b", exact=False)[1]
    a = init_params(3, tc, "cpu")
    b = init_params(torch.Generator().manual_seed(3), tc, "cpu")
    c = init_params(4, tc, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])


# -- sharding -----------------------------------------------------------------------

MESHES = {"data_model": ((2, 4), ("data", "model")),
          "pod_data_model": ((2, 2, 4), ("pod", "data", "model")),
          "odd": ((3, 5), ("data", "model"))}


def _canonical(spec):
    """A spec as a tuple, a one-axis group as its axis (``PartitionSpec``
    reads ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _meshes(which):
    sizes, names = MESHES[which]
    port = types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))
    return AbstractMesh(sizes, names), port


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("which", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_references(params, arch, which, layout):
    """On the reference's own (stacked) params the port's rules give the
    reference's specs, compared as tuples; on the port's per-layer params
    they give one entry per dim."""
    jmesh, mesh = _meshes(which)
    ref_params, ours = params[arch]
    want = dict(_named_leaves(jax.tree.map(
        _canonical, jsharding.param_specs(ref_params, jmesh, layout),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))))
    got = {name: _canonical(s) for name, s in _named_leaves(
        sharding.param_specs(ref_params, mesh, layout))}
    assert got == want
    shapes = dict(_named_leaves(ours))
    for name, spec in _named_leaves(sharding.param_specs(ours, mesh,
                                                         layout)):
        assert len(spec) == shapes[name].dim(), name


@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("which", sorted(MESHES))
def test_resolve_and_spec_are_the_references(which, layout):
    jmesh, mesh = _meshes(which)
    dims = (None, "batch", "data", "model")
    for d in dims:
        assert sharding.resolve(d, mesh, layout) \
            == jsharding.resolve(d, jmesh, layout), d
    with jsharding.set_mesh(jmesh, layout), sharding.set_mesh(mesh, layout):
        assert _canonical(sharding.spec(*dims)) \
            == _canonical(jsharding.spec(*dims))
        x = torch.ones(2, 3, 4)
        assert sharding.constrain(x, "batch", "model", None) is x
    assert sharding.spec("batch", "model") == tuple(
        jsharding.spec("batch", "model")) == ()
    # the port's own Mesh: one named axis
    from repro_torch.core.mesh import Mesh
    one = Mesh("data", "gloo", 4, 0, torch.device("cpu"))
    assert sharding.resolve("batch", one) == ("data",)


def test_constrain_is_a_no_op_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.constrain(x, "batch", None) is x
    with pytest.raises(ValueError):
        sharding.constrain(x, "batch", None, "model")


# -- positions and caches -----------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("arch", ["llama3_8b", "qwen2_vl_2b"])
def test_make_positions_is_the_references(arch, offset):
    jc, tc = configs_for(arch)
    tok = tokens(jc, length=5)
    want = np.asarray(jmake_positions(jax.numpy.asarray(tok), jc,
                                      offset=offset))
    got = make_positions(torch.from_numpy(tok), tc, offset=offset)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_and_init_cache_are_the_references(arch, kv):
    """``cache_spec`` allocates nothing and has ``init_cache``'s shapes and
    dtypes, which are the reference's per layer; ``init_cache``'s values
    are the reference's (zeros, pos -1)."""
    jc, tc = configs_for(arch, exact=False, kv_cache_dtype=kv)
    B, max_len = 2, 40
    spec = cache_spec(tc, B, max_len)
    ours = init_cache(tc, B, max_len, "cpu")
    ref = interop.model_cache(to_numpy(jinit_cache(jc, B, max_len)), tc,
                              "cpu")
    jspec = jcache_spec(jc, B, max_len)
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jspec))
    assert sum(x.numel() for x in leaves(spec)) == n_ref
    for s, a, b in zip(spec, ours, ref):
        assert s.keys() == a.keys() == b.keys()
        for k in s:
            assert s[k].device.type == "meta"
            assert s[k].shape == a[k].shape == b[k].shape, k
            assert s[k].dtype == a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k


# -- modes --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_370m",
                                  "recurrentgemma_2b"])
def test_remat_and_head_false_change_nothing(arch):
    """``remat="full"`` recomputes each block in the backward: the same
    loss and gradients; ``head=False`` returns the final-norm hidden state,
    which the LM head turns into the logits."""
    tc = configs_for(arch)[1]
    p = init_params(0, tc, "cpu")
    tok = torch.from_numpy(tokens(tc, length=16))
    pos = make_positions(tok, tc)
    grads = []
    for remat in ("none", "full"):
        leaf_list = [x.requires_grad_() for x in leaves(p)]
        logits, _, _ = forward(p, tok, pos, tc, remat=remat)
        loss = torch.logsumexp(logits, -1).mean()
        grads.append((loss.detach(), torch.autograd.grad(loss, leaf_list)))
        for x in leaf_list:
            x.requires_grad_(False)
    assert torch.equal(grads[0][0], grads[1][0])
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        hidden, _, _ = forward(p, tok, pos, tc, head=False)
        logits, _, _ = forward(p, tok, pos, tc)
    assert hidden.shape == (*tok.shape, tc.d_model)
    head = p["embed"] if tc.tie_embeddings else p["lm_head"]
    assert torch.equal(layers.lm_head_apply(head, hidden, tc), logits)
    with pytest.raises(ValueError):
        forward(p, tok, pos, tc, remat="some")


def test_mrope_differs_from_rope_on_spatial_ids():
    """qwen2-vl: distinct h/w position ids change the logits against the
    collapsed text-only ids (tests/test_models.py's case)."""
    tc = configs_for("qwen2_vl_2b")[1]
    p = init_params(0, tc, "cpu")
    L = 16
    tok = torch.from_numpy(tokens(tc, batch=1, length=L))
    grid = torch.stack([torch.zeros(L, dtype=torch.int32),
                        torch.arange(L, dtype=torch.int32) // 4,
                        torch.arange(L, dtype=torch.int32) % 4])[None]
    with torch.no_grad():
        l_text, _, _ = forward(p, tok, make_positions(tok, tc), tc)
        l_grid, _, _ = forward(p, tok, grid, tc)
    assert float((l_text - l_grid).abs().max()) > 1e-3


def test_no_reduced_precision_float32_matmuls_are_set():
    """The port never turns on TF32 or lowers float32 matmul precision: the
    f32 parity on the card rests on full-precision products."""
    src = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    pattern = re.compile(r"allow_tf32\s*=|set_float32_matmul_precision\(")
    hits = [str(f) for f in src.rglob("*.py")
            if pattern.search(f.read_text())]
    assert not hits, hits
