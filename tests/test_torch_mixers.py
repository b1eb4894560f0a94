"""The port's non-attention mixers against the JAX package's on the
reference's own parameters and the same inputs: MoE routing (chosen
experts, capacity slots and drops through the dispatch buffer, exactly, at
f32 with the default capacity factor; a tie case), the MoE layer's output
and aux loss; the Mamba-2 SSD (``_segsum``, ``ssd_chunked``, ``ssd_apply``'s
full pass, prefill cache and decode steps); the RG-LRU (the doubling scan
against ``jax.lax.associative_scan``, ``rglru_apply`` in its three
modes)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import sharding as jsharding
from repro.models import ssd as jssd
from repro_torch import configs, interop
from repro_torch.models import moe, rglru, sharding, ssd

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

# f32 on both sides, sums in different orders
F32_TOL = 1e-5


def _cfgs(arch, **changes):
    return (dataclasses.replace(jconfigs.get_reduced(arch), **changes),
            dataclasses.replace(configs.get_reduced(arch), **changes))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return interop.tensor(arr, "cpu")


def _close(got, want, tol=F32_TOL, **kw):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.float().numpy(), want, rtol=tol,
        atol=tol * max(float(np.abs(want).max()), 1.0), **kw)


# -- MoE ----------------------------------------------------------------------------

def _buffers(module, monkeypatch):
    """Record the (B, E, C, d) dispatch buffers ``module``'s moe_apply
    hands to ``sharding.constrain``."""
    seen = []
    inner = module.constrain

    def spy(x, *dims):
        if len(dims) == 4 and not seen:
            seen.append(np.array(x, np.float32))
        return inner(x, *dims)

    monkeypatch.setattr(module, "constrain", spy)
    return seen


def _moe_case(which, rng):
    """(reference config, port config, reference params, x): f32, the
    default capacity factor (1.25). "skewed": the router favours expert 0,
    so its row capacity overflows; "tie": a zero router, every probability
    equal, so top-k takes experts 0..k-1 for every token."""
    jc, tc = _cfgs("granite_moe_3b_a800m", dtype="float32")
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(5), jc))
    x = rng.standard_normal((2, 64, jc.d_model)).astype(np.float32)
    if which == "skewed":
        x[..., 0] = np.abs(x[..., 0]) + 1.0
        p["router"]["w"] = p["router"]["w"].copy()
        p["router"]["w"][0, 0] += 3.0
    else:
        p["router"]["w"] = np.zeros_like(p["router"]["w"])
    return jc, tc, p, x


@pytest.mark.parametrize("which", ["skewed", "tie"])
def test_moe_routing_and_drops_are_the_references(which, monkeypatch):
    """The dispatch buffers equal bit for bit (every kept choice's token at
    its expert and slot, zeros elsewhere); the port's kept choices are
    exactly the buffer's rows, its top-k that of ``jax.lax.top_k`` (lower
    expert first on a tie), and some choices are dropped."""
    jc, tc, p, x = _moe_case(which, np.random.default_rng(6))
    ref_bufs = _buffers(jsharding, monkeypatch)
    port_bufs = _buffers(sharding, monkeypatch)
    y_ref, aux_ref = jmoe.moe_apply(p, jnp.asarray(x), jc)
    tp, tx = _tensors(p), torch.from_numpy(x)
    y, aux = moe.moe_apply(tp, tx, tc)
    np.testing.assert_array_equal(port_bufs[0], ref_bufs[0])
    probs, gate, idx, pos, keep = moe.route(tp, tx, tc)
    logits = jnp.asarray(x) @ jnp.asarray(p["router"]["w"])
    _, ref_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jc.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert (~keep).any() and keep.any()
    buf = torch.from_numpy(ref_bufs[0])
    for b, l, j in torch.nonzero(keep).tolist():
        e, c = int(idx[b, l, j]), int(pos[b, l, j])
        assert torch.equal(buf[b, e, c], tx[b, l]), (b, l, j)
    assert int((buf.abs().sum(-1) > 0).sum()) == int(keep.sum())
    if which == "tie":
        assert (idx == torch.arange(tc.top_k)).all()
    _close(y, y_ref)
    _close(aux, aux_ref)


@pytest.mark.parametrize("seq_len", [1, 7, 32, 2048])
@pytest.mark.parametrize("arch", ["dbrx_132b", "granite_moe_3b_a800m"])
def test_row_capacity_is_the_references(arch, seq_len):
    for cf in (1.0, 1.25, 5.0):
        jc, tc = (dataclasses.replace(c, capacity_factor=cf)
                  for c in (jconfigs.get(arch), configs.get(arch)))
        assert moe._row_capacity(seq_len, tc) \
            == jmoe._row_capacity(seq_len, jc)


def test_moe_bf16_output_is_the_references_to_bf16_rounding():
    """The default bf16 activations on the same bf16 input: routing is the
    same here (no near tie), the output within a few bf16 roundings."""
    jc, tc = _cfgs("granite_moe_3b_a800m")
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(7), jc))
    x = np.random.default_rng(8).standard_normal((2, 32, jc.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    y_ref, aux_ref = jmoe.moe_apply(p, jx, jc)
    y, aux = moe.moe_apply(_tensors(p), torch.from_numpy(
        np.array(jx, np.float32)).to(torch.bfloat16), tc)
    assert y.dtype == torch.bfloat16
    _close(y, y_ref, tol=2 ** -6)
    _close(aux, aux_ref)


# -- SSD ----------------------------------------------------------------------------

def test_segsum_is_the_references():
    x = np.random.default_rng(9).standard_normal((3, 2, 12)).astype(
        np.float32)
    want = np.asarray(jssd._segsum(jnp.asarray(x)))
    got = ssd._segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked_is_the_references(initial):
    rng = np.random.default_rng(10)
    b, l, h, p, n, chunk = 2, 48, 3, 4, 5, 8
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.arange(1, h + 1, dtype=np.float32)
    B, C = (rng.standard_normal((b, l, h, n)).astype(np.float32)
            for _ in range(2))
    s0 = (rng.standard_normal((b, h, p, n)).astype(np.float32) if initial
          else None)
    jy, jst = jssd.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                               None if s0 is None else jnp.asarray(s0))
    y, st = ssd.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk,
                            None if s0 is None else torch.from_numpy(s0))
    _close(y, jy)
    _close(st, jst)


def _mixer_runs(jmod, tmod, jc, tc, p, u, init_cache, prefill):
    """Full pass, prefill of ``prefill`` tokens with a cache, then decode
    to the end, on both packages: [(name, port, reference), ...]."""
    apply_j = jax.jit(getattr(jmod, f"{tmod.__name__.rsplit('.', 1)[1]}"
                              "_apply"), static_argnums=2)
    apply_t = getattr(tmod, f"{tmod.__name__.rsplit('.', 1)[1]}_apply")
    tp = _tensors(p)
    ju = jnp.asarray(u, jnp.dtype(jc.dtype))
    tu = torch.from_numpy(np.array(ju, np.float32)).to(
        getattr(torch, jc.dtype))
    out = []
    yj, _ = apply_j(p, ju, jc)
    yt, _ = apply_t(tp, tu, tc)
    out.append(("full", yt, yj))
    jcache = jax.tree.map(jnp.asarray, init_cache[0])
    tcache = _tensors(init_cache[0])
    yj, jcache = apply_j(p, ju[:, :prefill], jc, jcache)
    yt, tcache = apply_t(tp, tu[:, :prefill], tc, tcache)
    out.append(("prefill", yt, yj))
    for name in jcache:     # the port's cache is written in place: copied
        out.append((f"cache {name}", tcache[name].clone(), jcache[name]))
    for s in range(prefill, u.shape[1]):
        yj, jcache = apply_j(p, ju[:, s:s + 1], jc, jcache)
        yt, tcache = apply_t(tp, tu[:, s:s + 1], tc, tcache)
        out.append((f"decode {s}", yt, yj))
    for name in jcache:
        out.append((f"final cache {name}", tcache[name], jcache[name]))
    return out


# bf16: a few bf16 roundings (2^-8 relative each) of the largest magnitude
MIXER_TOL = {"float32": F32_TOL, "bfloat16": 2 ** -5}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_apply_is_the_references(dtype):
    """mamba2 reduced (chunk 16): a 40-token full pass (chunk shrinks to
    10), a 37-token prefill (chunk 1 ... 37 is prime) into the cache, three
    decode steps."""
    jc, tc = _cfgs("mamba2_370m", dtype=dtype)
    p = jax.tree.map(np.asarray, jssd.ssd_init(jax.random.PRNGKey(11), jc))
    p["dt_bias"] = np.linspace(-1, 1, p["dt_bias"].size, dtype=np.float32)
    u = np.random.default_rng(12).standard_normal((2, 40, jc.d_model))
    cache = jax.tree.map(np.asarray, jssd.ssd_cache_init(2, jc))
    for name, got, want in _mixer_runs(jssd, ssd, jc, tc, p, u, (cache,),
                                       37):
        _close(got, want, tol=MIXER_TOL[dtype], err_msg=name)


def test_linear_scan_is_associative_scan():
    rng = np.random.default_rng(13)
    for L in (1, 6, 33):
        a = rng.uniform(0.5, 1.0, (2, L, 3)).astype(np.float32)
        b = rng.standard_normal((2, L, 3)).astype(np.float32)

        def combine(x, y):
            return x[0] * y[0], y[0] * x[1] + y[1]

        _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                     jnp.asarray(b)), axis=1)
        got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
        _close(got, want, err_msg=str(L))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_apply_is_the_references(dtype):
    """recurrentgemma reduced: a 40-token full pass, a 37-token prefill
    into the cache, decode to 40."""
    jc, tc = _cfgs("recurrentgemma_2b", dtype=dtype)
    p = jax.tree.map(np.asarray, jrglru.rglru_init(jax.random.PRNGKey(14),
                                                   jc))
    u = np.random.default_rng(15).standard_normal((2, 40, jc.d_model))
    cache = jax.tree.map(np.asarray, jrglru.rglru_cache_init(2, jc))
    for name, got, want in _mixer_runs(jrglru, rglru, jc, tc, p, u,
                                       (cache,), 37):
        _close(got, want, tol=MIXER_TOL[dtype], err_msg=name)


def test_mixer_inits_are_the_references_in_shape_and_kind():
    """``ssd_init`` and ``rglru_init``: the reference's leaves, shapes and
    dtypes, with A_log = log(1..H), D ones, dt_bias zeros."""
    for arch, jinit, tinit in (("mamba2_370m", jssd.ssd_init, ssd.ssd_init),
                               ("recurrentgemma_2b", jrglru.rglru_init,
                                rglru.rglru_init)):
        jc, tc = _cfgs(arch)
        want = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jc))
        got = tinit(torch.Generator().manual_seed(0), tc)
        flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
        flat_g = dict(jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.numpy(), got)))
        assert flat_w.keys() == flat_g.keys()
        for k in flat_w:
            assert flat_w[k].shape == flat_g[k].shape, k
            assert flat_w[k].dtype == flat_g[k].dtype, k
    p = ssd.ssd_init(torch.Generator().manual_seed(0),
                     _cfgs("mamba2_370m")[1])
    h = p["A_log"].numel()
    torch.testing.assert_close(p["A_log"], torch.log(torch.arange(1.0, h + 1)))
    assert (p["D"] == 1).all() and (p["dt_bias"] == 0).all()
