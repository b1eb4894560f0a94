"""Shared pieces of the LM-stack parity tests (``test_torch_models*.py``,
``test_torch_lm_loss.py``): the JAX package's model run once per
configuration (jitted, so decode steps reuse one compile), its params and
cache carried across with ``repro_torch.interop``, and the port run on the
same tokens on the CPU."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import make_positions as jmake_positions
from repro_torch import configs, interop
from repro_torch.models import forward, init_cache, make_positions

ARCHS = configs.ARCH_IDS
# batch, sequence and prefill lengths of tests/test_models.py
B, L, LP = 2, 32, 24
# exactified f32: |port - reference| <= F32_RTOL * max |logit|. Both sides
# compute in f32 and differ only in summation order (observed <= 2.2e-6);
# the JAX package's own decode == forward test allows 5e-4.
F32_RTOL = 2e-4


def exactify(cfg):
    """f32 activations + drop-free MoE so prefill/decode are comparable
    (tests/test_models.py's ``_exactify``)."""
    cf = cfg.capacity_factor
    if cfg.n_experts:
        cf = float(cfg.n_experts) / cfg.top_k
    return dataclasses.replace(cfg, dtype="float32", capacity_factor=cf)


def configs_for(arch, exact=True, **changes):
    """(reference config, port config), the same fields on both."""
    jc, tc = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    if exact:
        jc, tc = exactify(jc), exactify(tc)
    return (dataclasses.replace(jc, **changes),
            dataclasses.replace(tc, **changes))


@functools.lru_cache(maxsize=None)
def _jitted():
    return jax.jit(jforward, static_argnames=("cfg", "remat", "head"))


def tokens(cfg, batch=B, length=L, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length)).astype(np.int32)


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def reference_params(jc):
    return jinit_params(jax.random.PRNGKey(0), jc)


def port_params(jparams, tc):
    return interop.model_params(to_numpy(jparams), tc, "cpu")


def reference_run(jc, jparams, tok, prefill=LP, decode=True, trace=False):
    """The reference's score forward, prefill of ``prefill`` tokens and
    decode steps to the end, as numpy: logits, aux, prefill logits, cache
    and aux, and the decode logits (B, L - prefill, V); with ``trace``
    also the cache after each decode step."""
    f = _jitted()
    t = jnp.asarray(tok)
    out = {}
    logits, _, aux = f(jparams, t, jmake_positions(t, jc), cfg=jc)
    out["logits"], out["aux"] = np.asarray(logits), float(aux)
    if not decode:
        return out
    cache = jinit_cache(jc, tok.shape[0], tok.shape[1])
    lp, cache, aux = f(jparams, t[:, :prefill],
                       jmake_positions(t[:, :prefill], jc), cfg=jc,
                       cache=cache)
    out["prefill"], out["cache"] = np.asarray(lp), to_numpy(cache)
    out["prefill_aux"] = float(aux)
    steps, out["caches"] = [], []
    for s in range(prefill, tok.shape[1]):
        ls, cache, _ = f(jparams, t[:, s:s + 1],
                         jmake_positions(t[:, s:s + 1], jc, offset=s),
                         cfg=jc, cache=cache)
        steps.append(np.asarray(ls[:, 0]))
        if trace:
            out["caches"].append(to_numpy(cache))
    out["decode"] = np.stack(steps, axis=1)
    return out


def _host(cache):
    return [{k: v.cpu().clone() for k, v in c.items()} for c in cache]


def port_run(tc, tparams, tok, prefill=LP, decode=True, device="cpu",
             trace=False):
    """The port's counterpart of :func:`reference_run` on ``device``."""
    t = torch.from_numpy(tok).to(device)
    out = {}
    with torch.no_grad():
        logits, _, aux = forward(tparams, t, make_positions(t, tc), tc)
        out["logits"], out["aux"] = logits.cpu().numpy(), float(aux)
        if not decode:
            return out
        cache = init_cache(tc, tok.shape[0], tok.shape[1], device)
        lp, cache, _ = forward(tparams, t[:, :prefill],
                               make_positions(t[:, :prefill], tc), tc,
                               cache=cache)
        out["prefill"] = lp.cpu().numpy()
        out["cache"] = _host(cache)
        steps, out["caches"] = [], []
        for s in range(prefill, tok.shape[1]):
            ls, cache, _ = forward(
                tparams, t[:, s:s + 1],
                make_positions(t[:, s:s + 1], tc, offset=s), tc,
                cache=cache)
            steps.append(ls[:, 0].cpu().numpy())
            if trace:
                out["caches"].append(_host(cache))
    out["decode"] = np.stack(steps, axis=1)
    return out


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def assert_cache_equal(port_cache, ref_cache, tc, rtol=F32_RTOL):
    """The port's per-layer cache against the reference's stacked one:
    integer leaves (int8 payloads, ``pos``) exactly, floats within ``rtol``
    of the leaf's largest magnitude (the forward's tolerance)."""
    ref = interop.model_cache(ref_cache, tc, "cpu")
    assert len(ref) == len(port_cache) == tc.n_layers
    for i, (a, b) in enumerate(zip(port_cache, ref)):
        assert a.keys() == b.keys(), (i, sorted(a), sorted(b))
        for name in a:
            x, y = a[name], b[name]
            assert x.shape == y.shape and x.dtype == y.dtype, (i, name)
            if x.dtype in (torch.int8, torch.int32):
                assert torch.equal(x, y), (i, name, int((x != y).sum()))
            else:
                y = y.float().numpy()
                np.testing.assert_allclose(
                    x.float().numpy(), y, rtol=0,
                    atol=rtol * max(float(np.abs(y).max()), 1e-30),
                    err_msg=f"layer {i} {name}")
