"""Shared pieces of the train-step parity tests (``test_torch_train_step.py``,
``test_torch_train_mixers.py`` and ``test_torch_train_attention.py``, the
ten reduced configs split three ways): the reduced configs in f32, the JAX
package's loss gradients and train step jitted once per configuration,
and the port's on the same params (carried across with
``repro_torch.interop``) and tokens."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _lm_parity import to_numpy
from _train_rules import (GRAD_RTOL, LOSS_RTOL, assert_first_step,
                          assert_grads)
from repro import configs as jconfigs
from repro.models import init_params as jinit_params
from repro.optim import adamw as jadamw
from repro.train import train_step as jtrain_step
from repro_torch import configs, interop
from repro_torch import tree as tree_mod
from repro_torch.train import train_step

B, L = 2, 32
# the reference's loss_fn reads remat and loss_chunk only: one static
# config per variant, so that every test of a file reuses one compile
GRADS_CFG = jtrain_step.TrainConfig(remat="full", loss_chunk=8)


def cfgs(arch, **changes):
    jc = dataclasses.replace(jconfigs.get_reduced(arch), dtype="float32",
                             **changes)
    tc = dataclasses.replace(configs.get_reduced(arch), dtype="float32",
                             **changes)
    return jc, tc


def batch(tc, batch_size=B, length=L, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, tc.vocab_size, (batch_size, length)
                                   ).astype(np.int32),
            "labels": rng.integers(0, tc.vocab_size, (batch_size, length)
                                   ).astype(np.int32)}


def port_batch(b, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _value_and_grad():
    return jax.jit(jax.value_and_grad(jtrain_step.loss_fn, has_aux=True),
                   static_argnames=("cfg", "tc"))


@functools.lru_cache(maxsize=None)
def reference(arch):
    jc, tc = cfgs(arch)
    return jc, tc, jinit_params(jax.random.PRNGKey(0), jc), batch(tc)


def reference_grads(jc, tc, jparams, b, jtc):
    """The reference's (loss, metrics) and its gradients as the port's
    leaves (flattening order of the port's params)."""
    (loss, metrics), grads = _value_and_grad()(
        jparams, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]),
        cfg=jc, tc=jtc)
    grads = tree_mod.leaves(interop.model_params(to_numpy(grads), tc, "cpu"))
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def reference_step(jc, jtc, jparams, b, step=0):
    """The reference's ``make_train_step`` (jitted) from ``adamw.init``:
    new params and state, numpy, and the metrics."""
    jopt = jadamw.init(jparams)
    fn = jax.jit(jtrain_step.make_train_step(jc, jtc))
    params, opt, metrics = fn(jparams, jopt, {k: jnp.asarray(v) for k, v in
                                              b.items()}, jnp.int32(step))
    return (to_numpy(params), to_numpy(opt),
            {k: float(v) for k, v in metrics.items()})


def check_loss_and_grads(arch):
    """``loss_fn``'s value and gradients against ``jax.value_and_grad`` of
    the reference's: without and with the chunked loss (the reference run
    with remat "none" and "full" respectively), each held by the port
    with remat "none" and "full"."""
    jc, tc, jparams, b = reference(arch)
    params = interop.model_params(to_numpy(jparams), tc, "cpu")
    tok, lab = port_batch(b)["tokens"], port_batch(b)["labels"]
    for chunk, jtc in ((0, jtrain_step.TrainConfig(remat="none")),
                       (8, GRADS_CFG)):
        want_loss, want_metrics, want = reference_grads(jc, tc, jparams, b,
                                                        jtc)
        for remat in ("none", "full"):
            tc_ = train_step.TrainConfig(remat=remat, loss_chunk=chunk)
            (loss, metrics), grads = train_step.value_and_grad(
                params, tok, lab, tc, tc_)
            label = f"{arch} chunk={chunk} remat={remat}"
            np.testing.assert_allclose(float(loss), want_loss,
                                       rtol=LOSS_RTOL, err_msg=label)
            assert metrics.keys() == want_metrics.keys(), label
            for k, v in metrics.items():
                np.testing.assert_allclose(float(v), want_metrics[k],
                                           rtol=LOSS_RTOL, atol=1e-7,
                                           err_msg=f"{label} {k}")
            assert_grads(grads, want, label)


def check_first_step(arch):
    """One ``make_train_step`` step (remat "full", chunked loss, lr at its
    peak) from the same params and ``adamw.init`` state: the metrics, the
    state, and the params under the first-step rule."""
    jc, tc, jparams, b = reference(arch)
    kw = dict(remat="full", loss_chunk=8, warmup_steps=0, peak_lr=1e-3)
    jtc = jtrain_step.TrainConfig(**kw)
    _, _, ref_grads = reference_grads(jc, tc, jparams, b, GRADS_CFG)
    want_p, want_opt, want_m = reference_step(jc, jtc, jparams, b)
    params = interop.model_params(to_numpy(jparams), tc, "cpu")
    p0 = [p.clone() for p in tree_mod.leaves(params)]
    opt = interop.opt_state(to_numpy(jadamw.init(jparams)), tc, "cpu")
    step = train_step.make_train_step(tc, train_step.TrainConfig(**kw))
    got_p, got_opt, got_m = step(params, opt, port_batch(b), 0)
    assert got_p is params and got_opt is opt
    assert got_m.keys() == want_m.keys()
    for k, v in got_m.items():
        np.testing.assert_allclose(float(v), want_m[k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert int(got_opt["step"]) == int(want_opt["step"]) == 1
    want_state = interop.opt_state(want_opt, tc, "cpu")
    clip = min(1.0, 1.0 / want_m["grad_norm"])
    for name, power in (("m", 1), ("v", 2)):
        # m = 0.1 g, v = 0.05 g^2 of the clipped gradient
        for g, a, w in zip(ref_grads, tree_mod.leaves(got_opt[name]),
                           tree_mod.leaves(want_state[name])):
            scale = float((g.abs() * clip).max()) ** power
            assert float((a - w).abs().max()) <= 2 * GRAD_RTOL * max(
                scale, 1e-30), (arch, name)
    return assert_first_step(p0, tree_mod.leaves(got_p),
                             tree_mod.leaves(interop.model_params(
                                 want_p, tc, "cpu")),
                             ref_grads, want_m["lr"], clip, arch)
