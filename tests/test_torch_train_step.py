"""The port's train step (``repro_torch.train.train_step``) against the
JAX package's at two reduced configs in f32 (the other eight:
``test_torch_train_mixers.py`` and ``test_torch_train_attention.py``):
``loss_fn``'s loss and every gradient leaf
against ``jax.value_and_grad`` of the reference's, and one
``make_train_step`` step under the first-step rule (``_train_parity``);
then ``microbatches=2`` against one batch of the same rows, and the
reference's bf16-params training test (``test_train_loss.py``) through
both packages on the same bigram batches."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import to_numpy
from _train_parity import (GRADS_CFG, batch, cfgs, check_first_step,
                           check_loss_and_grads, port_batch, reference,
                           reference_grads, reference_step)
from _train_rules import LOSS_RTOL, assert_first_step, assert_grads
from repro import configs as jconfigs
from repro.data import BigramLM as JBigramLM
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro.train import train_step as jtrain_step
from repro_torch import configs, interop
from repro_torch import tree as tree_mod
from repro_torch.data import BigramLM
from repro_torch.train import TrainConfig, init_state, make_train_step
from repro_torch.train import train_step

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

# the bf16-params run: per-step losses of the two packages. Both keep bf16
# params and an f32 master; XLA fuses bf16 chains and rounds once per
# fusion, the port after every op (ROADMAP C: logits within 5e-2 of max
# |logit|), and the params then move apart by bf16 roundings
BF16_LOSS_RTOL = 2e-2


ARCHS = ("llama3_8b", "qwen2_vl_2b")


def test_the_three_files_cover_every_reduced_config():
    from test_torch_train_attention import ARCHS as ATTENTION
    from test_torch_train_mixers import ARCHS as MIXERS
    assert sorted(ARCHS + ATTENTION + MIXERS) == sorted(configs.ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_are_the_references(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_is_the_references(arch):
    check_first_step(arch)


def test_microbatches_equal_one_batch_of_the_same_rows():
    """llama3-8b reduced, 4 rows: microbatches=2 against the reference's
    microbatches=2 step (metrics, params under the first-step rule), and
    against the port's one batch of the same 4 rows (metrics within
    LOSS_RTOL, the state's moments within the gradient tolerance)."""
    arch = "llama3_8b"
    jc, tc = cfgs(arch)
    jparams = reference(arch)[2]
    b = batch(tc, batch_size=4)
    kw = dict(remat="full", loss_chunk=8, warmup_steps=0, peak_lr=1e-3)
    jtc = jtrain_step.TrainConfig(microbatches=2, **kw)
    want_p, want_opt, want_m = reference_step(jc, jtc, jparams, b)
    _, _, ref_grads = reference_grads(jc, tc, jparams, b, GRADS_CFG)
    runs = {}
    for n_mb in (1, 2):
        params = interop.model_params(to_numpy(jparams), tc, "cpu")
        p0 = [p.clone() for p in tree_mod.leaves(params)]
        opt = interop.opt_state(to_numpy(jax.tree.map(
            jnp.zeros_like, want_opt)), tc, "cpu")
        step = make_train_step(tc, TrainConfig(microbatches=n_mb, **kw))
        runs[n_mb] = step(params, opt, port_batch(b), 0)
    (p1, o1, m1), (p2, o2, m2) = runs[1], runs[2]
    for k in m1:
        np.testing.assert_allclose(float(m2[k]), want_m[k], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
        # means of the two halves' means; ppl_proxy = exp(ce) is not linear
        if k != "ppl_proxy":
            np.testing.assert_allclose(float(m2[k]), float(m1[k]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    clip = min(1.0, 1.0 / want_m["grad_norm"])
    assert_first_step(p0, tree_mod.leaves(p2), tree_mod.leaves(
        interop.model_params(want_p, tc, "cpu")), ref_grads,
        want_m["lr"], clip, "microbatches=2")
    # the two accumulations' first moments are 0.1 of their gradients
    assert_grads([10 * m for m in tree_mod.leaves(o2["m"])],
                 [10 * m for m in tree_mod.leaves(o1["m"])],
                 "microbatches 2 vs 1")


def test_bf16_params_training_decreases_loss():
    """The reference's test through both packages: the same bf16 params
    (carried across), 30 steps on the same BigramLM batches. Params stay
    bf16, the master stays f32, the loss falls, and each step's loss is
    the reference's within BF16_LOSS_RTOL."""
    jc = jconfigs.get_reduced("llama3_8b")
    tc = configs.get_reduced("llama3_8b")
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=30, remat="none",
              bf16_params=True, loss_chunk=16)
    jparams, jopt = jinit_state(jax.random.PRNGKey(0), jc,
                                jtrain_step.TrainConfig(**kw))
    params = interop.model_params(to_numpy(jparams), tc, "cpu")
    opt = interop.opt_state(to_numpy(jopt), tc, "cpu")
    assert tree_mod.leaves(params)[0].dtype == torch.bfloat16
    assert "master" in opt
    jstep = jax.jit(jmake_train_step(jc, jtrain_step.TrainConfig(**kw)),
                    donate_argnums=(0, 1))
    step = make_train_step(tc, TrainConfig(**kw))
    jdata, data = JBigramLM(jc.vocab_size), BigramLM(tc.vocab_size,
                                                     device="cpu")
    losses, want = [], []
    for s in range(30):
        jb, b = jdata.batch(s, 4, 32), data.batch(s, 4, 32)
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
        jparams, jopt, jm = jstep(jparams, jopt, jb,
                                  jnp.asarray(s, jnp.int32))
        params, opt, m = step(params, opt, b, s)
        losses.append(float(m["ce"]))
        want.append(float(jm["ce"]))
    assert losses[-1] < losses[0] - 0.005, losses[::6]
    np.testing.assert_allclose(losses, want, rtol=BF16_LOSS_RTOL)
    # params stay bf16, master stays f32
    assert tree_mod.leaves(params)[0].dtype == torch.bfloat16
    assert tree_mod.leaves(opt["master"])[0].dtype == torch.float32


def test_init_state_is_the_port_init_with_optimizer_state():
    tc = configs.get_reduced("mamba2_370m")
    params, opt = init_state(0, tc, device="cpu")
    from repro_torch.models import init_params
    for a, b in zip(tree_mod.leaves(params),
                    tree_mod.leaves(init_params(0, tc, "cpu"))):
        assert torch.equal(a, b)
    assert set(opt) == {"m", "v", "step"} and int(opt["step"]) == 0
    assert all(float(x.abs().max()) == 0 and x.dtype == torch.float32
               for x in tree_mod.leaves(opt["m"]))
    params, opt = init_state(0, tc, TrainConfig(bf16_params=True),
                             device="cpu")
    assert {x.dtype for x in tree_mod.leaves(params)} == {torch.bfloat16}
    for p, master in zip(tree_mod.leaves(params),
                         tree_mod.leaves(opt["master"])):
        assert torch.equal(master.to(torch.bfloat16), p)
