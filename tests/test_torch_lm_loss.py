"""The port's LM loss (``repro_torch.train.loss``) against the JAX
package's: ``lm_loss`` with and without a mask, the MoE aux term and the
z-loss over a padded vocabulary, ``chunked_lm_loss`` over several chunk
sizes, each within 1e-5; the chunked loss equal to the full one, values
and gradients (its per-chunk logits are recomputed in the backward); and
the loss of a reduced model's forward on the reference's parameters."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (configs_for, port_params, port_run,
                        reference_params, reference_run, tokens)
from repro import configs as jconfigs
from repro.train import loss as jloss
from repro_torch import configs
from repro_torch.models import layers
from repro_torch.train import loss

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

TOL = 1e-5
# granite-moe reduced: vocab 515, padded to 768, so the mask matters
ARCH = "granite_moe_3b_a800m"


def _cfgs(arch=ARCH):
    return jconfigs.get_reduced(arch), configs.get_reduced(arch)


def _assert_metrics(got, want):
    total, metrics = got
    jtotal, jmetrics = want
    assert metrics.keys() == jmetrics.keys()
    np.testing.assert_allclose(float(total), float(jtotal), rtol=TOL)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=TOL, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("aux", [None, 0.37])
@pytest.mark.parametrize("z_coef", [1e-4, 0.1])
def test_lm_loss_is_the_references(masked, aux, z_coef):
    jc, tc = _cfgs()
    rng = np.random.default_rng(0)
    B, L = 3, 20
    logits = (4 * rng.standard_normal((B, L, tc.vocab_padded))).astype(
        np.float32)
    labels = rng.integers(0, tc.vocab_size, (B, L)).astype(np.int32)
    mask = (rng.random((B, L)) < 0.7) if masked else None
    want = jloss.lm_loss(jnp.asarray(logits), jnp.asarray(labels), jc,
                         mask=None if mask is None else jnp.asarray(mask),
                         aux=None if aux is None else jnp.float32(aux),
                         z_coef=z_coef)
    got = loss.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                       tc, mask=None if mask is None else torch.from_numpy(
                           mask),
                       aux=None if aux is None else torch.tensor(aux),
                       z_coef=z_coef)
    _assert_metrics(got, want)


def _hidden_case(arch=ARCH, B=2, L=24):
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(1)
    table = (0.02 * rng.standard_normal((tc.vocab_padded, tc.d_model))
             ).astype(np.float32)
    hidden = rng.standard_normal((B, L, tc.d_model)).astype(np.float32)
    labels = rng.integers(0, tc.vocab_size, (B, L)).astype(np.int32)
    return jc, tc, table, hidden, labels


@pytest.mark.parametrize("chunk", [512, 8, 10, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_lm_loss_is_the_references(chunk, dtype):
    """chunk 512 -> the whole sequence, 10 -> shrinks to 8 (a divisor of
    24); in bf16 the hidden state and the table round to bf16 first, then
    both packages compute in f32."""
    jc, tc, table, hidden, labels = _hidden_case()
    jc, tc = (dataclasses.replace(c, dtype=dtype) for c in (jc, tc))
    jdt = jnp.dtype(dtype)
    jh = jnp.asarray(hidden, jdt)
    want = jloss.chunked_lm_loss({"table": jnp.asarray(table)}, jh,
                                 jnp.asarray(labels), jc, chunk=chunk,
                                 aux=jnp.float32(0.5))
    th = torch.from_numpy(np.array(jh, np.float32)).to(
        layers.torch_dtype(dtype))
    got = loss.chunked_lm_loss({"table": torch.from_numpy(table)}, th,
                               torch.from_numpy(labels), tc, chunk=chunk,
                               aux=torch.tensor(0.5))
    _assert_metrics(got, want)


@pytest.mark.parametrize("chunk", [24, 8, 5])
def test_chunked_equals_full_in_value_and_gradient(chunk):
    """The chunked loss is the full loss on the head's logits, and the
    gradients through its recomputed chunks are the full loss's."""
    _, tc, table, hidden, labels = _hidden_case()
    results = []
    for chunked in (False, True):
        t = torch.from_numpy(table).requires_grad_()
        h = torch.from_numpy(hidden).requires_grad_()
        lab = torch.from_numpy(labels)
        if chunked:
            total, metrics = loss.chunked_lm_loss({"table": t}, h, lab, tc,
                                                  chunk=chunk)
        else:
            logits = layers.lm_head_apply({"table": t}, h, tc)
            total, metrics = loss.lm_loss(logits, lab, tc)
        grads = torch.autograd.grad(total, (t, h))
        results.append((total.detach(), metrics, grads))
    (full, fm, fg), (ch, cm, cg) = results
    torch.testing.assert_close(ch, full, rtol=TOL, atol=0)
    for k in fm:
        torch.testing.assert_close(cm[k].detach(), fm[k].detach(),
                                   rtol=TOL, atol=0)
    # the table's gradient sums the chunks' in another order: held to TOL
    # of the largest element
    for a, b in zip(cg, fg):
        torch.testing.assert_close(a, b, rtol=TOL,
                                   atol=TOL * float(b.abs().max()))


@pytest.mark.parametrize("arch", ["llama3_8b", "granite_moe_3b_a800m",
                                  "gemma3_27b"])
def test_loss_of_a_forward_is_the_references(arch):
    """A reduced model's score forward on the reference's parameters, then
    the loss of the next token with the MoE aux term, in exactified f32."""
    jc, tc = configs_for(arch)
    jp = reference_params(jc)
    tok = tokens(jc, length=33)
    ref = reference_run(jc, jp, tok[:, :-1], decode=False)
    port = port_run(tc, port_params(jp, tc), tok[:, :-1], decode=False)
    want = jloss.lm_loss(jnp.asarray(ref["logits"]), jnp.asarray(tok[:, 1:]),
                         jc, aux=jnp.float32(ref["aux"]))
    got = loss.lm_loss(torch.from_numpy(port["logits"]),
                       torch.from_numpy(tok[:, 1:]), tc,
                       aux=torch.tensor(port["aux"]))
    _assert_metrics(got, want)
