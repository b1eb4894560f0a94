"""The port's LM serving (``repro_torch.serve.engine``) against the JAX
package's: every case of the reference's ``test_serve.py`` through both
packages -- greedy generation deterministic and equal to the reference's,
the slot engine equal to ``generate`` per request at the four
architectures of ``test_serve.py`` (attention, SSD, RG-LRU with a local
window, sliding-window attention), more requests than slots, and
temperature sampling under one key -- with tokens equal up to a stated
near tie, plus each cache leaf's batch axis and the slot merge."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import to_numpy
from repro import configs as jconfigs
from repro.models import init_params as jinit_params
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import generate as jgenerate
from repro.serve import engine as jengine
from repro_torch import configs, interop
from repro_torch import tree as tree_mod
from repro_torch.core import prng
from repro_torch.models import (cache_spec, forward, init_params,
                                make_positions)
from repro_torch.serve import Engine, Request, generate
from repro_torch.serve import engine

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

# a token may differ from the reference's only where the two best scores
# (greedy: logits; sampling: Gumbel noise + logits / temperature) are
# closer than NEAR_TIE times the largest |logit|: twice the f32 forward's
# tolerance against the reference (tests/_lm_parity.py F32_RTOL); the
# sequences are held up to their first such position
NEAR_TIE = 4e-4


def _setup(arch="llama3_8b"):
    jc = dataclasses.replace(jconfigs.get_reduced(arch), dtype="float32")
    tc = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
    jparams = jinit_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jparams, interop.model_params(to_numpy(jparams), tc,
                                                 "cpu")


def _scores(tc, params, seq, n_prompt, temperature=0.0, key=None):
    """The scores each generated token of ``seq`` (B, L) was picked from:
    the port's logits of every prefix (the score forward), masked to the
    vocabulary, divided by the temperature and, with a key, plus the
    Gumbel noise ``generate`` draws for that step."""
    with torch.no_grad():
        logits, _, _ = forward(params, seq, make_positions(seq, tc), tc)
    logits = logits[:, n_prompt - 1:-1, :tc.vocab_size]
    if temperature > 0.0:
        logits = logits / temperature
        keys = [key]
        for _ in range(logits.shape[1] - 1):
            key, kt = prng.split(key, 2)
            keys.append(kt)
        noise = torch.stack([prng.gumbel(k, (seq.shape[0], logits.shape[-1]))
                             for k in keys], dim=1)
        logits = logits + noise
    return logits


def _assert_tokens(tc, params, got, want, n_prompt, **sampling):
    """Equal, or equal up to a first difference at a near tie of the
    scores the port picked from."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :n_prompt], want[:, :n_prompt])
    if (got == want).all():
        return
    scores = _scores(tc, params, torch.from_numpy(got), n_prompt, **sampling)
    top = torch.topk(scores, 2, dim=-1).values
    scale = float(scores.abs().max())
    for b in range(got.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if len(diff):
            s = diff[0] - n_prompt
            gap = float(top[b, s, 0] - top[b, s, 1])
            assert gap <= NEAR_TIE * scale, (b, diff[0], gap / scale)


def test_greedy_generation_deterministic():
    jc, tc, jparams, params = _setup()
    prompt = prng.randint(prng.PRNGKey(1), (2, 8), 0, tc.vocab_size)
    jprompt = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                 jc.vocab_size)
    np.testing.assert_array_equal(prompt.numpy(), np.asarray(jprompt))
    out1 = generate(params, tc, prompt, n_new=12)
    out2 = generate(params, tc, prompt, n_new=12)
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())
    assert tuple(out1.shape) == (2, 20) and out1.dtype == torch.int32
    assert int(out1.max()) < tc.vocab_size
    _assert_tokens(tc, params, out1, jgenerate(jparams, jc, jprompt, 12), 8)


@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_370m",
                                  "recurrentgemma_2b", "gemma3_27b"])
def test_engine_matches_generate(arch):
    """The slot engine's output equals straight greedy generation for each
    request, including when slots are shared across requests; both equal
    the reference's generation up to a near tie."""
    jc, tc, jparams, params = _setup(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab_size, size=6).astype(np.int32)
               for _ in range(3)]
    n_new = 6
    want = [generate(params, tc, torch.from_numpy(p[None]), n_new)[0].numpy()
            for p in prompts]
    eng = Engine(params, tc, n_slots=2, max_len=6 + n_new)
    done = eng.run([Request(prompt=p, max_new=n_new) for p in prompts])
    for r, w in zip(done, want):
        np.testing.assert_array_equal(r.out, w)
    for p, w in zip(prompts, want):
        ref = np.asarray(jgenerate(jparams, jc, jnp.asarray(p[None]),
                                   n_new))
        _assert_tokens(tc, params, w[None], ref, len(p))


def test_engine_more_requests_than_slots():
    jc, tc, jparams, params = _setup("mamba2_370m")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tc.vocab_size, size=4).astype(np.int32)
               for _ in range(5)]
    eng = Engine(params, tc, n_slots=2, max_len=16)
    done = eng.run([Request(prompt=p, max_new=5) for p in prompts])
    assert len(done) == 5
    for r in done:
        assert len(r.out) == 9
    jdone = JEngine(jparams, jc, n_slots=2, max_len=16).run(
        [JRequest(prompt=p, max_new=5) for p in prompts])
    for r, j in zip(done, jdone):
        _assert_tokens(tc, params, r.out[None], j.out[None], 4)


def test_temperature_sampling_respects_vocab():
    """Sampling under one key draws Gumbel noise of the logits' whole
    shape (``jax.random.categorical`` with 2-D logits), so the port picks
    the reference's tokens up to a near tie."""
    jc, tc, jparams, params = _setup()
    prompt = prng.randint(prng.PRNGKey(2), (4, 4), 0, tc.vocab_size)
    key = prng.PRNGKey(3)
    out = generate(params, tc, prompt, n_new=8, temperature=1.0, key=key)
    assert int(out.max()) < tc.vocab_size
    want = jgenerate(jparams, jc, jnp.asarray(prompt.numpy()), n_new=8,
                     temperature=1.0, key=jax.random.PRNGKey(3))
    _assert_tokens(tc, params, out, want, 4, temperature=1.0, key=key)


def test_sample_token_is_the_references():
    """Greedy and sampled picks on padded-vocabulary logits, under the
    same keys."""
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((6, 40))).astype(np.float32)
    for temperature in (0.0, 0.7, 1.0):
        for seed in range(4):
            got = engine.sample_token(prng.PRNGKey(seed),
                                      torch.from_numpy(logits), temperature,
                                      vocab_size=33)
            want = jengine.sample_token(jax.random.PRNGKey(seed),
                                        jnp.asarray(logits), temperature,
                                        vocab_size=33)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert int(got.max()) < 33


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_each_cache_leaf_is_merged_along_its_batch_axis(arch):
    """``Engine`` finds each per-layer cache leaf's batch axis from the
    shapes of two cache specs, and a merge writes slot s there only."""
    tc = configs.get_reduced(arch)
    axes = engine._batch_axes(tc, 16)
    leaves = tree_mod.leaves(cache_spec(tc, 3, 16))
    assert len(axes) == len(leaves)
    for axis, leaf in zip(axes, leaves):
        assert leaf.shape[axis] == 3
    eng = Engine(init_params(0, tc, "cpu"), tc, n_slots=3, max_len=16)
    one = tree_mod.map(lambda x: torch.full(x.shape, 7, dtype=x.dtype),
                       cache_spec(tc, 1, 16))
    before = [x.clone() for x in tree_mod.leaves(eng.cache)]
    eng._merge_slot(one, 1)
    for axis, old, new in zip(axes, before, tree_mod.leaves(eng.cache)):
        for s in range(3):
            got, was = new.select(axis, s), old.select(axis, s)
            if s == 1:
                assert bool((got == 7).all())
            else:
                assert torch.equal(got, was)

