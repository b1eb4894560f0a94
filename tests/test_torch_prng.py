"""The port's threefry2x32 against ``jax.random``: the same keys give the
same bits, so the port samples what the JAX package samples; ``randint``
bit for bit, ``normal`` to a few ulps (XLA's erf_inv formula, its FMAs
and log apart), and ``BigramLM``'s batches equal to the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import strategy as jstrategy
from repro.data import BigramLM as JBigramLM
from repro_torch import interop
from repro_torch.core import prng, strategy
from repro_torch.data import BigramLM

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 + 3, -5]


def _port(key_array):
    return interop.key(np.asarray(key_array), device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_are_bit_equal(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    for num in (2, 3, 18, (4, 5)):
        np.testing.assert_array_equal(
            prng.split(tk, num).numpy(),
            np.asarray(jax.random.split(jk, num)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_bits_are_bit_equal(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    for shape in ((1,), (1000,), (7, 13)):
        np.testing.assert_array_equal(
            prng.uniform(tk, shape).numpy(),
            np.asarray(jax.random.uniform(jk, shape)))
        np.testing.assert_array_equal(
            prng.random_bits(tk, shape).numpy(),
            np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
    np.testing.assert_array_equal(
        prng.uniform(tk, (500,), minval=-2.0, maxval=3.0).numpy(),
        np.asarray(jax.random.uniform(jk, (500,), minval=-2.0, maxval=3.0)))


def test_batched_keys_are_the_vmapped_draws():
    """A leading key axis draws what jax.vmap over the keys draws."""
    jks = jax.random.split(jax.random.PRNGKey(9), 6)
    tks = _port(jks)
    np.testing.assert_array_equal(
        prng.uniform(tks, (333,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (333,)))(jks)))
    np.testing.assert_array_equal(
        prng.split(tks).numpy(),
        np.asarray(jax.vmap(jax.random.split)(jks)).astype(np.int64))


@pytest.mark.parametrize("n_sites", [1, 9, 100])
def test_split_keys_table_is_bit_equal(n_sites):
    jk = jax.random.PRNGKey(0)
    j_table = jstrategy.ALGORITHM1.keys(jk, n_sites)
    t_table = strategy.ALGORITHM1.keys(prng.PRNGKey(0), n_sites)
    assert t_table.shape == (n_sites, 2, 2)
    np.testing.assert_array_equal(t_table.numpy(),
                                  np.asarray(j_table).astype(np.int64))


def test_gumbel_agrees_to_log_rounding():
    """Gumbel noise is -log(-log(u)) of bit-equal uniforms; PyTorch's and
    XLA's log may round differently in the last place, so the values agree
    to that rounding, not bit for bit: a few float32 ulps of 1 + |g| (near
    g = 0 the outer log of a value near 1 turns an ulp of its argument into
    an absolute error of about 6e-8)."""
    jk = jax.random.PRNGKey(11)
    g_j = np.asarray(jax.random.gumbel(jk, (100_000,)))
    g_t = prng.gumbel(prng.PRNGKey(11), (100_000,)).numpy()
    assert np.all(np.abs(g_t - g_j) <= 4 * 2.0**-23 * (1 + np.abs(g_j)))


@pytest.mark.parametrize("seed", range(6))
def test_categorical_draws_equal_except_one_ulp_ties(seed):
    """Indices are equal except where the best two Gumbel scores tie within
    the log rounding difference between the libraries (a few ulps); such
    ties are vanishingly rare and each one is checked to be one."""
    rng = np.random.default_rng(seed)
    logits = np.log(rng.random((50, 3000)).astype(np.float32) ** 3
                    + 1e-30).astype(np.float32)
    jks = jax.random.split(jax.random.PRNGKey(seed), 50)
    j_idx = np.asarray(jax.vmap(jax.random.categorical)(jks,
                                                       jnp.asarray(logits)))
    t_idx = prng.categorical(_port(jks), torch.from_numpy(logits)).numpy()
    differ = np.nonzero(j_idx != t_idx)[0]
    assert len(differ) <= 1
    for row in differ:
        g = np.asarray(jax.random.gumbel(jks[row], (3000,))) + logits[row]
        a, b = g[j_idx[row]], g[t_idx[row]]
        assert abs(a - b) <= 8 * 2.0**-23 * (1 + abs(a))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_is_bit_equal(seed):
    """int32 draws in the reference's uint32 arithmetic, spans that wrap
    its multiplier (2**16 squared) included."""
    for lo, hi, shape in ((0, 256, (64,)), (0, 100_000, (50,)),
                          (-5, 70_000, (3, 4)), (0, 128_256, (2, 9)),
                          (3, 3, (5,)), (7, 2, (4,)),
                          (-2**31, 2**31 - 1, (20,))):
        got = prng.randint(prng.PRNGKey(seed), shape, lo, hi)
        want = jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# normal: XLA's CPU code contracts products and sums into FMAs and has its
# own log, so about 5% of values differ in their last bits (observed
# relative difference <= 2.4e-7)
NORMAL_RTOL = 8 * 2.0**-23


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_agrees_to_a_few_ulps(seed):
    got = prng.normal(prng.PRNGKey(seed), (300, 300)).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (300, 300)))
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=0)
    assert (got == want).mean() > 0.9


@pytest.mark.parametrize("vocab,active", [(515, 256), (64, 256),
                                          (1000, 100)])
def test_bigram_batches_are_the_references(vocab, active):
    """The transition logits to a few ulps, and the token streams equal:
    each step is a Gumbel-max pick whose best two scores stand further
    apart than the logits' difference (a flip would need a near tie; none
    occurs at these sizes). Within one process both hash the same
    (PYTHONHASHSEED salts per process, not per call)."""
    ref = JBigramLM(vocab, active, seed=3)
    port = BigramLM(vocab, active, seed=3, device="cpu")
    assert port.active_vocab == ref.active_vocab == min(vocab, active)
    np.testing.assert_allclose(port._logits.numpy(), np.asarray(ref._logits),
                               rtol=NORMAL_RTOL, atol=0)
    for step in (0, 1, 17):
        got, want = port.batch(step, 4, 32), ref.batch(step, 4, 32)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32 and got[k].shape == (4, 32)
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                      got["labels"][:, :-1].numpy())


def test_bigram_chunks_its_gumbel_draws_without_changing_them(monkeypatch):
    """The Gumbel block is drawn a few steps at a time: any chunk gives
    the same stream."""
    from repro_torch.data import synthetic
    port = BigramLM(300, 200, seed=1, device="cpu")
    whole = port.batch(5, 3, 40)
    monkeypatch.setattr(synthetic, "_GUMBEL_CHUNK", 3 * 200 * 7)
    chunked = port.batch(5, 3, 40)
    for k in whole:
        assert torch.equal(whole[k], chunked[k])
