"""The port's threefry2x32 against ``jax.random``: the same keys give the
same bits, so the port samples what the JAX package samples."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import strategy as jstrategy
from repro_torch import interop
from repro_torch.core import prng, strategy

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
