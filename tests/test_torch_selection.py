"""The port's coreset data selection (``repro_torch.data.selection``)
against the JAX package's (``repro.data.selection``): the selection cases
of ``tests/test_data_selection.py`` through both packages on the same
seeded pools, on the CPU.

``t_i`` and every index of a live slot are exact (the draws are the same
threefry words, and the masses agree but for the last bits); the weights
agree to 1e-3 of the largest end to end (the local Lloyd solves round
differently) and to 1e-5 given the reference's Round-1 state (the centre
weights are one-hot sums in another order). The chunked ``embed_examples``
equals one chunk bit for bit and the reference to 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclustering
from repro.data import selection as jselection
from repro_torch import interop
from repro_torch.core import clustering, prng
from repro_torch.data import (Selection, embed_examples, gather_selected,
                              select_coreset)

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

# weights given the reference's Round 1: the centre weights are one-hot
# sums in another order
WEIGHT_RTOL = 1e-5
# weights end to end, relative to the largest: the local Lloyd solves round
# differently, which moves the masses in their last bits
# (tests/test_torch_exec.py's CENTER_RTOL)
CENTER_RTOL = 1e-3
EMBED_RTOL = 1e-6


def _both(seed, emb, mask, **kw):
    """select_coreset in the port (CPU) and in the reference."""
    p = select_coreset(prng.PRNGKey(seed), emb, mask, device="cpu", **kw)
    j = jselection.select_coreset(jax.random.PRNGKey(seed), jnp.asarray(emb),
                                  jnp.asarray(mask), **kw)
    return p, j


def _same_selection(p, j, rtol=CENTER_RTOL):
    """``t_i``, the weight-0 pattern and every index of a live slot exact
    (an invalid slot's index is arbitrary); weights within ``rtol`` of the
    largest."""
    assert np.array_equal(p.t_i.numpy(), np.asarray(j.t_i))
    assert p.indices.dtype == torch.int32
    jw = np.asarray(j.weights)
    live = jw != 0
    assert np.array_equal(p.weights.numpy() != 0, live)
    assert np.array_equal(p.indices.numpy()[live], np.asarray(j.indices)[live])
    np.testing.assert_allclose(p.weights.numpy(), jw, rtol=rtol,
                               atol=rtol * float(np.abs(jw).max()))
    np.testing.assert_allclose(p.local_costs.numpy(),
                               np.asarray(j.local_costs), rtol=1e-5)


def _pool(seed, n_sites, M, d):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_sites, M, d)).astype(np.float32)


def test_select_coreset_preserves_mass_and_budget():
    n_sites, M, d = 4, 200, 16
    emb = _pool(0, n_sites, M, d)
    mask = np.ones((n_sites, M), bool)
    sel, jsel = _both(0, emb, mask, k=5, t=100)
    _same_selection(sel, jsel)
    assert int(sel.t_i.sum()) == 100
    np.testing.assert_allclose(float(sel.weights.double().sum()),
                               n_sites * M, rtol=1e-3)
    assert int(sel.indices.max()) < M and int(sel.indices.min()) >= 0


def test_selection_weighted_cost_approximates_pool_cost():
    rng = np.random.default_rng(1)
    n_sites, M, d = 4, 300, 8
    emb = np.concatenate([
        c + 0.3 * rng.standard_normal((n_sites, M // 4, d))
        for c in 3.0 * rng.standard_normal((4, d))], axis=1
    ).astype(np.float32)
    mask = np.ones((n_sites, M), bool)
    sel, jsel = _both(1, emb, mask, k=4, t=400)
    _same_selection(sel, jsel)
    flat = torch.from_numpy(emb).reshape(-1, d)
    rows = torch.arange(n_sites)[:, None]
    sel_pts = torch.from_numpy(emb)[rows, sel.indices.long()].reshape(-1, d)
    sel_w = sel.weights.reshape(-1)
    errs = []
    for trial in range(5):
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(10 + trial),
                                         (4, d)))
        full = float(clustering.cost(flat, x, device="cpu"))
        approx = float(clustering.cost(sel_pts, x, weights=sel_w,
                                       device="cpu"))
        jfull = float(jclustering.cost(jnp.asarray(flat.numpy()),
                                       jnp.asarray(x)))
        assert full == pytest.approx(jfull, rel=1e-5)
        errs.append(abs(approx / full - 1))
    assert max(errs) < 0.2, errs


def test_masked_pool_never_selects_padding():
    """Ragged pools: padded examples carry weight 0 and never join the
    selection, as in the reference; t_buffer above t keeps its slots
    weight-0."""
    n_sites, M, d = 3, 120, 6
    emb = _pool(5, n_sites, M, d)
    mask = np.ones((n_sites, M), bool)
    mask[0, 90:] = False
    mask[2, 40:] = False
    sel, jsel = _both(5, emb, mask, k=4, t=60, t_buffer=70, lloyd_iters=3)
    _same_selection(sel, jsel)
    w = sel.weights.numpy()
    idx = sel.indices.numpy()
    assert not (w[mask[np.arange(n_sites)[:, None], idx] == 0] != 0).any()
    np.testing.assert_allclose(float(sel.weights.double().sum()),
                               mask.sum(), rtol=1e-3)


def _reference_round1(key, emb, mask, k, lloyd_iters=5):
    """The reference's local solves as ``_select_coreset`` runs them (its
    key split, its public clustering calls under a jitted vmap): keys,
    masses, assignments, centre examples."""
    n_sites = emb.shape[0]
    w_site = jnp.asarray(mask).astype(jnp.float32)
    keys = jax.random.split(key, 2 * n_sites).reshape(n_sites, 2, -1)

    @jax.jit
    def solves(keys, emb, w_site):
        def one(ki, pts, w):
            c = jclustering.kmeans_pp_init(ki, pts, k, weights=w,
                                           backend="jnp")
            c, _ = jclustering.lloyd(pts, c, weights=w, iters=lloyd_iters,
                                     backend="jnp")
            d2, a = jclustering.min_dist_argmin(pts, c, backend="jnp")
            dc = jclustering.pairwise_sq_dists(c, pts)
            dc = jnp.where(w[None, :] > 0, dc, jnp.inf)
            return w * d2, a, jnp.argmin(dc, axis=1).astype(jnp.int32)
        return jax.vmap(one)(keys[:, 0], emb, w_site)

    m, a, c_idx = solves(keys, jnp.asarray(emb), w_site)
    return keys, np.asarray(m), np.asarray(a), np.asarray(c_idx)


@pytest.mark.parametrize("seed,k,t", [(0, 5, 100), (1, 4, 400)])
def test_local_samples_given_the_references_round1(seed, k, t):
    """The port's sampling stage on the reference's Round-1 masses,
    assignments and centre examples (carried across with ``interop``):
    ``t_i`` and every index exact, weights to 1e-5."""
    from repro_torch.core.coreset import _windowed_sum, \
        proportional_allocation
    from repro_torch.data.selection import _local_samples
    emb = _pool(seed, 4, 200, 8)
    mask = np.ones((4, 200), bool)
    jsel = jselection.select_coreset(jax.random.PRNGKey(seed),
                                     jnp.asarray(emb), jnp.asarray(mask),
                                     k=k, t=t)
    keys, m, a, c_idx = _reference_round1(jax.random.PRNGKey(seed), emb,
                                          mask, k)
    m = interop.tensor(m, "cpu")
    local_costs = _windowed_sum(m)
    np.testing.assert_array_equal(local_costs.numpy(),
                                  np.asarray(jsel.local_costs))
    t_i = proportional_allocation(local_costs, t)
    idx, w = _local_samples(interop.key(np.asarray(keys[:, 1]), "cpu"), m,
                            torch.from_numpy(mask).float(),
                            interop.tensor(a, "cpu"),
                            interop.tensor(c_idx, "cpu"), t_i,
                            _windowed_sum(local_costs), k, t, t)
    _same_selection(Selection(idx, w, t_i, local_costs), jsel,
                    rtol=WEIGHT_RTOL)
    assert np.array_equal(idx.numpy(), np.asarray(jsel.indices))


def test_gather_selected_layout():
    rng = np.random.default_rng(2)
    n_sites, M, L = 3, 50, 12
    toks = rng.integers(0, 100, size=(n_sites, M, L)).astype(np.int32)
    emb = rng.standard_normal((n_sites, M, 4)).astype(np.float32)
    mask = np.ones((n_sites, M), bool)
    sel, jsel = _both(2, emb, mask, k=3, t=20)
    _same_selection(sel, jsel)
    out = gather_selected(torch.from_numpy(toks), sel)
    jout = jselection.gather_selected(jnp.asarray(toks), jsel)
    assert out["tokens"].shape == (n_sites * (20 + 3), L)
    assert out["weights"].shape == (n_sites * 23,)
    assert np.array_equal(out["tokens"].numpy(), np.asarray(jout["tokens"]))
    # the reference's selection, carried across, gathers the same rows
    carried = interop.selection(np.asarray(jsel.indices),
                                np.asarray(jsel.weights),
                                np.asarray(jsel.t_i),
                                np.asarray(jsel.local_costs), "cpu")
    assert isinstance(carried, Selection)
    got = gather_selected(toks, carried)
    assert np.array_equal(got["tokens"].numpy(), np.asarray(jout["tokens"]))
    assert np.array_equal(got["weights"].numpy(),
                          np.asarray(jout["weights"]))


def test_embed_examples_shape_and_values():
    table = np.random.default_rng(0).standard_normal((64, 8)).astype(
        np.float32)
    toks = np.random.default_rng(1).integers(0, 64, size=(2, 5, 10)).astype(
        np.int32)
    emb = embed_examples(table, toks, device="cpu")
    assert emb.shape == (2, 5, 8) and emb.dtype == torch.float32
    ref = np.asarray(jselection.embed_examples(jnp.asarray(table),
                                               jnp.asarray(toks)))
    np.testing.assert_allclose(emb.numpy(), ref, rtol=EMBED_RTOL,
                               atol=EMBED_RTOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("chunk_bytes", [1, 10 * 16 * 4 * 3, 10 ** 9])
def test_chunked_embed_examples_equal_one_chunk(monkeypatch, chunk_bytes):
    """One example at a time, three at a time and all at once give the
    same bits (bfloat16 tables are upcast per chunk)."""
    from repro_torch.data import selection
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((97, 16)).astype(
        np.float32))
    toks = torch.from_numpy(rng.integers(0, 97, size=(3, 7, 10)))
    half = table.to(torch.bfloat16)
    monkeypatch.setattr(selection, "EMBED_CHUNK_BYTES", 10 ** 12)
    whole = embed_examples(table, toks, device="cpu")
    whole_half = embed_examples(half.float(), toks, device="cpu")
    monkeypatch.setattr(selection, "EMBED_CHUNK_BYTES", chunk_bytes)
    assert torch.equal(embed_examples(table, toks, device="cpu"), whole)
    assert torch.equal(embed_examples(half, toks, device="cpu"), whole_half)


def test_selection_rerun_is_bit_identical():
    emb = _pool(7, 2, 64, 5)
    mask = np.ones((2, 64), bool)
    a = select_coreset(prng.PRNGKey(3), emb, mask, 3, 16, device="cpu")
    b = select_coreset(prng.PRNGKey(3), emb, mask, 3, 16, device="cpu")
    for f in ("indices", "weights", "t_i", "local_costs"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
