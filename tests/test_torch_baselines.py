"""The port's baselines (COMBINE and Zhang et al.'s coreset of coresets)
against the JAX package's, on a 9-site instance (5,000 x 10, k = 5,
grid(3, 3)), and one Zhang node at a time fed the reference's child
coresets. Sampled points are compared exactly; float outputs within the
tolerances stated at each test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core import clustering as jclustering
from repro.core import coreset as jcoreset
from repro.core import distributed as jdistributed
from repro.core import topology as jtopology
from repro.core.partition import pad_partition, partition_indices
from repro_torch import interop
from repro_torch.core import baselines, clustering, coreset, distributed, prng
from repro_torch.core import topology

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

K, S = 5, 60


@pytest.fixture(scope="module")
def sites():
    rng = np.random.default_rng(0)
    centers = 3.0 * rng.standard_normal((K, 10))
    data = np.concatenate(
        [c + 0.2 * rng.standard_normal((1000, 10)) for c in centers]
    ).astype(np.float32)
    sp, sm = pad_partition(data, partition_indices(data, 9, "weighted",
                                                   seed=1))
    return data, sp, sm


# the centres of the two packages agree to this (float32 Lloyd sums in
# another order; 2e-6 measured on this instance)
CENTRE_ATOL = 1e-5


def _nearest(q, centres):
    """float64 squared distance of each row of q to its nearest centre,
    and that centre."""
    d2 = ((q.astype(np.float64)[:, None, :]
           - centres.astype(np.float64)[None]) ** 2).sum(-1)
    b = d2.argmin(1)
    return d2[np.arange(len(q)), b], b


def _mass_rtol(q, centres):
    """Relative tolerance of each sample's weight w_q = W / (t m_q): its
    mass m_q = d2(q, B) is the float32 |q|^2 + |b|^2 - 2 q.b in both
    packages, off by a few roundings of |q|^2 + |b|^2, and its centre b
    differs by up to CENTRE_ATOL per coordinate, which moves d2 by
    2 |q - b| sqrt(d) CENTRE_ATOL. A point near its centre has a small d2
    and so a loose weight; a far one a tight weight."""
    d2, b = _nearest(q, centres)
    scale = (q.astype(np.float64) ** 2).sum(-1) + (
        centres.astype(np.float64)[b] ** 2).sum(-1)
    move = 2.0 * np.sqrt(d2) * np.sqrt(q.shape[-1]) * CENTRE_ATOL
    return 1e-5 + (8 * 2.0**-24 * scale + move) / np.maximum(d2, 1e-30)


# share of draws that may differ: the inverse-CDF draw reads a cumulative
# sum of masses that differ in the last bits, so a uniform within that
# much of a boundary takes the neighbouring point (1 of 999 draws seen)
MAX_DRAW_FLIPS = 0.002


def _check_coresets(p_pts, p_w, j_pts, j_w, n_samples):
    """Per coreset of ``n_samples`` draws + K centres (rows of a batch):
    zero-weight slots the same; the drawn points equal but for at most
    MAX_DRAW_FLIPS of the draws; centres within CENTRE_ATOL; each sample
    weight of an equal draw within its mass's tolerance (:func:`_mass_rtol`);
    each centre weight, W(P_b) minus the samples' weights, within the sum
    of its samples' tolerances (both weights of a differing draw), plus
    1e-5 of their weight and 1e-3 for the sums' own rounding."""
    np.testing.assert_array_equal(p_w == 0, j_w == 0)
    np.testing.assert_allclose(p_pts[:, n_samples:], j_pts[:, n_samples:],
                               rtol=0, atol=CENTRE_ATOL)
    flips = draws = 0
    for pp, pw, jp, jw in zip(p_pts, p_w, j_pts, j_w):
        live = np.nonzero(jw[:n_samples] != 0)[0]
        centres = jp[n_samples:]
        same = (pp[live] == jp[live]).all(-1)
        flips += int((~same).sum())
        draws += len(live)
        tol = _mass_rtol(jp[live], centres) * np.abs(jw[live])
        tol[~same] = np.abs(pw[live][~same]) + np.abs(jw[live][~same])
        err = np.abs(pw[live] - jw[live])
        assert (err[same] <= tol[same]).all(), (err / tol)[same].max()
        _, b = _nearest(jp[live], centres)
        w_tol = np.bincount(b, tol, minlength=len(centres))
        w_tol += 1e-5 * np.bincount(b, np.abs(jw[live]),
                                    minlength=len(centres))
        np.testing.assert_array_less(
            np.abs(pw[n_samples:] - jw[n_samples:]), w_tol + 1e-3)
    assert flips <= MAX_DRAW_FLIPS * draws, (flips, draws)


@pytest.mark.parametrize("t_total", [90, 270, 1000])
def test_combine_matches_reference(sites, t_total):
    _, sp, sm = sites
    key = jax.random.PRNGKey(3)
    j = jbaselines.combine(key, jnp.asarray(sp), jnp.asarray(sm), K,
                           t_total, backend="jnp")
    p = baselines.combine(interop.key(np.asarray(key), "cpu"), sp, sm, K,
                          t_total, device="cpu")
    s = t_total // 9
    assert p.points.shape == tuple(j.points.shape) == (9 * (s + K), 10)
    _check_coresets(p.points.numpy().reshape(9, s + K, 10),
                    p.weights.numpy().reshape(9, s + K),
                    np.asarray(j.points).reshape(9, s + K, 10),
                    np.asarray(j.weights).reshape(9, s + K), s)
    # every site's coreset keeps its weight |P_i|
    np.testing.assert_allclose(
        p.weights.double().numpy().reshape(9, -1).sum(1), sm.sum(1),
        rtol=1e-5)


def test_combine_kmedian_samples_match_reference(sites):
    _, sp, sm = sites
    key = jax.random.PRNGKey(4)
    j = jbaselines.combine(key, jnp.asarray(sp), jnp.asarray(sm), K, 180,
                           objective="kmedian", backend="jnp")
    p = baselines.combine(interop.key(np.asarray(key), "cpu"), sp, sm, K,
                          180, objective="kmedian", device="cpu")
    pts_p = p.points.numpy().reshape(9, 20 + K, 10)
    pts_j = np.asarray(j.points).reshape(9, 20 + K, 10)
    np.testing.assert_array_equal(pts_p[:, :20], pts_j[:, :20])


@pytest.mark.parametrize("make", [lambda m: m.grid(3, 3),
                                  lambda m: m.grid(10, 10),
                                  lambda m: m.wan_clusters(3, 3),
                                  lambda m: m.preferential(25, 2, seed=1)])
def test_combine_ledger_matches_reference(make):
    jg, pg = make(jtopology), make(topology)
    for t_total in (1, 400, 15000):
        j = jbaselines.combine_ledger(jg, jg.n, K, t_total, 90)
        p = baselines.combine_ledger(pg, pg.n, K, t_total, 90)
        assert p.as_dict(by_phase=True) == j.as_dict(by_phase=True)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 5153, 20000])
def test_pad_bucket_matches_reference(n):
    assert baselines._pad_bucket(n) == jbaselines._pad_bucket(n)


def _reference_zhang_nodes(key, sp, sm, tree):
    """The reference's zhang_tree loop, keeping every node's coreset
    (the loop of ``repro.core.baselines.zhang_tree``, line for line)."""
    keys = jax.random.split(key, tree.n)
    children = tree.children()
    store = [None] * tree.n
    for v in tree.bottom_up_order():
        own = sp[v][sm[v]]
        pts = np.concatenate([own] + [store[c][0] for c in children[v]])
        ws = np.concatenate([np.ones(len(own), np.float32)]
                            + [store[c][1] for c in children[v]])
        pad = jbaselines._pad_bucket(len(pts)) - len(pts)
        cs = jcoreset.build_coreset(
            keys[v], jnp.asarray(np.pad(pts, ((0, pad), (0, 0)))), K, S,
            weights=jnp.asarray(np.pad(ws, (0, pad))), backend="jnp")
        store[v] = (np.asarray(cs.points), np.asarray(cs.weights))
    return keys, store


@pytest.fixture(scope="module")
def zhang_reference(sites):
    _, sp, sm = sites
    tree = jtopology.bfs_spanning_tree(jtopology.grid(3, 3))
    key = jax.random.PRNGKey(5)
    keys, store = _reference_zhang_nodes(key, sp, sm, tree)
    cs, ledger = jbaselines.zhang_tree(key, sp, sm, tree, K, S,
                                       backend="jnp")
    return key, keys, store, cs, ledger


def test_reference_zhang_loop_is_the_reference(zhang_reference):
    """The per-node replica above gives the reference's own root."""
    _, _, store, cs, _ = zhang_reference
    np.testing.assert_array_equal(store[0][0], np.asarray(cs.points))
    np.testing.assert_array_equal(store[0][1], np.asarray(cs.weights))


@pytest.mark.parametrize("v", range(9))
def test_zhang_node_given_reference_children(sites, zhang_reference, v):
    """Node v alone: its own points and the reference's child coresets,
    carried across with interop.coreset, padded to 256 rows and built on
    the reference's key of node v, give the reference's node coreset."""
    _, sp, sm = sites
    _, keys, store, _, _ = zhang_reference
    tree = topology.bfs_spanning_tree(topology.grid(3, 3))
    kids = [interop.coreset(*store[c], "cpu") for c in tree.children()[v]]
    own = torch.from_numpy(sp[v][sm[v]])
    pts = torch.cat([own] + [c.points for c in kids])
    ws = torch.cat([torch.ones(own.shape[0])] + [c.weights for c in kids])
    pad = baselines._pad_bucket(pts.shape[0]) - pts.shape[0]
    cs = coreset.build_coreset(
        interop.key(np.asarray(keys[v]), "cpu"),
        torch.nn.functional.pad(pts, (0, 0, 0, pad)), K, S,
        weights=torch.nn.functional.pad(ws, (0, pad)), device="cpu")
    _check_coresets(cs.points.numpy()[None], cs.weights.numpy()[None],
                    store[v][0][None], store[v][1][None], S)


def test_zhang_tree_end_to_end(sites, zhang_reference):
    """The whole tree on both packages: the ledger equal exactly, the root
    coreset (s + k slots) keeps the total weight n, and its solve costs
    what the reference's costs to 1e-3 relative on the full data. Slot by
    slot the roots differ: each node's instance holds its children's
    coresets, whose float weights differ in the last bits, and four levels
    of D^2 seeding on them compound that into different draws (at least
    80% of the root's sampled slots are still equal); one node at a time
    the port is the reference's (test above)."""
    data, sp, sm = sites
    key, _, _, cs_j, ledger_j = zhang_reference
    tree = topology.bfs_spanning_tree(topology.grid(3, 3))
    cs_p, ledger_p = baselines.zhang_tree(interop.key(np.asarray(key),
                                                      "cpu"),
                                          sp, sm, tree, K, S, device="cpu")
    assert ledger_p.as_dict(by_phase=True) == ledger_j.as_dict(by_phase=True)
    assert ledger_p.points == 8 * (S + K)
    assert cs_p.points.shape == (S + K, 10)
    assert abs(float(cs_p.weights.double().sum()) - len(data)) < 0.05
    same = (cs_p.points.numpy()[:S] == np.asarray(cs_j.points)[:S]).all(-1)
    assert same.mean() >= 0.8
    k2 = jax.random.fold_in(key, 1)
    c_j = jdistributed._solve_on_coreset(k2, cs_j, K, "kmeans", 12, "jnp")
    c_p = distributed._solve_on_coreset(
        interop.key(np.asarray(k2), "cpu"), cs_p, K, "kmeans", 12, "torch")
    j = float(jclustering.cost(jnp.asarray(data), c_j, backend="jnp"))
    p = float(clustering.cost(data, c_p, device="cpu"))
    assert abs(p - j) <= 1e-3 * j


def test_fold_in_is_bit_equal():
    for seed in (0, 5, 2**31 + 9):
        for data in (0, 1, 7, 2**31 + 3):
            j = jax.random.fold_in(jax.random.PRNGKey(seed), data)
            p = prng.fold_in(prng.PRNGKey(seed), data)
            np.testing.assert_array_equal(p.numpy(),
                                          np.asarray(j).astype(np.int64))


def test_baselines_run_on_the_gpu_unless_asked_for_the_cpu(sites,
                                                          monkeypatch):
    _, sp, sm = sites
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baselines.combine(prng.PRNGKey(0), sp, sm, K, 90)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baselines.zhang_tree(prng.PRNGKey(0), sp, sm,
                             topology.bfs_spanning_tree(topology.grid(3, 3)),
                             K, S)
