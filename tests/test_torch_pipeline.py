"""The port's whole slice against the JAX package on the quickstart
instance (20,000 x 10, k=5, grid(3, 3), t=400): Algorithm 2 over the
flood and the BFS-tree routes, plus the numpy support modules, the backend
registry and the device rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclustering
from repro.core import coreset as jcoreset
from repro.core import distributed as jdistributed
from repro.core import topology as jtopology
from repro.core import comm as jcomm
from repro.core import partition as jpartition
from repro.data import synthetic as jsynthetic
from repro_torch import interop
from repro_torch.core import (backend, clustering, comm, coreset,
                              distributed, partition, prng, topology)
from repro_torch.data import synthetic

K, T = 5, 400


@pytest.fixture(scope="module")
def instance():
    rng = np.random.default_rng(0)
    centers = 3.0 * rng.standard_normal((K, 10))
    data = np.concatenate(
        [c + 0.2 * rng.standard_normal((4000, 10)) for c in centers]
    ).astype(np.float32)
    sp, sm = jpartition.pad_partition(
        data, jpartition.partition_indices(data, 9, "weighted", seed=1))
    return data, sp, sm


@pytest.fixture(scope="module")
def runs(instance):
    """Both packages, both routes, and both centralized baselines."""
    data, sp, sm = instance
    jg, tg = jtopology.grid(3, 3), topology.grid(3, 3)
    jkey, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0)
    out = {"jax": {}, "port": {}}
    for routing in ("flood", "bfs"):
        out["jax"][routing] = jdistributed.graph_distributed_kmeans(
            jkey, jnp.asarray(sp), jnp.asarray(sm), K, T, jg,
            routing=routing, backend="jnp")
        out["port"][routing] = distributed.graph_distributed_kmeans(
            tkey, sp, sm, K, T, tg, routing=routing, device="cpu")
    out["jax"]["tree"] = jdistributed.distributed_kmeans_tree(
        jkey, jnp.asarray(sp), jnp.asarray(sm), K, T,
        jtopology.bfs_spanning_tree(jg), backend="jnp")
    out["port"]["tree"] = distributed.distributed_kmeans_tree(
        tkey, sp, sm, K, T, topology.bfs_spanning_tree(tg), device="cpu")
    k1 = jax.random.split(jkey)[0]
    out["jax"]["t_i"] = np.asarray(jcoreset.distributed_coreset(
        k1, jnp.asarray(sp), jnp.asarray(sm), K, T, lloyd_iters=8,
        backend="jnp").t_i)
    out["port"]["t_i"] = coreset.distributed_coreset(
        prng.split(tkey)[0], sp, sm, K, T, lloyd_iters=8,
        device="cpu").t_i.numpy()
    _, out["jax"]["base"] = jclustering.solve(jkey, jnp.asarray(data), K,
                                              restarts=4, backend="jnp")
    _, out["port"]["base"] = clustering.solve(tkey, data, K, restarts=4,
                                              device="cpu")
    return out


ROUTES = ["flood", "bfs", "tree"]


def test_t_i_exactly_equal(runs):
    np.testing.assert_array_equal(runs["port"]["t_i"], runs["jax"]["t_i"])
    assert runs["port"]["t_i"].sum() == T


@pytest.mark.parametrize("route", ROUTES)
def test_ledgers_exactly_equal(runs, route):
    assert (runs["port"][route].ledger.as_dict(by_phase=True)
            == runs["jax"][route].ledger.as_dict(by_phase=True))


@pytest.mark.parametrize("route", ROUTES)
def test_centers_match_reference(runs, route):
    """Centers within rtol/atol 1e-3 of the reference's. Not tighter: at
    one of the nine sites the reference's jitted Lloyd step resolves a near
    tie the other way (a float64 re-run sides with the port), which moves
    that site's Round-1 solution by ~1e-2, hence its sampling masses and
    about 1% of its Round-2 draws; the final solve absorbs that to <1e-3."""
    np.testing.assert_allclose(runs["port"][route].centers.numpy(),
                               np.asarray(runs["jax"][route].centers),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("route", ROUTES)
def test_cost_ratio_matches_reference(runs, instance, route):
    data = instance[0]
    j = float(jclustering.cost(jnp.asarray(data), runs["jax"][route].centers,
                               backend="jnp") / runs["jax"]["base"])
    p = float(clustering.cost(data, runs["port"][route].centers,
                              device="cpu") / runs["port"]["base"])
    assert abs(p - j) <= 1e-4 * j
    assert p < 1.1


def test_routes_solve_the_same_centers(runs):
    """Flood and tree routes run the same math on the same keys: the port
    gives them bit-identical centers (only the ledgers differ)."""
    assert torch.equal(runs["port"]["flood"].centers,
                       runs["port"]["bfs"].centers)
    assert torch.equal(runs["port"]["bfs"].centers,
                       runs["port"]["tree"].centers)


def test_final_solve_on_the_reference_coreset(runs):
    """Algorithm 2's final solve alone, on the JAX package's coreset
    carried across: the same seeds and Lloyd steps give centers within
    1e-4 (float32 sums in another order)."""
    jres = runs["jax"]["flood"]
    k2 = jax.random.split(jax.random.PRNGKey(0))[1]
    j = jdistributed._solve_on_coreset(k2, jres.coreset, K, "kmeans", 8,
                                       "jnp")
    cs = interop.coreset(np.asarray(jres.coreset.points),
                         np.asarray(jres.coreset.weights), "cpu")
    p = distributed._solve_on_coreset(interop.key(np.asarray(k2), "cpu"),
                                      cs, K, "kmeans", 8, "torch")
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-4)


def test_solve_with_restarts_matches_reference(instance, runs):
    """The centralized baseline (best of 4 restarts) costs the same to
    1e-5 relative."""
    assert abs(float(runs["port"]["base"]) - float(runs["jax"]["base"])) \
        <= 1e-5 * float(runs["jax"]["base"])


def test_engines_and_routings_not_ported_raise(instance):
    _, sp, sm = instance
    g = topology.grid(3, 3)
    for kw, match in (({"engine": "exec"}, "not yet ported"),
                      ({"engine": "nope"}, "unknown engine"),
                      ({"routing": "min_cost"}, "not yet ported"),
                      ({"routing": "nope"}, "unknown routing"),
                      ({"strategy": "cohen_addad"}, "not yet ported"),
                      ({"objective": "power(3)"}, "not yet ported")):
        with pytest.raises(ValueError, match=match):
            distributed.graph_distributed_kmeans(prng.PRNGKey(0), sp, sm, K,
                                                 T, g, device="cpu", **kw)


# -- the device rule --------------------------------------------------------

def test_no_silent_cpu(instance, monkeypatch):
    """Without a GPU, an entry point called without device="cpu" raises
    instead of quietly running on the CPU."""
    data, sp, sm = instance
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.graph_distributed_kmeans(prng.PRNGKey(0), sp, sm, K, T,
                                             topology.grid(3, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        clustering.solve(prng.PRNGKey(0), data, K)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        coreset.distributed_coreset(prng.PRNGKey(0), sp, sm, K, T)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.key(np.zeros(2, np.uint32))
    assert backend.resolve_device("cpu") == torch.device("cpu")


def test_phase_times_are_reported(instance):
    _, sp, sm = instance
    times = {}
    distributed.graph_distributed_kmeans(prng.PRNGKey(0), sp, sm, K, T,
                                         topology.grid(3, 3), device="cpu",
                                         phase_times=times)
    assert set(times) == {"round1", "round2", "solve"}
    assert all(v >= 0.0 for v in times.values())


# -- the backend registry ---------------------------------------------------

def test_backend_auto_selection_follows_the_data_device():
    assert backend.resolve_name(None, "cpu") == "torch"
    assert backend.resolve_name(None, "cuda") == "cuda"
    assert backend.resolve_name(None, torch.device("cuda", 0)) == "cuda"
    assert set(backend.available_backends()) >= {"torch", "cuda"}
    with pytest.raises(KeyError, match="unknown clustering backend"):
        backend.resolve_name("pallas")


def test_use_backend_semantics():
    """The four behaviours of the reference's use_backend: plain-call
    stickiness, context restore, re-entering a stored instance, and exit
    without enter being a no-op."""
    assert backend.default_backend_name("cpu") == "torch"
    with backend.use_backend("cuda") as b:
        assert b.name == "cuda"
        assert backend.default_backend_name("cpu") == "cuda"
    assert backend.default_backend_name("cpu") == "torch"
    stored = backend.use_backend("cuda")          # sticky plain call
    assert backend.default_backend_name("cpu") == "cuda"
    with backend.use_backend("torch"):
        with stored:
            assert backend.default_backend_name("cpu") == "cuda"
        assert backend.default_backend_name("cpu") == "torch"
    stored.__exit__(None, None, None)             # no matching enter
    assert backend.default_backend_name("cpu") == "cuda"
    backend._local.default = None
    assert backend.default_backend_name("cpu") == "torch"


def test_backend_instances_never_shadow_a_name():
    class Other(backend.TorchBackend):
        name = "torch"
    with pytest.raises(ValueError, match="already registered"):
        backend.resolve_name(Other())
    custom = backend.TorchBackend()
    custom.name = "torch_custom_test"
    assert backend.resolve_name(custom) == "torch_custom_test"
    assert backend.get_backend("torch_custom_test") is custom
    with pytest.raises(TypeError):
        backend.resolve_name(object())


# -- the numpy support modules ----------------------------------------------

@pytest.mark.parametrize("make", [lambda m: m.grid(3, 3),
                                  lambda m: m.grid(10, 10),
                                  lambda m: m.erdos_renyi(25, 0.3, seed=2)])
def test_topology_copy_matches_reference(make):
    jg, tg = make(jtopology), make(topology)
    assert tg.edges == jg.edges and tg.n == jg.n
    np.testing.assert_array_equal(tg.degrees(), jg.degrees())
    jt, tt = jtopology.bfs_spanning_tree(jg), topology.bfs_spanning_tree(tg)
    assert (tt.parent, tt.depth, tt.height) == (jt.parent, jt.depth,
                                                jt.height)
    np.testing.assert_array_equal(tt.path_costs(), jt.path_costs())
    t_i = np.random.default_rng(tg.n).integers(0, 50, tg.n)
    pairs = [(jcomm.flood_portions_cost(jg, t_i, 5, 10),
              comm.flood_portions_cost(tg, t_i, 5, 10)),
             (jcomm.flood_cost(jg, jg.n, unit_scalars=1.0),
              comm.flood_cost(tg, tg.n, unit_scalars=1.0)),
             (jcomm.tree_allocation_cost(jt), comm.tree_allocation_cost(tt)),
             (jcomm.tree_up_cost(jt, list(t_i + 5.0), dim=10),
              comm.tree_up_cost(tt, list(t_i + 5.0), dim=10)),
             (jcomm.tree_broadcast_cost(jt, unit_points=5.0, dim=10),
              comm.tree_broadcast_cost(tt, unit_points=5.0, dim=10))]
    for j, p in pairs:
        assert p.as_dict(by_phase=True) == j.as_dict(by_phase=True)


def test_graph_validation_is_kept():
    with pytest.raises(ValueError, match="self-loop"):
        topology.Graph(3, ((1, 1),))
    with pytest.raises(ValueError, match="unsorted"):
        topology.Graph(3, ((1, 2), (0, 1)))
    with pytest.raises(ValueError, match="not connected"):
        topology.bfs_spanning_tree(topology.Graph(3, ((0, 1),)))


@pytest.mark.parametrize("method", ["uniform", "similarity", "weighted",
                                    "degree"])
def test_partition_copy_matches_reference(method):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((900, 4)).astype(np.float32)
    deg = np.arange(1, 10)
    j = jpartition.partition_indices(data, 9, method, seed=4, degrees=deg)
    p = partition.partition_indices(data, 9, method, seed=4, degrees=deg)
    for a, b in zip(j, p):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jpartition.pad_partition(data, j),
                    partition.pad_partition(data, p)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", synthetic.paper_dataset_names())
def test_paper_dataset_copy_matches_reference(name):
    assert synthetic.paper_dataset_names() == jsynthetic.paper_dataset_names()
    pts, k = synthetic.paper_dataset(name, seed=1, scale=0.01)
    pts_j, k_j = jsynthetic.paper_dataset(name, seed=1, scale=0.01)
    assert k == k_j
    np.testing.assert_array_equal(pts, pts_j)
