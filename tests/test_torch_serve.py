"""The port's serving tier against the JAX package's: the query-bucketing
helpers, the (stacked-tenant) query entry points with the masking
contract, and ``ClusterServeEngine`` replayed on both packages with the
same tenants and traffic (tickets, counters, dispatched shapes), plus the
engine's refresh budget, validation and no-op rules.

On the CPU the batched argmin runs its plain version; the CUDA entry is
held to a loop of single-tenant launches by ``tests/test_torch_cuda.py``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serve import cluster as jcluster
from repro_torch.core import backend
from repro_torch.kernels import distance_argmin as da_mod
from repro_torch.kernels import ops, ref
from repro_torch.serve import ClusterServeEngine, StaticCenters

# (T, m, k, d): tenant count, queries per tenant, max centres, dimension
SHAPES = [(1, 8, 4, 3), (5, 12, 8, 16), (9, 33, 17, 7)]


def _tenants(T, m, k, d, seed=0):
    """Stacked queries and centres with ragged live centre counts."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, m, d)).astype(np.float32)
    c = rng.standard_normal((T, k, d)).astype(np.float32)
    k_real = rng.integers(1, k + 1, size=T)
    mask = np.arange(k)[None, :] < k_real[:, None]
    return q, c, mask, k_real


# -- query bucketing ---------------------------------------------------------

def test_query_bucket_matches_reference():
    for n in range(0, 300):
        for lo, hi in ((8, None), (8, 64), (1, 128), (16, 16)):
            assert ops.query_bucket(n, lo, hi) == jops.query_bucket(n, lo, hi)
    for fn in (ops.query_bucket, jops.query_bucket):
        with pytest.raises(ValueError, match="max_bucket"):
            fn(10, min_bucket=8, max_bucket=4)


def test_pad_queries_matches_reference():
    rng = np.random.default_rng(1)
    for n in (0, 1, 7, 8, 9, 100, 128):
        pts = rng.standard_normal((n, 3)).astype(np.float32)
        got, n_got = ops.pad_queries(torch.from_numpy(pts), max_bucket=128)
        want, n_want = jops.pad_queries(jnp.asarray(pts), max_bucket=128)
        assert n_got == n_want == n
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="chunk_queries"):
        ops.pad_queries(torch.zeros(100, 4), max_bucket=64)


def test_chunk_queries_matches_reference():
    rng = np.random.default_rng(0)
    for n in [0, 1, 7, 8, 64, 65, 200, 1000]:
        pts = rng.standard_normal((n, 3)).astype(np.float32)
        got = ops.chunk_queries(torch.from_numpy(pts), 8, 64)
        want = jops.chunk_queries(jnp.asarray(pts), 8, 64)
        assert [(c[1], c[2]) for c in got] == [(c[1], c[2]) for c in want]
        for (a, _, _), (b, _, _) in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- query entry points -------------------------------------------------------

@pytest.mark.parametrize("T,m,k,d", SHAPES)
def test_batched_ref_matches_reference_and_serial_loop(T, m, k, d):
    q, c, mask, _ = _tenants(T, m, k, d)
    c_sent = np.where(mask[..., None], c, ref.CENTER_SENTINEL).astype(
        np.float32)
    md, am = ops.min_dist_argmin_batched(torch.from_numpy(q),
                                         torch.from_numpy(c_sent))
    md_j, am_j = jref.min_dist_argmin_batched_ref(jnp.asarray(q),
                                                  jnp.asarray(c_sent))
    np.testing.assert_array_equal(am.numpy(), np.asarray(am_j))
    np.testing.assert_allclose(md.numpy(), np.asarray(md_j), rtol=1e-5,
                               atol=1e-5)
    for t in range(T):
        md_t, am_t = ops.min_dist_argmin(torch.from_numpy(q[t]),
                                         torch.from_numpy(c_sent[t]))
        assert torch.equal(md[t], md_t) and torch.equal(am[t], am_t)


@pytest.mark.parametrize("objective", ["kmeans", "kmedian"])
@pytest.mark.parametrize("T,m,k,d", SHAPES)
def test_query_assignments_batched_matches_reference(T, m, k, d, objective):
    """The same stacked, masked buffers through both packages: equal
    assignments, distances in the objective's metric (euclidean for
    k-median) within float32 tolerance; masked rows never win."""
    q, c, mask, k_real = _tenants(T, m, k, d, seed=2)
    a, dist = backend.query_assignments_batched(q, c, mask, objective,
                                                device="cpu")
    a_j, d_j = jbackend.query_assignments_batched(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(mask),
        objective=objective, backend="jnp")
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(dist.numpy(), np.asarray(d_j), rtol=1e-5,
                               atol=1e-5)
    assert (a.numpy() < k_real[:, None]).all()
    for t in range(T):
        a_s, d_s = backend.query_assignments(q[t], c[t, :k_real[t]],
                                             objective, device="cpu")
        a_sj, d_sj = jbackend.query_assignments(
            jnp.asarray(q[t]), jnp.asarray(c[t, :k_real[t]]), objective,
            backend="jnp")
        np.testing.assert_array_equal(a_s.numpy(), np.asarray(a_sj))
        np.testing.assert_allclose(d_s.numpy(), np.asarray(d_sj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(a[t].numpy(), a_s.numpy())


def test_batched_wrapper_refuses_cpu_tensors():
    before = (da_mod.KERNEL.launches, da_mod.KERNEL_BATCHED.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        da_mod.distance_argmin_batched(torch.zeros(2, 8, 3),
                                       torch.zeros(2, 64, 3))
    assert (da_mod.KERNEL.launches, da_mod.KERNEL_BATCHED.launches) == before


# -- the engine, replayed on both packages -----------------------------------

def _scenario(seed=7):
    """Tenants (k, d, objective, centres) and traffic: ragged k and d,
    both objectives, empty batches, an idle tenant and an oversized burst
    that must be chunked."""
    rng = np.random.default_rng(seed)
    tenants, traffic = [], []
    for t in range(10):
        k = int(rng.integers(1, 20))
        d = int(rng.choice([4, 6, 8]))
        obj = ("kmeans", "kmedian")[t % 2]
        tenants.append((k, d, obj, rng.standard_normal((k, d)).astype(
            np.float32)))
    for step in range(3):
        burst = []
        for t in range(9):               # tenant 9 stays idle
            n = [0, 1, 5, 40, 17][(t + step) % 5]
            if step == 1 and t == 2:
                n = 150                  # > max_bucket: chunked
            burst.append((t, rng.standard_normal(
                (n, tenants[t][1])).astype(np.float32)))
        traffic.append(burst)
    return tenants, traffic


def _replay(engine, static, tenants, traffic):
    tids = [engine.add_tenant(static(c), k=k, d=d, objective=obj)
            for k, d, obj, c in tenants]
    tickets = []
    for burst in traffic:
        tickets += [(t, q, engine.enqueue(tids[t], q)) for t, q in burst]
        engine.step()
    engine.run()
    return tickets


def test_engine_replay_matches_reference_engine():
    tenants, traffic = _scenario()
    port = ClusterServeEngine(max_bucket=32, max_group=4, device="cpu")
    ref_eng = jcluster.ClusterServeEngine(backend="jnp", max_bucket=32,
                                          max_group=4)
    got = _replay(port, StaticCenters, tenants, traffic)
    want = _replay(ref_eng, jcluster.StaticCenters, tenants, traffic)
    for (t, q, a), (_, _, b) in zip(got, want):
        assert a.done and b.done and a.n == b.n == q.shape[0]
        assert a.n_padded == b.n_padded
        np.testing.assert_array_equal(a.assign, np.asarray(b.assign))
        np.testing.assert_allclose(a.dist, np.asarray(b.dist), rtol=1e-5,
                                   atol=1e-6)
        # and equal to the port's own per-tenant query of the same rows
        if q.shape[0]:
            k, _, obj, c = tenants[t]
            a_s, d_s = backend.query_assignments(q, c, obj, device="cpu")
            np.testing.assert_array_equal(a.assign, a_s.numpy())
            np.testing.assert_allclose(a.dist, d_s.numpy(), rtol=1e-6,
                                       atol=1e-7)
    counts = {k: v for k, v in port.stats.as_dict().items()
              if not k.endswith("_s")}
    assert counts == {k: v for k, v in ref_eng.stats.as_dict().items()
                      if not k.endswith("_s")}
    assert port.compiled_shapes == ref_eng.compiled_shapes
    assert port.stats.n_dispatches < port.stats.n_tenant_dispatches


def test_dispatched_shape_set_bounded_under_adversarial_sweep():
    rng = np.random.default_rng(5)
    eng = ClusterServeEngine(min_bucket=8, max_bucket=64, device="cpu")
    tid = eng.add_tenant(StaticCenters(rng.standard_normal((4, 8))), k=4,
                         d=8)
    for n in list(range(1, 71)) + [500, 1337]:
        eng.enqueue(tid, rng.standard_normal((n, 8)).astype(np.float32))
        eng.run()
    assert {s[1] for s in eng.compiled_shapes} <= {8, 16, 32, 64}
    assert all((s[0] & (s[0] - 1)) == 0 for s in eng.compiled_shapes)
    assert len(eng.compiled_shapes) <= 2 * (int(math.log2(64 / 8)) + 1)


class _Source:
    """A centre source that solves on refresh (a new array each time) and
    turns stale on demand; it fits both packages' engines."""

    def __init__(self, centers, staleness=0.0):
        self._solution = centers
        self._cur = None
        self.stale = False
        self.s = staleness

    def cached_centers(self):
        return self._cur

    def is_stale(self):
        return self.stale

    def staleness(self):
        return self.s

    def refresh(self):
        self._cur = self._solution.copy()
        self.stale = False
        return self._cur


def _budget_scenario(engine):
    """refresh_budget=1: one re-solve per step; a never-solved tenant waits
    (deferred, not dropped); a stale solved tenant keeps serving."""
    rng = np.random.default_rng(3)
    srcs = [_Source(rng.standard_normal((4, 6)).astype(np.float32), s)
            for s in (1.0, 2.0)]
    tids = [engine.add_tenant(s, k=4, d=6) for s in srcs]
    q = np.zeros((5, 6), np.float32)
    log = []
    k1, k2 = (engine.enqueue(t, q) for t in tids)
    log.append((engine.step(), k1.done, k2.done))
    log.append((engine.step(), k1.done, k2.done))
    for s in srcs:
        s.stale = True
    k1, k2 = (engine.enqueue(t, q) for t in tids)
    log.append((engine.step(), k1.done, k2.done))
    return log, srcs


def test_refresh_budget_matches_reference():
    got, srcs = _budget_scenario(ClusterServeEngine(refresh_budget=1,
                                                    device="cpu"))
    want, _ = _budget_scenario(jcluster.ClusterServeEngine(
        backend="jnp", refresh_budget=1))
    assert got == want
    # step 1 served one tenant only; step 3 served both, one refreshed
    assert got[0][0] == 5 and got[0][1] != got[0][2]
    assert got[1] == (5, True, True) and got[2] == (10, True, True)
    assert [s.stale for s in srcs].count(True) == 1


def test_engine_empty_step_is_noop():
    eng = ClusterServeEngine(device="cpu")
    eng.add_tenant(StaticCenters(np.zeros((3, 4), np.float32)), k=3, d=4)
    before = eng.stats.as_dict()
    assert eng.step() == 0
    assert eng.run() == 0
    assert eng.stats.as_dict() == before
    assert eng.compiled_shapes == set()


def test_engine_validation_errors():
    eng = ClusterServeEngine(device="cpu")
    with pytest.raises(TypeError, match="center source"):
        eng.add_tenant(object(), k=3, d=4)
    tid = eng.add_tenant(StaticCenters(np.zeros((3, 4), np.float32)),
                         k=3, d=4)
    with pytest.raises(ValueError, match="already registered"):
        eng.add_tenant(StaticCenters(np.zeros((3, 4), np.float32)),
                       k=3, d=4, tenant_id=tid)
    with pytest.raises(ValueError, match="k >= 1"):
        eng.add_tenant(StaticCenters(np.zeros((1, 4), np.float32)),
                       k=0, d=4)
    with pytest.raises(ValueError, match="unknown objective"):
        eng.add_tenant(StaticCenters(np.zeros((3, 4), np.float32)),
                       k=3, d=4, objective="kmeans ")
    with pytest.raises(ValueError, match="not yet ported"):
        eng.add_tenant(StaticCenters(np.zeros((3, 4), np.float32)),
                       k=3, d=4, objective="power(3)")
    with pytest.raises(KeyError, match="unknown tenant"):
        eng.enqueue(tid + 999, np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="query points"):
        eng.enqueue(tid, np.zeros((2, 5), np.float32))
    with pytest.raises(ValueError, match="max_bucket"):
        ClusterServeEngine(min_bucket=64, max_bucket=8, device="cpu")
    # a refresh budget of 0 against a never-solved tenant cannot progress
    zero = ClusterServeEngine(refresh_budget=0, device="cpu")
    never = zero.add_tenant(_Source(np.zeros((2, 4), np.float32)), k=2, d=4)
    zero.enqueue(never, np.zeros((1, 4), np.float32))
    with pytest.raises(RuntimeError, match="cannot make progress"):
        zero.run()


def test_engine_runs_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusterServeEngine()
    assert ClusterServeEngine(device="cpu").backend == "torch"
