"""The port's public signatures and the API pieces that came with them,
against the JAX package: shared functions take the reference's parameters
in the reference's order (the port's extras, such as ``device``, after
them), the ``chunk`` argument and its ``"torch_chunked"`` backend, and the
strategy descriptor's ``validate`` hook."""
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jclustering
from repro.core import strategy as jstrategy
from repro.core.backend import JnpChunkedBackend
from repro_torch.core import backend, clustering, strategy

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

MODULES = ("backend", "baselines", "clustering", "comm", "coreset",
           "distributed", "message_passing", "objective", "partition",
           "strategy", "topology")
# modules outside core, by their path in the package
PACKAGE_MODULES = ("wan.faults", "wan.schedules", "wan.runtime",
                   "wan.quiesce", "data.selection", "models.sharding",
                   "models.layers", "models.moe", "models.ssd",
                   "models.rglru", "models.blocks", "models.model",
                   "train.loss", "train.train_step", "train.pipeline",
                   "optim.adamw", "optim.compression", "optim.schedule",
                   "checkpoint.manager", "serve.engine", "launch.mesh",
                   "launch.shapes", "launch.ft", "launch.train",
                   "launch.serve", "launch.specs", "launch.dryrun")


def _path(mod):
    return mod if mod in PACKAGE_MODULES else f"core.{mod}"


def _shared_functions():
    for mod in MODULES + PACKAGE_MODULES:
        port = importlib.import_module(f"repro_torch.{_path(mod)}")
        ref = importlib.import_module(f"repro.{_path(mod)}")
        for name in sorted(vars(port)):
            f, g = getattr(port, name), getattr(ref, name, None)
            if (name.startswith("_") or not inspect.isfunction(f)
                    or not inspect.isfunction(g)
                    or f.__module__ != port.__name__):
                continue
            yield mod, name


SHARED = list(_shared_functions())


def test_the_clustering_names_are_all_held():
    names = {n for m, n in SHARED if m == "clustering"}
    assert names >= {"cost", "kmeans_pp_init", "lloyd", "lloyd_converged",
                     "lloyd_stats", "min_dist_argmin", "pairwise_sq_dists",
                     "point_costs", "solve", "weiszfeld_stats"}
    assert {("message_passing", "flood_exec"),
            ("distributed", "graph_distributed_kmeans"),
            ("distributed", "distributed_kmeans"),
            ("coreset", "staged_distributed_coreset"),
            ("coreset", "merge_coresets"),
            ("distributed", "spmd_distributed_kmeans"),
            ("distributed", "spmd_distributed_kmeans_fn"),
            ("message_passing", "neighbor_rounds_gather"),
            ("message_passing", "neighbor_rounds_sum"),
            ("message_passing", "torus_rounds_gather"),
            ("message_passing", "torus_rounds_sum"),
            ("message_passing", "torus_mesh_shape"),
            ("message_passing", "collective_hops")} <= set(SHARED)
    assert {("wan.faults", "random_fault_plan"),
            ("wan.schedules", "activation_masks"),
            ("wan.schedules", "liveness_masks"),
            ("wan.runtime", "wan_flood_exec"),
            ("wan.runtime", "async_algorithm1_rounds"),
            ("wan.runtime", "restricted_sim_coreset"),
            ("wan.quiesce", "certify_quiescence"),
            ("data.selection", "select_coreset"),
            ("data.selection", "embed_examples"),
            ("data.selection", "gather_selected")} <= set(SHARED)
    assert {("models.model", "init_params"), ("models.model", "forward"),
            ("models.model", "init_cache"), ("models.model", "cache_spec"),
            ("models.model", "make_positions"),
            ("models.layers", "attention_apply"),
            ("models.moe", "moe_apply"), ("models.ssd", "ssd_apply"),
            ("models.rglru", "rglru_apply"), ("models.blocks", "block_apply"),
            ("models.sharding", "param_specs"), ("train.loss", "lm_loss"),
            ("train.loss", "chunked_lm_loss")} <= set(SHARED)
    assert {("train.train_step", "loss_fn"),
            ("train.train_step", "make_train_step"),
            ("train.train_step", "init_state"),
            ("train.pipeline", "pipeline_forward"),
            ("optim.adamw", "update"), ("optim.adamw", "init"),
            ("optim.adamw", "clip_by_global_norm"),
            ("optim.compression", "compressed_psum"),
            ("optim.compression", "compress_with_feedback"),
            ("optim.schedule", "warmup_cosine"),
            ("checkpoint.manager", "restore"), ("checkpoint.manager", "save"),
            ("serve.engine", "generate"),
            ("serve.engine", "make_serve_steps"),
            ("serve.engine", "sample_token")} <= set(SHARED)
    assert {("launch.mesh", "make_mesh"),
            ("launch.mesh", "make_production_mesh"),
            ("launch.specs", "build_cell"), ("launch.specs", "input_specs"),
            ("launch.specs", "default_microbatches"),
            ("launch.dryrun", "run_cell"), ("launch.dryrun", "main"),
            ("launch.ft", "detect_straggler"),
            ("launch.shapes", "cells_for"), ("launch.shapes", "all_cells"),
            ("launch.train", "main"), ("launch.train", "parse_args"),
            ("launch.train", "build_cfg"),
            ("launch.serve", "main")} <= set(SHARED)


@pytest.mark.parametrize("mod,name", SHARED,
                         ids=[f"{m}.{n}" for m, n in SHARED])
def test_parameters_are_the_references_in_order(mod, name):
    """The reference's parameter names are a prefix of the port's, so
    positional calls bind alike; the port's own parameters come after."""
    port = getattr(importlib.import_module(f"repro_torch.{_path(mod)}"),
                   name)
    ref = getattr(importlib.import_module(f"repro.{_path(mod)}"), name)
    theirs = list(inspect.signature(ref).parameters)
    ours = list(inspect.signature(port).parameters)
    assert ours[:len(theirs)] == theirs, (ours, theirs)


def test_graph_distributed_kmeans_takes_the_references_full_prefix():
    """faults, wan_mode, wan_seed and wan_p sit where the reference has
    them, strategy after them, the port's device and phase_times last."""
    from repro.core import distributed as jdistributed
    from repro_torch.core import distributed
    for name in ("graph_distributed_kmeans", "distributed_kmeans"):
        ours = list(inspect.signature(getattr(distributed, name)).parameters)
        theirs = list(inspect.signature(
            getattr(jdistributed, name)).parameters)
        assert ours == theirs + ["device", "phase_times"]
        assert ours[12:17] == ["faults", "wan_mode", "wan_seed", "wan_p",
                               "strategy"]


@pytest.mark.parametrize("kw", [{"faults": "plan"},
                                {"faults": "plan", "routing": "bfs",
                                 "engine": "exec"},
                                {"engine": "async"}],
                         ids=["faults-sim", "faults-exec", "async"])
def test_faults_and_async_raise_not_yet_ported(kw):
    """The WAN runtime is ported (the test keeps the name it had before),
    so the reference's rules hold: a faults plan needs
    engine='exec'|'async' (the sim engine raises) and flood routing (a
    tree route raises), with the reference's messages; engine="async" runs
    on the WAN runtime."""
    from repro.core import distributed as jdistributed
    from repro.core import topology as jtopology
    from repro.wan.faults import FaultPlan as JFaultPlan
    from repro_torch.core import distributed, prng, topology
    from repro_torch.wan import FaultPlan
    g = topology.grid(2, 2)
    sp = np.random.default_rng(0).standard_normal((4, 8, 3)).astype(
        np.float32)
    sm = np.ones((4, 8), bool)
    ours = dict(kw, faults=FaultPlan(seed=0)) if "faults" in kw else kw
    if kw.get("engine") == "async":
        res = distributed.graph_distributed_kmeans(prng.PRNGKey(0), sp, sm,
                                                   2, 8, g, device="cpu",
                                                   **ours)
        assert res.centers.shape == (2, 3)
        assert bool(torch.isfinite(res.centers).all())
        return
    theirs = dict(kw, faults=JFaultPlan(seed=0))
    with pytest.raises(ValueError) as err:
        distributed.graph_distributed_kmeans(prng.PRNGKey(0), sp, sm, 2, 8,
                                             g, device="cpu", **ours)
    with pytest.raises(ValueError) as jerr:
        jdistributed.graph_distributed_kmeans(
            jax.random.PRNGKey(0), jnp.asarray(sp), jnp.asarray(sm), 2, 8,
            jtopology.grid(2, 2), **theirs)
    assert str(err.value) == str(jerr.value).replace("repro.wan",
                                                     "repro_torch.wan")
    assert "not yet ported" not in str(err.value)


# the stream package's public classes and their methods, against the
# reference's (repro.stream)
STREAM_CLASSES = ("TreeConfig", "CoresetTree", "StreamState",
                  "AggregateResult", "DistributedStream",
                  "ClusterQueryService", "ServiceStats")


def _stream_methods():
    import repro.stream as jstream
    import repro_torch.stream as pstream
    for cls in STREAM_CLASSES:
        port, ref = getattr(pstream, cls), getattr(jstream, cls)
        yield cls, "__init__"
        for name, f in sorted(vars(port).items()):
            if (not name.startswith("_") and inspect.isfunction(f)
                    and inspect.isfunction(getattr(ref, name, None))):
                yield cls, name


STREAM_METHODS = list(_stream_methods())


def test_every_stream_class_and_method_is_held():
    assert {c for c, _ in STREAM_METHODS} == set(STREAM_CLASSES)
    assert {("DistributedStream", "aggregate"), ("CoresetTree", "push"),
            ("StreamState", "summary"), ("ClusterQueryService", "query"),
            ("ClusterQueryService", "query_load")} <= set(STREAM_METHODS)


@pytest.mark.parametrize("cls,name", STREAM_METHODS,
                         ids=[f"{c}.{n}" for c, n in STREAM_METHODS])
def test_stream_parameters_are_the_references_in_order(cls, name):
    """Constructors and public methods of the stream classes take the
    reference's parameters as a prefix (the port's device after them)."""
    import repro.stream as jstream
    import repro_torch.stream as pstream
    ours = list(inspect.signature(
        getattr(getattr(pstream, cls), name)).parameters)
    theirs = list(inspect.signature(
        getattr(getattr(jstream, cls), name)).parameters)
    assert ours[:len(theirs)] == theirs, (ours, theirs)
    assert set(ours[len(theirs):]) <= {"device"}, ours


LAUNCH_CLASSES = (("ft", "Heartbeat"), ("ft", "Supervisor"),
                  ("ft", "SupervisorConfig"), ("specs", "Cell"),
                  ("shapes", "ShapeSpec"))


def _launch_methods():
    for mod, cls in LAUNCH_CLASSES:
        port = getattr(importlib.import_module(f"repro_torch.launch.{mod}"),
                       cls)
        ref = getattr(importlib.import_module(f"repro.launch.{mod}"), cls)
        yield mod, cls, "__init__"
        for name, f in sorted(vars(ref).items()):
            if not name.startswith("_") and inspect.isfunction(f):
                assert inspect.isfunction(getattr(port, name, None)), name
                yield mod, cls, name


LAUNCH_METHODS = list(_launch_methods())


@pytest.mark.parametrize("mod,cls,name", LAUNCH_METHODS,
                         ids=[f"{c}.{n}" for _, c, n in LAUNCH_METHODS])
def test_launch_classes_take_the_references_parameters(mod, cls, name):
    """The launchers' classes (``Heartbeat``, ``Supervisor`` and its
    config, ``Cell``, ``ShapeSpec``): constructors and public methods
    take the reference's parameters as a prefix."""
    port = getattr(importlib.import_module(f"repro_torch.launch.{mod}"), cls)
    ref = getattr(importlib.import_module(f"repro.launch.{mod}"), cls)
    ours = list(inspect.signature(getattr(port, name)).parameters)
    theirs = list(inspect.signature(getattr(ref, name)).parameters)
    assert ours[:len(theirs)] == theirs, (ours, theirs)


# -- chunk= and the torch_chunked backend ------------------------------------

def _instance(n=1000, d=7, k=6, seed=0):
    """n points (a tail block that 64 does not divide), k centres drawn
    apart from the points (on a point, k-median's sqrt of the matmul-form
    self-distance is rounding noise, which the packages round differently;
    ROADMAP C), positive weights."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return pts, rng.standard_normal((k, d)).astype(np.float32), w


@pytest.mark.parametrize("objective", ["kmeans", "kmedian"])
def test_cost_chunk_matches_reference_chunked(objective):
    """chunk=64 on the plain backend against the reference's jnp_chunked
    path (its chunk=64 on jnp), with tests/test_kernels.py's tolerances:
    per-point costs to 1e-5, the cost to 1e-5 relative."""
    pts, ctr, w = _instance()
    got = clustering.cost(pts, ctr, w, objective, 64, backend="torch",
                          device="cpu")
    want = jclustering.cost(jnp.asarray(pts), jnp.asarray(ctr),
                            jnp.asarray(w), objective, 64, backend="jnp")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    pc, pa = clustering.point_costs(pts, ctr, objective, 64, "torch",
                                    device="cpu")
    jc, ja = jclustering.point_costs(jnp.asarray(pts), jnp.asarray(ctr),
                                     objective, 64, "jnp")
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))


def test_chunk_upgrades_only_the_plain_backend(monkeypatch):
    """chunk turns a resolved "torch" backend (explicit or ambient) into a
    chunked one and leaves "cuda" alone; the third positional argument of
    min_dist_argmin is chunk, as in the reference."""
    pts, ctr, _ = _instance()
    seen = []
    for cls in (backend.TorchBackend, backend.TorchChunkedBackend,
                backend.CudaBackend):
        orig = cls.min_dist_argmin
        monkeypatch.setattr(
            cls, "min_dist_argmin",
            lambda self, p, c, _o=orig: seen.append(self) or _o(self, p, c))
    md, am = clustering.min_dist_argmin(pts, ctr, 64, "torch", device="cpu")
    assert [type(b) for b in seen] == [backend.TorchChunkedBackend]
    assert seen[0].chunk == 64
    with backend.use_backend("torch"):
        clustering.min_dist_argmin(pts, ctr, chunk=128, device="cpu")
    assert type(seen[-1]) is backend.TorchChunkedBackend
    assert seen[-1].chunk == 128
    clustering.min_dist_argmin(pts, ctr, chunk=64, backend="cuda",
                               device="cpu")
    assert type(seen[-1]) is backend.CudaBackend
    md_d, am_d = clustering.min_dist_argmin(pts, ctr, backend="torch",
                                            device="cpu")
    np.testing.assert_allclose(md.numpy(), md_d.numpy(), rtol=1e-6)
    assert torch.equal(am, am_d)
    # the reference's benchmark recipe, at its chunk
    assert torch.isfinite(clustering.cost(pts, ctr, chunk=65536,
                                          device="cpu"))


@pytest.mark.parametrize("op", ["lloyd_stats", "weiszfeld_stats"])
def test_torch_chunked_stats_match_reference(op):
    """The registered "torch_chunked" backend against the reference's
    JnpChunkedBackend at chunk=64 (15 full blocks and a tail), with
    tests/test_kernels.py's tolerances; per site, it gives what each
    site's own call gives."""
    pts, ctr, w = _instance()
    b = backend.TorchChunkedBackend(64, name="torch_chunked_64")
    got = getattr(b, op)(torch.from_numpy(pts), torch.from_numpy(ctr),
                         torch.from_numpy(w))
    want = getattr(JnpChunkedBackend(64), op)(
        jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)
    sites = torch.from_numpy(np.stack([pts, pts[::-1].copy()]))
    batched = getattr(b, op)(sites, torch.from_numpy(ctr).expand(2, -1, -1),
                             torch.from_numpy(np.stack([w, w[::-1]])))
    for s in range(2):
        one = getattr(b, op)(sites[s], torch.from_numpy(ctr),
                             torch.from_numpy(np.stack([w, w[::-1]])[s]))
        for x, y in zip(batched, one):
            assert torch.equal(x[s], y)
    assert "torch_chunked" in backend.available_backends()


def test_torch_chunked_batched_entry_matches_reference():
    """The stacked-tenant entry in tenant blocks (chunk // m tenants each,
    the last padded with sentinel centres) against the reference's."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((7, 10, 4)).astype(np.float32)
    c = rng.standard_normal((7, 3, 4)).astype(np.float32)
    b = backend.TorchChunkedBackend(32, name="torch_chunked_32")
    md, am = b.min_dist_argmin_batched(torch.from_numpy(q),
                                       torch.from_numpy(c))
    jmd, jam = JnpChunkedBackend(32).min_dist_argmin_batched(
        jnp.asarray(q), jnp.asarray(c))
    np.testing.assert_allclose(md.numpy(), np.asarray(jmd), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(am.numpy(), np.asarray(jam))
    assert md.shape == (7, 10)


def test_lloyd_takes_k_at_the_references_position():
    pts, ctr, w = _instance(n=300, k=4)
    a, ha = clustering.lloyd(pts, ctr, w, 3, "kmeans", 4, "torch",
                             device="cpu")
    b, hb = clustering.lloyd(pts, ctr, w, iters=3, backend="torch",
                             device="cpu")
    assert torch.equal(a, b) and torch.equal(ha, hb)


# -- the strategy descriptor's validate hook ---------------------------------

def _reject(strat):
    if strat.name.startswith("bad"):
        raise ValueError(f"strategy {strat.name!r} rejected")


@pytest.mark.parametrize("package", ["port", "reference"])
def test_strategy_validate_runs_at_construction(package):
    """A descriptor whose validate rejects raises at construction, in both
    packages; an accepted one is built and handed to validate once."""
    mod = strategy if package == "port" else jstrategy
    with pytest.raises(ValueError, match="rejected"):
        mod.CoresetStrategy(name="bad_protocol", validate=_reject)
    seen = []
    ok = mod.CoresetStrategy(name="checked_protocol",
                             validate=lambda s: seen.append(s.name))
    assert seen == ["checked_protocol"] and ok.validate is not None
    assert mod.CoresetStrategy(name="plain").validate is not None
