"""The SPMD mesh path (``spmd_distributed_kmeans``) of the port against the
JAX package, on the reference's own instances: the 8-site instance of
``test_core_distributed.SPMD_SCRIPT`` and ``test_collectives.TORUS_SCRIPT``
(k = 4, d = 8, 1,600 points, t = 256) and the 6-site instance of
``NONPOW2_SCRIPT`` (1,200 points, t = 192). The collectives each run
issues, by phase, are held to the reference's compiled program, parsed by
``repro.roofline.hlo.collective_phase_analysis`` as
``test_collectives.TORUS_SCRIPT`` parses it.

The reference runs in one subprocess on 8 forced host devices (a 6-device
mesh takes the first six), as its own scripts do, and saves ``np.asarray``
of every output. The port runs on one group of 8 gloo ranks and one of 6
(``repro_torch.core.mesh.launch`` on the CPU), each rank on one thread,
with the reference's keys. ``t_i`` must equal the reference's exactly,
local costs agree to rtol 1e-5 and centres to 1e-3 of max |centre| (the
tolerance of ``test_torch_pipeline.test_centers_match_reference``);
within the port the three collectives and all ranks are bit-identical.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import mesh as mesh_mod
from repro_torch.core import prng
from repro_torch.core.clustering import cost
from repro_torch.core.coreset import proportional_allocation
from repro_torch.core.distributed import (spmd_distributed_kmeans,
                                          spmd_distributed_kmeans_fn)
from repro_torch.core.partition import pad_partition, partition_indices
from repro_torch.roofline import trace

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, D = 4, 8
T8, T6 = 256, 192
LAUNCH_TIMEOUT = 240.0

# name -> (instance, keyword arguments of spmd_distributed_kmeans); the
# instance "eight" (8 sites), "sixteen" (16 sites merged two per rank) or
# "six" (the 6-site instance on a 6-rank mesh)
RUNS = {
    "kmeans/all_gather": ("eight", {}),
    "kmeans/neighbor_rounds": ("eight", {"collectives": "neighbor_rounds"}),
    "kmeans/torus_2d": ("eight", {"collectives": "torus_2d"}),
    "kmeans/torus_2d(4,2)": ("eight", {"collectives": "torus_2d",
                                       "mesh_shape": (4, 2)}),
    "kmedian/all_gather": ("eight", {"objective": "kmedian"}),
    "kmedian/neighbor_rounds": ("eight", {"objective": "kmedian",
                                          "collectives": "neighbor_rounds"}),
    "kmedian/torus_2d": ("eight", {"objective": "kmedian",
                                   "collectives": "torus_2d"}),
    "kmedian/torus_2d(4,2)": ("eight", {"objective": "kmedian",
                                        "collectives": "torus_2d",
                                        "mesh_shape": (4, 2)}),
    "mapreduce/all_gather": ("eight", {"strategy": "mapreduce"}),
    "merge16/all_gather": ("sixteen", {}),
    "six/all_gather": ("six", {}),
    "six/neighbor_rounds": ("six", {"collectives": "neighbor_rounds"}),
    "six/torus_2d": ("six", {"collectives": "torus_2d"}),
}
EIGHT = [name for name, (inst, _) in RUNS.items() if inst != "six"]
SIX = [name for name, (inst, _) in RUNS.items() if inst == "six"]
# the runs whose collectives are held to the reference's compiled program:
# the three modes on 8 ranks and on 6
PHASE_RUNS = ["kmeans/all_gather", "kmeans/neighbor_rounds",
              "kmeans/torus_2d", "six/all_gather", "six/neighbor_rounds",
              "six/torus_2d"]


def instance(which, pad_partition=pad_partition,
             partition_indices=partition_indices):
    """(points, site points, site mask, t, t_buffer) of the reference's
    scripts, from their seeds (partitioned by the given package's
    functions)."""
    per, n_sites, seed, t = {"eight": (400, 8, 1, T8),
                             "sixteen": (400, 16, 2, T8),
                             "six": (300, 6, 1, T6)}[which]
    rng = np.random.default_rng(0)
    c0 = 3.0 * rng.standard_normal((K, D))
    pts = np.concatenate([c0[i] + 0.15 * rng.standard_normal((per, D))
                          for i in range(K)]).astype(np.float32)
    sp, sm = pad_partition(pts, partition_indices(pts, n_sites, "weighted",
                                                  seed=seed))
    # the merged case runs with the default t_buffer, the others at t
    return pts, sp, sm, t, (None if which == "sixteen" else t)


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.core import clustering, spmd_distributed_kmeans
    from repro.core.distributed import spmd_distributed_kmeans_fn
    from repro.core.partition import pad_partition, partition_indices
    from repro.roofline.hlo import collective_phase_analysis
    sys.path.insert(0, "tests")
    from test_torch_spmd import K, PHASE_RUNS, RUNS, instance

    def inst(which):
        return instance(which, pad_partition, partition_indices)

    out = {"key": np.asarray(jax.random.PRNGKey(0))}
    for name, (which, kw) in RUNS.items():
        pts, sp, sm, t, t_buffer = inst(which)
        n = 6 if which == "six" else 8
        mesh = Mesh(np.array(jax.devices()[:n]), ("sites",))
        c, lc, t_i = spmd_distributed_kmeans(
            mesh, "sites", jax.random.PRNGKey(0), jnp.asarray(sp),
            jnp.asarray(sm), K, t=t, t_buffer=t_buffer, **kw)
        out[name + ":centers"] = np.asarray(c)
        out[name + ":local_costs"] = np.asarray(lc)
        out[name + ":t_i"] = np.asarray(t_i)
    for which in ("eight", "six"):
        pts = inst(which)[0]
        for objective in ("kmeans", "kmedian"):
            _, full = clustering.solve(jax.random.PRNGKey(0),
                                       jnp.asarray(pts), K, restarts=4,
                                       objective=objective)
            out[f"{which}:{objective}:full"] = np.asarray(full)
    # each mode's compiled program, its collectives by phase
    for name in PHASE_RUNS:
        which, kw = RUNS[name]
        pts, sp, sm, t, t_buffer = inst(which)
        n = 6 if which == "six" else 8
        mesh = Mesh(np.array(jax.devices()[:n]), ("sites",))
        fn = spmd_distributed_kmeans_fn("sites", n, K, t, t_buffer, **kw)

        def device_fn(key, p, m):
            return fn(key, p.reshape(-1, p.shape[-1]), m.reshape(-1))
        hlo = jax.jit(shard_map(
            device_fn, mesh=mesh, in_specs=(P(), P("sites"), P("sites")),
            out_specs=(P(), P("sites"), P("sites")),
        )).lower(jax.random.PRNGKey(0), jnp.asarray(sp),
                 jnp.asarray(sm)).compile().as_text()
        for phase, a in collective_phase_analysis(hlo).items():
            for kind, count in a.collective_counts.items():
                out[f"{name}:{phase}:{kind}:count"] = count
                out[f"{name}:{phase}:{kind}:bytes"] = (
                    a.collective_bytes_by_kind[kind])
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The JAX package's subprocess, started (it runs while the port's
    ranks do) with the path it saves its outputs to."""
    path = tmp_path_factory.mktemp("spmd_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(path)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    yield proc, path
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run, port):
    """The JAX package's outputs for every run of :data:`RUNS` (after the
    port's, so the two run side by side)."""
    proc, path = reference_run
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    return dict(np.load(path))


def _error(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


def run_ranks(mesh, names):
    """One rank: every run of ``names`` (from the reference's key, on the
    CPU), its phase record, its collectives by phase
    (``trace.collective_phase_analysis`` of the collectives recorded around
    the run: per phase, counts and link bytes by kind) and the validation
    errors. Host values only."""
    torch.set_num_threads(1)
    key = prng.PRNGKey(0, device="cpu")
    out = {}
    for name in names:
        which, kw = RUNS[name]
        _, sp, sm, t, t_buffer = instance(which)
        times = {}
        with trace.record() as led:
            c, lc, t_i = spmd_distributed_kmeans(
                mesh, "sites", key, sp, sm, K, t=t, t_buffer=t_buffer,
                phase_times=times, **kw)
        out[name] = (c.numpy(), lc.numpy(), t_i.numpy(), times)
        out[name + ":collectives"] = {
            phase: (a.collective_counts, a.collective_bytes_by_kind)
            for phase, a in trace.collective_phase_analysis(
                led.collectives).items()}
    _, sp, sm, t, _ = instance("eight" if mesh.size == 8 else "six")
    run = (mesh, "sites", key, sp, sm, K)
    out["errors"] = {
        "does not tile": _error(spmd_distributed_kmeans, *run, t=t,
                                collectives="torus_2d", mesh_shape=(3, 3)),
        "torus": _error(spmd_distributed_kmeans, *run, t=t,
                        mesh_shape=(2, 4)),
        "unknown collectives": _error(spmd_distributed_kmeans, *run, t=t,
                                      collectives="warp"),
        "must divide": _error(spmd_distributed_kmeans, mesh, "sites", key,
                              sp[:-1], sm[:-1], K, t=t),
    }
    return out


@pytest.fixture(scope="module")
def port(reference_run):
    """Every run of :data:`RUNS` on the port: 8 gloo ranks, then 6. Maps
    run name -> per-rank (centers, local_costs, t_i, phase record)."""
    out = {}
    for names, world in ((EIGHT, 8), (SIX, 6)):
        ranks = mesh_mod.launch(f"{__name__}:run_ranks", world, (names,),
                                device="cpu", timeout=LAUNCH_TIMEOUT)
        for name in names:
            out[name] = [r[name] for r in ranks]
            out[name + ":collectives"] = [r[name + ":collectives"]
                                          for r in ranks]
        out[f"errors{world}"] = [r["errors"] for r in ranks]
    return out


def _rank0(port, name):
    return port[name][0]


@pytest.mark.parametrize("name", list(RUNS))
def test_t_i_equal_the_reference(reference, port, name):
    np.testing.assert_array_equal(_rank0(port, name)[2],
                                  reference[name + ":t_i"])


@pytest.mark.parametrize("name", list(RUNS))
def test_local_costs_match_the_reference(reference, port, name):
    np.testing.assert_allclose(_rank0(port, name)[1],
                               reference[name + ":local_costs"], rtol=1e-5)


@pytest.mark.parametrize("name", list(RUNS))
def test_centers_match_the_reference(reference, port, name):
    ours, theirs = _rank0(port, name)[0], reference[name + ":centers"]
    assert ours.shape == theirs.shape == (K, D)
    scale = np.abs(theirs).max()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-3 * scale)


@pytest.mark.parametrize("name", list(RUNS))
def test_every_rank_holds_rank_0s_result_bit_for_bit(port, name):
    first = port[name][0]
    for r, other in enumerate(port[name][1:], 1):
        for a, b in zip(first[:3], other[:3]):
            assert a.tobytes() == b.tobytes(), (name, r)


@pytest.mark.parametrize("group", [
    ["kmeans/all_gather", "kmeans/neighbor_rounds", "kmeans/torus_2d",
     "kmeans/torus_2d(4,2)"],
    ["kmedian/all_gather", "kmedian/neighbor_rounds", "kmedian/torus_2d",
     "kmedian/torus_2d(4,2)"],
    ["six/all_gather", "six/neighbor_rounds", "six/torus_2d"]],
    ids=["kmeans", "kmedian", "six"])
def test_collectives_are_bit_identical(port, group):
    """The schedules relay bytes and the consumer code is the same, so the
    modes agree bit for bit with no barrier."""
    first = _rank0(port, group[0])
    for name in group[1:]:
        for a, b in zip(first[:3], _rank0(port, name)[:3]):
            assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("name", list(RUNS))
def test_allocation_sums_to_t_within_the_buffer(port, name):
    which, _ = RUNS[name]
    _, sp, _, t, t_buffer = instance(which)
    _, lc, t_i, _ = _rank0(port, name)
    world = 6 if which == "six" else 8
    assert t_i.dtype == np.int32 and t_i.shape == (world,)
    assert int(t_i.sum()) == t
    buffer = t_buffer if t_buffer is not None else max(4 * t // world, 64)
    assert (t_i <= buffer).all(), (t_i, buffer)
    if not name.startswith("mapreduce"):
        host = proportional_allocation(torch.from_numpy(lc), t).numpy()
        np.testing.assert_array_equal(t_i, host)


def test_default_buffer_of_the_merged_sites_is_sized_off_the_axis(port):
    """16 sites on 8 ranks: each rank merges two, so the default buffer is
    max(4 t // 8, 64) = 128 and no allocation exceeds it."""
    _, lc, t_i, _ = _rank0(port, "merge16/all_gather")
    assert lc.shape == (8,) and (t_i <= 128).all() and t_i.sum() == T8


def test_mapreduce_takes_the_uniform_split(port):
    _, _, t_i, times = _rank0(port, "mapreduce/all_gather")
    uniform = proportional_allocation(torch.ones(8), T8).numpy()
    np.testing.assert_array_equal(t_i, uniform)
    # no Round-1 gather: two gathers, both in Round 2
    assert times["gathers"] == 2 and "round1_gather_bytes" not in times


@pytest.mark.parametrize("name", list(RUNS))
def test_cost_ratio_against_the_centralized_solve(reference, port, name):
    """The reference script's bound: cost(P, centres) / a 4-restart
    centralized solve < 1.3, in the run's own objective."""
    which, kw = RUNS[name]
    pts = instance(which)[0]
    objective = kw.get("objective", "kmeans")
    base = "six" if which == "six" else "eight"
    full = float(reference[f"{base}:{objective}:full"])
    c = torch.from_numpy(_rank0(port, name)[0])
    ratio = float(cost(pts, c, objective=objective, device="cpu")) / full
    assert ratio < 1.3, ratio


@pytest.mark.parametrize("name", ["kmeans/all_gather", "kmeans/torus_2d",
                                  "six/torus_2d", "mapreduce/all_gather"])
def test_phase_record(port, name):
    """Walls of every phase; bytes each rank received per round (8 or 6
    ranks: the scalars, then t_buffer + k rows of d + 1 floats); hops of
    one gather; nothing staged on the CPU."""
    which, kw = RUNS[name]
    _, _, _, t, t_buffer = instance(which)
    world = 6 if which == "six" else 8
    times = _rank0(port, name)[3]
    for phase in ("round1", "round1_gather", "sample", "round2_gather",
                  "solve", "output_gather"):
        assert times[phase] >= 0.0, phase
    rows = t_buffer + K
    assert times["round2_gather_bytes"] == (world - 1) * rows * (D + 1) * 4
    if "strategy" not in kw:
        assert times["round1_gather_bytes"] == (world - 1) * 4
    assert times["output_gather_bytes"] == 2 * (world - 1) * 4
    hops = {"all_gather": world - 1, "torus_2d": {8: 4, 6: 3}[world]}
    assert times["hops"] == hops[kw.get("collectives", "all_gather")]
    assert times["staged_bytes"] == 0


@pytest.mark.parametrize("name", PHASE_RUNS)
def test_collectives_by_phase_equal_the_compiled_references(reference, port,
                                                            name):
    """Every rank's collectives in Round 1 and Round 2 -- counts and link
    bytes by kind, the port's round1_gather and round2_gather phases
    against the reference's round1 and round2 scopes -- equal what the
    reference's compiled program issues: one all-gather, or one
    collective-permute per ring or torus hop. "other" differs by the
    port's output gather: spmd_distributed_kmeans hands every rank the
    local costs and t_i by two all-gathers of one 4-byte scalar per rank,
    where the reference's shard_map assembles its sharded outputs outside
    the compiled program, with no collective."""
    world = 6 if name.startswith("six") else 8
    for rank in port[name + ":collectives"]:
        for phase in ("round1", "round2"):
            counts, link = rank[phase]
            prefix = f"{name}:{phase}:"
            kinds = {key[len(prefix):].rsplit(":", 1)[0]
                     for key in reference if key.startswith(prefix)}
            assert kinds, (name, phase)
            assert counts == {kind: float(reference[prefix + kind + ":count"])
                              for kind in kinds}, (name, phase)
            assert link == {kind: float(reference[prefix + kind + ":bytes"])
                            for kind in kinds}, (name, phase)
        assert not any(key.startswith(f"{name}:other:") for key in reference)
        scalars = world * 4
        assert rank["other"] == ({"all-gather": 2.0}, {
            "all-gather": 2 * (world - 1) / world * scalars})


@pytest.mark.parametrize("world", [8, 6])
@pytest.mark.parametrize("words", ["does not tile", "torus",
                                   "unknown collectives", "must divide"])
def test_validation_errors(port, world, words):
    for errors in port[f"errors{world}"]:
        assert errors[words] is not None and words in errors[words], errors


def test_the_port_runs_on_the_references_key(reference):
    """The ranks' key, ``prng.PRNGKey(0)``, is the reference's key carried
    over: the same raw words."""
    ours = prng.PRNGKey(0, device="cpu")
    assert torch.equal(interop.key(reference["key"], "cpu"), ours)


def test_fn_validates_before_any_rank_runs():
    """`spmd_distributed_kmeans_fn` validates without a mesh, in the
    reference's words."""
    with pytest.raises(ValueError, match="unknown collectives"):
        spmd_distributed_kmeans_fn("sites", 8, K, T8, T8, collectives="warp")
    with pytest.raises(ValueError, match="does not tile"):
        spmd_distributed_kmeans_fn("sites", 8, K, T8, T8,
                                   collectives="torus_2d", mesh_shape=(3, 2))
    with pytest.raises(ValueError, match="only meaningful with"):
        spmd_distributed_kmeans_fn("sites", 8, K, T8, T8, mesh_shape=(2, 4))


def test_a_nccl_mesh_on_a_shared_device_raises():
    """nccl needs one GPU per rank; it never falls back to gloo."""
    with pytest.raises(ValueError, match="nccl mesh runs on CUDA"):
        mesh_mod.launch(f"{__name__}:run_ranks", 2, ((),), backend="nccl",
                        device="cpu")
    with pytest.raises(ValueError, match="share a device"):
        mesh_mod.launch(f"{__name__}:run_ranks", 2, ((),), backend="nccl",
                        device="cuda:0")
    with pytest.raises(ValueError, match="unknown mesh backend"):
        mesh_mod.launch(f"{__name__}:run_ranks", 2, ((),), backend="mpi",
                        device="cpu")


def fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    return mesh.rank


def hang_on_rank_0(mesh):
    if mesh.rank == 0:
        import time
        time.sleep(600)
    return mesh.rank


def test_a_failed_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        mesh_mod.launch(f"{__name__}:fail_on_rank_1", 2, device="cpu",
                        timeout=60)
    assert "rank 1 fails on purpose" in str(err.value)


def test_a_rank_past_the_deadline_is_killed():
    with pytest.raises(RuntimeError, match="did not finish") as err:
        mesh_mod.launch(f"{__name__}:hang_on_rank_0", 2, device="cpu",
                        timeout=6)
    assert "ranks [0" in str(err.value)


def test_collectives_need_a_bound_axis():
    with pytest.raises(ValueError, match="is not bound"):
        mesh_mod.axis("sites")
