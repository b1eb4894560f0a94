"""The ring and 2-D torus collectives of the port's SPMD path against the
JAX package: ``torus_mesh_shape`` and ``collective_hops`` for every axis
size 1..64, and the four primitives on a group of 8 gloo ranks and one of
6 (``repro_torch.core.mesh.launch`` on the CPU, one thread per rank).

Payloads are seeded float32 arrays. The gathers' hold -0.0, +-inf, NaNs
with distinct payload bits and a denormal: every gather must relay them
bit for bit (equal to the stacked payloads, an all-gather). The sums add
in the reference's hop order, so each rank's total must equal the
reference's bit for bit; the reference's run in a subprocess on 8 forced
host devices (the 6-rank mesh takes the first six), as its own scripts
do. A NaN slot is held to be NaN (its payload bits are the CPU's choice).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import mesh as mesh_mod
from repro_torch.core import message_passing as mp

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (3, 5)
# the foldings of each world size the tests run (R, C); (1, W) and (W, 1)
# are the degenerate rings
FOLDINGS = {8: [(2, 4), (4, 2), (1, 8), (8, 1)],
            6: [(2, 3), (3, 2), (1, 6), (6, 1)]}
CASES = [(w, prim, f) for w in (8, 6)
         for prim, f in [("ring", None)] + [("torus", f)
                                            for f in FOLDINGS[w]]]
IDS = [f"{w}-{prim}" + ("" if f is None else f"{f[0]}x{f[1]}")
       for w, prim, f in CASES]


def payload(world, rank, kind):
    """Rank ``rank``'s seeded float32 payload of shape SHAPE. ``"gather"``
    holds -0.0, +-inf, a NaN whose payload bits name the rank and a
    denormal; ``"sum"`` holds finite values over seven decades, -0.0 on
    every rank (the total is -0.0), +inf on rank 2 and a NaN on rank 3."""
    rng = np.random.default_rng(1000 * world + 10 * rank
                                + (kind == "sum"))
    x = rng.standard_normal(SHAPE).astype(np.float32)
    if kind == "gather":
        x[0, 0] = -0.0
        x[0, 1] = np.inf if rank % 2 else -np.inf
        x[0, 2] = np.uint32(0x7FC00000 | (rank + 1)).view(np.float32)
        x[1, 0] = np.float32(1e-45) * rank
    else:
        x *= np.float32(10.0) ** rng.integers(-3, 4, SHAPE)
        x[0, 0] = -0.0
        x[0, 1] = np.inf if rank == 2 else x[0, 1]
        x[0, 2] = np.nan if rank == 3 else x[0, 2]
    return x


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.core.message_passing import (neighbor_rounds_gather,
                                            neighbor_rounds_sum,
                                            torus_rounds_gather,
                                            torus_rounds_sum)
    sys.path.insert(0, "tests")
    from test_torch_collectives import CASES, payload

    out = {}
    for w, prim, f in CASES:
        mesh = Mesh(np.array(jax.devices()[:w]), ("sites",))
        if prim == "ring":
            gather = lambda v: neighbor_rounds_gather(v, "sites", w)
            total = lambda v: neighbor_rounds_sum(v, "sites", w)
        else:
            gather = lambda v: torus_rounds_gather(v, "sites", f)
            total = lambda v: torus_rounds_sum(v, "sites", f)
        for kind, op in (("gather", gather), ("sum", total)):
            xs = np.stack([payload(w, r, kind) for r in range(w)])
            got = jax.jit(shard_map(lambda v: op(v[0])[None], mesh=mesh,
                                    in_specs=P("sites"),
                                    out_specs=P("sites")))(jnp.asarray(xs))
            out[f"{w}/{prim}/{f}/{kind}"] = np.asarray(got)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The JAX package's subprocess, started (it runs while the port's
    ranks do) with the path it saves its outputs to."""
    path = tmp_path_factory.mktemp("collectives_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(path)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    yield proc, path
    proc.kill()
    proc.communicate()


def _error(fn, *args):
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


def run_primitives(mesh):
    """One rank: every case of CASES on this world size, twice, plus the
    all-gather and the mismatch errors. Host arrays only."""
    torch.set_num_threads(1)
    w = mesh.size
    out = {}
    for rep in range(2):
        for ww, prim, f in CASES:
            if ww != w:
                continue
            for kind in ("gather", "sum"):
                x = torch.from_numpy(payload(w, mesh.rank, kind))
                if prim == "ring":
                    fn = (mp.neighbor_rounds_gather if kind == "gather"
                          else mp.neighbor_rounds_sum)
                    got = fn(x, "sites", w)
                else:
                    fn = (mp.torus_rounds_gather if kind == "gather"
                          else mp.torus_rounds_sum)
                    got = fn(x, "sites", f)
                out[f"{w}/{prim}/{f}/{kind}/{rep}"] = got.numpy()
    x = torch.from_numpy(payload(w, mesh.rank, "gather"))
    out["all_gather"] = mesh.all_gather(x).numpy()
    out["errors"] = {
        "ring sum, claimed 4": _error(mp.neighbor_rounds_sum, x, "sites", 4),
        "ring gather, claimed w + 1": _error(mp.neighbor_rounds_gather, x,
                                             "sites", w + 1),
        "ring gather, claimed 0": _error(mp.neighbor_rounds_gather, x,
                                         "sites", 0),
        "torus sum, (2, 2)": _error(mp.torus_rounds_sum, x, "sites", (2, 2)),
        "torus gather, (3, 3)": _error(mp.torus_rounds_gather, x, "sites",
                                       (3, 3)),
        "torus gather, (0, w)": _error(mp.torus_rounds_gather, x, "sites",
                                       (0, w)),
    }
    return out


@pytest.fixture(scope="module")
def port(reference_run):
    """Per world size, every rank's results of :func:`run_primitives`."""
    return {w: mesh_mod.launch(f"{__name__}:run_primitives", w,
                               device="cpu", timeout=240)
            for w in (8, 6)}


@pytest.fixture(scope="module")
def reference(reference_run, port):
    proc, path = reference_run
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log
    return dict(np.load(path))


@pytest.fixture(scope="module")
def jmp():
    """The reference's module, imported here and not at the top: the
    ranks import this file and need no JAX."""
    from repro.core import message_passing
    return message_passing


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint32)


@pytest.mark.parametrize("n", range(-1, 65))
def test_torus_mesh_shape_matches_reference(jmp, n):
    if n < 1:
        with pytest.raises(ValueError) as theirs:
            jmp.torus_mesh_shape(n)
        with pytest.raises(ValueError, match=str(theirs.value)):
            mp.torus_mesh_shape(n)
        return
    assert mp.torus_mesh_shape(n) == jmp.torus_mesh_shape(n)


HOPS = ([(mode, n, None) for mode in ("all_gather", "neighbor_rounds",
                                      "torus_2d") for n in range(1, 65)]
        + [("torus_2d", 16, (2, 8)), ("torus_2d", 16, (3, 2)),
           ("torus_2d", 8, (4, 2)), ("torus_2d", 6, (3, 2)),
           ("torus_2d", 7, (7, 1)), ("torus_2d", 12, (5, 2)),
           ("warp", 8, None), ("psum", 4, (2, 2))])


@pytest.mark.parametrize("mode,n,shape", HOPS,
                         ids=[f"{m}-{n}-{s}" for m, n, s in HOPS])
def test_collective_hops_matches_reference(jmp, mode, n, shape):
    try:
        want = jmp.collective_hops(mode, n, shape)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            mp.collective_hops(mode, n, shape)
        assert str(ours.value) == str(e)
        return
    assert mp.collective_hops(mode, n, shape) == want


@pytest.mark.parametrize("world,prim,folding", CASES, ids=IDS)
def test_gathers_relay_every_bit(port, world, prim, folding):
    """Every rank's gather equals the stacked payloads -- an all-gather --
    bit for bit, in flat row-major rank order."""
    want = np.stack([payload(world, r, "gather") for r in range(world)])
    for rank, out in enumerate(port[world]):
        got = out[f"{world}/{prim}/{folding}/gather/0"]
        assert got.shape == (world,) + SHAPE
        assert (_bits(got) == _bits(want)).all(), rank
        assert (_bits(out["all_gather"]) == _bits(want)).all(), rank


@pytest.mark.parametrize("world,prim,folding", CASES, ids=IDS)
def test_gathers_equal_the_reference(reference, port, world, prim, folding):
    key = f"{world}/{prim}/{folding}/gather"
    theirs = reference[key].reshape((world, world) + SHAPE)
    for rank, out in enumerate(port[world]):
        assert (_bits(out[key + "/0"]) == _bits(theirs[rank])).all(), rank


@pytest.mark.parametrize("world,prim,folding", CASES, ids=IDS)
def test_sums_equal_the_reference_bit_for_bit(reference, port, world, prim,
                                              folding):
    """Each rank adds in the reference's hop order: its total is the
    reference's at that rank bit for bit (NaN slots: NaN)."""
    key = f"{world}/{prim}/{folding}/sum"
    theirs = reference[key].reshape((world,) + SHAPE)
    for rank, out in enumerate(port[world]):
        ours = out[key + "/0"]
        nan = np.isnan(theirs[rank])
        assert (np.isnan(ours) == nan).all(), rank
        assert (_bits(ours)[~nan] == _bits(theirs[rank])[~nan]).all(), rank
        assert _bits(ours)[0, 0] == _bits(np.float32(-0.0)), rank
        assert ours[0, 1] == np.inf and nan[0, 2], rank


@pytest.mark.parametrize("world,prim,folding", CASES, ids=IDS)
def test_two_calls_are_bit_identical(port, world, prim, folding):
    for out in port[world]:
        for kind in ("gather", "sum"):
            key = f"{world}/{prim}/{folding}/{kind}"
            assert out[key + "/0"].tobytes() == out[key + "/1"].tobytes()


ERRORS = {"ring sum, claimed 4": "disagrees",
          "ring gather, claimed w + 1": "disagrees",
          "ring gather, claimed 0": "axis_size must be >= 1",
          "torus sum, (2, 2)": "disagrees",
          "torus gather, (3, 3)": "disagrees",
          "torus gather, (0, w)": "mesh_shape must be positive"}


@pytest.mark.parametrize("world", [8, 6])
@pytest.mark.parametrize("case", list(ERRORS))
def test_a_schedule_that_does_not_fit_the_group_raises(port, world, case):
    for out in port[world]:
        msg = out["errors"][case]
        assert msg is not None and ERRORS[case] in msg, (case, msg)
