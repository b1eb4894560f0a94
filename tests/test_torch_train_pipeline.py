"""The port's GPipe pipeline (``repro_torch.train.pipeline``) against the
JAX package's: the schedule's bubble math, and ``pipeline_forward`` on 4
gloo ranks against the reference's ``pipeline_forward`` under
``shard_map`` on 4 forced host devices (run in a subprocess, the stage
params taken by a reshape, which jax 0.9 accepts inside ``shard_map``
where the reference test's ``w_all[0]`` raises), both against the stages
applied in sequence."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.train.pipeline import PipelineSchedule as JPipelineSchedule
from repro_torch.core import mesh as mesh_mod
from repro_torch.train.pipeline import PipelineSchedule, pipeline_forward

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, MB, D = 4, 8, 2, 16
# the stages in sequence (the reference test's tolerance)
SEQ_TOL = 2e-4
# the two packages' tanh(x @ w), four stages deep: float32 matmuls and
# tanh in other orders
REF_TOL = 1e-5


def pipeline_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((S, D, D)).astype(np.float32)
          / np.sqrt(D)).astype(np.float32)
    xs = rng.standard_normal((M, MB, D)).astype(np.float32)
    return ws, xs


def sequential(ws, xs):
    out = xs.astype(np.float64)
    for w in ws:
        out = np.tanh(out @ w.astype(np.float64))
    return out


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.train.pipeline import pipeline_forward
    sys.path.insert(0, "tests")
    from test_torch_train_pipeline import S, pipeline_inputs

    ws, xs = pipeline_inputs()
    mesh = jax.make_mesh((S,), ("stage",))

    def run(w_all, mbs):
        return pipeline_forward(lambda w, x: jnp.tanh(x @ w),
                                w_all.reshape(w_all.shape[1:]), mbs,
                                "stage", S)

    out = jax.jit(shard_map(run, mesh=mesh, in_specs=(P("stage"), P()),
                            out_specs=P("stage")))(jnp.asarray(ws),
                                                   jnp.asarray(xs))
    np.save(sys.argv[1], np.asarray(out).reshape(S, *xs.shape))
""")


def _stage(w, x):
    return torch.tanh(x @ w)


def run_pipeline(mesh):
    torch.set_num_threads(1)
    ws, xs = pipeline_inputs()
    out = pipeline_forward(_stage, torch.from_numpy(ws[mesh.rank]),
                           torch.from_numpy(xs), mesh.axis_name, S)
    return out.numpy()


def test_schedule_bubble_math():
    s = PipelineSchedule(n_stages=4, n_microbatches=12)
    assert s.ticks == 15
    assert abs(s.bubble_fraction - 3 / 15) < 1e-9
    s2 = PipelineSchedule(n_stages=1, n_microbatches=8)
    assert s2.bubble_fraction == 0.0
    for stages in (1, 2, 4, 8):
        for mbs in (1, 3, 16):
            a = PipelineSchedule(stages, mbs)
            b = JPipelineSchedule(stages, mbs)
            assert (a.ticks, a.bubble_fraction) == (b.ticks,
                                                    b.bubble_fraction)


def test_pipeline_matches_the_reference_and_sequential(tmp_path):
    """The last rank holds every microbatch through all four stages, the
    others zeros, as the reference's shards do."""
    path = tmp_path / "pp.npy"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(path)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    try:
        ranks = mesh_mod.launch(f"{__name__}:run_pipeline", S,
                                axis_name="stage", device="cpu", timeout=240)
        log, _ = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, log
    want = np.load(path)
    ws, xs = pipeline_inputs()
    seq = sequential(ws, xs)
    np.testing.assert_allclose(want[-1], seq, rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(ranks[-1], seq, rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(ranks[-1], want[-1], rtol=REF_TOL,
                               atol=REF_TOL)
    for r in range(S - 1):
        assert not ranks[r].any() and not want[r].any(), r


def run_one_stage(mesh):
    ws, xs = pipeline_inputs()
    return pipeline_forward(_stage, torch.from_numpy(ws[0]),
                            torch.from_numpy(xs), mesh.axis_name, 1).numpy()


def test_one_stage_is_the_stage_and_a_wrong_count_raises():
    out, = mesh_mod.launch(f"{__name__}:run_one_stage", 1,
                           axis_name="stage", device="cpu", timeout=120)
    ws, xs = pipeline_inputs()
    np.testing.assert_allclose(out, np.tanh(xs @ ws[0]), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(RuntimeError, match="not 2 stages"):
        mesh_mod.launch(f"{__name__}:run_pipeline_two_stages", 1,
                        axis_name="stage", device="cpu", timeout=120)


def run_pipeline_two_stages(mesh):
    ws, xs = pipeline_inputs()
    return pipeline_forward(_stage, torch.from_numpy(ws[0]),
                            torch.from_numpy(xs), mesh.axis_name, 2)
