"""The port's fault tolerance (``repro_torch.launch.ft``) and its training
launcher under it: the reference's three cases of ``test_fault_tolerance.py``
through the port -- heartbeat round trip, straggler detection, and the
crash -> supervisor restart -> resume -> finish run of
``python -m repro_torch.launch.train --device cpu`` with
``REPRO_FAIL_AT_STEP`` -- plus one check the reference lacks: the resumed
run's final checkpoint is bit-equal to an uninterrupted run's with the
same arguments. Both runs draw their batches under one PYTHONHASHSEED
(``BigramLM`` hashes a string, which Python salts per process)."""
import json
import os
import subprocess
import sys

import torch

from repro import launch as jlaunch
from repro_torch import tree as tree_mod
from repro_torch.checkpoint import latest_step, restore
from repro_torch.launch.ft import (Heartbeat, Supervisor, SupervisorConfig,
                                   detect_straggler)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_port_keeps_its_own_copy():
    from repro_torch.launch import ft
    assert ft.Heartbeat is not jlaunch.ft.Heartbeat
    assert ft.Supervisor is not jlaunch.ft.Supervisor


def test_heartbeat_roundtrip(tmp_path):
    hb = Heartbeat(str(tmp_path / "hb.json"))
    hb.beat(3, {"loss": 1.5})
    with open(tmp_path / "hb.json") as f:
        data = json.load(f)
    assert data["step"] == 3 and data["loss"] == 1.5
    hb.beat(4)
    assert len(hb.step_times()) == 1


def test_detect_straggler():
    assert detect_straggler([1.0] * 10) is None
    times = [1.0] * 8 + [5.0] + [1.0]
    assert detect_straggler(times, factor=3.0) == 8
    assert detect_straggler([1.0, 1.2], factor=3.0) is None  # too few


def _argv(ckpt, hb, metrics):
    return [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "mamba2_370m", "--reduced",
            "--steps", "20", "--batch", "4", "--seq", "32",
            "--ckpt-dir", ckpt, "--ckpt-every", "5",
            "--heartbeat", hb, "--log-every", "5",
            "--metrics-out", metrics, "--device", "cpu"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env["PYTHONHASHSEED"] = "0"
    env.pop("REPRO_FAIL_AT_STEP", None)
    return env


def _final(ckpt):
    """The final checkpoint's leaves (``restore`` onto a target built from
    the file's own tree: the params' and the AdamW state's leaves)."""
    from repro_torch import configs
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    cfg = configs.get_reduced("mamba2_370m")
    params = init_params(0, cfg, "cpu")
    tree, step = restore(ckpt, target=(params, adamw.init(params)))
    return step, tree_mod.leaves(tree)


def test_crash_restart_resume_completes(tmp_path):
    """End-to-end: the trainer crashes at step 12 (injected), the
    supervisor restarts it, it resumes from the step-10 checkpoint and
    finishes all 20 steps; its final checkpoint is bit for bit an
    uninterrupted run's."""
    ckpt = str(tmp_path / "ckpt")
    hb = str(tmp_path / "hb.json")
    metrics = str(tmp_path / "metrics.json")
    env = _env()
    env["REPRO_FAIL_AT_STEP"] = "12"

    class TwoPhaseSupervisor(Supervisor):
        """Remove the failure injection after the first restart (the bug
        'goes away' once restarted -- models a node failure)."""

        def run(self):
            ret = None
            while True:
                proc = subprocess.Popen(self.argv, env=self.env, cwd=ROOT)
                ret = proc.wait()
                if ret == 0:
                    return 0
                self.events.append(f"exit-{ret}")
                self.restarts += 1
                self.env.pop("REPRO_FAIL_AT_STEP", None)
                if self.restarts > self.cfg.max_restarts:
                    return ret

    sup = TwoPhaseSupervisor(_argv(ckpt, hb, metrics),
                             SupervisorConfig(heartbeat_path=hb), env=env)
    ret = sup.run()
    assert ret == 0
    assert sup.restarts == 1 and sup.events == ["exit-42"]
    with open(metrics) as f:
        log = json.load(f)
    steps_seen = [m["step"] for m in log]
    assert 19 in steps_seen           # training completed
    # the restarted run resumed at step 10: it logged from there on
    assert steps_seen == [10, 15, 19]
    with open(hb) as f:
        assert json.load(f)["step"] == 19

    # the same arguments, never interrupted
    ckpt2 = str(tmp_path / "ckpt2")
    r = subprocess.run(_argv(ckpt2, str(tmp_path / "hb2.json"),
                             str(tmp_path / "metrics2.json")),
                       env=_env(), cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert latest_step(ckpt) == latest_step(ckpt2) == 20
    (s1, got), (s2, want) = _final(ckpt), _final(ckpt2)
    assert s1 == s2 == 20 and len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(tmp_path / "metrics2.json") as f:
        whole = {m["step"]: m for m in json.load(f)}
    for m in log:
        assert m == whole[m["step"]]
