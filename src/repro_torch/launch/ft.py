"""Fault tolerance (the port of ``repro.launch.ft``, pure Python, its own
copy): supervised training with heartbeat monitoring,
restart-from-checkpoint, and straggler detection.

The Supervisor runs the trainer as a subprocess. The trainer writes
a heartbeat file every step; the supervisor kills + restarts the run (from
the latest complete checkpoint -- the trainer auto-resumes) when the
heartbeat goes stale (hang/crash/straggler) or the process dies. Restart
count and backoff are bounded. Failure injection for tests:
``REPRO_FAIL_AT_STEP`` makes the trainer crash at a given step, proving the
checkpoint/restart path end to end (tests/test_torch_launch_ft.py).

At 1000+ node scale the same supervisor runs per-pod under the cluster
scheduler; the heartbeat file becomes the coordination-service key and
elastic restore (repro_torch.checkpoint.restore onto other devices)
handles shrunken meshes. Straggler mitigation: per-step wall time is
logged; steps slower than ``straggler_factor`` x the running median raise
an alert (and, under the supervisor, an optional restart on a healthy
replica set).
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import time
from typing import List, Optional


@dataclasses.dataclass
class SupervisorConfig:
    heartbeat_path: str
    heartbeat_timeout_s: float = 120.0
    max_restarts: int = 5
    backoff_s: float = 1.0
    poll_s: float = 0.5


class Heartbeat:
    """Trainer side: call ``beat(step)`` every step."""

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.time()
        self._times: List[float] = []

    def beat(self, step: int, metrics: Optional[dict] = None):
        now = time.time()
        self._times.append(now)
        payload = {"step": step, "time": now,
                   "uptime": now - self._t0}
        if metrics:
            payload.update({k: float(v) for k, v in metrics.items()})
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)

    def step_times(self) -> List[float]:
        return [b - a for a, b in zip(self._times, self._times[1:])]


def detect_straggler(step_times: List[float], factor: float = 3.0
                     ) -> Optional[int]:
    """Index of the first step slower than ``factor`` x running median."""
    if len(step_times) < 5:
        return None
    sorted_t = sorted(step_times)
    median = sorted_t[len(sorted_t) // 2]
    for i, t in enumerate(step_times):
        if t > factor * median:
            return i
    return None


class Supervisor:
    """Run ``argv`` under heartbeat supervision; restart on crash or stale
    heartbeat, up to ``max_restarts`` times."""

    def __init__(self, argv: List[str], cfg: SupervisorConfig,
                 env: Optional[dict] = None):
        self.argv = argv
        self.cfg = cfg
        self.env = env or dict(os.environ)
        self.restarts = 0
        self.events: List[str] = []

    def _heartbeat_age(self) -> float:
        try:
            with open(self.cfg.heartbeat_path) as f:
                return time.time() - json.load(f)["time"]
        except Exception:
            return 0.0  # no heartbeat yet: grace

    def run(self) -> int:
        while True:
            proc = subprocess.Popen(self.argv, env=self.env)
            start = time.time()
            while True:
                ret = proc.poll()
                if ret is not None:
                    break
                if (time.time() - start > self.cfg.heartbeat_timeout_s
                        and self._heartbeat_age()
                        > self.cfg.heartbeat_timeout_s):
                    self.events.append("stale-heartbeat-kill")
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    ret = -9
                    break
                time.sleep(self.cfg.poll_s)
            if ret == 0:
                self.events.append("clean-exit")
                return 0
            self.restarts += 1
            self.events.append(f"restart-{self.restarts}(ret={ret})")
            if self.restarts > self.cfg.max_restarts:
                self.events.append("gave-up")
                return ret
            time.sleep(self.cfg.backoff_s * self.restarts)
