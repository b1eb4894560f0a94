"""From a ``torch.profiler`` trace of the traced runs to what the per-layer
readers take: device operations tied to the program's ``work:<function>``
scope and phase, the traced window, busy time, idle gaps by what the host
was doing, and each kernel function's bound over its device time.

A device operation carries the correlation id of the runtime call that
launched it; that call's enclosing CPU ranges give its ``work:`` scope and
its phase (``round1``, ``round2``, ``solve``: the program's phase scopes).
User annotations (ranges projected onto the device's timeline) are not
operations. A ``work:`` scope counts towards a roofline only when every
launch inside it has its device operation in the trace, so a profiler that
drops events cannot inflate a share; the readers of the whole trace
(launches, time outside the kernels, the idle share) read nothing from a
trace that lost any operation (:attr:`Trace.whole`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from portbench import work as work_mod

PHASES = ("round1", "round2", "solve")
RUN_SCOPE = "portbench:run"
_LAUNCHES = ("Launch", "Memcpy", "Memset")


@dataclasses.dataclass(frozen=True)
class Op:
    """One device operation: name, start and end (microseconds from the
    trace's start), the ``work:`` function and phase of its launch (None
    outside them), and the identity of its ``work:`` scope."""

    name: str
    start_us: float
    end_us: float
    function: Optional[str]
    phase: Optional[str]
    scope: Optional[int]


@dataclasses.dataclass
class Trace:
    """The reduced trace of ``runs`` traced runs: its device operations,
    the runtime calls that launched work (kernels, copies, sets) and how
    many of those have no operation in the trace."""

    ops: List[Op]
    window_us: Tuple[float, float]
    ranges: List[Tuple[float, float, str]]   # host phase and work ranges
    complete: Dict[int, Tuple[str, str]]     # scope -> (function, phase)
    launches: int = 0
    missing: int = 0

    @property
    def whole(self) -> bool:
        """Every launch has its device operation, and there was one."""
        return self.launches > 0 and self.missing == 0

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def busy_s(self) -> float:
        """The union of the operations' spans inside the window."""
        lo, hi = self.window_us
        total, cur_s, cur_e = 0.0, None, None
        for s, e in sorted((max(o.start_us, lo), min(o.end_us, hi))
                           for o in self.ops):
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e6

    def gaps(self) -> List[Tuple[str, float]]:
        """Every idle stretch of the device inside the window, named by the
        innermost host range (phase, or phase/work function) open at its
        start: [(name, seconds)], longest first."""
        lo, hi = self.window_us
        spans = sorted((o.start_us, o.end_us) for o in self.ops
                       if o.end_us > lo and o.start_us < hi)
        out, cur = [], lo
        for s, e in spans + [(hi, hi)]:
            if s > cur:
                out.append((self._host_at(cur), (s - cur) / 1e6))
            cur = max(cur, e)
        return sorted(out, key=lambda g: -g[1])

    def _host_at(self, us: float) -> str:
        best = None
        for s, e, name in self.ranges:
            if s <= us < e and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else "outside phases"

    def device_s_by_name(self) -> List[Tuple[str, float]]:
        acc: Dict[str, float] = collections.defaultdict(float)
        for o in self.ops:
            acc[o.name] += (o.end_us - o.start_us) / 1e6
        return sorted(acc.items(), key=lambda x: -x[1])

    def roofline(self, label: str, sizes: List[int], k: int, t: int, d: int,
                 peaks: Dict[str, float]) -> Optional[float]:
        """Bound over device time (a share, 0..1) of every complete
        ``work:<label>`` scope, the bound from the data's real rows; None
        where no complete scope ran."""
        device: Dict[int, float] = collections.defaultdict(float)
        for o in self.ops:
            if (o.scope in self.complete and o.function == label
                    and o.phase in work_mod.PHASE_ROWS):
                device[o.scope] += (o.end_us - o.start_us) / 1e6
        if not device:
            return None
        bound = sum(work_mod.bound_s(work_mod.call_work(
            label, self.complete[s][1], sizes, k, t, d), peaks)
                    for s in device)
        return bound / sum(device.values())


def reduce(events) -> Trace:
    """Reduce ``prof.events()`` of the traced runs (each run inside a
    ``record_function(RUN_SCOPE)``)."""
    cuda = torch.autograd.DeviceType.CUDA
    runtime = {}
    ranges, runs = [], []
    for e in events:
        if e.device_type == cuda:
            continue
        if e.name.startswith("cu"):
            runtime[e.id] = e
        elif e.name == RUN_SCOPE:
            runs.append((e.time_range.start, e.time_range.end))
        elif e.name in PHASES or e.name.startswith("work:"):
            ranges.append((e.time_range.start, e.time_range.end,
                           e.name[len("work:"):] if e.name.startswith("work:")
                           else e.name))
    # scope -> [launches, operations seen], and its function and phase
    counts: Dict[int, List[int]] = collections.defaultdict(lambda: [0, 0])
    where: Dict[int, Tuple[str, Optional[str]]] = {}

    def scope_of(call):
        function = phase = scope = None
        parent = call.cpu_parent
        while parent is not None:
            if scope is None and parent.name.startswith("work:"):
                scope, function = id(parent), parent.name[len("work:"):]
            if phase is None and parent.name in PHASES:
                phase = parent.name
            parent = parent.cpu_parent
        return scope, function, phase

    tied = {}
    for cid, call in runtime.items():
        if not any(w in call.name for w in _LAUNCHES):
            continue
        scope, function, phase = scope_of(call)
        tied[cid] = (scope, function, phase)
        if scope is not None:
            counts[scope][0] += 1
            where[scope] = (function, phase)
    ops, seen = [], set()
    for e in events:
        if e.device_type != cuda or getattr(e, "is_user_annotation", False):
            continue
        seen.add(e.id)
        scope, function, phase = tied.get(e.id, (None, None, None))
        if scope is not None:
            counts[scope][1] += 1
        ops.append(Op(e.name, e.time_range.start, e.time_range.end,
                      function, phase, scope))
    complete = {s: where[s] for s, (n_launch, n_ops) in counts.items()
                if n_launch and n_ops >= n_launch}
    window = ((min(s for s, _ in runs), max(e for _, e in runs)) if runs
              else (0.0, 0.0))
    # a host range names what the host was doing; work functions nest in
    # phases, so show them as phase/function
    named = []
    for s, e, name in ranges:
        if name in PHASES:
            named.append((s, e, name))
        else:
            outer = [n for (ps, pe, n) in ranges
                     if n in PHASES and ps <= s and e <= pe]
            named.append((s, e, f"{outer[0]}/{name}" if outer else name))
    return Trace(ops, window, named, complete, launches=len(tied),
                 missing=sum(1 for cid in tied if cid not in seen))
