"""The roofline's measurements of a program with no HLO: the port's
counterpart of ``repro.roofline.hlo``.

The JAX package compiles each path to HLO and parses it: dot flops, result
bytes, collective link bytes, loop trip counts, and the ``jax.named_scope``
phase of every collective. The port runs eagerly, so it records the same
quantities as the program runs:

* **Phases.** :func:`phase` (entered by ``core.coreset._phase`` around every
  phase of every path) opens ``torch.profiler.record_function(name)`` and
  sets the current phase, which the two ledgers below read.
* **The work ledger.** Inside ``with record() as led:`` every call through
  the clustering backend protocol (``min_dist_argmin``,
  ``min_dist_argmin_batched``, ``lloyd_stats``, ``weiszfeld_stats`` of the
  ``"torch"``, ``"torch_chunked"`` and ``"cuda"`` backends of
  ``core.backend``, each method decorated with :func:`work`) appends a
  :class:`Call` -- function, shape, phase, backend -- and runs under
  ``record_function("work:<label>")``, so a profiler groups the device
  kernels of each call under its function, fused kernel or two-pass form
  alike. Outside ``record()`` a call costs one check.
* **Scopes without a call.** Inside ``record()``, :func:`scope` opens
  ``record_function("work:<label>")`` and records no :class:`Call`, so its
  device time lands in :func:`analyze`'s ``other_ms``. The project's draws
  (``core.prng``: ``split``, ``fold_in``, ``random_bits``, ``uniform``,
  ``gumbel``, ``categorical``, ``normal``, ``randint``, each decorated with
  :func:`draw`) run under ``work:draw.<name>``, the outermost draw of a
  thread alone, so ``categorical``'s Gumbel and uniform draws are one
  ``work:draw.categorical``; the paths that read ``t_i`` to the host and
  price the analytic ledger (``core.distributed``) run under
  ``work:ledger``. Outside ``record()`` each costs one check.
* **Collective records.** Inside ``record()``, ``core.mesh.Mesh`` appends
  to ``led.collectives`` a :class:`CollectiveRecord` for every collective
  it issues (:func:`note_collective`): an ``all-gather`` or a
  ``collective-permute`` (one ring hop), its group, its result bytes and
  the current phase.
  :func:`collective_phase_analysis` prices them with the reference's
  algorithmic factors (:func:`collective_link`) per phase.
* :func:`analyze` -- per phase and function: calls, flops and bytes from
  :mod:`repro_torch.roofline.work`, the bound; with a profiler's device
  spans (:func:`device_spans`) the device time of each function, the
  device's busy time (the union of its operations' spans), the idle share
  and each function's bound over its device time.

Everything here is per process, as the reference's figures are per device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.ref import CENTER_SENTINEL
from repro_torch.roofline import work as work_mod

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all")


@dataclasses.dataclass
class Analysis:
    """The reference's totals: flops, result bytes, link bytes on the
    card's interconnect (``ici_*``) and across the network between nodes
    (``dcn_*``), collectives and their link bytes by kind."""

    dot_flops: float = 0.0
    elementwise_flops: float = 0.0
    result_bytes: float = 0.0
    ici_collective_bytes: float = 0.0
    dcn_collective_bytes: float = 0.0
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def add(self, other: "Analysis", mult: float = 1.0):
        self.dot_flops += other.dot_flops * mult
        self.elementwise_flops += other.elementwise_flops * mult
        self.result_bytes += other.result_bytes * mult
        self.ici_collective_bytes += other.ici_collective_bytes * mult
        self.dcn_collective_bytes += other.dcn_collective_bytes * mult
        for k, v in other.collective_counts.items():
            self.collective_counts[k] = (
                self.collective_counts.get(k, 0.0) + v * mult)
        for k, v in other.collective_bytes_by_kind.items():
            self.collective_bytes_by_kind[k] = (
                self.collective_bytes_by_kind.get(k, 0.0) + v * mult)


# -- collectives ---------------------------------------------------------------

def collective_link(kind: str, n: int, result_bytes: float) -> float:
    """Link bytes of one collective over a group of ``n``, by the standard
    algorithmic factors: all-reduce 2 (N-1)/N, all-gather (N-1)/N,
    reduce-scatter N-1, all-to-all (N-1)/N, collective-permute 1, each
    times the result bytes."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}; known: {COLLECTIVES}")
    if kind == "all-reduce":
        return 2.0 * (n - 1) / max(n, 1) * result_bytes
    if kind in ("all-gather", "all-to-all", "ragged-all-to-all"):
        return (n - 1) / max(n, 1) * result_bytes
    if kind == "reduce-scatter":
        return (n - 1) * result_bytes
    return result_bytes


def crosses(ranks: Sequence[int], pod_block: Optional[int]) -> bool:
    """Whether a group crosses the network between nodes: its ranks span
    more than one block of ``pod_block`` consecutive ranks."""
    return pod_block is not None and len({r // pod_block
                                          for r in ranks}) > 1


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective as issued: its kind, the ranks of its group (a ring
    hop's: the sender and the receiver), the bytes of its result on this
    rank and the phase it ran in (None outside every phase)."""

    kind: str
    ranks: Tuple[int, ...]
    result_bytes: int
    phase: Optional[str]


def _in_phase(name: Optional[str], phases: Sequence[str]) -> str:
    """The phase of ``phases`` a recorded phase belongs to: itself, or the
    one it gathers for (``round1_gather`` is ``round1``'s collective, as
    the reference's ``round1`` scope holds its gather), else ``other``."""
    for p in phases:
        if name == p or name == f"{p}_gather":
            return p
    return "other"


def collective_phase_analysis(records: Iterable[CollectiveRecord],
                              phases: Tuple[str, ...] = ("round1", "round2"),
                              pod_block: Optional[int] = None
                              ) -> Dict[str, Analysis]:
    """Per phase: collective counts and link bytes by kind, and the link
    bytes on and across nodes, from a mesh's records. Collectives outside
    every phase land in ``"other"``. As the reference's, only the
    collective fields of each :class:`Analysis` are filled."""
    out = {p: Analysis() for p in (*phases, "other")}
    for rec in records:
        a = out[_in_phase(rec.phase, phases)]
        link = collective_link(rec.kind, len(rec.ranks), rec.result_bytes)
        a.collective_counts[rec.kind] = a.collective_counts.get(
            rec.kind, 0.0) + 1
        a.collective_bytes_by_kind[rec.kind] = (
            a.collective_bytes_by_kind.get(rec.kind, 0.0) + link)
        if crosses(rec.ranks, pod_block):
            a.dcn_collective_bytes += link
        else:
            a.ici_collective_bytes += link
    return out


# -- phases ----------------------------------------------------------------------

_STATE = threading.local()


def current_phase() -> Optional[str]:
    """The innermost open :func:`phase` of this thread, or None."""
    stack = getattr(_STATE, "phases", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def phase(name: str):
    """Make ``name`` the current phase for the block, under
    ``torch.profiler.record_function(name)``."""
    stack = getattr(_STATE, "phases", None)
    if stack is None:
        stack = _STATE.phases = []
    stack.append(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        stack.pop()


# -- the work ledger ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Call:
    """One call through the backend protocol: the function, its shape
    ``(sites or tenants, rows, centres, features)`` -- the centres of a
    batched call are the live ones, a 0-d tensor until :func:`analyze`
    reads it -- the phase (None outside every phase) and the backend."""

    function: str
    shape: tuple
    phase: Optional[str]
    backend: str

    @property
    def label(self) -> str:
        """The function, with a one-centre assignment (D^z seeding) apart:
        it runs another kernel."""
        if self.function == "min_dist_argmin" and self.shape[2] == 1:
            return "min_dist_argmin[k=1]"
        return self.function

    def sizes(self) -> Tuple[int, int, int, int]:
        """The shape as integers (reads a batched call's live count)."""
        return tuple(int(x) for x in self.shape)


class Ledger(list):
    """The :class:`Call` s of one :func:`record` block, in order, the
    :class:`CollectiveRecord` s it issued (``collectives``) and the block's
    wall seconds."""

    wall_s: Optional[float] = None

    def __init__(self, calls: Iterable[Call] = ()):
        super().__init__(calls)
        self.collectives: List[CollectiveRecord] = []


_LEDGER: Optional[Ledger] = None


@contextlib.contextmanager
def record():
    """Record every backend protocol call and every collective of the
    block into a new :class:`Ledger` (yielded), and the block's wall
    seconds. The caller synchronizes the device inside the block where the
    wall should cover the device's work."""
    global _LEDGER
    prev, led = _LEDGER, Ledger()
    _LEDGER = led
    t0 = time.perf_counter()
    try:
        yield led
    finally:
        led.wall_s = time.perf_counter() - t0
        _LEDGER = prev


def work(fn):
    """Decorate a backend protocol method ``(self, points, centers, ...)``
    named after its function: inside :func:`record` its call appends a
    :class:`Call` to the ledger and runs under ``work:<label>``; outside,
    it costs one check."""
    function = fn.__name__

    @functools.wraps(fn)
    def method(self, points, centers, *rest, **kw):
        led = _LEDGER
        if led is None:
            return fn(self, points, centers, *rest, **kw)
        if function == "min_dist_argmin_batched":
            # the live centres, counted on the device (no host sync) before
            # the call's scope opens
            k = (centers[..., 0] != CENTER_SENTINEL).sum()
        else:
            k = centers.shape[-2]
        shape = (math.prod(points.shape[:-2]), points.shape[-2], k,
                 points.shape[-1])
        call = Call(function, shape, current_phase(), self.name)
        led.append(call)
        with torch.profiler.record_function(f"work:{call.label}"):
            return fn(self, points, centers, *rest, **kw)
    return method


_NO_SCOPE = contextlib.nullcontext()


def scope(label: str):
    """``record_function("work:<label>")`` inside :func:`record`, for work
    that is no backend protocol call (the ledger's pricing); it records no
    :class:`Call`. Outside, one check and a context that does nothing."""
    if _LEDGER is None:
        return _NO_SCOPE
    return torch.profiler.record_function(f"work:{label}")


def draw(fn):
    """Decorate a draw of ``core.prng``: inside :func:`record` the
    outermost draw of the thread runs under ``work:draw.<name>`` and the
    draws it makes open nothing; outside, it costs one check. The draw's
    result is the undecorated function's."""
    label = f"work:draw.{fn.__name__}"

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        if _LEDGER is None or getattr(_STATE, "drawing", False):
            return fn(*args, **kw)
        _STATE.drawing = True
        try:
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        finally:
            _STATE.drawing = False
    return wrapped


def note_collective(kind: str, ranks: Tuple[int, ...],
                    result_bytes: int) -> None:
    """Append a :class:`CollectiveRecord` in the current phase to the
    ledger of the enclosing :func:`record`; outside, one check."""
    if _LEDGER is not None:
        _LEDGER.collectives.append(CollectiveRecord(
            kind, tuple(ranks), int(result_bytes), current_phase()))


# -- device time -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Span:
    """One device operation of a profile: its name, start and end
    (microseconds), and the function and phase of the ledger call that
    launched it (None where it ran outside every ``work:`` scope or
    phase)."""

    name: str
    start_us: float
    end_us: float
    function: Optional[str] = None
    phase: Optional[str] = None


def device_spans(events, phases: Iterable[str]) -> List[Span]:
    """The device operations of a ``torch.profiler`` profile
    (``prof.events()``), each tied to its launch: a device operation
    carries the correlation id of the runtime call that launched it
    (``cudaLaunchKernel``, ``cudaMemsetAsync``, ...), whose enclosing CPU
    scopes give its ``work:`` function and its phase (the innermost scope
    named in ``phases``). User annotations -- ``record_function`` ranges
    projected onto the device's timeline -- are not operations and are
    left out."""
    phases = set(phases)
    cuda = torch.autograd.DeviceType.CUDA
    launches = {e.id: e for e in events
                if e.device_type != cuda and e.name.startswith("cu")}
    out = []
    for e in events:
        if e.device_type != cuda or getattr(e, "is_user_annotation", False):
            continue
        function = where = None
        parent = launches.get(e.id)
        while parent is not None:
            if function is None and parent.name.startswith("work:"):
                function = parent.name[len("work:"):]
            if where is None and parent.name in phases:
                where = parent.name
            parent = parent.cpu_parent
        out.append(Span(e.name, e.time_range.start, e.time_range.end,
                        function, where))
    return out


def busy_us(spans: Iterable[Span]) -> float:
    """The union of the spans' time ranges (microseconds)."""
    ranges = sorted((s.start_us, s.end_us) for s in spans)
    if not ranges:
        return 0.0
    busy, cur_s, cur_e = 0.0, ranges[0][0], ranges[0][1]
    for s, e in ranges[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


@dataclasses.dataclass
class Row:
    """One function in one phase: its calls, their work and bound, and
    (with a profile) the device time of the operations they launched."""

    phase: str
    function: str
    calls: int
    flops: float
    bytes: float
    bound_ms: float
    bound_by: str
    device_ms: Optional[float] = None

    @property
    def share(self) -> Optional[float]:
        """Bound over device time: the share of the card's roofline the
        function reached (None without a profile or device time)."""
        return self.bound_ms / self.device_ms if self.device_ms else None


@dataclasses.dataclass
class Roofline:
    """:func:`analyze`'s result. ``busy_ms`` and ``idle_share`` only with a
    profile; ``other_ms`` is device time launched under no kernel
    function's ``work:`` scope (the draws, the ledger's copy, PyTorch's own
    operations)."""

    rows: List[Row]
    wall_ms: Optional[float]
    busy_ms: Optional[float] = None
    device_ops: int = 0
    idle_share: Optional[float] = None
    other_ms: Optional[float] = None

    def analysis(self) -> Analysis:
        """The totals as the reference's :class:`Analysis`: the work's
        flops and bytes as ``dot_flops`` and ``result_bytes``."""
        return Analysis(dot_flops=sum(r.flops for r in self.rows),
                        result_bytes=sum(r.bytes for r in self.rows))

    def lines(self) -> List[str]:
        """The table, one line per row, and the totals."""
        out = [f"{'phase':14s} {'function':26s} {'calls':>6s} "
               f"{'GFLOP':>10s} {'GB':>9s} {'bound ms':>10s} "
               f"{'device ms':>10s} {'bound/dev':>9s}"]
        for r in self.rows:
            dev = "-" if r.device_ms is None else f"{r.device_ms:.4f}"
            share = "-" if r.share is None else f"{r.share:.3f}"
            out.append(f"{r.phase:14s} {r.function:26s} {r.calls:6d} "
                       f"{r.flops / 1e9:10.3f} {r.bytes / 1e9:9.4f} "
                       f"{r.bound_ms:10.4f} {dev:>10s} {share:>9s} "
                       f"({r.bound_by})")
        if self.busy_ms is not None:
            out.append(f"device busy {self.busy_ms:.3f} ms over "
                       f"{self.device_ops} operations in a wall of "
                       f"{self.wall_ms:.3f} ms: idle share "
                       f"{self.idle_share:.4f}; under no kernel function "
                       f"{self.other_ms:.3f} ms")
        return out


def analyze(ledger: Ledger, events: Optional[Sequence[Span]] = None,
            hardware=None, wall_s: Optional[float] = None) -> Roofline:
    """Per phase and function of ``ledger``: calls, flops and bytes
    (:mod:`~repro_torch.roofline.work`), the bound on ``hardware``
    (default: ``report.H100_SXM``); with ``events`` (:func:`device_spans`)
    the device time each function's calls launched, the device's busy time
    and idle share over ``wall_s`` (default: the ledger's wall)."""
    if hardware is None:
        from repro_torch.roofline.report import H100_SXM
        hardware = H100_SXM
    rows: Dict[Tuple[str, str], Row] = {}
    for call in ledger:
        key = (call.phase or "other", call.label)
        flops, nbytes = work_mod.MODELS[call.function](*call.sizes())
        row = rows.get(key)
        if row is None:
            row = rows[key] = Row(key[0], key[1], 0, 0.0, 0.0, 0.0, "")
        row.calls += 1
        row.flops += flops
        row.bytes += nbytes
    for row in rows.values():
        row.bound_ms, row.bound_by = work_mod.bound(row.flops, row.bytes,
                                                    hardware)
    wall = ledger.wall_s if wall_s is None else wall_s
    out = Roofline(list(rows.values()),
                   None if wall is None else wall * 1e3)
    if events is None:
        return out
    for row in out.rows:
        row.device_ms = 0.0
    other = 0.0
    for s in events:
        row = rows.get((s.phase or "other", s.function))
        if row is None:
            other += s.end_us - s.start_us
            continue
        row.device_ms += (s.end_us - s.start_us) / 1e3
    out.busy_ms = busy_us(events) / 1e3
    out.device_ops = len(events)
    out.other_ms = other / 1e3
    if out.wall_ms:
        out.idle_share = 1.0 - out.busy_ms / out.wall_ms
    return out
