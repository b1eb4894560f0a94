"""SPMD meshes over ``torch.distributed``: the port's counterpart of
``jax.make_mesh`` plus ``shard_map`` for one named axis, and of a mesh of
several named axes (:class:`MeshGrid`: the trainer's (data, model)).

The JAX package runs its SPMD path (``spmd_distributed_kmeans`` and the
ring / 2-D torus collectives of ``message_passing``) as one program over
the devices of a mesh axis. Here N processes play the N devices: each is
one rank of a process group, and a :class:`Mesh` names that group's axis.

* :class:`Mesh` -- the axis name, the group's backend, its size
  (``shape[axis_name]``), this process's rank (``axis_index``) and the
  device the rank computes on. ``with mesh:`` binds the axis name, so the
  collectives find their group by name as ``shard_map`` code does;
  :func:`axis` resolves a bound name.
* **Transport.** ``nccl`` is for ranks that each own a distinct GPU.
  ``gloo`` moves host buffers only: with CUDA tensors every collective and
  every ring hop stages its buffer through pinned host memory explicitly,
  one device-to-host and one host-to-device copy, and the mesh counts the
  staged bytes (:attr:`Mesh.staged_bytes`). Ranks that share one GPU run
  gloo; a ``nccl`` mesh whose ranks share a device raises, it never
  switches transport on its own.
* :class:`MeshGrid` -- several named axes over the default group, ranks
  laid out row-major as ``jax.make_mesh`` lays out its devices (rank
  ``d * M + m`` on a (data, model) grid). Each axis is a :class:`Mesh`
  over a sub-group of its own (one per row and per column,
  ``torch.distributed.new_group``), ``world`` is every rank in that
  order (an axis pair such as ("data", "model") jointly), and each other
  run of axes a spec can name (("pod", "data") on a (pod, data, model)
  grid) a :class:`Mesh` of its own (``joint``). ``with grid:`` binds
  every axis. ``MeshGrid.stand_in`` is one rank of such a grid with no
  process group: its collectives (:class:`StandInMesh`) record what a
  real rank's record and return empty tensors of the result's shape, so
  a step runs on meta tensors as one rank of a grid that was never
  started (the dry run's).
* :func:`launch` -- start ``world_size`` ranks with the ``spawn`` start
  method (a parent that has initialised CUDA cannot fork) and a
  ``file://`` store in a temporary directory (no TCP port to collide), run
  a function given by its importable name ``"module:function"`` on each as
  ``fn(mesh, *args)``, and return every rank's result. It joins with a
  timeout, kills the stragglers, and raises if any rank failed or timed
  out.

Every gathered or relayed buffer is copied byte for byte (memcpy, never
arithmetic), so -0.0, inf and NaN arrive as they left.
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import itertools
import math
import multiprocessing
import os
import queue as queue_mod
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.backend import DeviceLike, resolve_device
from repro_torch.roofline.trace import note_collective

_BOUND = threading.local()


@dataclasses.dataclass
class Mesh:
    """One named axis over a process group (the default one unless
    ``group`` is given), as seen from one rank: ``rank`` is the rank's
    index along the axis and ``ranks`` the group's global ranks in axis
    order (default ``0 .. size - 1``). ``staged_bytes`` counts the bytes a gloo mesh on a CUDA device
    copied between the device and pinned host memory, both ways. Inside
    ``repro_torch.roofline.record()`` every collective issued (XLA's
    ``all-gather`` and ``collective-permute``) is appended to the ledger's
    ``collectives``, for ``roofline.trace.collective_phase_analysis``."""

    axis_name: str
    backend: str
    size: int
    rank: int
    device: torch.device
    staged_bytes: int = 0
    group: Any = None
    ranks: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.ranks is None:
            self.ranks = tuple(range(self.size))

    @property
    def shape(self) -> dict:
        """``{axis_name: size}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_name: self.size}

    @property
    def staging(self) -> bool:
        """Whether buffers cross pinned host memory (gloo on a GPU)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def __enter__(self) -> "Mesh":
        stack = getattr(_BOUND, "stack", None)
        if stack is None:
            stack = _BOUND.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _BOUND.stack.pop()
        return False

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the transport takes it: a pinned host copy when
        staging (counted), else ``x`` contiguous."""
        if not self.staging:
            return x.contiguous()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        self.staged_bytes += host.nbytes
        return host

    def _wire_empty(self, shape, dtype) -> torch.Tensor:
        if self.staging:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _unwire(self, host: torch.Tensor) -> torch.Tensor:
        if not self.staging:
            return host
        self.staged_bytes += host.nbytes
        return host.to(self.device)

    def all_gather(self, x: torch.Tensor, kind: str = "all-gather"
                   ) -> torch.Tensor:
        """``(size, *x.shape)``: every rank's ``x`` in rank order (one
        collective; bf16, which gloo does not take, travels as its bits
        viewed as float16: a gather copies bytes). ``kind`` is the
        collective the caller makes of it, as the record names it
        (:meth:`note`)."""
        if x.dtype == torch.bfloat16:
            return self.all_gather(x.view(torch.float16),
                                   kind).view(torch.bfloat16)
        send = self._wire(x)
        out = self._wire_empty((self.size,) + tuple(x.shape), x.dtype)
        dist.all_gather(list(out.unbind(0)), send, group=self.group)
        self.note(kind, x)
        return self._unwire(out)

    def note(self, kind: str, x: torch.Tensor) -> None:
        """Record the all-gather of ``x`` as the collective ``kind`` it
        stands for, with that collective's result bytes on this rank:
        the gathered ``size`` copies (``all-gather``), ``x``'s own
        (``all-reduce``: the sum of the gathered copies), or this rank's
        slice of them (``reduce-scatter``)."""
        n = x.numel() * x.element_size()
        note_collective(kind, self.ranks, {
            "all-gather": n * self.size, "all-reduce": n,
            "reduce-scatter": n // self.size}[kind])

    def hop(self, buf: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """One hop of a ring: send ``buf`` to axis index ``dst`` and return
        what axis index ``src`` sent, as one non-blocking send / receive
        pair with both ends waited on (a ring of blocking sends can
        deadlock)."""
        send = self._wire(buf)
        recv = self._wire_empty(tuple(buf.shape), buf.dtype)
        ops = [dist.P2POp(dist.isend, send, dst),
               dist.P2POp(dist.irecv, recv, src)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        note_collective("collective-permute", (self.rank, dst), recv.nbytes)
        return self._unwire(recv)


class StandInMesh(Mesh):
    """A :class:`Mesh` of one rank with no process group
    (:meth:`MeshGrid.stand_in`): each collective records what a real
    rank's records (kind, group, result bytes, in order) and returns an
    empty tensor of the result's shape on the input's device, so meta
    tensors stay meta and nothing moves."""

    def all_gather(self, x: torch.Tensor, kind: str = "all-gather"
                   ) -> torch.Tensor:
        self.note(kind, x)
        return torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype,
                           device=x.device)

    def hop(self, buf: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        note_collective("collective-permute", (self.rank, dst), buf.nbytes)
        return torch.empty_like(buf)


@dataclasses.dataclass
class MeshGrid:
    """Several named axes over the default process group, as seen from
    one rank (the counterpart of ``jax.make_mesh(shape, axis_names)``):
    global rank ``r`` sits at the row-major coordinates of ``r`` in
    ``sizes``. ``axes[name]`` is the :class:`Mesh` of the ranks that
    differ from this one in ``name`` alone, ``world`` the :class:`Mesh` of
    every rank in global order (the axes jointly, the first major), and
    ``joint[names]`` for every other run of two or more axes in the
    grid's order (``("pod", "data")``) the :class:`Mesh` of the ranks
    that differ from this one in those axes alone, the first major. Each
    mesh's ``ranks`` are its group's global ranks in its own order.
    Build it on every rank at once (:meth:`build`): each sub-group is a
    collective ``new_group``. :meth:`stand_in` is one rank of a grid with
    no process group at all."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    axes: Dict[str, Mesh]
    world: Mesh
    joint: Dict[Tuple[str, ...], Mesh] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def build(cls, axis_names: Sequence[str], sizes: Sequence[int],
              backend: str, rank: int, device: torch.device) -> "MeshGrid":
        def group(members):
            return dist.new_group(list(members), backend=backend)
        return cls._make(axis_names, sizes, backend, rank, device, group,
                         Mesh)

    @classmethod
    def stand_in(cls, axis_names: Sequence[str], sizes: Sequence[int],
                 rank: int = 0) -> "MeshGrid":
        """Rank ``rank`` of the grid with no process group, on the meta
        device: the same axes, joint axes, ``world``, ``shape`` and
        ``coords`` as a built grid's, each mesh a :class:`StandInMesh`
        (its collectives record what a real rank's record and move
        nothing)."""
        return cls._make(axis_names, sizes, "none", rank,
                         torch.device("meta"), lambda members: None,
                         StandInMesh)

    @classmethod
    def _make(cls, axis_names, sizes, backend, rank, device, group,
              mesh_cls) -> "MeshGrid":
        """The grid of ``rank``: ``group(members)`` is called for every
        group of every run of axes, on every rank in the same order."""
        names, sizes = tuple(axis_names), tuple(int(n) for n in sizes)
        world = math.prod(sizes)
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not on a grid of {sizes}")
        coords = _coords(rank, sizes)
        axes, joint = {}, {}
        for run in _runs(len(names)):
            outside = [j for j in range(len(sizes)) if j not in run]
            for rest in itertools.product(*(range(sizes[j])
                                            for j in outside)):
                fixed = dict(zip(outside, rest))
                members = tuple(
                    _flat([{**fixed, **dict(zip(run, sub))}[j]
                           for j in range(len(sizes))], sizes)
                    for sub in itertools.product(*(range(sizes[j])
                                                   for j in run)))
                g = group(members)
                if rank not in members:
                    continue
                key = tuple(names[j] for j in run)
                mesh = mesh_cls(",".join(key), backend, len(members),
                                members.index(rank), device, group=g,
                                ranks=members)
                if len(run) == 1:
                    axes[key[0]] = mesh
                else:
                    joint[key] = mesh
        return cls(names, sizes, rank, device, backend, axes,
                   mesh_cls(",".join(names), backend, world, rank, device),
                   joint)

    @property
    def shape(self) -> dict:
        """``{axis_name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return self.world.size

    @property
    def coords(self) -> dict:
        """This rank's index along each axis."""
        return {n: m.rank for n, m in self.axes.items()}

    @property
    def staged_bytes(self) -> int:
        return self.world.staged_bytes + sum(
            m.staged_bytes for m in (*self.axes.values(),
                                     *self.joint.values()))

    def __enter__(self) -> "MeshGrid":
        for m in self.axes.values():
            m.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        for m in reversed(list(self.axes.values())):
            m.__exit__(*exc)
        return False


def _runs(n: int) -> List[Tuple[int, ...]]:
    """The axes' runs a grid of ``n`` axes builds groups for, in the order
    every rank builds them: each axis alone, then every other set of two
    or more axes (in the grid's order) but all of them (``world``)."""
    out = [(i,) for i in range(n)]
    for k in range(2, n):
        out += list(itertools.combinations(range(n), k))
    return out


def _coords(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for n in reversed(sizes):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _flat(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, n in zip(coords, sizes):
        r = r * n + c
    return r


def axis(axis_name: str) -> Mesh:
    """The innermost bound mesh (``with mesh:``) whose axis is
    ``axis_name``; raises if none is."""
    for mesh in reversed(getattr(_BOUND, "stack", [])):
        if mesh.axis_name == axis_name:
            return mesh
    raise ValueError(f"mesh axis {axis_name!r} is not bound in this process: "
                     f"run inside `with mesh:` (launch() binds it)")


def axis_index(axis_name: str) -> int:
    """This rank's index along ``axis_name`` (``jax.lax.axis_index``)."""
    return axis(axis_name).rank


def _rank_devices(world_size: int, backend: str,
                  device: DeviceLike) -> List[torch.device]:
    """Each rank's device: ``device`` for all, or with no index (or
    ``None``: CUDA) ``cuda:{rank % device_count}``. A nccl mesh needs one
    distinct GPU per rank."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", r % count) for r in range(world_size)]
    else:
        devices = [dev] * world_size
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"a nccl mesh runs on CUDA devices, not {dev}")
        if len(set(devices)) < world_size:
            raise ValueError(
                f"a nccl mesh needs one GPU per rank: {world_size} ranks "
                f"on {sorted(set(map(str, devices)))} share a device; use "
                f"backend='gloo' (staged through host memory) for ranks "
                f"that share a GPU")
    elif backend != "gloo":
        raise ValueError(f"unknown mesh backend {backend!r}: expected "
                         f"'gloo'|'nccl'")
    return devices


def _resolve(target: str):
    module, _, name = target.partition(":")
    if not module or not name:
        raise ValueError(f"target {target!r} is not 'module:function'")
    return getattr(importlib.import_module(module), name)


def _rank_main(rank: int, spec: dict, results) -> None:
    """One rank: join the group through the file store, bind the mesh, run
    the target and report ``(rank, ok, result or traceback)``."""
    try:
        device = spec["devices"][rank]
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            spec["backend"], init_method=spec["init_method"],
            world_size=spec["world_size"], rank=rank,
            timeout=datetime.timedelta(seconds=spec["timeout"]))
        try:
            if spec["shape"] is None:
                mesh = Mesh(spec["axis_name"], spec["backend"],
                            spec["world_size"], rank, device)
            else:
                mesh = MeshGrid.build(spec["axis_name"], spec["shape"],
                                      spec["backend"], rank, device)
            fn = _resolve(spec["target"])
            with mesh:
                out = fn(mesh, *spec["args"])
        finally:
            dist.destroy_process_group()
    except Exception:   # the rank's boundary: report, the parent raises
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, out))


def launch(target: str, world_size: int, args: Sequence = (), *,
           axis_name: Union[str, Sequence[str]] = "sites",
           backend: str = "gloo", device: DeviceLike = None,
           timeout: float = 600.0,
           shape: Optional[Sequence[int]] = None) -> List[Any]:
    """Run ``target`` (``"module:function"``, importable in a fresh
    interpreter: a ``python -c`` body is not) on ``world_size`` spawned
    ranks as ``fn(mesh, *args)`` and return the results in rank order.
    ``mesh`` is a :class:`Mesh` of one axis; with ``shape`` (one size per
    name of ``axis_name``, their product ``world_size``) a
    :class:`MeshGrid`.

    ``device``: every rank's device (default CUDA; ``"cpu"`` explicit), or
    one without an index for ``cuda:{rank % device_count}``. ``timeout``
    (seconds) bounds the whole run and each collective: a rank that fails
    raises here with its traceback, ranks still running after a failure or
    the deadline are killed, and nothing is carried on. Results travel by
    pickle, so return host values (numpy arrays, CPU tensors)."""
    if shape is not None:
        shape, axis_name = tuple(shape), tuple(axis_name)
        if len(shape) != len(axis_name) or math.prod(shape) != world_size:
            raise ValueError(f"mesh shape {shape} over axes {axis_name} "
                             f"does not hold {world_size} ranks")
    devices = _rank_devices(world_size, backend, device)
    ctx = multiprocessing.get_context("spawn")
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        spec = {"target": target, "args": tuple(args),
                "world_size": world_size, "axis_name": axis_name,
                "shape": shape,
                "backend": backend, "devices": devices, "timeout": timeout,
                "init_method": "file://" + os.path.join(tmp, "store")}
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(r, spec, results),
                             name=f"mesh-rank-{r}")
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got, failed = {}, {}
        try:
            while len(got) + len(failed) < world_size and not failed:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    for r, p in enumerate(procs):
                        if (p.exitcode not in (None, 0) and r not in got
                                and r not in failed):
                            failed[r] = f"exited with code {p.exitcode}"
                    continue
                (got if ok else failed)[rank] = out
        finally:
            # after a failure the others may wait in a collective: a short
            # grace, then kill
            until = time.monotonic() + 5.0 if failed else deadline
            for p in procs:
                p.join(timeout=max(until - time.monotonic(), 0.0))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    missing = [r for r in range(world_size) if r not in got and r not in failed]
    if failed or missing:
        lines = [f"rank {r} failed:\n{failed[r]}" for r in sorted(failed)]
        if missing:
            why = ("were still running after a rank failed" if failed
                   else f"did not finish within {timeout} s")
            lines.append(f"ranks {missing} {why} and were stopped")
        raise RuntimeError(f"launch({target!r}, {world_size}) failed:\n"
                           + "\n".join(lines))
    return [got[r] for r in range(world_size)]
