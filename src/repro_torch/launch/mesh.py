"""Production meshes (the port of ``repro.launch.mesh``) as *logical*
meshes: axis names and sizes, no device. The port has no devices-in-a-mesh
object: a run's ranks are processes (``repro_torch.core.mesh.launch``), and
the dry run (``launch.dryrun``) lays a step out over a mesh it never
allocates. ``models.sharding`` takes a :class:`LogicalMesh` as it takes
any object with ``axis_names`` and a ``shape`` mapping. Importing this
module touches no CUDA state."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """``axis_names`` and their sizes (``dims``, in the same order)."""

    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"{len(self.dims)} sizes for the axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(int(n) < 1 for n in self.dims):
            raise ValueError(f"mesh sizes must be positive: {self.dims}")

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """Single pod: (16, 16) = 256 chips, axes (data, model).
    Multi-pod: (2, 16, 16) = 512 chips, axes (pod, data, model); only data
    parallelism (gradient all-reduce) crosses the pod (network) axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> LogicalMesh:
    """Arbitrary mesh helper for tests / small runs."""
    return LogicalMesh(tuple(str(a) for a in axes),
                       tuple(int(n) for n in shape))


def run_device(name: str) -> torch.device:
    """The device a launcher's ``--device`` names: ``cuda`` (the default
    of every launcher) raises when no GPU is found, so a run never falls
    back to the CPU unasked."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; "
                           f"pass --device cpu to run on the CPU")
    return dev


def where(dev: torch.device) -> str:
    """The device a launcher's times were taken on, for its printed
    lines: the card's name and power limit as ``nvidia-smi`` gives them,
    or ``the CPU``."""
    if dev.type != "cuda":
        return "the CPU"
    from repro_torch.roofline.report import card
    name, limit = card(dev)
    return f"{name}, {limit:.2f} W"
