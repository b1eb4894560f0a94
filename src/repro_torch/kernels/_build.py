"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use into ``build/``
beside this file (listed in ``.gitignore``) and loaded with :mod:`ctypes`.
All sources are compiled at once, one ``nvcc`` process each, so the build
costs the time of the slowest file. A library is named after a hash of the
sources and flags, so an edit rebuilds it and an unchanged tree reuses it.

Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc or a GPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

SOURCE_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildResult:
    """One built library: its path, the compile time (0 when reused) and
    ptxas's report per kernel (entry function; registers, barriers and
    shared memory; stack and spills)."""

    name: str
    path: Path
    seconds: float
    ptxas: List[str]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise FileNotFoundError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels need "
        "the CUDA toolkit to build")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SOURCE_DIR.glob("*.cuh")) + [SOURCE_DIR / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _ptxas_lines(log: str) -> List[str]:
    return [line.strip() for line in log.splitlines()
            if any(w in line for w in ("entry function", "registers",
                                       "spill"))]


def build() -> Dict[str, BuildResult]:
    """Compile every ``csrc/*.cu`` concurrently (or reuse an unchanged
    build); returns one :class:`BuildResult` each. Raises with nvcc's output
    if one fails."""
    names = sorted(p.stem for p in SOURCE_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = {}
    nvcc = None
    for name in names:
        out = BUILD_DIR / f"{name}-{_digest(name)}.so"
        log = out.with_suffix(".log")
        if out.exists() and log.exists():
            results[name] = BuildResult(name, out, 0.0,
                                        _ptxas_lines(log.read_text()))
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, out, log, tmp, time.perf_counter())
    failures = []
    for name, (proc, out, log, tmp, t0) in running.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit "
                            f"{proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
        log.write_text(text)
        results[name] = BuildResult(name, out, seconds, _ptxas_lines(text))
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


class Kernel:
    """A C entry point of a built CUDA library and the count of launches
    made through it.

    ``library`` names the source (``csrc/<library>.cu``; by default the
    kernel's own name): one library may hold several entry points, each
    with its own counter. ``launches`` is a plain integer that the kernel's
    wrapper increments once per launch and nothing else touches, so a run
    can show that its main path went through the kernel."""

    def __init__(self, name: str, function: str, argtypes: Sequence,
                 library: Optional[str] = None):
        self.name = name
        self.function = function
        self.argtypes = list(argtypes)
        self.library = library or name
        self.launches = 0
        self._fn = None

    def fn(self):
        """The C entry point, building every kernel library on first use."""
        if self._fn is None:
            path = build()[self.library].path
            fn = getattr(ctypes.CDLL(str(path)), self.function)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
