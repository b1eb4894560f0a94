"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the smoke script refuses to run (and
prints no result) without a GPU."""
import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _is_forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_every_port_module_imports_without_jax_or_repro():
    """A fresh interpreter imports repro_torch and every module under it;
    neither JAX nor anything of the JAX package may be loaded."""
    script = f"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {SRC!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({{"modules": names, "loaded": sorted(sys.modules)}}))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, check=True, env=env, cwd=ROOT)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(result["modules"]) >= 18, result["modules"]
    bad = [m for m in result["loaded"] if _is_forbidden(m)]
    assert bad == [], bad


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_files():
    for dirpath, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", [os.path.join(ROOT, "chip_smoke.py")]
                         + sorted(_port_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_name_no_jax_or_repro_import(path):
    """Statically, too: no import statement (even one inside a function)
    names JAX or the JAX package."""
    bad = [m for m in _imports(path) if _is_forbidden(m)]
    assert bad == [], bad


def test_chip_smoke_without_a_gpu_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
