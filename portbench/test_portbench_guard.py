"""No module of JAX or of the JAX package is loaded by a run."""
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from portbench import guard
from portbench import run as harness

ROOT = Path(__file__).resolve().parents[1]


def test_a_run_loads_nothing_of_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
            "import portbench.run, portbench.control, portbench.check\n"
            "import repro_torch.core.distributed, repro_torch.roofline.trace\n"
            "from portbench import guard\n"
            "assert 'repro_torch' in sys.modules\n"
            "print(guard.loaded())\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.strip() == "[]"


def test_whole_top_level_names_are_compared():
    assert guard.loaded({"repro_torch", "repro_torch.core", "reprox",
                         "jaxtyping", "portbench.run"}) == []
    assert guard.loaded({"repro.core.distributed"}) == ["repro"]
    assert guard.loaded({"jax.numpy", "jaxlib", "flax.linen"}) == [
        "flax", "jax", "jaxlib"]


def test_a_forbidden_module_after_the_window_stops_the_run(small,
                                                           monkeypatch):
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    with pytest.raises(guard.Forbidden):
        harness.run_cell("kmeans-bigcross", 5, 0.1, False,
                         torch.device("cpu"), overrides=small)
