"""The port's serving launcher (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``): ``main`` runs on the CPU with the
reference's request count and output lengths, and on the reference's
params carried across (f32 configs on both sides) the engine's tokens
equal the reference's, as ``test_torch_serve_engine.py`` holds them (up
to a near tie of the scores the port picked from)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _lm_parity import to_numpy
from repro.launch import serve as jserve
from repro.models import init_params as jinit_params
from repro_torch import interop
from repro_torch.launch import serve
from test_torch_serve_engine import _assert_tokens

torch.set_num_threads(1)

ARGV = ["--requests", "4", "--slots", "3", "--max-new", "6",
        "--max-len", "32"]


def test_serve_main_on_the_cpu_has_the_references_shape(capsys):
    got = serve.main(ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    want = jserve.main(ARGV)
    assert len(got) == len(want) == 4
    assert [len(r.out) for r in got] == [len(r.out) for r in want] \
        == [8 + 6] * 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
    assert "tok/s on the CPU" in out


@pytest.fixture
def f32(monkeypatch):
    """Both launchers' reduced configs in f32."""
    for mod in (serve, jserve):
        get = mod.configs.get_reduced
        monkeypatch.setattr(
            mod.configs, "get_reduced", lambda arch, get=get:
            dataclasses.replace(get(arch), dtype="float32"))


@pytest.mark.parametrize("arch", ["llama3_8b", "mamba2_370m"])
def test_serve_tokens_are_the_references(f32, arch):
    argv = ARGV + ["--arch", arch]
    want = jserve.main(argv)
    jc = jserve.configs.get_reduced(arch)
    tc = serve.configs.get_reduced(arch)
    params = interop.model_params(
        to_numpy(jinit_params(jax.random.PRNGKey(0), jc)), tc, "cpu")
    got = serve.main(argv + ["--device", "cpu"], params=params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_tokens(tc, params, g.out[None], np.asarray(w.out)[None],
                       len(g.prompt))


def test_serve_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(ARGV)
