"""The port's prefill and decode modes (``repro_torch.models.forward`` with
a cache) against the JAX package's on the reference's own parameters, in
exactified f32, at every reduced configuration of ``ARCH_IDS``: the
prefill's logits and cache (int8 payloads and ``pos`` exactly, floats to
the forward's tolerance) and each decode step's logits; then an int8 KV
cache, a logit soft-cap (the masked rectangle, ``_attention_rect``, which
no configuration reaches), and the local layers' ring branch. On the port
alone: decode equals the score forward, as ``tests/test_models.py``
holds the reference."""
import numpy as np
import pytest
import torch

from _lm_parity import (ARCHS, F32_RTOL, LP, assert_cache_equal,
                        configs_for, port_params, port_run,
                        reference_params, reference_run, tokens)
from repro_torch import interop
from repro_torch.models import init_cache, init_params
from repro_torch.models.model import layer_kinds

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

# An int8 cache rounds K and V to steps of 1/127 of each row's largest
# magnitude: where a value sits within f32 noise of a half step, the two
# packages round it apart (one step), and from then on the caches differ
# in that element. Decode steps are held to F32_RTOL up to the first such
# flip, then to INT8_FLIP_RTOL: one flip moves one element of K or V by a
# step, which moves the logits by ~1e-4 of their largest magnitude here
# (observed 2.6e-4 after 7 flips over 8 steps of gemma3 reduced), and every
# payload difference must be that one step
INT8_FLIP_RTOL = 2e-3

# (name, architecture, config changes): every reduced architecture, then
# an int8 KV cache on a global and on a local-window model, and a soft-cap
# on both (no configuration sets one: the rectangle and the banded path
# with a cap)
CASES = ([(arch, arch, {}) for arch in ARCHS] + [
    ("llama3_8b-int8", "llama3_8b", {"kv_cache_dtype": "int8"}),
    ("gemma3_27b-int8", "gemma3_27b", {"kv_cache_dtype": "int8"}),
    ("llama3_8b-softcap", "llama3_8b", {"attn_logit_softcap": 2.0}),
    ("gemma3_27b-softcap", "gemma3_27b", {"attn_logit_softcap": 2.0}),
])
NAMES = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def runs():
    """Each case's reference and port: score forward, prefill of LP tokens,
    decode to L, on the reference's parameters."""
    out = {}
    for name, arch, changes in CASES:
        jc, tc = configs_for(arch, **changes)
        jp = reference_params(jc)
        tok = tokens(jc)
        trace = tc.kv_cache_dtype == "int8"
        out[name] = (tc, reference_run(jc, jp, tok, trace=trace),
                     port_run(tc, port_params(jp, tc), tok, trace=trace))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_and_cache_are_the_references(runs, name):
    tc, ref, port = runs[name]
    scale = np.abs(ref["logits"]).max()
    np.testing.assert_allclose(port["prefill"], ref["prefill"], rtol=0,
                               atol=F32_RTOL * scale)
    assert_cache_equal(port["cache"], ref["cache"], tc)


@pytest.mark.parametrize("name", NAMES)
def test_decode_logits_are_the_references(runs, name):
    tc, ref, port = runs[name]
    scale = np.abs(ref["logits"]).max()
    np.testing.assert_allclose(port["logits"], ref["logits"], rtol=0,
                               atol=F32_RTOL * scale)
    flipped = False
    for s in range(port["decode"].shape[1]):
        if tc.kv_cache_dtype == "int8":
            flipped |= _int8_payloads_differ(port["caches"][s],
                                             ref["caches"][s], tc)
        np.testing.assert_allclose(
            port["decode"][:, s], ref["decode"][:, s], rtol=0,
            atol=(INT8_FLIP_RTOL if flipped else F32_RTOL) * scale,
            err_msg=f"decode step {s}")


def _int8_payloads_differ(port_cache, ref_cache, tc):
    """Whether any int8 payload differs; every difference one step."""
    differ = False
    for a, b in zip(port_cache, interop.model_cache(ref_cache, tc, "cpu")):
        for name in ("k", "v"):
            if a[name].dtype == torch.int8:
                gap = (a[name].int() - b[name].int()).abs()
                assert int(gap.max()) <= 1, name
                differ |= bool(gap.any())
    return differ


@pytest.mark.parametrize("name", [n for n in NAMES if "int8" not in n])
def test_decode_matches_forward(runs, name):
    """tests/test_models.py's check on the port: prefill and decode logits
    equal the score forward's within 5e-4 * max |logit| (an int8 cache
    quantizes K and V, so it is held to the reference instead)."""
    tc, _, port = runs[name]
    scale = np.abs(port["logits"]).max()
    np.testing.assert_allclose(port["prefill"], port["logits"][:, :LP],
                               rtol=0, atol=5e-4 * scale)
    np.testing.assert_allclose(port["decode"], port["logits"][:, LP:],
                               rtol=0, atol=5e-4 * scale)


@pytest.mark.parametrize("name", ["gemma3_27b", "recurrentgemma_2b",
                                  "gemma3_27b-int8"])
def test_local_layers_take_the_ring_branch(runs, name):
    """A prefill longer than the window keeps the last ``window`` tokens
    with slot == pos % window (``layers.py:397-405`` of the reference)."""
    tc, _, port = runs[name]
    assert LP > tc.window
    local = [c for c, kind in zip(port["cache"], layer_kinds(tc))
             if kind == "local"]
    assert local
    for c in local:
        pos = c["pos"]
        assert pos.shape[1] == tc.window
        slots = torch.arange(tc.window, dtype=torch.int32)
        assert torch.equal(pos % tc.window, slots.expand_as(pos))
        assert int(pos.min()) == LP - tc.window and int(pos.max()) == LP - 1


def test_init_params_and_init_cache_need_a_device_without_a_gpu():
    """Entry points run on the GPU unless asked for the CPU, and never on
    the CPU by accident."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    tc = configs_for("llama3_8b")[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(0, tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(tc, 1, 8)
