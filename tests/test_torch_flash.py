"""The port's flash attention (``repro_torch.models.flash``, an autograd
function) against the JAX package's custom-VJP one and ``jax.grad`` of it
on the same inputs, over ``tests/test_flash_attention.py``'s cases at its
tolerances, plus bf16 inputs; then the other attention paths of
``layers.py`` -- the soft-capped rectangle, the sliding-window band and the
decode step -- against the reference's on the same inputs."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models.flash import flash_attention as jflash
from repro_torch import configs
from repro_torch.models import layers
from repro_torch.models.flash import flash_attention

# torch runs single-threaded in these tests: with JAX's CPU runtime in the
# same process, the two thread pools contend and torch's ops run 10-40x
# slower
torch.set_num_threads(1)

# tests/test_flash_attention.py's cases and tolerances
CASES = [
    (2, 64, 2, 2, 16, 16, 16),
    (1, 96, 4, 1, 8, 32, 48),
    (2, 128, 1, 4, 16, 128, 64),   # single q chunk
]
FWD_TOL, GRAD_TOL = 2e-4, 3e-3


def _inputs(rng, B, L, KV, G, hd, dtype=np.float32):
    return [rng.standard_normal(s).astype(dtype)
            for s in ((B, L, KV, G, hd), (B, L, KV, hd), (B, L, KV, hd))]


def _naive(q, k, v, q_pos, k_pos):
    """The port's plain softmax attention (test_flash_attention's)."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) / math.sqrt(q.shape[-1])
    mask = k_pos[None, :] <= q_pos[:, None]
    s = torch.where(mask, s, -1e30)
    return torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(s, -1), v)


@pytest.mark.parametrize("B,L,KV,G,hd,qc,kc", CASES)
def test_flash_forward_and_gradients_are_the_references(B, L, KV, G, hd,
                                                        qc, kc):
    rng = np.random.default_rng(0)
    q, k, v = _inputs(rng, B, L, KV, G, hd)
    w = rng.standard_normal(q.shape).astype(np.float32)
    pos = np.arange(L, dtype=np.int32)
    jpos = jnp.asarray(pos)

    def jloss(q, k, v):
        return jnp.sum(jflash(q, k, v, jpos, jpos, qc, kc) * w)

    jout = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), jpos, jpos, qc,
                             kc))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    out = flash_attention(tq, tk, tv, tpos, tpos, qc, kc)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=FWD_TOL,
                               atol=FWD_TOL)
    naive = _naive(tq.detach(), tk.detach(), tv.detach(), tpos, tpos)
    np.testing.assert_allclose(out.detach().numpy(), naive.numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    for a, b, nm in zip(grads, jgrads, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{nm}")


def test_flash_bf16_inputs_are_the_references():
    """bf16 in, bf16 out, gradients in bf16: both packages compute in f32
    on the same bf16 values, so they agree to one bf16 rounding (2^-8
    relative) of the output and the gradients."""
    rng = np.random.default_rng(1)
    B, L, KV, G, hd = 1, 32, 2, 2, 8
    q, k, v = (a.astype(np.float32) for a in _inputs(rng, B, L, KV, G, hd))
    pos = np.arange(L, dtype=np.int32)
    jpos = jnp.asarray(pos)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jout = jflash(jq, jk, jv, jpos, jpos, 16, 16)
    jgrads = jax.grad(lambda *a: jnp.sum(jflash(*a, jpos, jpos, 16, 16)
                                         .astype(jnp.float32)),
                      argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16).requires_grad_() for a in (jq, jk, jv))
    tpos = torch.from_numpy(pos)
    out = flash_attention(tq, tk, tv, tpos, tpos, 16, 16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout, np.float32), rtol=2 ** -8,
                               atol=2 ** -8)
    grads = torch.autograd.grad(out.float().sum(), (tq, tk, tv))
    for a, b, nm in zip(grads, jgrads, "qkv"):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=2 ** -7,
                                   atol=2 ** -7, err_msg=f"d{nm}")


# -- the other attention paths of layers.py -------------------------------------

def _cfgs(**changes):
    jc = dataclasses.replace(jconfigs.get_reduced("gemma3_27b"), **changes)
    tc = dataclasses.replace(configs.get_reduced("gemma3_27b"), **changes)
    return jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 2.0])
@pytest.mark.parametrize("path", ["rect", "banded"])
def test_attention_paths_are_the_references(path, softcap, dtype):
    """``_attention_rect`` (over 4 KV chunks and 2 Q chunks) and
    ``_attention_banded`` (window 16, 3 Q chunks) on the same q, k, v: f32
    to FWD_TOL, bf16 to one bf16 rounding of the output."""
    jc, tc = _cfgs(attn_logit_softcap=softcap, dtype=dtype)
    rng = np.random.default_rng(2)
    B, L, H, KV, hd = 2, 48, 4, 2, 16
    q = rng.standard_normal((B, L, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, L, KV, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.arange(L, dtype=np.int32)
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(
        layers.torch_dtype(dtype)) for a in (jq, jk, jv))
    tpos = torch.from_numpy(pos)
    if path == "rect":
        want = jlayers._attention_rect(jq, jk, jv, jnp.asarray(pos),
                                       jnp.asarray(pos), jc, 12, q_chunk=24)
        got = layers._attention_rect(tq, tk, tv, tpos, tpos, tc, 12,
                                     q_chunk=24)
    else:
        want = jlayers._attention_banded(jq, jk, jv, jnp.asarray(pos),
                                         jnp.asarray(pos), jc, 16)
        got = layers._attention_banded(tq, tk, tv, tpos, tpos, tc, 16)
    tol = FWD_TOL if dtype == "float32" else 2 ** -8
    assert got.dtype == layers.torch_dtype(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kind", ["attn", "local"])
def test_attention_decode_is_the_references(kind):
    """``_attention_decode`` against a ring cache whose slots hold
    positions at different depths per sequence, some empty."""
    jc, tc = _cfgs(attn_logit_softcap=2.0, dtype="float32")
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 3, 16, 4, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    slot_pos = rng.integers(-1, 40, (B, S)).astype(np.int32)
    cur = np.array([39, 20, 5], np.int32)
    want = jlayers._attention_decode(*map(jnp.asarray, (q, k, v, slot_pos,
                                                        cur)), jc, kind)
    got = layers._attention_decode(*map(torch.from_numpy, (q, k, v,
                                                           slot_pos, cur)),
                                   tc, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_int8_quantization_is_the_references():
    """``_quant_kv`` rounds half to even and clips to +-127, as the
    reference: payloads and scales equal on values placed on half steps."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    x[..., 0] = 127.0 / 8            # scale 1/8 + 1e-8: halves land below
    x[..., 1:4] = np.array([2.5, -3.5, 0.5], np.float32) / 8
    jq, jsc = jlayers._quant_kv(jnp.asarray(x))
    tq, tsc = layers._quant_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_array_equal(
        layers._dequant_kv(tq, tsc, torch.float32).numpy(),
        np.asarray(jlayers._dequant_kv(jq, jsc, jnp.float32)))
