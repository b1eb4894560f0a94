"""Explicit, key-based threefry2x32 random numbers in PyTorch.

The JAX package draws every random number of the main path from
``jax.random`` with the default threefry2x32 implementation in its
*partitionable* mode (``jax_threefry_partitionable=True``). This module
reproduces those draws bit for bit from the same keys, so the port and the
reference sample the same seeds, the same Round-2 indices and the same
coreset slots:

* a key is an int64 tensor of shape ``(..., 2)`` holding the two uint32
  words of a raw JAX key (``jax.random.PRNGKey(seed)``); leading axes batch
  independent keys, as ``jax.vmap`` over keys does;
* :func:`split`, :func:`fold_in`, :func:`uniform` and :func:`categorical`
  (Gumbel-max, ``mode="low"``) follow ``jax/_src/prng.py`` and
  ``jax/_src/random.py``;
* inside ``roofline.record()`` each public draw runs under the profiler
  range ``work:draw.<name>``, the outermost alone (``categorical``'s
  Gumbel and uniform draws are one ``work:draw.categorical``); the range
  changes no bit of the draw (``roofline.trace.draw``).

uint32 arithmetic runs in int64 with explicit 32-bit masks: PyTorch has no
full set of unsigned 32-bit operations on every device.

``categorical`` takes ``log`` twice; PyTorch's and XLA's ``log`` may round
differently in the last place, so two Gumbel scores that tie within one ulp
can pick different indices in the two libraries. Everything else here is
exact integer arithmetic or a single correctly rounded float operation.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.roofline.trace import draw

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_F32_TINY = float(torch.finfo(torch.float32).tiny)

Shape = Union[int, Sequence[int]]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The raw key ``jax.random.PRNGKey(seed)`` as JAX builds it with 64-bit
    mode off (the JAX package's setting): the seed is taken modulo 2**32
    and the high word is zero."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _check_key(key: torch.Tensor) -> None:
    if key.dtype != torch.int64 or key.ndim < 1 or key.shape[-1] != 2:
        raise TypeError(f"a key is an int64 tensor of shape (..., 2), got "
                        f"{tuple(key.shape)} {key.dtype}")


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors holding uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def _shape(shape: Shape):
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _hash_counters(key: torch.Tensor, shape):
    """threefry over the flat uint64 iota of ``shape`` (high word, low
    word) under every key of the batch: ``(..., *shape)`` word pairs."""
    _check_key(key)
    size = 1
    for s in shape:
        size *= s
    if size >= 1 << 32:
        raise ValueError("more than 2**32 counters per key are not supported")
    lo = torch.arange(size, dtype=torch.int64, device=key.device)
    lo = lo.reshape(shape)
    hi = torch.zeros_like(lo)
    view = key.shape[:-1] + (1,) * len(shape)
    k1 = key[..., 0].reshape(view)
    k2 = key[..., 1].reshape(view)
    return threefry2x32(k1, k2, hi, lo)


@draw
def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: keys of shape ``(..., *num, 2)``."""
    b1, b2 = _hash_counters(key, _shape(num))
    return torch.stack([b1, b2], dim=-1)


@draw
def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the seed pair ``(0, data mod
    2**32)`` under the key; shape ``(..., 2)``."""
    _check_key(key)
    k1, k2 = key[..., 0], key[..., 1]
    lo = torch.full_like(k1, int(data) & _MASK)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


@draw
def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element (as int64 in [0, 2**32)), shape
    ``(..., *shape)``."""
    b1, b2 = _hash_counters(key, _shape(shape))
    return b1 ^ b2


@draw
def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the 23 high bits become the
    mantissa of a float in [1, 2), minus one, scaled to [minval, maxval)."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA fuses floats * span + lo into one FMA: the 24-bit by 24-bit
    # product is exact in float64, so one rounding to float32 follows it
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


@draw
def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel(mode="low")`` in float32."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


@draw
def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (Gumbel-max, with
    replacement): one int64 index per key. ``logits`` is ``(..., n)`` with
    the key's batch shape in front."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


# XLA's float32 erf_inv (Giles' polynomials in w = -log1p(-x^2), split at
# w = 5) and its log1p (a Cephes rational below |x| = sqrt(2) - 1, else
# log(1 + x)), the lowering that jax.random.normal goes through
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    r = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        r = r * x + c
    return r


def _log1p_xla(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    small = x * x2 * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + (-0.5 * x2 + small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


def _erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    w = -_log1p_xla(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coeff = [torch.where(lt, torch.tensor(a, dtype=x.dtype, device=x.device),
                         torch.tensor(b, dtype=x.dtype, device=x.device))
             for a, b in zip(_ERFINV_W_LT5, _ERFINV_W_GE5)]
    p = coeff[0]
    for c in coeff[1:]:
        p = c + p * w
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


@draw
def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: a uniform draw on (-1, 1) (its low
    end the float after -1) through ``sqrt(2) * erf_inv``, with XLA's
    ``erf_inv`` and ``log1p`` formulas. XLA may contract a product and a
    sum into one FMA and its ``log`` is its own, so about 5% of values
    differ from the JAX package's in their last few bits (relative
    difference observed <= 2.3e-7)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, minval=lo, maxval=1.0)
    sqrt2 = torch.tensor(2.0 ** 0.5, dtype=torch.float32, device=key.device)
    return sqrt2 * _erfinv_xla(u)


@draw
def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` with int32 output (the JAX package's default
    integer): two 32-bit words per value (the key split in two), folded
    into the span with uint32 arithmetic (``jax/_src/random.py``'s
    ``_randint``); ``minval`` when ``maxval <= minval``."""
    info = torch.iinfo(torch.int32)
    lo = max(min(int(minval), info.max), info.min)
    hi = max(min(int(maxval), info.max), info.min)
    span = (hi - lo) & _MASK if hi > lo else 1
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    # int64 products wrap mod 2**64, so their low 32 bits are uint32's
    offset = ((higher % span) * multiplier) & _MASK
    offset = ((offset + lower % span) & _MASK) % span
    return (lo + offset).to(torch.int32)
