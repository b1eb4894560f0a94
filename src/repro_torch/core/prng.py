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
* :func:`split`, :func:`uniform` and :func:`categorical` (Gumbel-max,
  ``mode="low"``) follow ``jax/_src/prng.py`` and ``jax/_src/random.py``.

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


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: keys of shape ``(..., *num, 2)``."""
    b1, b2 = _hash_counters(key, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element (as int64 in [0, 2**32)), shape
    ``(..., *shape)``."""
    b1, b2 = _hash_counters(key, _shape(shape))
    return b1 ^ b2


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


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel(mode="low")`` in float32."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (Gumbel-max, with
    replacement): one int64 index per key. ``logits`` is ``(..., n)`` with
    the key's batch shape in front."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
