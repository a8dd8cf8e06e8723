"""Threefry-2x32 random streams, word for word those of ``jax.random``.

The reference draws its sampler's noise from ``jax.random`` (threefry
2x32 keys, ``fold_in``, ``gumbel``) with ``jax_threefry_partitionable``
on, the default since jax 0.5.  This module computes the same uint32
words in plain torch on whatever device its inputs lie on, so a sampled
token stream stays a pure function of (seed, request id, position) in
both packages.  The streams are counter-based: no ``torch.Generator`` and
no state between calls.

Word representation: torch has little unsigned 32-bit arithmetic on
CUDA, so every uint32 word is held in an **int64** tensor with values in
[0, 2^32); each add and shift is masked back with ``& 0xFFFFFFFF``.  A
key is a (..., 2) int64 tensor, the two words of jax's key data.

Counterparts (jax 0.9.0):

  * ``threefry2x32``   — ``jax/_src/prng.py`` ``_threefry2x32_lowering``
  * ``prng_key``       — ``PRNGKey(seed)``'s key data (``threefry_seed``)
  * ``fold_in``        — ``threefry_fold_in``
  * ``random_bits``    — ``_threefry_random_bits_partitionable``, 32 bit:
    ``bits1 ^ bits2`` of the hash over ``iota_2x32_shape``
  * ``uniform``        — ``jax/_src/random.py`` ``_uniform`` for float32
  * ``gumbel``         — ``_gumbel`` in its default ``"low"`` mode
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
# the Threefry-2x32 rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32 = np.finfo(np.float32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x1, x2)
    under the key (k1, k2); int64 tensors broadcast together, or Python
    ints (the host path of ``fold_in_words``).  Returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK
    x1 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key_words(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s key data: the seed's high and low
    32-bit words."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2^32)")
    return (seed >> 32) & MASK, seed & MASK


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``key_words(seed)`` as a (2,) int64 tensor."""
    return torch.tensor(key_words(seed), dtype=torch.int64, device=device)


def fold_in_words(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``fold_in`` of one key on the host, in Python ints (a few µs, where
    the tensor path costs a few hundred)."""
    return threefry2x32(key[0], key[1], 0, data & MASK)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of the count pair (0, data) under
    ``key``.  ``key`` (..., 2) int64; ``data`` an int or an integer
    tensor broadcastable to ``key.shape[:-1]``, taken modulo 2^32 as jax
    takes it as uint32.  Returns the new (..., 2) keys."""
    if not torch.is_tensor(data):
        data = torch.tensor(data & MASK, dtype=torch.int64,
                            device=key.device)
    data = data.to(torch.int64) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` with partitionable threefry:
    the hash of the counts (hi, lo) of a flat uint64 iota of ``shape``,
    output words XORed.  ``key`` (..., 2); returns (..., *shape) int64
    words.  Shapes of 2^32 elements or more are refused (the high count
    word is then nonzero)."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError(f"random_bits: {n} words, at most 2^32 - 1")
    lead = key.shape[:-1]
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval) and clamped below
    at ``minval``.  XLA fuses the scaling ``floats * span + lo`` into one
    multiply-add, rounded once: it is computed here in float64 (the
    product of a 23-bit and a 24-bit mantissa is exact there) and rounded
    once to float32.  Returns (..., *shape) float32."""
    bits = random_bits(key, shape)
    one = int(np.float32(1.0).view(np.uint32))
    floats = ((bits >> (32 - _F32.nmant)) | one).to(torch.int32) \
        .view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp((floats.double() * span + lo).float(), min=lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, ``mode="low"``:
    ``-log(-log(u))`` with u uniform on [tiny, 1).  The logs are taken in
    float64 and the result rounded once to float32, so it lies within
    half an ulp of the exact value on any device; XLA's float32 logs put
    the reference's within about an ulp.  Returns (..., *shape)
    float32."""
    u = uniform(key, shape, minval=float(_F32.tiny), maxval=1.0)
    return (-torch.log(-torch.log(u.double()))).float()
