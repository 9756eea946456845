"""Threefry-2x32 and the key derivation of ``jax.random``, on the host.

The reference's randomness is all counter-based Threefry-2x32
(``repro.kernels.common.threefry2x32``).  Under the pinned configuration
(``jax_default_prng_impl=threefry2x32``, ``jax_threefry_partitionable``)
the ``jax.random`` key functions reduce to it:

* ``PRNGKey(seed)``  = ``(0, seed mod 2**32)`` for an int32 seed;
* ``fold_in(k, d)``  = ``threefry(k, (0, d))``;
* ``split(k, n)[i]`` = ``threefry(k, (0, i))``.

* ``bits(k, shape)``  = ``x0 ^ x1`` of ``threefry(k, (hi, lo))`` over the
  flat row-major index split into its high and low 32-bit words;
* ``uniform(k, ...)`` = the top 23 bits of ``bits`` as the mantissa of a
  float in [1, 2), minus 1, then scaled.

Keys are pairs of Python ints: the serving path derives a few hundred seed
words per decode step, and plain ints are far cheaper than small tensors.
The device-side counter draws live in ``kernels/common.py``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core.fma import fma

M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: int, k1: int, c0: int, c1: int) -> Tuple[int, int]:
    """Threefry-2x32, 20 rounds, on Python ints (uint32 semantics)."""
    k0, k1 = k0 & M32, k1 & M32
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (c0 + ks[0]) & M32
    x1 = (c1 + ks[1]) & M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & M32
    return x0, x1


def threefry2x32_tensor(k0, k1, c0, c1):
    """Threefry-2x32 on int64 tensors (or numpy int64 arrays) holding
    uint32 words, masked to 32 bits after every add and rotate.
    ``k0``/``k1``/``c1``: ints or arrays that broadcast against ``c0``."""
    if isinstance(k0, int):
        k0 &= M32
    if isinstance(k1, int):
        k1 &= M32
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (c0 + ks[0]) & M32
    x1 = (c1 + ks[1]) & M32
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` key data for an int32 seed."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit int32, got {seed}")
    return (0, seed & M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, data & M32)


def split(key: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(key, num)`` (partitionable derivation)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def key_data(key: Key) -> Key:
    """The two uint32 words of a key (keys are already raw words here)."""
    return (key[0] & M32, key[1] & M32)


def derive_seed(key: Key, step: Optional[int] = None,
                site: Optional[int] = None) -> Key:
    """``repro.kernels.common.derive_seed``: fold step, then site."""
    if step is not None:
        key = fold_in(key, step)
    if site is not None:
        key = fold_in(key, site)
    return key_data(key)


def _bits_range(key: Key, lo: int, hi: int, device) -> torch.Tensor:
    """Words lo..hi-1 of the flat ``jax.random.bits`` draw (int64)."""
    idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32_tensor(key[0], key[1], idx >> 32, idx & M32)
    return x0 ^ x1


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` (partitionable derivation)
    as uint32 words in an int64 tensor."""
    shape = tuple(shape)
    return _bits_range(key, 0, math.prod(shape), device).reshape(shape)


def int32_words(w: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) as the int32 bit patterns a kernel reads."""
    w = w & M32
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def random_words(key: Key, shape, device=None,
                 chunk: int = 1 << 24) -> torch.Tensor:
    """``random_bits`` as int32 bit patterns, drawn ``chunk`` words at a
    time (a (3, 1.1e9) draw would otherwise hold tens of GB of int64)."""
    out = torch.empty(tuple(shape), dtype=torch.int32, device=device)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), chunk):
        hi = min(flat.numel(), lo + chunk)
        flat[lo:hi] = int32_words(_bits_range(key, lo, hi, device))
    return out


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``;
    XLA evaluates ``floats * (maxval - minval) + minval`` as one fused
    multiply-add, and so does the port (``core.fma``)."""
    bits = random_bits(key, shape, device)
    one = (bits >> 9) | 0x3F800000                 # float32 in [1, 2)
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    span = torch.tensor(maxval, dtype=torch.float32, device=device) - lo
    return torch.maximum(lo, fma(span, floats, lo))

