"""Threefry-2x32 and the key derivation of ``jax.random``, on the host.

The reference's randomness is all counter-based Threefry-2x32
(``repro.kernels.common.threefry2x32``).  Under the pinned configuration
(``jax_default_prng_impl=threefry2x32``, ``jax_threefry_partitionable``)
the ``jax.random`` key functions reduce to it:

* ``PRNGKey(seed)``  = ``(0, seed mod 2**32)`` for an int32 seed;
* ``fold_in(k, d)``  = ``threefry(k, (0, d))``;
* ``split(k, n)[i]`` = ``threefry(k, (0, i))``.

Keys are pairs of Python ints: the serving path derives a few hundred seed
words per decode step, and plain ints are far cheaper than small tensors.
The device-side counter draws live in ``kernels/common.py``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

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


def threefry2x32_tensor(k0, k1, c0: torch.Tensor, c1: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 on int64 tensors holding uint32 words (masked to 32
    bits after every add and rotate).  ``k0``/``k1``: ints or tensors that
    broadcast against the counters."""
    if isinstance(k0, int):
        k0 = torch.tensor(k0 & M32, dtype=torch.int64, device=c0.device)
    if isinstance(k1, int):
        k1 = torch.tensor(k1 & M32, dtype=torch.int64, device=c0.device)
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

