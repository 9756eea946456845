"""Quantized arithmetic under the standard rounding model, paper eq. 5/6
(counterpart of ``repro.core.qarith``).

Every op is computed in float32 and then rounded onto the target grid:
``fl(a op b) = (a op b)(1 + δ)``.  ``qmatmul`` models the accumulated
gradient-evaluation error (eq. 9) at three fidelity levels:

* ``"result"`` -- one rounding of the float32 product;
* ``"chunk"``  -- K split into chunks, partial sums rounded as they
  accumulate (``s ← fl(s + fl(chunk_dot))``);
* ``"fma"``    -- every multiply and every add rounded (chunks of one).

The float32 products are ``torch.matmul`` (the reference leaves them to
XLA, outside any kernel); on the card they must not run in TF32, so
``matmul`` refuses while ``torch.backends.cuda.matmul.allow_tf32`` is
set.  Their sums run in another order than XLA's, so ``"result"`` and
``"chunk"`` agree with the reference up to a grid step on the few outputs
whose sum lands near a rounding decision; ``"fma"`` sums nothing and
agrees bitwise.  Stochastic roundings draw ``prng.random_bits`` of the
reference's key splits.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.rounding import RoundingSpec


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 ``a @ b``; raises on the card while TF32 is allowed."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("qarith.matmul: TF32 is on (torch.backends.cuda"
                           ".matmul.allow_tf32); the paper's products are "
                           "float32")
    return a @ b


def _round(spec: RoundingSpec, x: torch.Tensor, key, v=None):
    if spec.is_identity:
        return x.float()
    return spec(x, key=key, v=v)


def _split(key: Optional[prng.Key], n: int):
    if key is None:
        return (None,) * n
    return prng.split(key, n)


def qadd(a, b, spec: RoundingSpec, *, key=None, v=None):
    return _round(spec, a.float() + b.float(), key, v)


def qsub(a, b, spec: RoundingSpec, *, key=None, v=None):
    return _round(spec, a.float() - b.float(), key, v)


def qmul(a, b, spec: RoundingSpec, *, key=None, v=None):
    return _round(spec, a.float() * b.float(), key, v)


def qdiv(a, b, spec: RoundingSpec, *, key=None, v=None):
    return _round(spec, a.float() / b.float(), key, v)


def qmatmul(a: torch.Tensor, b: torch.Tensor, spec: RoundingSpec, *,
            key: Optional[prng.Key] = None, accum: str = "result",
            chunk: int = 32) -> torch.Tensor:
    """Rounded ``a @ b`` with configurable accumulation fidelity.
    a: (..., M, K), b: (..., K, N) float32."""
    a, b = a.float(), b.float()
    if spec.is_identity:
        return matmul(a, b)
    if accum == "result":
        return _round(spec, matmul(a, b), key)
    k_dim = a.shape[-1]
    if accum == "fma":
        chunk_size = 1
    elif accum == "chunk":
        chunk_size = min(chunk, k_dim)
    else:
        raise ValueError(f"unknown accum mode {accum!r}")
    n_chunks = -(-k_dim // chunk_size)
    pad = n_chunks * chunk_size - k_dim
    if pad:
        a = F.pad(a, (0, pad))
        b = F.pad(b, (0, 0, 0, pad))
    a_c = a.reshape(a.shape[:-1] + (n_chunks, chunk_size))
    b_c = b.reshape(b.shape[:-2] + (n_chunks, chunk_size) + b.shape[-1:])
    keys = _split(key, 2 * n_chunks)
    s = None
    for i in range(n_chunks):
        part = _round(spec, matmul(a_c[..., :, i, :], b_c[..., i, :, :]),
                      keys[2 * i])
        s = part if s is None else _round(spec, s + part, keys[2 * i + 1])
    return s


def qdot(a, b, spec: RoundingSpec, *, key=None, accum: str = "result",
         chunk: int = 32) -> torch.Tensor:
    """Rounded inner product of two vectors."""
    return qmatmul(a.float().reshape(1, -1), b.float().reshape(-1, 1), spec,
                   key=key, accum=accum, chunk=chunk)[0, 0]
