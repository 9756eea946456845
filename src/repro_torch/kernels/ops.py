"""The public key-taking wrappers of the kernels (counterpart of
``repro.kernels.ops``).

These are the entry points a caller with a ``jax.random``-style key uses:
the explicit-bits flavours draw their bits operand as ``jax.random.bits``
does (``core.prng.random_words``, the same words as int32 bit patterns),
the in-kernel flavours reduce the key to its seed words
(``core.prng.derive_seed``).  Plain functions on tensors: each dispatches
to its kernel for a CUDA tensor and to the kernel's plain twin for a CPU
one.

``sr_cast``            -> K1  (``kernels.sr_cast.sr_cast``)
``sr_cast_prng``       -> K1' (``kernels.sr_cast.sr_cast_prng``)
``fused_qupdate``      -> K2  (``kernels.fused_update.fused_qupdate``)
``fused_qupdate_prng`` -> K2' (``kernels.fused_update.fused_qupdate_prng``)
``qmatmul_lowp``       -> K3  (``kernels.qmatmul.qmatmul``)
``qmatmul_lowp_prng``  -> K3' (``kernels.qmatmul.qmatmul_prng``)
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.gd import GDRounding
from repro_torch.kernels import fused_update, qmatmul, sr_cast as _sr_cast


def _weights(b: torch.Tensor) -> torch.Tensor:
    """B as the kernels take it: bf16 stays (widened exactly in the
    kernel), anything else goes to float32."""
    return b if b.dtype in (torch.float32, torch.bfloat16) else b.float()


def sr_cast(x: torch.Tensor, key: prng.Key, fmt, mode: str = "sr",
            eps: float = 0.0, v=None, rand_bits: int = 32,
            overflow: str = "saturate") -> torch.Tensor:
    """Stochastic-round cast through K1, bits ``jax.random.bits(key,
    x.shape)``."""
    x = x.float()
    bits = prng.random_words(key, x.shape, device=x.device)
    return _sr_cast.sr_cast(x, bits, fmt, mode, eps, v, rand_bits=rand_bits,
                            overflow=overflow)


def sr_cast_prng(x: torch.Tensor, key: prng.Key, fmt, mode: str = "sr",
                 eps: float = 0.0, v=None, rand_bits: int = 32,
                 overflow: str = "saturate") -> torch.Tensor:
    """Stochastic-round cast through K1' (bits drawn in the kernel from
    ``derive_seed(key)``)."""
    return _sr_cast.sr_cast_prng(x.float(), prng.derive_seed(key), fmt, mode,
                                 eps, v, rand_bits=rand_bits,
                                 overflow=overflow)


def fused_qupdate(x: torch.Tensor, g: torch.Tensor, t: float,
                  key: prng.Key, cfg: GDRounding) -> torch.Tensor:
    """The fused eq.-8 update through K2, bits ``jax.random.bits(key, (3,
    *x.shape))``."""
    x, g = x.float(), g.float()
    bits3 = prng.random_words(key, (3, *x.shape), device=x.device)
    return fused_update.fused_qupdate(x, g, t, bits3, cfg)


def fused_qupdate_prng(x: torch.Tensor, g: torch.Tensor, t: float,
                       key: prng.Key, cfg: GDRounding) -> torch.Tensor:
    """The fused eq.-8 update through K2' (bits drawn in the kernel)."""
    return fused_update.fused_qupdate_prng(x.float(), g.float(), t,
                                           prng.derive_seed(key), cfg)


def qmatmul_lowp(a: torch.Tensor, b: torch.Tensor, key: prng.Key, fmt,
                 mode: str = "sr", eps: float = 0.0) -> torch.Tensor:
    """Low-precision-output GEMM through K3, bits ``jax.random.bits(key,
    (M, N))``.  (The reference's block-size arguments have no counterpart:
    the CUDA kernels tile themselves.)"""
    a = a.float()
    bits = prng.random_words(key, (a.shape[0], b.shape[1]), device=a.device)
    return qmatmul.qmatmul(a, _weights(b), bits, fmt, mode, eps=eps)


def qmatmul_lowp_prng(a: torch.Tensor, b: torch.Tensor, key: prng.Key, fmt,
                      mode: str = "sr", eps: float = 0.0) -> torch.Tensor:
    """Low-precision-output GEMM through K3' (bits drawn in the kernel
    from ``derive_seed(key)``)."""
    return qmatmul.qmatmul_prng(a.float(), _weights(b),
                                prng.derive_seed(key), fmt, mode, eps=eps)
