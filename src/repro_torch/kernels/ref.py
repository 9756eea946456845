"""Plain oracles of the explicit-bits kernels (counterpart of
``repro.kernels.ref``).

Each oracle takes the *same* explicit random bits as its kernel (uint32
words in int64 tensors), so a kernel and its oracle agree bit for bit
wherever the kernel's sums are exact: ``sr_cast_ref`` for K1
(``kernels.sr_cast.sr_cast``), ``fused_qupdate_ref`` for K2
(``kernels.fused_update.fused_qupdate``), ``qmatmul_ref`` for K3
(``kernels.qmatmul.qmatmul``).  They are written from the rounding core
alone (``core.rounding.round_to_format``), independent of the kernels'
block rounding.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.gd import GDRounding, _resolve_v, f32
from repro_torch.core.rounding import round_to_format
from repro_torch.core.schemes import get_scheme


def sr_cast_ref(x: torch.Tensor, bits: Optional[torch.Tensor], fmt,
                mode: str, eps: float = 0.0, v=None, rand_bits: int = 32,
                overflow: str = "saturate") -> torch.Tensor:
    """Oracle for K1 (``kernels.sr_cast.sr_cast``)."""
    return round_to_format(x, fmt, mode, bits=bits, eps=eps, v=v,
                           rand_bits=rand_bits, overflow=overflow)


def fused_qupdate_ref(x: torch.Tensor, g: torch.Tensor, t: float,
                      bits3: torch.Tensor, cfg: GDRounding) -> torch.Tensor:
    """Oracle for K2 (``kernels.fused_update.fused_qupdate``): the paper's
    eq. 8 fed rows 0, 1, 2 of ``bits3``."""
    x, g = x.float(), g.float()
    g_hat = cfg.grad(g, bits=bits3[0], v=_resolve_v(cfg.grad_v, g, x))
    upd = cfg.mul(f32(t) * g_hat, bits=bits3[1],
                  v=_resolve_v(cfg.mul_v, g_hat, x))
    z = x - upd
    return cfg.sub(z, bits=bits3[2], v=_resolve_v(cfg.sub_v, g_hat, x))


def qmatmul_ref(a: torch.Tensor, b: torch.Tensor,
                bits: Optional[torch.Tensor], fmt, mode: str = "sr",
                eps: float = 0.0, rand_bits: int = 32) -> torch.Tensor:
    """Oracle for K3 (``kernels.qmatmul.qmatmul``): fp32 GEMM, then the
    result rounded."""
    prod = a.float() @ b.float()
    if get_scheme(mode).stochastic:
        return round_to_format(prod, fmt, mode, bits=bits, eps=eps,
                               rand_bits=rand_bits)
    return round_to_format(prod, fmt, mode, eps=eps)
