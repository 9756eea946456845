"""Primitive layers: the quantized dense primitive, RMSNorm, RoPE and
initializers (counterpart of ``repro.models.layers``).

Compute dtype is bfloat16.  The reference keeps float32 weights and casts
each one to the activation dtype inside every GEMM (``qdense``); the port
rounds the weight matrices to bfloat16 once, when they are made or loaded
(``store_weight``), because the values the GEMMs see are identical and the
per-call cast of every weight would double the bytes a decode step moves.
Norm scales stay float32, as the reference uses them.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.precision.policy import QuantCtx, qdot

COMPUTE_DTYPE = torch.bfloat16


def store_weight(w: torch.Tensor) -> torch.Tensor:
    """A GEMM weight as the port stores it: rounded once to bf16."""
    return w.to(COMPUTE_DTYPE)


def qdense(x: torch.Tensor, w: torch.Tensor,
           quant: Optional[QuantCtx] = None, tag: int = 0) -> torch.Tensor:
    """``x @ w`` in the activation dtype through the quantized-GEMM path:
    the single call site of every weight matmul in models/."""
    return qdot(x, w.to(x.dtype), quant, tag)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None, n: Optional[int] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, scale^2) weights, (d_in, d_out) or stacked (n, d_in, d_out),
    drawn in float32 and stored as ``dtype`` (one float32 leaf alive at a
    time: the draw is scaled in place)."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    shape = (d_in, d_out) if n is None else (n, d_in, d_out)
    w = torch.randn(shape, generator=gen, device=gen.device).mul_(scale)
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=gen.device) \
        .mul_(0.02).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _device_frequencies(head_dim: int, theta: float,
                        device: torch.device) -> torch.Tensor:
    """The frequency table on ``device``, made once per (hd, theta,
    device): a host-to-device copy per call would block the host until
    the device queue drains, serialising every decode step."""
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = _device_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
