"""Float32 fused multiply-add, as XLA contracts ``a * b + c``.

The reference's compiled code evaluates ``a * b + c`` as one fused
multiply-add (one rounding) where PyTorch's eager ops round twice: the
momentum update ``0.9 * m + g`` and the uniform draw's
``floats * span + min`` are such sums.  ``fma`` computes the correctly
rounded float32 result in float64: the product of two float32 values is
exact there, and the float64 sum rounded to float32 is the fused result
except where that sum is itself exactly a float32 midpoint (it may have
been rounded onto one from the exact value); those rare elements are
redone with the sum's exact error (TwoSum) made round-to-odd, and
round-to-odd at 53 bits followed by rounding to 24 bits equals one
rounding of the exact value.  Like XLA's CPU backend, float32 subnormal
operands count as zero and subnormal results flush to zero.

It is the plain twin of ``kernels.fused_update.momentum_fma``, which the
momentum takes on the card (one ``__fmaf_rn`` per element).
"""
from __future__ import annotations

import torch

CHUNK = 1 << 24             # elements per pass (float64 temporaries)
_LOW29 = (1 << 29) - 1      # float64 significand bits below float32's
_HALF = 1 << 28             # ... holding exactly half a float32 ulp
_TINY = 2.0 ** -126


def _round_to_odd_f32(p, c, s) -> torch.Tensor:
    """float32 of p + c (float64, p exact product) via round-to-odd."""
    bp = s - c                                        # TwoSum error of s
    err = (p - bp) + (c - (s - bp))
    odd = (s.view(torch.int64) & 1) == 1
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, -float("inf")))
    s = torch.where((err != 0) & ~odd, torch.nextafter(s, toward), s)
    return s.float()


def flush(v: torch.Tensor) -> torch.Tensor:
    """Float32 subnormals to signed zero, as XLA's CPU backend treats
    operands and results (flush-to-zero, denormals-are-zero)."""
    return torch.where(v.abs() < _TINY, v * 0.0, v)


def _fma_block(a, b, c) -> torch.Tensor:
    a, b, c = flush(a), flush(b), flush(c)
    p = b.double() * a.double()                       # exact
    c = c.double() if c.dim() == 0 else c
    s = p + c
    out = s.float()
    mid = (s.view(torch.int64) & _LOW29) == _HALF
    if bool(mid.any()):
        i = mid.nonzero(as_tuple=True)
        out[i] = _round_to_odd_f32(p[i], c.expand_as(s)[i].double(), s[i])
    return flush(out)


def fma(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``round_f32(a * b + c)`` with one rounding; ``b`` a float32
    tensor, ``a`` and ``c`` float32 tensors shaped like it or scalars
    (0-dim tensors, or Python floats taken as float32)."""
    def operand(v):
        if not torch.is_tensor(v):
            v = torch.tensor(v, dtype=torch.float32, device=b.device)
        return v.float() if v.dim() == 0 else v.float().reshape(-1)
    a, c, bf = operand(a), operand(c), b.reshape(-1)
    out = torch.empty(bf.shape, dtype=torch.float32, device=b.device)
    for lo in range(0, bf.numel(), CHUNK):
        hi = min(bf.numel(), lo + CHUNK)
        out[lo:hi] = _fma_block(*(v if v.dim() == 0 else v[lo:hi]
                                  for v in (a, bf, c)))
    return out.view(b.shape)
