"""Bit-exact software emulation of low-precision rounding, in PyTorch
(counterpart of ``repro.core.rounding``).

Values are carried in float32.  A value is decomposed onto its grid with
integer bit manipulation and exact power-of-two scaling, so no step rounds:
``frac = (|x| - floor_grid(|x|)) / ulp`` is exact, and every scheme is the
rule "round the magnitude away from zero with probability ``p_up``".

Random bits are uint32 words carried in int64 tensors (values in
``[0, 2**32)``): PyTorch on the CPU has no uint32 add, shift or compare.

Emulation domain: the reference flushes float32 inputs with
``|x| < 2**-126`` to signed zero (TPU / XLA-CPU flush-to-zero).  PyTorch
and CUDA keep subnormals, so the flush is explicit here too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import prng, schemes as _schemes
from repro_torch.core.formats import FPFormat
from repro_torch.core.grids import Grid, get_grid
from repro_torch.core.schemes import (RAND_BITS_CHOICES, RoundingScheme,
                                      get_scheme)

_F32_MANT_BITS = 23
_F32_EXP_BIAS = 127
TINY = 2.0 ** -126


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2**n`` for int tensor n in [-126, 127]."""
    bits = (n.to(torch.int32) + _F32_EXP_BIAS) << _F32_MANT_BITS
    return bits.view(torch.float32)


def _exact_scale(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``x * 2**n`` exactly, for |n| <= 252, in two in-range factors."""
    n = n.to(torch.int32)
    n1 = torch.div(n, 2, rounding_mode="floor")
    n2 = n - n1
    return x * _pow2(n1) * _pow2(n2)


def _float_exponent(x: torch.Tensor) -> torch.Tensor:
    """floor(log2|x|) for normal float32 (bit view); -127 for subnormals."""
    bits = x.contiguous().view(torch.int32)
    raw_exp = (bits >> _F32_MANT_BITS) & 0xFF
    return torch.where(raw_exp > 0, raw_exp - _F32_EXP_BIAS,
                       torch.full_like(raw_exp, -_F32_EXP_BIAS))


def _narrow_grid(fmt: FPFormat) -> bool:
    """Every spacing exponent keeps ``2**±qe`` a normal float32."""
    return fmt.quantum_min_exp >= -126 and fmt.emax - fmt.precision < 126


def _quantum_exponent(x: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Exponent of the grid spacing at |x|, clamped to [emin, emax]."""
    e = _float_exponent(torch.abs(x))
    qe = torch.clamp(e, fmt.emin, fmt.emax) - (fmt.precision - 1)
    if not fmt.subnormals:
        qe = torch.where(e < fmt.emin, torch.full_like(qe, fmt.emin), qe)
    return qe


def magnitude_decompose(x: torch.Tensor, fmt: FPFormat):
    """(floor_mag, quantum, frac, fy) of |x| on the grid of ``fmt``."""
    x = x.float()
    mag = torch.abs(x)
    qe = _quantum_exponent(x, fmt)
    if _narrow_grid(fmt):
        quantum = _pow2(qe)
        y = mag * _pow2(-qe)
        fy = torch.floor(y)
        return fy * quantum, quantum, y - fy, fy
    y = _exact_scale(mag, -qe)
    fy = torch.floor(y)
    floor_mag = _exact_scale(fy, qe)
    half = torch.div(qe, 2, rounding_mode="floor")
    quantum = _pow2(half) * _pow2(qe - half)
    return floor_mag, quantum, y - fy, fy


def _ceil_from_decompose(x: torch.Tensor, fy: torch.Tensor,
                         fmt: FPFormat) -> torch.Tensor:
    """(fy + 1) * 2**qe, exactly."""
    qe = _quantum_exponent(x, fmt)
    if _narrow_grid(fmt):
        return (fy + 1.0) * _pow2(qe)
    return _exact_scale(fy + 1.0, qe)


def _uniform_from_bits(bits: torch.Tensor, rand_bits: int = 32,
                       randomness: str = "uniform") -> torch.Tensor:
    """Random words (int64 holding uint32) -> uniform float32 in [0, 1).

    r = 32: the top 24 bits, ``(bits >> 8) * 2**-24``.  r in {8, 16}: the
    low r bits, centred ``(b + 1/2) * 2**-r`` ("uniform") or uncentred
    ``b * 2**-r`` ("comparison", SR 2.0).  "bittrick": the complemented
    uncentred draw ``(b XOR (2**r - 1)) * 2**-r``.
    """
    if randomness == "bittrick":
        mask = (1 << rand_bits) - 1
        comp = ((bits & mask) ^ mask).to(torch.float32)
        return comp * (2.0 ** -rand_bits)
    if rand_bits == 32:
        return (bits >> 8).to(torch.float32) * (2.0 ** -24)
    if rand_bits not in RAND_BITS_CHOICES:
        raise ValueError(f"rand_bits must be one of {RAND_BITS_CHOICES}, "
                         f"got {rand_bits}")
    low = (bits & ((1 << rand_bits) - 1)).to(torch.float32)
    if randomness == "comparison":
        return low * (2.0 ** -rand_bits)
    return (low + 0.5) * (2.0 ** -rand_bits)


def _flush_tiny(z: torch.Tensor) -> torch.Tensor:
    """Flush float32-subnormal values to signed zero (reference FTZ)."""
    return torch.where(torch.abs(z) < TINY, z * 0.0, z)


def _finish(x, z, mag, sign_x, grid: Grid, overflow: str):
    """Overflow policy, sign, -0 fix-up, transform back, non-finite
    passthrough: the tail shared by round_to_format and round_block."""
    xmax = grid.fmt.xmax
    if overflow == "saturate":
        mag = torch.clamp(mag, max=xmax)
    elif overflow == "inf":
        mag = torch.where(mag > xmax, torch.full_like(mag, float("inf")), mag)
    else:
        raise ValueError(f"unknown overflow policy {overflow!r}")
    out = torch.where(sign_x < 0, -mag, mag)
    out = torch.where(torch.signbit(z) & (z == 0), torch.full_like(out, -0.0),
                      out)
    out = grid.from_grid(out)
    return torch.where(torch.isfinite(x), out, x)


def round_to_format(x: torch.Tensor, fmt, mode: str = "rn", *,
                    key: Optional[prng.Key] = None,
                    bits: Optional[torch.Tensor] = None, eps: float = 0.0,
                    v: Optional[torch.Tensor] = None,
                    overflow: str = "saturate",
                    rand_bits: int = 32) -> torch.Tensor:
    """Round float32 ``x`` onto the grid of ``fmt`` using scheme ``mode``.

    ``bits``: int64 tensor of uint32 words, same shape as x (stochastic
    schemes); with ``rand_bits < 32`` only the low bits are consumed.
    ``key``: without ``bits``, a stochastic scheme draws
    ``prng.random_bits(key, x.shape)`` (``jax.random.bits``).
    ``v``: the bias direction of signed-SRε.  Returns exact grid values.
    """
    grid = get_grid(fmt)
    scheme = get_scheme(mode)
    fmt = grid.fmt
    x = x.float()
    if scheme.stochastic:
        if bits is None:
            if key is None:
                raise ValueError(f"mode {mode!r} needs `key` or `bits`")
            bits = prng.random_bits(key, x.shape, x.device)
        u = _uniform_from_bits(bits, rand_bits, scheme.randomness)
    else:
        u = torch.full_like(x, 0.5)
    if scheme.needs_v:
        if v is None:
            raise ValueError(f"{scheme.name} requires the bias-direction `v`")
        sign_v = torch.sign(torch.broadcast_to(v.float(), x.shape))
    else:
        sign_v = torch.zeros_like(x)

    z = _flush_tiny(grid.to_grid(x))
    floor_mag, _, frac, fy = magnitude_decompose(z, fmt)
    ceil_mag = _ceil_from_decompose(z, fy, fmt)
    sign_x = torch.sign(z)
    p_up = scheme.p_up(frac, fy, sign_x, eps, sign_v)
    mag = torch.where(u < p_up, ceil_mag, floor_mag)
    mag = torch.where(frac == 0.0, torch.abs(z), mag)
    return _finish(x, z, mag, sign_x, grid, overflow)


def ulp(x: torch.Tensor, fmt) -> torch.Tensor:
    """Grid spacing at x in carrier units (``repro.core.rounding.ulp``):
    the spacing just above |x| for grid points.  Spacings below 2**-126
    (bfloat16's subnormal range) read as 0, as under the reference's
    flush-to-zero."""
    grid = get_grid(fmt)
    _, quantum, _, _ = magnitude_decompose(grid.to_grid(x), grid.fmt)
    quantum = torch.where(quantum < TINY, torch.zeros_like(quantum), quantum)
    return quantum * grid.scale if grid.transformed else quantum


def floor_ceil(x: torch.Tensor, fmt):
    """The directed floor and ceiling (⌊x⌋, ⌈x⌉) on the grid (paper §2.2)."""
    return round_to_format(x, fmt, "rd"), round_to_format(x, fmt, "ru")


def is_representable(x: torch.Tensor, fmt) -> torch.Tensor:
    """Whether each element of x is exactly representable on the grid
    (non-finite values count as representable, as in the reference)."""
    grid = get_grid(fmt)
    x = x.float()
    z = grid.to_grid(x)
    _, _, frac, _ = magnitude_decompose(z, grid.fmt)
    return ((frac == 0.0) & (torch.abs(z) <= grid.fmt.xmax)) \
        | ~torch.isfinite(x)


def _successor_fmt(x: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """su(x) on an untransformed format grid: a grid point steps up by its
    quantum when x >= 0 and by the quantum just below |x| when x < 0 (half
    the quantum at a binade's lower edge above the subnormals); any other
    value goes to its RU rounding.  Quanta and sums below 2**-126 flush to
    zero, as the reference's do under XLA (bfloat16's subnormal range)."""
    x = x.float()
    _, q, frac, fy = magnitude_decompose(x, fmt)
    q = _flush_tiny(q)
    e = _float_exponent(torch.abs(x))
    boundary = (fy == 2.0 ** (fmt.precision - 1)) & (e > fmt.emin)
    q_below = _flush_tiny(torch.where(boundary, q * 0.5, q))
    succ_exact = _flush_tiny(torch.where(x >= 0, x + q, x + q_below))
    out = torch.where(frac == 0.0, succ_exact, round_to_format(x, fmt, "ru"))
    return torch.where(torch.isfinite(x), out, x)


def successor(x: torch.Tensor, fmt) -> torch.Tensor:
    """su(x): the smallest grid value strictly greater than x (eq. 10)."""
    grid = get_grid(fmt)
    if not grid.transformed:
        return _successor_fmt(x, grid.fmt)
    return grid.from_grid(_successor_fmt(grid.to_grid(x), grid.fmt))


def predecessor(x: torch.Tensor, fmt) -> torch.Tensor:
    """pr(x): the largest grid value strictly smaller than x (eq. 10)."""
    grid = get_grid(fmt)
    x = x.float()
    if not grid.transformed:
        return -_successor_fmt(-x, grid.fmt)
    return grid.from_grid(-_successor_fmt(-grid.to_grid(x), grid.fmt))


def grid_flips(ref: torch.Tensor, got: torch.Tensor, fmt, slack=None):
    """Compare two tensors of grid values: (number of elements whose
    values differ, whether every such pair is one grid step apart).

    +0 and -0 count as equal.  A pair on both sides of zero within one
    step of it (the unrounded value's sign itself was within rounding
    error) counts as adjacent.  Steps are counted in a shifted grid's own
    coordinates.  With ``slack`` (a float, or a tensor like ``ref``: how
    far apart the two unrounded values may lie, in carrier units), a pair
    also counts as adjacent when it is at most one step at the larger
    magnitude plus its slack apart, the most a monotone rounding of two
    such values gives.
    """
    diff = ref != got
    n = int(diff.sum())
    if n == 0:
        return 0, True
    r, g = ref[diff], got[diff]
    if torch.is_tensor(slack):
        slack = slack[diff]
    grid = get_grid(fmt)
    if grid.transformed:
        r, g, fmt = grid.to_grid(r), grid.to_grid(g), grid.fmt.name
        if slack is not None:
            slack = slack / grid.scale
    lo = torch.minimum(r.abs(), g.abs())
    step = ulp(lo, fmt)
    q0 = ulp(torch.zeros_like(lo), fmt)
    adjacent = ((r - g).abs() == step) | ((r.abs() <= q0) & (g.abs() <= q0))
    if slack is not None:
        hi = torch.maximum(r.abs(), g.abs())
        adjacent |= (r - g).abs() <= ulp(hi, fmt) + slack
    return n, bool(adjacent.all())


# ---------------------------------------------------------------------------
# RoundingSpec: grid + scheme + params, one canonical string form.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoundingSpec:
    """A rounding policy (see ``repro.core.rounding.RoundingSpec``);
    ``fmt=None`` is the identity."""

    fmt: Optional[str] = None
    mode: str = "rn"
    eps: float = 0.0
    rand_bits: int = 32
    overflow: str = "saturate"

    def __post_init__(self):
        if self.rand_bits not in RAND_BITS_CHOICES:
            raise ValueError(f"rand_bits must be one of {RAND_BITS_CHOICES}, "
                             f"got {self.rand_bits}")
        if self.overflow not in ("saturate", "inf"):
            raise ValueError(f"overflow must be 'saturate' or 'inf', "
                             f"got {self.overflow!r}")
        get_scheme(self.mode)

    @property
    def is_identity(self) -> bool:
        return self.fmt is None

    @property
    def stochastic(self) -> bool:
        return (not self.is_identity) and get_scheme(self.mode).stochastic

    @property
    def scheme(self) -> RoundingScheme:
        return get_scheme(self.mode)

    def __str__(self) -> str:
        return _schemes.format_spec_name(
            None if self.fmt is None else get_grid(self.fmt).name,
            self.scheme.name, self.eps, self.rand_bits, self.overflow)

    def __call__(self, x: torch.Tensor, *, key: Optional[prng.Key] = None,
                 bits: Optional[torch.Tensor] = None,
                 v: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.is_identity:
            return x.float()
        return round_to_format(x, self.fmt, self.mode, key=key, bits=bits,
                               eps=self.eps, v=v, rand_bits=self.rand_bits,
                               overflow=self.overflow)


IDENTITY = RoundingSpec(None)


def spec(fmt=None, mode="rn", eps=0.0, rand_bits: int = 32,
         overflow: str = "saturate") -> RoundingSpec:
    """Convenience constructor (grid/scheme names canonicalized)."""
    return RoundingSpec(None if fmt is None else get_grid(fmt).name,
                        get_scheme(mode).name, eps, rand_bits, overflow)


def parse_spec(name: str) -> RoundingSpec:
    """Canonical name -> RoundingSpec (``parse_spec(str(s)) == s``)."""
    p = _schemes.parse_spec_name(name)
    return RoundingSpec(p.grid, p.scheme, p.eps, p.rand_bits, p.overflow)
