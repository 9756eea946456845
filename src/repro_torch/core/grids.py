"""Rounding grids (counterpart of ``repro.core.grids``).

A :class:`Grid` is an FP-format descriptor plus an optional affine
transform.  Three families, as in the reference:

* FP-format grids (``binary8``, ``e4m3``, ``bfloat16``, ...);
* fixed-point grids ``fxp<W>.<F>``: a degenerate FP format with
  ``precision = W-1`` and ``emin = emax = W-2-F``, so the FP engine rounds
  them bit-exactly with uniform quantum ``2^-F``;
* ``(scale, mu)``-shifted grids: round ``(x - mu)/scale`` on an inner grid
  and map back.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Union

import torch

from repro_torch.core.formats import FPFormat, get_format


@dataclasses.dataclass(frozen=True)
class Grid:
    """A rounding grid: an engine descriptor + optional affine transform."""

    name: str
    fmt: FPFormat
    kind: str = "fp"
    scale: float = 1.0
    mu: float = 0.0

    def __post_init__(self):
        if self.scale <= 0.0:
            raise ValueError(f"grid scale must be positive, got {self.scale}")

    @property
    def transformed(self) -> bool:
        return self.scale != 1.0 or self.mu != 0.0

    def to_grid(self, x: torch.Tensor) -> torch.Tensor:
        """Carrier domain -> grid domain ((x - mu)/scale), in float32."""
        if not self.transformed:
            return x
        return (x.float() - torch.tensor(self.mu, dtype=torch.float32)) \
            / torch.tensor(self.scale, dtype=torch.float32)

    def from_grid(self, y: torch.Tensor) -> torch.Tensor:
        """Grid domain -> carrier domain (y*scale + mu), in float32."""
        if not self.transformed:
            return y
        return y.float() * torch.tensor(self.scale, dtype=torch.float32) \
            + torch.tensor(self.mu, dtype=torch.float32)

    @property
    def xmax(self) -> float:
        """Largest representable value (carrier domain)."""
        return self.fmt.xmax * self.scale + self.mu


def fp_grid(fmt) -> Grid:
    fmt = get_format(fmt)
    return Grid(name=fmt.name, fmt=fmt, kind="fp")


_FXP_RE = re.compile(r"^fxp(\d+)\.(\d+)$")


def fixed_point_grid(width: int, frac_bits: int) -> Grid:
    """Signed fixed point: ``width`` bits incl. sign, ``frac_bits`` fraction."""
    if not 2 <= width <= 24:
        raise ValueError(f"fxp width must be in [2, 24] (float32-exact "
                         f"significands), got {width}")
    if not 0 <= frac_bits <= 126:
        raise ValueError(f"fxp frac_bits must be in [0, 126], "
                         f"got {frac_bits}")
    name = f"fxp{width}.{frac_bits}"
    fmt = FPFormat(name=name, precision=width - 1,
                   emin=width - 2 - frac_bits, emax=width - 2 - frac_bits,
                   subnormals=True)
    return Grid(name=name, fmt=fmt, kind="fxp")


def shifted_grid(inner, scale: float, mu: float = 0.0,
                 name: Optional[str] = None) -> Grid:
    """(scale, mu)-shifted wrapper: round ``(x - mu)/scale`` on ``inner``."""
    inner = get_grid(inner)
    if inner.transformed:
        raise ValueError("shifted_grid cannot nest shifted grids; "
                         f"{inner.name!r} is already transformed")
    if name is None:
        name = f"shift({inner.name},s={scale:g},mu={mu:g})"
    return Grid(name=name, fmt=inner.fmt, kind=inner.kind,
                scale=float(scale), mu=float(mu))


_REGISTRY: Dict[str, Grid] = {}


def register_grid(grid: Grid) -> None:
    """Register a custom grid under its name (so a ``RoundingSpec`` can
    name it, e.g. a shifted grid)."""
    _REGISTRY[grid.name] = grid


def get_grid(g: Union[Grid, FPFormat, str]) -> Grid:
    """Grid | FPFormat | format name/alias | "fxpW.F" -> Grid."""
    if isinstance(g, Grid):
        return g
    if isinstance(g, FPFormat):
        return fp_grid(g)
    name = str(g).lower()
    cached = _REGISTRY.get(name)
    if cached is not None:
        return cached
    m = _FXP_RE.match(name)
    if m:
        grid = fixed_point_grid(int(m.group(1)), int(m.group(2)))
    else:
        try:
            grid = fp_grid(get_format(name))
        except ValueError as exc:
            raise ValueError(
                f"unknown rounding grid {g!r} (or any 'fxp<W>.<F>' "
                "fixed-point grid)") from exc
    _REGISTRY[name] = grid
    return grid
