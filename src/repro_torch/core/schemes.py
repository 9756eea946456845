"""Rounding-scheme registry + the canonical spec grammar
(counterpart of ``repro.core.schemes``).

Every scheme reduces to one rule: round the magnitude away from zero with
probability ``p_up(frac, fy, sign_x, eps, sign_v)`` on the grid
decomposition.  Spec names follow ``<grid>-<scheme>[-e<eps>][-r<bits>][-inf]``
("binary8-sr", "e4m3-sr-r8", "bf16-ssr-e0.4", "fp32" = identity).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import grids as _grids

RAND_BITS_CHOICES = (8, 16, 32)


@dataclasses.dataclass(frozen=True)
class RoundingScheme:
    """One rounding scheme: the unified magnitude rule + its randomness."""

    name: str
    randomness: str        # "none" | "uniform" | "comparison" | "bittrick"
    p_up: Callable
    needs_v: bool = False
    default_eps: float = 0.0
    default_rand_bits: int = 32

    @property
    def stochastic(self) -> bool:
        return self.randomness != "none"

    @property
    def p_up_is_frac(self) -> bool:
        """``p_up == frac`` identically: enables the pure-SR fast path."""
        return self.name in ("sr", "sr2", "sr_bittrick")


def _p_sr(frac, fy, sign_x, eps, sign_v):
    return frac


def _p_sr_eps(frac, fy, sign_x, eps, sign_v):
    return torch.clamp(frac + eps, max=1.0)


def _p_signed_sr_eps(frac, fy, sign_x, eps, sign_v):
    return torch.clamp(frac - sign_x * sign_v * eps, 0.0, 1.0)


def _p_rn(frac, fy, sign_x, eps, sign_v):
    fy_odd = (fy.to(torch.int32) & 1).to(frac.dtype)
    one, zero = torch.ones_like(frac), torch.zeros_like(frac)
    return torch.where(frac > 0.5, one, torch.where(frac < 0.5, zero, fy_odd))


def _p_rz(frac, fy, sign_x, eps, sign_v):
    return torch.zeros_like(frac)


def _p_ra(frac, fy, sign_x, eps, sign_v):
    return torch.ones_like(frac)


def _p_rd(frac, fy, sign_x, eps, sign_v):   # toward -inf
    return (sign_x < 0).to(frac.dtype)


def _p_ru(frac, fy, sign_x, eps, sign_v):   # toward +inf
    return (sign_x > 0).to(frac.dtype)


_SCHEMES: Dict[str, RoundingScheme] = {}
_ALIASES: Dict[str, str] = {"ssr": "signed_sr_eps",
                            "sr-bittrick": "sr_bittrick"}


def register_scheme(s: RoundingScheme) -> None:
    _SCHEMES[s.name] = s


def get_scheme(name_or_scheme) -> RoundingScheme:
    if isinstance(name_or_scheme, RoundingScheme):
        return name_or_scheme
    name = _ALIASES.get(str(name_or_scheme), str(name_or_scheme))
    try:
        return _SCHEMES[name]
    except KeyError as exc:
        raise ValueError(f"unknown rounding scheme {name_or_scheme!r}; "
                         f"known: {scheme_names()}") from exc


def scheme_names() -> Tuple[str, ...]:
    return tuple(sorted(_SCHEMES))


for _s in (
    RoundingScheme("rn", "none", _p_rn),
    RoundingScheme("rz", "none", _p_rz),
    RoundingScheme("ra", "none", _p_ra),
    RoundingScheme("rd", "none", _p_rd),
    RoundingScheme("ru", "none", _p_ru),
    RoundingScheme("sr", "uniform", _p_sr),
    RoundingScheme("sr_eps", "uniform", _p_sr_eps, default_eps=0.1),
    RoundingScheme("signed_sr_eps", "uniform", _p_signed_sr_eps,
                   needs_v=True, default_eps=0.1),
    RoundingScheme("sr2", "comparison", _p_sr, default_rand_bits=8),
    RoundingScheme("sr_bittrick", "bittrick", _p_sr, default_rand_bits=16),
):
    register_scheme(_s)

class ParsedSpec(NamedTuple):
    """Result of :func:`parse_spec_name` (``grid`` None = identity)."""

    grid: Optional[str]
    scheme: str = "rn"
    eps: float = 0.0
    rand_bits: int = 32
    overflow: str = "saturate"


IDENTITY_NAMES = ("fp32", "none")

_EPS_RE = re.compile(r"^e(\d+(?:\.\d+)?)$")
_RBITS_RE = re.compile(r"^r(\d+)$")


def parse_spec_name(name: str) -> ParsedSpec:
    """Parse one canonical ``<grid>-<scheme>[-e..][-r..][-inf]`` name."""
    if not isinstance(name, str) or not name:
        raise ValueError(f"spec name must be a non-empty string, got {name!r}")
    if name in IDENTITY_NAMES:
        return ParsedSpec(None)
    tokens = name.split("-")
    if len(tokens) < 2:
        raise ValueError(
            f"bad spec name {name!r}: expected '<grid>-<scheme>[-e<eps>]"
            f"[-r<bits>][-inf]' (or {'/'.join(IDENTITY_NAMES)})")
    grid = _grids.get_grid(tokens[0]).name
    rest = 2
    if len(tokens) > 2 and _ALIASES.get("-".join(tokens[1:3])) in _SCHEMES:
        scheme = get_scheme("-".join(tokens[1:3]))
        rest = 3
    else:
        scheme = get_scheme(tokens[1])
    eps, rand_bits, overflow = scheme.default_eps, scheme.default_rand_bits, \
        "saturate"
    for tok in tokens[rest:]:
        m = _EPS_RE.match(tok)
        if m:
            eps = float(m.group(1))
            continue
        m = _RBITS_RE.match(tok)
        if m:
            rand_bits = int(m.group(1))
            if rand_bits not in RAND_BITS_CHOICES:
                raise ValueError(f"{name!r}: rand_bits must be one of "
                                 f"{RAND_BITS_CHOICES}")
            continue
        if tok == "inf":
            overflow = "inf"
            continue
        raise ValueError(f"bad spec-name token {tok!r} in {name!r} "
                         "(expected e<eps>, r<bits> or inf)")
    return ParsedSpec(grid, scheme.name, eps, rand_bits, overflow)


def format_spec_name(grid: Optional[str], scheme: str = "rn",
                     eps: float = 0.0, rand_bits: int = 32,
                     overflow: str = "saturate") -> str:
    """Inverse of :func:`parse_spec_name` (defaults elided)."""
    if grid is None:
        return "fp32"
    s = get_scheme(scheme)
    out = f"{_grids.get_grid(grid).name}-{s.name}"
    if eps != s.default_eps:
        out += f"-e{eps:g}"
    if rand_bits != s.default_rand_bits:
        out += f"-r{rand_bits}"
    if overflow == "inf":
        out += "-inf"
    return out
