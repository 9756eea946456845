"""Floating-point format descriptors (counterpart of ``repro.core.formats``).

A format has a significand precision ``p`` (digits including the implicit
bit, unit roundoff ``u = 2**-p``) and an exponent range ``[emin, emax]``
for normal values ``1.m * 2**E`` (paper sec. 2.1).  Values are carried in
float32; a value is representable iff ``round_to_format`` leaves it
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """Binary floating-point format (see ``repro.core.formats.FPFormat``)."""

    name: str
    precision: int
    emin: int
    emax: int
    subnormals: bool = True

    @property
    def xmax(self) -> float:
        """Largest finite number ``(2 - 2**(1-p)) * 2**emax``."""
        return (2.0 - 2.0 ** (1 - self.precision)) * 2.0 ** self.emax

    @property
    def xmin(self) -> float:
        """Smallest positive normal number ``2**emin``."""
        return 2.0 ** self.emin

    @property
    def quantum_min_exp(self) -> int:
        return self.emin - self.precision + 1


# binary8 == E5M2: u = 2^-3, xmax = 57344.  e4m3 here uses every exponent
# field for finite values, so its xmax is 480 (not the OCP e4m3fn 448).
BINARY8 = FPFormat("binary8", precision=3, emin=-14, emax=15)
E4M3 = FPFormat("e4m3", precision=4, emin=-6, emax=8)
BFLOAT16 = FPFormat("bfloat16", precision=8, emin=-126, emax=127)
BINARY16 = FPFormat("binary16", precision=11, emin=-14, emax=15)
BINARY32 = FPFormat("binary32", precision=24, emin=-126, emax=127)

_REGISTRY: Dict[str, FPFormat] = {
    f.name: f for f in (BINARY8, E4M3, BFLOAT16, BINARY16, BINARY32)
}
_REGISTRY["e5m2"] = BINARY8
_REGISTRY["fp8"] = BINARY8
_REGISTRY["fp32"] = BINARY32
_REGISTRY["bf16"] = BFLOAT16
_REGISTRY["fp16"] = BINARY16


def get_format(name_or_fmt) -> FPFormat:
    """Resolve a format by name (or pass through an FPFormat)."""
    if isinstance(name_or_fmt, FPFormat):
        return name_or_fmt
    try:
        return _REGISTRY[str(name_or_fmt).lower()]
    except KeyError as exc:
        raise ValueError(
            f"unknown floating-point format {name_or_fmt!r}; "
            f"known: {sorted(_REGISTRY)}") from exc
