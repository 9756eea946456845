"""Evaluators for the paper's convergence bounds, sec. 4 (counterpart of
``repro.core.theory``; plain numpy in float64).

Used by the paper's runners (``repro_torch.paper``): the Theorem-2 bound
of Figure 3 and the convergence harness's envelope check.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import get_format


def exact_rate_bound(L: float, t: float, k, x0_dist: float):
    """Theorem 2: f(x_k) − f* ≤ 2L‖x0 − x*‖² / (4 + L·t·k)."""
    k = np.asarray(k, np.float64)
    return 2.0 * L * x0_dist ** 2 / (4.0 + L * t * k)


def u_upper_bound(a: float, c: float) -> float:
    """Prop. 3 / Lemma 4 precision requirement: u ≤ a / (c + 4a + 4)."""
    return a / (c + 4.0 * a + 4.0)


def stepsize_bound(L: float, fmt) -> float:
    """Rounded-GD stepsize requirement t ≤ 1 / (L (1+2u)²)."""
    u = get_format(fmt).u
    return 1.0 / (L * (1.0 + 2.0 * u) ** 2)


def gradient_floor_general(a: float, c: float, fmt, n: int) -> float:
    """Lemma 4 eq. (24): ‖∇f‖ ≥ a⁻¹(2 + 4u + √a)·√n·c·u."""
    u = get_format(fmt).u
    return (2.0 + 4.0 * u + np.sqrt(a)) * np.sqrt(n) * c * u / a


def gradient_floor_sr(a: float, c: float, fmt, n: int, condition: int = 14) -> float:
    """Theorem 6 gradient floors: eq. (33) for condition (14), (35) for (15)."""
    u = get_format(fmt).u
    if condition == 14:
        return (2.0 + np.sqrt(a)) * np.sqrt(n) * c * u / a
    if condition == 15:
        return 3.0 * np.sqrt(n) * c * u / a
    raise ValueError("condition must be 14 or 15")


def sr_rate_bound(L: float, t: float, k, chi: float, a: float,
                  condition: int = 14):
    """Theorem 6: E[f(x_k) − f*] ≤ 2Lχ² / (4 + L·t·k·(1−2a))  (cond. 14)
    or (1−2a²) (cond. 15)."""
    k = np.asarray(k, np.float64)
    shrink = (1.0 - 2.0 * a) if condition == 14 else (1.0 - 2.0 * a ** 2)
    return 2.0 * L * chi ** 2 / (4.0 + L * t * k * shrink)


def sr_eps_rate_bound(L: float, t: float, k, chi: float, a: float,
                      b: float, condition: int = 14):
    """Corollary 7: as Theorem 6 but with (1 + 2b − 2a) [or (1 + 2b − 2a²)],
    0 < b ≤ 2εu — the SRε acceleration term."""
    k = np.asarray(k, np.float64)
    shrink = (1.0 + 2.0 * b - 2.0 * a) if condition == 14 else (1.0 + 2.0 * b - 2.0 * a ** 2)
    return 2.0 * L * chi ** 2 / (4.0 + L * t * k * shrink)


def b_upper_bound(eps: float, fmt) -> float:
    """Corollary 7 / Lemma 1: 0 < b ≤ 2εu."""
    return 2.0 * eps * get_format(fmt).u


def stagnation_monotonicity_floor_sr(c: float, fmt, n: int, t: float,
                                     x_norm: float, condition: int = 14) -> float:
    """Prop. 9 gradient floors (51)/(52) for SR under stagnation."""
    u = get_format(fmt).u
    if condition == 14:
        return c * u * np.sqrt(n) / (1 - c * u) + (u / t) * np.sqrt(1.0 / (1 - c * u)) * x_norm
    return (u / t) * x_norm


def stagnation_monotonicity_floor_signed(c: float, fmt, n: int, t: float,
                                         x_norm: float, eps: float,
                                         condition: int = 14) -> float:
    """Prop. 11 gradient floors (62)/(63) for signed-SRε under stagnation."""
    u = get_format(fmt).u
    if condition == 14:
        return (c * u * np.sqrt(n) / (1 - c * u)
                + (u / t) * np.sqrt((1 + 2 * eps) / (1 - c * u)) * x_norm)
    return (u / t) * np.sqrt(1 + 2 * eps) * x_norm
