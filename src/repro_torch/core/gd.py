"""Gradient descent in floating-point arithmetic, paper sec. 3
(counterpart of ``repro.core.gd``).

The GD update is the paper's three rounded steps (eq. 8):

    ĝ  = Q₁(∇f(x̂))          (8a) gradient evaluation
    z  = x̂ − Q₂(t · ĝ)      (8b) stepsize multiply
    x̂⁺ = Q₃(z)              (8c) subtraction

each with its own ``RoundingSpec``; for signed-SRε the bias direction ``v``
is wired to the rounded gradient.  ``run_gd`` is the paper's experiment
loop with both engines: "jnp" (per-step rounding calls drawing
``jax.random`` bits, the reference's name kept) and "kernel" (the fused
eq.-8 update, kernels/fused_update.py).  Also the stagnation diagnostics
of sec. 3.2 (τ_k and the Scenario-1/2 predicates).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng, rounding, xla_math
from repro_torch.core.rounding import IDENTITY, RoundingSpec


def _resolve_v(source: str, g, x):
    if source == "grad":
        return g
    if source == "neg_grad":
        return -g
    if source == "self":      # degrade signed-SRε to the SRε self-sign rule
        return None
    raise ValueError(f"unknown v_source {source!r}")


@dataclasses.dataclass(frozen=True)
class GDRounding:
    """Rounding policy of the three steps of the GD update: ``grad`` (8a),
    ``mul`` (8b, on ``t * ĝ``), ``sub`` (8c, on ``x − update``);
    ``*_v`` name the bias direction of signed-SRε at each step ("grad",
    "neg_grad" or "self")."""

    grad: RoundingSpec = IDENTITY
    mul: RoundingSpec = IDENTITY
    sub: RoundingSpec = IDENTITY
    grad_v: str = "self"
    mul_v: str = "grad"
    sub_v: str = "grad"

    def step_specs(self) -> Tuple[RoundingSpec, RoundingSpec, RoundingSpec]:
        return (self.grad, self.mul, self.sub)


def fp32_config() -> GDRounding:
    """Exact-arithmetic baseline (binary32 carrier, no extra rounding)."""
    return GDRounding()


def make_config(fmt, mode_8a="rn", mode_8b="sr", mode_8c="sr",
                eps_8a=0.0, eps_8b=0.0, eps_8c=0.0) -> GDRounding:
    """Same format for all three steps, per-step schemes."""
    return GDRounding(grad=rounding.spec(fmt, mode_8a, eps_8a),
                      mul=rounding.spec(fmt, mode_8b, eps_8b),
                      sub=rounding.spec(fmt, mode_8c, eps_8c))


def f32(t) -> float:
    """A stepsize as the float32 the reference multiplies by."""
    return float(np.float32(t))


class GDStepOut(NamedTuple):
    x_new: torch.Tensor
    g_hat: torch.Tensor     # rounded gradient (after 8a)
    update: torch.Tensor    # Q₂(t·ĝ) (after 8b)
    z: torch.Tensor         # x − update (before 8c)


def gd_step(x, g, t, cfg: GDRounding,
            key: Optional[prng.Key] = None) -> GDStepOut:
    """One rounded GD step given the (exact or pre-rounded) gradient."""
    x, g = x.float(), g.float()
    if any(s.stochastic for s in cfg.step_specs()) and key is None:
        raise ValueError("stochastic rounding configured but no key given")
    k1 = k2 = k3 = None
    if key is not None:
        k1, k2, k3 = prng.split(key, 3)
    g_hat = cfg.grad(g, key=k1, v=_resolve_v(cfg.grad_v, g, x))
    update = cfg.mul(f32(t) * g_hat, key=k2,
                     v=_resolve_v(cfg.mul_v, g_hat, x))
    z = x - update
    x_new = cfg.sub(z, key=k3, v=_resolve_v(cfg.sub_v, g_hat, x))
    return GDStepOut(x_new=x_new, g_hat=g_hat, update=update, z=z)


def gd_step_kernel(x, g, t, cfg: GDRounding, key: prng.Key,
                   step: int = 0) -> torch.Tensor:
    """One rounded GD step through the fused update (K2', in-kernel
    Threefry bits keyed by the seed words ``derive_seed(key, step)``).
    Its bits differ from ``gd_step``'s, so the two agree statistically."""
    from repro_torch.kernels.fused_update import fused_qupdate_prng
    return fused_qupdate_prng(x.float(), g.float(), t,
                              prng.derive_seed(key, step), cfg)


def run_gd(f: Callable, grad_f: Callable, x0, t: float, cfg: GDRounding,
           steps: int, key: Optional[prng.Key] = None, param_fmt=None,
           engine: str = "jnp"):
    """Run ``steps`` rounded-GD iterations; returns (f after each step,
    x_final).  ``param_fmt`` rounds the initial iterate onto the storage
    grid (RN).  Step i draws from ``split(key, steps)[i]``."""
    if engine not in ("jnp", "kernel"):
        raise ValueError(f"unknown engine {engine!r}")
    x = x0.float()
    if param_fmt is not None:
        x = rounding.round_to_format(x, param_fmt, "rn")
    if key is None:
        key = prng.PRNGKey(0)
    fs = []
    for k in prng.split(key, steps):
        if engine == "kernel":
            x = gd_step_kernel(x, grad_f(x), t, cfg, k)
        else:
            x = gd_step(x, grad_f(x), t, cfg, k).x_new
        fs.append(f(x))
    return torch.stack(fs), x


# ---------------------------------------------------------------------------
# Stagnation diagnostics (paper sec. 3.2).
# ---------------------------------------------------------------------------
def tau(z, update, fmt) -> torch.Tensor:
    """τ_k = max_i 2^{-e_i}·|update_i| with z_i ∈ [2^{e_i−1}, 2^{e_i}).

    ``z`` is the would-be iterate, ``update`` the rounded |t·ĝ|.  RN
    stagnates when τ_k ≤ u/2 (and the iterate's lsb is even).  2^{-e} is
    the reference's ``exp2``, XLA's (``core.xla_math``): not exact at most
    exponents, but the value the reference compares."""
    z = z.float()
    e = rounding._float_exponent(torch.abs(z)) + 1
    return torch.max(torch.abs(update.float())
                     * xla_math.exp2_f32(-e.float()))


def rn_would_stagnate(x, update, fmt) -> torch.Tensor:
    """Scenario-2 predicate per coordinate: RN(x − update) == x (eq. 12)."""
    x = rounding.round_to_format(x.float(), fmt, "rn")
    stepped = rounding.round_to_format(x - update.float(), fmt, "rn")
    return stepped == x


def scenario(x, update, fmt) -> torch.Tensor:
    """1 if no coordinate stagnates under RN (Scenario 1), else 2 (int32)."""
    stag = rn_would_stagnate(x, update, fmt)
    return torch.where(torch.any(stag), 2, 1).to(torch.int32)
