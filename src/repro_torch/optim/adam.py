"""QAdam: Adam with low-precision state and the paper's rounded update
(counterpart of ``repro.optim.adam``).

m and v live on configurable low-precision grids (stochastic rounding
keeps the small-update signal alive in the second moment as it does for
the parameters); the update goes through the eq.-8 chain, the Adam
direction in the place of the gradient.

Moment layouts, by ``update_path``:

* ``"jnp"`` / ``"fused_bits"`` -- per-leaf trees like the parameters,
  rounded with ``jax.random`` keys folded from (key, 0x6D / 0x76, step,
  leaf); the chain per leaf (``jnp``) or through K2 (``fused_bits``);
* ``"fused"`` -- one flat carry over the raveled parameter vector, updated
  inside K5 (``kernels/fused_update.py``) with the direction and the chain
  in one pass; with ``moments_packed`` the carries are uint8/uint16 grid
  codes (``kernels/common.pack_block``): 20 B/elt for bf16 moments.

``kahan`` adds float32 compensation carries to either layout.  Both
layouts compute what the reference's compiled step computes, contractions
and flushes included (``core/fma.py``; ``kernels/fused_update.py`` lists
them for K5); the bias corrections ``1 - b ** step`` come from the C
library's ``powf``, as XLA's CPU backend computes them.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.fma import flush, fma
from repro_torch.core.gd import GDRounding, f32
from repro_torch.core.rounding import IDENTITY, RoundingSpec
from repro_torch.kernels import common
from repro_torch.kernels.fused_update import adam_quotient
from repro_torch.kernels.tree_update import (tree_flatten, tree_map,
                                             tree_ravel, tree_unflatten,
                                             tree_unravel)
from repro_torch.optim import base

_M_SALT, _V_SALT = 0x6D, 0x76          # "m", "v"
_TINY = 2.0 ** -126

@functools.lru_cache(maxsize=None)
def _powf():
    """The C library's float32 ``powf``, loaded at first use."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return fn


def bias_correction(beta: float, step: int) -> float:
    """``1 - beta ** step`` in float32 as the reference's compiled step
    computes it: the C library's ``powf`` (not correctly rounded, and not
    PyTorch's or numpy's power), a subnormal power flushed to zero, one
    float32 subtraction."""
    p = _powf()(f32(beta), f32(step))
    if abs(p) < _TINY:
        p = 0.0
    return float(np.float32(1.0) - np.float32(p))


class QAdamState(NamedTuple):
    step: int
    m: Any                 # tree like params, or a flat carry ("fused")
    v: Any
    key: prng.Key
    cm: Any = ()           # Kahan compensation carries (() when disabled)
    cv: Any = ()


def _ema(spec, beta, m, a, key, scale_g=None):
    """``Q(beta * m + (1 - beta) * a)`` of the per-leaf path; ``scale_g``:
    the second moment's gradient, whose term the reference writes as
    ``(1 - beta) * g * g``."""
    b, ob = f32(beta), f32(1.0 - beta)
    term = flush(flush(ob * scale_g) * scale_g) if scale_g is not None \
        else flush(ob * a)
    return base.round_state(spec, fma(b, m, term), key)


def _ema_kahan(spec, beta, m, a, c, key, g=None):
    """The compensated per-leaf EMA; ``g``: the gradient whose square
    ``a`` is."""
    ob = f32(1.0 - beta)
    diff = fma(g, g, -m) if g is not None else flush(a - m)
    y = fma(ob, diff, -c)
    s = base.round_state(spec, flush(m + y), key)
    return s, flush(flush(s - m) - y)


@dataclasses.dataclass(frozen=True)
class QAdam:
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    cfg: GDRounding = GDRounding()
    m_spec: RoundingSpec = IDENTITY
    v_spec: RoundingSpec = IDENTITY
    weight_decay: float = 0.0
    update_path: str = "jnp"   # "jnp" | "fused" | "fused_bits" (optim/base)
    moments_packed: bool = False   # store flat moments as packed grid codes
    kahan: bool = False            # Kahan-compensated moment EMAs

    def __post_init__(self):
        if self.moments_packed:
            if self.update_path != "fused":
                raise ValueError("moments_packed requires the fully-fused "
                                 "update_path='fused'")
            if self.m_spec.is_identity or self.v_spec.is_identity:
                raise ValueError("moments_packed requires non-identity "
                                 "m_spec/v_spec (fp32 carries cannot pack)")

    def init(self, params, key: Optional[prng.Key] = None) -> QAdamState:
        key = prng.PRNGKey(0) if key is None else key
        if self.update_path == "fused":
            flat, _ = tree_ravel(params)

            def carry(spec):
                if self.moments_packed:
                    # code 0 decodes to +0.0 on every packable grid
                    return torch.zeros_like(flat,
                                            dtype=common.pack_dtype(spec.fmt))
                return torch.zeros_like(flat)

            comp = [torch.zeros_like(flat) for _ in range(2)] \
                if self.kahan else [(), ()]
            return QAdamState(step=0, m=carry(self.m_spec),
                              v=carry(self.v_spec), key=key, cm=comp[0],
                              cv=comp[1])
        flat, spec = tree_ravel(params)

        def zeros():     # held as one flat buffer, like the parameters
            return tree_unravel(torch.zeros_like(flat), spec)
        return QAdamState(step=0, m=zeros(), v=zeros(), key=key,
                          cm=zeros() if self.kahan else (),
                          cv=zeros() if self.kahan else ())

    def scalars(self, t, step: int):
        """K5's ``[t, c1, c2, eps, wd]`` of the step that makes the
        state's step ``step``."""
        return [f32(t), bias_correction(self.b1, step),
                bias_correction(self.b2, step), f32(self.eps),
                f32(self.weight_decay)]

    # ------------------------------------------------------------- fused --
    def _apply_fused(self, params, grads, state: QAdamState, t):
        step = state.step + 1
        cm = state.cm if self.kahan else None
        cv = state.cv if self.kahan else None
        new_params, m, v, cm, cv = base.tree_rounded_adam_update(
            params, grads, state.m, state.v, self.scalars(t, step),
            self.cfg, state.key, state.step, m_spec=self.m_spec,
            v_spec=self.v_spec, b1=self.b1, b2=self.b2,
            packed=self.moments_packed, cm=cm, cv=cv)
        return new_params, QAdamState(
            step=step, m=m, v=v, key=state.key,
            cm=cm if self.kahan else (), cv=cv if self.kahan else ())

    # --------------------------------------------------------------- jnp --
    def moment_trees(self, state: QAdamState, grads):
        """The per-leaf paths' new (m, v, cm, cv) from ``state`` and
        ``grads`` (cm, cv: ``()`` without Kahan)."""
        km = base.leaf_keys(prng.fold_in(state.key, _M_SALT), state.step,
                            grads)
        kv = base.leaf_keys(prng.fold_in(state.key, _V_SALT), state.step,
                            grads)
        if not self.kahan:
            return (tree_map(lambda m, g, k: _ema(
                        self.m_spec, self.b1, m, flush(g), k),
                        state.m, grads, km),
                    tree_map(lambda v, g, k: _ema(
                        self.v_spec, self.b2, v, None, k,
                        scale_g=flush(g)), state.v, grads, kv), (), ())
        g_leaves, tdef = tree_flatten(grads)
        ms = [_ema_kahan(self.m_spec, self.b1, m, flush(g), c, k)
              for m, g, c, k in zip(tree_flatten(state.m)[0], g_leaves,
                                    tree_flatten(state.cm)[0],
                                    tree_flatten(km)[0])]
        vs = [_ema_kahan(self.v_spec, self.b2, v, None, c, k, g=flush(g))
              for v, g, c, k in zip(tree_flatten(state.v)[0], g_leaves,
                                    tree_flatten(state.cv)[0],
                                    tree_flatten(kv)[0])]

        def unf(xs):
            return tree_unflatten(tdef, xs)
        return (unf([p[0] for p in ms]), unf([p[0] for p in vs]),
                unf([p[1] for p in ms]), unf([p[1] for p in vs]))

    def apply(self, params, grads, state: QAdamState,
              lr: Optional[Any] = None):
        """One optimizer step; returns (new_params, new_state)."""
        t = self.lr if lr is None else lr
        if self.update_path == "fused":
            return self._apply_fused(params, grads, state, t)
        step = state.step + 1
        new_m, new_v, new_cm, new_cv = self.moment_trees(state, grads)
        _, c1, c2, eps, wd = self.scalars(t, step)

        def direction(m, v, p):
            d = adam_quotient(m, v, c1, c2, eps)
            return fma(wd, flush(p), d) if self.weight_decay else d

        directions = tree_map(direction, new_m, new_v, params)
        new_params = base.tree_rounded_update(
            params, directions, t, self.cfg, state.key, state.step,
            update_path=self.update_path)
        return new_params, QAdamState(step=step, m=new_m, v=new_v,
                                      key=state.key, cm=new_cm, cv=new_cv)


def qadam(lr, b1=0.9, b2=0.999, eps=1e-8, cfg: GDRounding = GDRounding(),
          m_spec: RoundingSpec = IDENTITY, v_spec: RoundingSpec = IDENTITY,
          weight_decay=0.0, update_path: str = "jnp",
          moments_packed: bool = False, kahan: bool = False) -> QAdam:
    return QAdam(lr=lr, b1=b1, b2=b2, eps=eps, cfg=cfg, m_spec=m_spec,
                 v_spec=v_spec, weight_decay=weight_decay,
                 update_path=update_path, moments_packed=moments_packed,
                 kahan=kahan)
