"""QSGD: SGD (+ momentum) with the paper's rounded update path
(counterpart of ``repro.optim.sgd``).

The parameter update is eq. (8): gradient rounding (8a), stepsize-multiply
rounding (8b), subtraction rounding (8c), each with its own RoundingSpec.
Momentum, if any, is kept on ``momentum_spec``'s grid (float32 when it is
the identity, as the trainer CLI builds it).  ``momentum * m + g`` is one
fused multiply-add, as the reference's compiled step evaluates it
(``kernels.fused_update.momentum_fma``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.gd import GDRounding
from repro_torch.core.rounding import IDENTITY, RoundingSpec
from repro_torch.kernels.fused_update import momentum_fma
from repro_torch.kernels.tree_update import (tree_map, tree_ravel,
                                             tree_unravel)
from repro_torch.optim import base

_MOM_SALT = 0x6D6F6D          # "mom"


class QSGDState(NamedTuple):
    step: int
    momentum: Any          # tree like params (or () if momentum == 0)
    key: prng.Key


@dataclasses.dataclass(frozen=True)
class QSGD:
    """Functional quantized SGD; ``update_path`` picks the update engine
    (optim/base.py).  The reference's ``nesterov`` and ``param_spec``
    options are not ported yet."""

    lr: float
    momentum: float = 0.0
    cfg: GDRounding = GDRounding()
    momentum_spec: RoundingSpec = IDENTITY
    update_path: str = "jnp"

    def init(self, params, key: Optional[prng.Key] = None) -> QSGDState:
        key = prng.PRNGKey(0) if key is None else key
        mom = ()
        if self.momentum:
            # zeros held as one flat buffer, like the trainer's params
            flat, spec = tree_ravel(params)
            mom = tree_unravel(torch.zeros_like(flat), spec)
        return QSGDState(step=0, momentum=mom, key=key)

    def _momentum(self, state: QSGDState, grads):
        if self.momentum_spec.is_identity:
            # elementwise, so one pass over the flat vectors is the same
            # as the per-leaf map (and keeps the result flat)
            mf, spec = tree_ravel(state.momentum)
            gf, _ = tree_ravel(grads)
            return tree_unravel(momentum_fma(self.momentum, mf, gf), spec)
        mkeys = base.leaf_keys(prng.fold_in(state.key, _MOM_SALT),
                               state.step, grads)
        return tree_map(lambda m, g, k: base.round_state(
            self.momentum_spec, momentum_fma(self.momentum, m, g), k),
            state.momentum, grads, mkeys)

    def apply(self, params, grads, state: QSGDState, lr: Optional[Any] = None):
        """One optimizer step; returns (new_params, new_state)."""
        t = self.lr if lr is None else lr
        if self.momentum:
            new_mom = eff = self._momentum(state, grads)
        else:
            new_mom, eff = (), grads
        new_params = base.tree_rounded_update(
            params, eff, t, self.cfg, state.key, state.step,
            update_path=self.update_path)
        return new_params, QSGDState(step=state.step + 1, momentum=new_mom,
                                     key=state.key)


def qsgd(lr, momentum=0.0, cfg: GDRounding = GDRounding(),
         momentum_spec: RoundingSpec = IDENTITY,
         update_path: str = "jnp") -> QSGD:
    return QSGD(lr=lr, momentum=momentum, cfg=cfg,
                momentum_spec=momentum_spec, update_path=update_path)
