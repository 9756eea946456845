"""Shared plumbing of the quantized optimizers (counterpart of
``repro.optim.base``).

Per-leaf, per-step keys: every parameter leaf gets an independent key
folded from (base_key, step, leaf_index), so the whole optimizer step is a
deterministic function of (key, step).  Three parameter-update paths:

* ``"jnp"``        -- the per-leaf chain of rounding calls drawing
                     ``jax.random`` bits (the reference's name kept);
* ``"fused"``      -- ONE K2' launch over the flattened tree, bits drawn in
                     the kernel (12 B/elt): the hot path;
* ``"fused_bits"`` -- one K2 launch fed explicit bits (24 B/elt): the
                     audit mode.

``tree_rounded_adam_update`` is QAdam's fused step (K5).  The reference's
mesh branches (a replicated ``shard_map``) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.gd import GDRounding, _resolve_v, f32
from repro_torch.core.rounding import RoundingSpec
from repro_torch.kernels.tree_update import (fused_tree_adam_update,
                                             fused_tree_update, tree_flatten,
                                             tree_map, tree_unflatten)

UPDATE_PATHS = ("jnp", "fused", "fused_bits")


def leaf_keys(base_key: prng.Key, step: int, tree):
    """One key per leaf, folded from (base_key, step, leaf index)."""
    leaves, treedef = tree_flatten(tree)
    stepped = prng.fold_in(base_key, step)
    return tree_unflatten(treedef, [prng.fold_in(stepped, i)
                                    for i in range(len(leaves))])


def rounded_param_update(x, g, t, cfg: GDRounding, key: prng.Key):
    """The eq.-8 update of one leaf (the "jnp" path)."""
    k1, k2, k3 = prng.split(key, 3)
    g_hat = cfg.grad(g, key=k1, v=_resolve_v(cfg.grad_v, g, x))
    upd = cfg.mul(f32(t) * g_hat, key=k2,
                  v=_resolve_v(cfg.mul_v, g_hat, x))
    z = x - upd
    return cfg.sub(z, key=k3, v=_resolve_v(cfg.sub_v, g_hat, x))


def round_state(spec: RoundingSpec, x: torch.Tensor, key: prng.Key):
    """Round an optimizer-state leaf onto its storage grid."""
    if spec.is_identity:
        return x
    return spec(x, key=key)


def tree_rounded_update(params, grads, t, cfg: GDRounding, key: prng.Key,
                        step: int, *, update_path: str = "jnp"):
    """Eq.-8 rounded update of a whole parameter tree."""
    if update_path == "jnp":
        return tree_map(lambda p, g, k: rounded_param_update(p, g, t, cfg, k),
                        params, grads, leaf_keys(key, step, params))
    if update_path not in ("fused", "fused_bits"):
        raise ValueError(f"unknown update_path {update_path!r}; "
                         f"known: {UPDATE_PATHS}")
    mode = "prng" if update_path == "fused" else "bits"
    return fused_tree_update(params, grads, t, cfg, key, step, mode=mode)


def tree_rounded_adam_update(params, grads, m, v, scal, cfg: GDRounding,
                             key: prng.Key, step: int, *, m_spec, v_spec,
                             b1: float, b2: float, packed: bool, cm=None,
                             cv=None):
    """QAdam's fully-fused step over a tree (``kernels/tree_update.py``):
    ``m``/``v`` (and ``cm``/``cv``) flat carries, ``scal`` the ``[t, c1,
    c2, eps, wd]`` vector.  Returns ``(params⁺, m', v', cm', cv')``
    (``cm'``/``cv'`` None without Kahan)."""
    return fused_tree_adam_update(params, grads, m, v, scal, cfg, key, step,
                                  m_spec=m_spec, v_spec=v_spec, b1=b1, b2=b2,
                                  packed=packed, cm=cm, cv=cv)
