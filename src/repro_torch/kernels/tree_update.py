"""Whole-tree fused optimizer step: ONE update-kernel launch per parameter
tree (counterpart of ``repro.kernels.tree_update``).

The tree is flattened in ``jax.tree_util.tree_flatten`` order (dict keys
sorted, lists in order, layer-stacked leaves whole), concatenated into one
float32 vector, updated by the fused eq.-8 kernel, and split back.  The
order matters: a parameter's random bits are keyed by its position in the
flat vector.

A tree whose leaves are already consecutive views of one flat float32
buffer, in that order, ravels to the buffer itself with no copy, and
``tree_unravel`` returns such views: the trainer keeps parameters,
gradients and momentum that way, so a step at tinyllama-1.1b size copies
none of its three 4.4 GB vectors.

Modes: ``prng`` (K2', bits drawn in the kernel from
``derive_seed(key, step)``, 12 B/elt) and ``bits`` (K2, explicit
``bits(fold_in(key, step), (3, n))``, 24 B/elt: the audit mode).
``fused_tree_adam_update`` runs QAdam's whole step through K5 with the
moments as flat carries over the raveled vector.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.gd import GDRounding
from repro_torch.kernels.fused_update import (fused_qadam_prng,
                                              fused_qupdate,
                                              fused_qupdate_prng)


# ---------------------------------------------------------------------------
# trees: nested dicts and lists; anything else (a tensor, a key tuple) is a
# leaf
# ---------------------------------------------------------------------------
def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) in ``jax.tree_util.tree_flatten`` order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                ("dict", keys, [p[1] for p in parts]))
    if isinstance(tree, list):
        parts = [tree_flatten(t) for t in tree]
        return ([leaf for p in parts for leaf in p[0]],
                ("list", None, [p[1] for p in parts]))
    return [tree], None


def _build(d, it):
    if d is None:
        return next(it)
    kind, keys, children = d
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(keys, children)}
    return [_build(c, it) for c in children]


def tree_unflatten(treedef, leaves):
    # a module-level recursion: a closure that calls itself would be a
    # reference cycle holding ``leaves`` (the whole tree's tensors) until
    # the cyclic collector runs, several GB per train step at full size
    return _build(treedef, iter(leaves))


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


# ---------------------------------------------------------------------------
# ravel / unravel
# ---------------------------------------------------------------------------
def _flat_base(leaves) -> torch.Tensor:
    """The float32 buffer the leaves are consecutive views of, else None."""
    base = getattr(leaves[0], "_base", None)
    if base is None or base.dim() != 1 or base.dtype != torch.float32:
        return None
    ptr, size = base.data_ptr(), base.element_size()
    off = 0
    for leaf in leaves:
        if leaf._base is not base or leaf.dtype != torch.float32 \
                or not leaf.is_contiguous() \
                or leaf.data_ptr() != ptr + off * size:
            return None
        off += leaf.numel()
    return base if off == base.numel() else None


def tree_ravel(tree) -> Tuple[torch.Tensor, Any]:
    """All leaves as one float32 vector; returns (flat, spec).  No copy
    when the leaves are consecutive views of one flat buffer."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        return torch.zeros((0,)), (treedef, (), ())
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    sizes = tuple(leaf.numel() for leaf in leaves)
    flat = _flat_base(leaves)
    if flat is None:
        flat = torch.cat([leaf.float().reshape(-1) for leaf in leaves])
    return flat, (treedef, shapes, sizes)


def tree_unravel(flat: torch.Tensor, spec):
    """Inverse of tree_ravel: leaves are views of ``flat``."""
    treedef, shapes, sizes = spec
    leaves, off = [], 0
    for shape, size in zip(shapes, sizes):
        leaves.append(flat[off:off + size].view(shape))
        off += size
    return tree_unflatten(treedef, leaves)


def flat_backed(tree):
    """The tree with float32 leaves held as views of one flat buffer."""
    return tree_unravel(*tree_ravel(tree))


def fused_tree_update(params, grads, t, cfg: GDRounding, key: prng.Key,
                      step: int = 0, *, mode: str = "prng"):
    """The paper's eq.-8 rounded update of a whole parameter tree with one
    kernel launch.  ``mode``: "prng" (K2') or "bits" (K2).  Returns the
    new tree, whose leaves are views of one new flat buffer."""
    xf, spec = tree_ravel(params)
    gf, _ = tree_ravel(grads)
    if xf.numel() == 0:
        return params
    if xf.shape != gf.shape:
        raise ValueError(f"params/grads size mismatch: {tuple(xf.shape)} vs "
                         f"{tuple(gf.shape)}")
    if mode == "prng":
        out = fused_qupdate_prng(xf, gf, t, prng.derive_seed(key, step), cfg)
    elif mode == "bits":
        # jax.random.bits(fold_in(key, step), (3, n), uint32)
        bits3 = prng.random_words(prng.fold_in(key, step), (3, xf.numel()),
                                  xf.device)
        out = fused_qupdate(xf, gf, t, bits3, cfg)
    else:
        raise ValueError(f"unknown tree-update mode {mode!r}")
    return tree_unravel(out, spec)


def fused_tree_adam_update(params, grads, m, v, scal, cfg: GDRounding,
                           key: prng.Key, step: int = 0, *, m_spec, v_spec,
                           b1: float, b2: float, packed: bool, cm=None,
                           cv=None):
    """QAdam's step over a whole parameter tree with one K5 launch: the
    rounded moment EMAs (``m``/``v``, and ``cm``/``cv`` with Kahan, flat
    carries over the raveled vector), the bias-corrected direction and the
    eq.-8 chain.  ``scal``: ``[t, c1, c2, eps, weight_decay]``.  Returns
    ``(params⁺, m', v', cm', cv')``, ``cm'``/``cv'`` None without Kahan;
    the new tree's leaves are views of one new flat buffer."""
    xf, spec = tree_ravel(params)
    gf, _ = tree_ravel(grads)
    if xf.numel() == 0:
        return params, m, v, cm, cv
    if xf.shape != gf.shape:
        raise ValueError(f"params/grads size mismatch: {tuple(xf.shape)} vs "
                         f"{tuple(gf.shape)}")
    if tuple(m.shape) != tuple(xf.shape) or tuple(v.shape) != tuple(xf.shape):
        raise ValueError(f"moment carries must be flat {tuple(xf.shape)}, "
                         f"got {tuple(m.shape)}/{tuple(v.shape)}")
    outs = fused_qadam_prng(xf, gf, m, v, scal, prng.derive_seed(key, step),
                            cfg, m_spec=m_spec, v_spec=v_spec, b1=b1, b2=b2,
                            packed=packed, cm=cm, cv=cv)
    comp = (outs[3], outs[4]) if cm is not None else (None, None)
    return (tree_unravel(outs[0], spec), outs[1], outs[2]) + comp
