"""Parameters of the JAX reference -> parameters of the port.

``params_from_jax`` takes the reference's ``Model.init`` tree (as numpy
arrays, e.g. ``jax.device_get(params)``) for the dense decoder (SwiGLU or
GeGLU: the same three FFN weights; no ``lm_head`` where the embeddings
are tied, as gemma-7b's):
``{"embed", "blocks": {"attn": {norm1, norm2, attn: {wq, wk, wv, wo},
mlp: {w_gate, w_up, w_down}}}, "final_norm"[, "lm_head"]}`` with the block
leaves stacked over layers, or for the MoE decoder, whose blocks hold
``moe: {router (L, D, E), w_gate (L, E, D, F), w_up (L, E, D, F), w_down
(L, E, F, D)[, shared: {w_gate, w_up, w_down}]}`` in place of ``mlp``.  It
returns the port's tree of tensors: the same keys and layouts (the expert
stacks as lists of per-layer (E, ., .) tensors), GEMM weights rounded once
to bf16 and norm scales float32 (models/model.py), so both packages
compute the same thing.  ``master_params_from_jax`` keeps every leaf
float32, as views of one flat buffer: the master parameters the trainer
updates (dense decoder only: MoE training is not ported yet).
``qadam_state_from_jax`` takes a reference ``QAdamState`` and returns the
port's: the step and key words as Python ints, the moment carries (flat
uint8/uint16 codes or float32, or per-leaf trees) and the Kahan carries
with their dtypes kept, float32 trees flat-backed.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels.tree_update import flat_backed
from repro_torch.optim.adam import QAdamState
from repro_torch.models.model import store_params

_ATTN_KEYS = {"wq", "wk", "wv", "wo"}
_MLP_KEYS = {"w_gate", "w_up", "w_down"}
_MOE_KEYS = {"router", "w_gate", "w_up", "w_down"}


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _checked_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's dense- or MoE-decoder tree, checked, as nested
    dicts."""
    blocks = tree["blocks"]
    if set(blocks) != {"attn"}:
        raise NotImplementedError(f"block types {sorted(blocks)} are not "
                                  "ported yet ('attn' blocks only)")
    b = blocks["attn"]
    ffn_key = "moe" if "moe" in b else "mlp"
    ffn_keys = set(b.get(ffn_key, {}))
    if ffn_key == "moe":
        ok = ffn_keys - {"shared"} == _MOE_KEYS and (
            "shared" not in ffn_keys or set(b["moe"]["shared"]) == _MLP_KEYS)
    else:
        ok = ffn_keys == _MLP_KEYS
    if set(b) != {"norm1", "norm2", "attn", ffn_key} \
            or set(b["attn"]) != _ATTN_KEYS or not ok:
        raise ValueError("unexpected block layout: "
                         f"{sorted(b)} / {sorted(b.get('attn', {}))} / "
                         f"{sorted(ffn_keys)}")
    keep = {k: tree[k] for k in ("embed", "final_norm", "lm_head")
            if k in tree}
    keep["blocks"] = {"attn": b}
    return keep


def _per_layer_experts(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's MoE layout: each (L, E, ., .) expert stack as a list of
    its L per-layer tensors."""
    b = tree["blocks"]["attn"]
    if "moe" not in b:
        return tree
    m = dict(b["moe"])
    for k in ("w_gate", "w_up", "w_down"):
        m[k] = list(torch.unbind(m[k]))
    tree["blocks"]["attn"] = {**b, "moe": m}
    return tree


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Map the reference's dense- or MoE-decoder parameter tree onto the
    port's serving parameters."""
    return store_params(_per_layer_experts(
        _tensors(_checked_tree(tree), device)))


def master_params_from_jax(tree: Dict[str, Any],
                           device="cpu") -> Dict[str, Any]:
    """The reference's tree as float32 master parameters (flat-backed)."""
    keep = _checked_tree(tree)
    if "moe" in keep["blocks"]["attn"]:
        raise NotImplementedError("MoE training is not ported yet")
    return flat_backed(_tensors(keep, device))


def _keep_dtype(tree, device):
    """A tree of arrays as tensors of the same dtypes (``()`` stays)."""
    if isinstance(tree, dict):
        return {k: _keep_dtype(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_keep_dtype(v, device) for v in tree)
    return torch.from_numpy(np.array(tree)).to(device)


def _carry(tree, device):
    """A moment carry: a flat tensor, ``()``, or a per-leaf float32 tree
    held flat-backed, as the port's optimizers hold it."""
    out = _keep_dtype(tree, device)
    return flat_backed(out) if isinstance(out, dict) else out


def qadam_state_from_jax(state, device="cpu") -> QAdamState:
    """The reference's ``QAdamState`` (arrays as numpy, e.g.
    ``jax.device_get(state)``) as the port's."""
    key = tuple(int(w) for w in np.asarray(state.key).reshape(-1))
    return QAdamState(step=int(np.asarray(state.step)),
                      m=_carry(state.m, device), v=_carry(state.v, device),
                      key=key, cm=_carry(state.cm, device),
                      cv=_carry(state.cv, device))
