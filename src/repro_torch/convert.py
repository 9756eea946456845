"""Parameters of the JAX reference -> parameters of the port.

``params_from_jax`` takes the reference's ``Model.init`` tree (as numpy
arrays, e.g. ``jax.device_get(params)``) for the dense decoder:
``{"embed", "blocks": {"attn": {norm1, norm2, attn: {wq, wk, wv, wo},
mlp: {w_gate, w_up, w_down}}}, "final_norm", "lm_head"}`` with the block
leaves stacked over layers, and returns the port's tree of tensors: the
same keys and layouts, GEMM weights rounded once to bf16 and norm scales
float32 (models/model.py), so both packages compute the same thing.
``master_params_from_jax`` keeps every leaf float32, as views of one flat
buffer: the master parameters the trainer updates.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels.tree_update import flat_backed
from repro_torch.models.model import store_params

_BLOCK_KEYS = {"norm1", "norm2", "attn", "mlp"}
_ATTN_KEYS = {"wq", "wk", "wv", "wo"}
_MLP_KEYS = {"w_gate", "w_up", "w_down"}


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _dense_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's dense-decoder tree, checked, as nested dicts."""
    blocks = tree["blocks"]
    if set(blocks) != {"attn"}:
        raise NotImplementedError(f"block types {sorted(blocks)} are not "
                                  "ported yet (dense 'attn' blocks only)")
    b = blocks["attn"]
    if set(b) != _BLOCK_KEYS or set(b["attn"]) != _ATTN_KEYS \
            or set(b["mlp"]) != _MLP_KEYS:
        raise ValueError("unexpected dense block layout: "
                         f"{sorted(b)} / {sorted(b.get('attn', {}))} / "
                         f"{sorted(b.get('mlp', {}))}")
    keep = {k: tree[k] for k in ("embed", "final_norm", "lm_head")
            if k in tree}
    keep["blocks"] = {"attn": b}
    return keep


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Map the reference's dense-decoder parameter tree onto the port's
    serving parameters."""
    return store_params(_tensors(_dense_tree(tree), device))


def master_params_from_jax(tree: Dict[str, Any],
                           device="cpu") -> Dict[str, Any]:
    """The reference's tree as float32 master parameters (flat-backed)."""
    return flat_backed(_tensors(_dense_tree(tree), device))
