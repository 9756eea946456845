"""Block assembly for the dense and MoE decoders (counterpart of
``repro.models.transformer``): pre-norm attention + pre-norm FFN (the MoE
FFN under ``cfg.moe``), parameters stacked over layers, run as a Python
loop over the layers.  An MoE block's aux loss is not collected: it
enters the training loss with MoE training, not ported yet.

Seed chain of the reference's ``apply_blocks``: the plan of "attn" blocks is
one segment, so ``seg_rng = fold_in(rng, 0)`` and layer i gets
``split(seg_rng, n_layers)[i]``; its quantized-GEMM context is
``ctx_for(cfg, keys[i])``.

A stacked leaf may also be given as a list of per-layer tensors (the
trainer differentiates with respect to each layer's slice separately, so
autograd never assembles a zero-filled stacked gradient per layer).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import prng
from repro_torch.models import attention, ffn, layers as L, moe
from repro_torch.precision.policy import ctx_for


def init_blocks(gen: torch.Generator, cfg,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Stacked params of the "attn" blocks (leading dim = layer; an MoE
    block's expert stacks are per-layer lists).  GEMM weights are stored
    as ``dtype``, norm scales float32."""
    if cfg.family not in ("dense", "moe") or set(cfg.plan()) != {"attn"}:
        raise NotImplementedError(f"block plan of {cfg.name!r} "
                                  f"({cfg.family}) is not ported yet")
    n, d = cfg.n_layers, cfg.d_model
    dev = gen.device
    block = {
        "norm1": torch.zeros((n, d), device=dev),
        "norm2": torch.zeros((n, d), device=dev),
        "attn": attention.attn_init(gen, cfg, n=n, dtype=dtype),
    }
    if cfg.moe is not None:
        block["moe"] = moe.moe_init(gen, cfg, n, dtype=dtype)
    else:
        block["mlp"] = ffn.ffn_init(gen, d, cfg.d_ff, cfg.ffn_act, n=n,
                                    dtype=dtype)
    return {"attn": block}


def _layer(tree, i: int):
    """Layer i's view of a stacked parameter tree (no copy); a leaf is a
    stacked tensor or a list of per-layer tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def apply_attn_block(p, x, positions, cfg, cache, layer: int, key,
                     emit=None):
    qc = ctx_for(cfg, key)
    h = L.rms_norm(x, p["norm1"])
    x = x + attention.attn_apply(p["attn"], h, positions, cfg, cache=cache,
                                 layer=layer, quant=qc, emit=emit)
    h2 = L.rms_norm(x, p["norm2"])
    if "moe" in p:
        y, _ = moe.moe_apply(p["moe"], h2, cfg, quant=qc)
        return x + y
    return x + ffn.ffn_apply(p["mlp"], h2, cfg.ffn_act, quant=qc)


def apply_blocks(blocks, x, positions, cfg, *, caches=None,
                 rng: prng.Key, emit=None):
    """Run every layer over ``x`` (B, S, D): the whole sequence (no
    caches; ``emit``, a contiguous KV cache, receives every layer's k/v),
    or new tokens appended to the KV cache ``caches["attn"]`` (contiguous
    or paged)."""
    seg_rng = prng.fold_in(rng, 0)
    keys = prng.split(seg_rng, cfg.n_layers)
    stacked = blocks["attn"]
    cache = None if caches is None else caches["attn"]
    for i in range(cfg.n_layers):
        x = apply_attn_block(_layer(stacked, i), x, positions, cfg, cache,
                             i, keys[i], emit)
    return x
