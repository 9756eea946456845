"""GQA attention with RoPE and a contiguous KV cache, decode branch
(counterpart of ``repro.models.attention``).

Only the cached decode branch of ``attn_apply`` is ported (one or more new
tokens against a (B, S_max, n_kv, hd) cache per layer, RoPE positions);
the paged, flash and prefill branches, M-RoPE and sliding windows wait
for later slices.  The cache is updated in place
(the reference returns a new array), which saves a full cache copy per
token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.precision import policy as QP


@dataclasses.dataclass
class KVCache:
    """Stacked over layers: k, v (n_layers, B, S_max, n_kv, hd); ``length``
    tokens already cached (shared by every layer)."""
    k: torch.Tensor
    v: torch.Tensor
    length: int = 0


def attn_init(gen: torch.Generator, cfg, n: Optional[int] = None
              ) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": L.dense_init(gen, d, nh * hd, n=n),
        "wk": L.dense_init(gen, d, nkv * hd, n=n),
        "wv": L.dense_init(gen, d, nkv * hd, n=n),
        "wo": L.dense_init(gen, nh * hd, d, scale=1.0 / (nh * hd) ** 0.5,
                           n=n),
    }


def _sdpa(q, k, v, mask, scale: float):
    """Naive attention over (B, KV, G, Sq, Skv) scores; GQA by grouping."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    dv = v.shape[-1]
    q = q.reshape(B, Sq, KV, group, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskv->bqkgv", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, dv)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> KVCache:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def attn_apply(params, x, positions, cfg, *, cache: KVCache, layer: int,
               quant=None) -> torch.Tensor:
    """x: (B, S, D) new tokens; appends their k/v to layer ``layer`` of the
    cache at ``cache.length`` and attends to the whole prefix."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    q = L.qdense(x, params["wq"], quant, QP.TAG_ATTN_Q).reshape(B, S, nh, hd)
    k = L.qdense(x, params["wk"], quant, QP.TAG_ATTN_K).reshape(B, S, nkv, hd)
    v = L.qdense(x, params["wv"], quant, QP.TAG_ATTN_V).reshape(B, S, nkv, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    start = cache.length
    Skv = cache.k.shape[2]
    if start + S > Skv:
        raise ValueError(f"KV cache full: {start} + {S} > capacity {Skv}")
    cache.k[layer, :, start:start + S] = k.to(cache.k.dtype)
    cache.v[layer, :, start:start + S] = v.to(cache.v.dtype)
    q_pos = start + torch.arange(S, device=x.device)
    k_pos = torch.arange(Skv, device=x.device)
    valid = k_pos[None, :] <= q_pos[:, None]
    mask = valid[None].expand(B, S, Skv)
    out = _sdpa(q, cache.k[layer].to(x.dtype), cache.v[layer].to(x.dtype),
                mask, 1.0 / hd ** 0.5)
    return L.qdense(out.reshape(B, S, nh * hd), params["wo"], quant,
                    QP.TAG_ATTN_O)
