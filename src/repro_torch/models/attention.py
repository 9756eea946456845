"""GQA attention with RoPE: the full-sequence (training) branch, the
contiguous-KV-cache decode branch and the paged (serving) branch
(counterpart of ``repro.models.attention``).

Without a cache, ``attn_apply`` is causal attention over the whole
sequence: ``precision.attention.qattention`` (the rounded flash kernels)
when the policy rounds the attention sites, else ``flash_attention``, the
reference's blocked online-softmax recurrence in plain float32 ops.  With
a cache, new tokens go through ``kv_store`` (rounded onto the policy's
cache grid and packed, unless the policy keeps float32 values) into a
(B, n_kv, S_max, hd) cache per layer,
updated in place (the reference returns a new (B, S_max, n_kv, hd) array,
which would copy the cache per token; this layout is the one K9 reads, so
decode passes the cache to it without a transpose); a single new token
under a rounded attention policy attends through ``qattn_decode`` (K9,
decoding packed codes on load), anything else through plain attention
over the unpacked cache.

With a ``serving.PagedKVCache`` the new tokens' k/v are rounded keyed by
their request (``round_kv_request`` under the request×layer words, never
the batch slot or ``quant.words``), appended into the shared page pool
through each slot's block table, and attended either by K10
(``qattn_decode_paged``: one token under a rounded-attention policy) or
through the gathered logical view with a causal mask per slot and row
(chunked prefill, unrounded attention sites).  RoPE runs at each slot's
own positions.  M-RoPE and sliding windows wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.models import layers as L
from repro_torch.precision import attention as PA
from repro_torch.precision import policy as QP
from repro_torch.serving import paged_cache as PC


@dataclasses.dataclass
class KVCache:
    """Stacked over layers: k, v (n_layers, B, n_kv, S_max, hd); ``length``
    tokens already cached (shared by every layer)."""
    k: torch.Tensor
    v: torch.Tensor
    length: int = 0


def attn_init(gen: torch.Generator, cfg, n: Optional[int] = None,
              dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": L.dense_init(gen, d, nh * hd, n=n, dtype=dtype),
        "wk": L.dense_init(gen, d, nkv * hd, n=n, dtype=dtype),
        "wv": L.dense_init(gen, d, nkv * hd, n=n, dtype=dtype),
        "wo": L.dense_init(gen, nh * hd, d, scale=1.0 / (nh * hd) ** 0.5,
                           n=n, dtype=dtype),
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


def flash_attention(q, k, v, scale: float, *, causal: bool = True,
                    q_block: int = 1024, kv_block: int = 1024):
    """Blocked attention with online softmax (the reference's
    ``flash_attention``, same block loop and float32 arithmetic; torch's
    exp and sums, which differ from XLA's by float32 ulps: ROADMAP §3).
    q: (B, Sq, H, dk); k: (B, Skv, KV, dk); v: (B, Skv, KV, dv)."""
    B, Sq, H, dk = q.shape
    KV = k.shape[2]
    G = H // KV
    dv = v.shape[-1]
    qb = min(q_block, Sq)
    kb = min(kv_block, k.shape[1])
    n_q = -(-Sq // qb)
    n_k = -(-k.shape[1] // kb)
    qf = q.float().reshape(B, Sq, KV, G, dk)
    kf, vf = k.float(), v.float()
    inf = float("inf")
    out_blocks = []
    for i in range(n_q):
        q_i = qf[:, i * qb:(i + 1) * qb]
        qlen = q_i.shape[1]
        m = torch.full((B, KV, G, qlen), -inf, device=q.device)
        l = torch.zeros((B, KV, G, qlen), device=q.device)
        acc = torch.zeros((B, KV, G, qlen, dv), device=q.device)
        q_lo = i * qb
        q_hi = q_lo + qlen - 1
        for j in range(n_k):
            k_lo = j * kb
            if causal and k_lo > q_hi:
                continue                                    # above diagonal
            k_hi = min((j + 1) * kb, k.shape[1]) - 1
            s = torch.einsum("bqkgh,bskh->bkgqs", q_i,
                             kf[:, k_lo:k_hi + 1]) * scale
            if causal and k_hi > q_lo:
                qpos = torch.arange(q_lo, q_hi + 1, device=q.device)[:, None]
                kpos = torch.arange(k_lo, k_hi + 1, device=q.device)[None, :]
                s = torch.where(kpos <= qpos, s, torch.full_like(s, -inf))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                               torch.zeros_like(m))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskv->bkgqv", p, vf[:, k_lo:k_hi + 1])
            m = m_new
        out_blocks.append(acc / torch.clamp(l, min=1e-30)[..., None])
    o = torch.cat(out_blocks, dim=3)                        # (B,KV,G,Sq,dv)
    return o.movedim(3, 1).reshape(B, Sq, H, dv).to(q.dtype)


def cache_dtype(cfg, dtype=torch.bfloat16) -> torch.dtype:
    """Storage dtype of the KV cache under ``cfg.gemm_policy``: code words
    (uint8/uint16) under a packed ``kv_cache_fmt``, float32 grid values
    under an unpacked one, else ``dtype``."""
    pol = QP.resolve_policy(cfg.gemm_policy)
    spec = PA.kv_cache_spec(pol)
    if spec is None:
        return dtype
    return common.pack_dtype(spec.fmt) if pol.kv_cache_packed \
        else torch.float32


def _kv_fmt(pol) -> Optional[str]:
    """The grid whose code words the cache holds, or None (values)."""
    spec = PA.kv_cache_spec(pol)
    return spec.fmt if spec is not None and pol.kv_cache_packed else None


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> KVCache:
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len,
             cfg.resolved_head_dim)
    dt = cache_dtype(cfg, dtype)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))


def attn_apply(params, x, positions, cfg, *, cache: Optional[KVCache] = None,
               layer: int = 0, quant=None,
               emit: Optional[KVCache] = None) -> torch.Tensor:
    """x: (B, S, D).  Without ``cache``: causal attention over the whole
    sequence.  With it: x are new tokens, their k/v go to layer ``layer``
    of the cache at ``cache.length`` (a ``PagedKVCache``: at each slot's
    length), and they attend to the whole prefix.  ``positions`` (B, S)
    or broadcastable: the tokens' RoPE positions.  ``emit`` (prefill,
    without ``cache``): a contiguous cache that receives this layer's k/v
    at positions 0..S-1, stored as a decode step would store them."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    scale = 1.0 / hd ** 0.5
    pol = quant.policy if quant is not None else None
    q = L.qdense(x, params["wq"], quant, QP.TAG_ATTN_Q).reshape(B, S, nh, hd)
    k = L.qdense(x, params["wk"], quant, QP.TAG_ATTN_K).reshape(B, S, nkv, hd)
    v = L.qdense(x, params["wv"], quant, QP.TAG_ATTN_V).reshape(B, S, nkv, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if isinstance(cache, PC.PagedKVCache):
        out = _paged_attention(q, k, v, cache, layer, pol, scale)
        return L.qdense(out.reshape(B, S, nh * hd), params["wo"], quant,
                        QP.TAG_ATTN_O)
    if cache is None:
        if emit is not None:
            kv = torch.stack([k, v])
            if PA.kv_cache_spec(pol) is not None:
                kv = PA.kv_store(kv, quant, pos0=0, stream=(0, 1))
            kv = kv.to(emit.k.dtype).transpose(2, 3)
            emit.k[layer, :, :, :S] = kv[0]
            emit.v[layer, :, :, :S] = kv[1]
        if pol is not None and not pol.attn_sites_identity:
            out = PA.qattention(q, k, v, quant, scale=scale, causal=True,
                                q_block=cfg.attn_q_block,
                                kv_block=cfg.attn_kv_block)
        else:
            out = flash_attention(q, k, v, scale, causal=True)
        return L.qdense(out.reshape(B, S, nh * hd), params["wo"], quant,
                        QP.TAG_ATTN_O)

    start = cache.length
    Skv = cache.k.shape[3]
    if start + S > Skv:
        raise ValueError(f"KV cache full: {start} + {S} > capacity {Skv}")
    # k (stream 0) and v (stream 1) rounded and packed in one pass
    kv = PA.kv_store(torch.stack([k, v]), quant, pos0=start,
                     stream=(0, 1)).to(cache.k.dtype)
    cache.k[layer, :, :, start:start + S] = kv[0].transpose(1, 2)
    cache.v[layer, :, :, start:start + S] = kv[1].transpose(1, 2)
    kv_fmt = _kv_fmt(pol)
    if S == 1 and pol is not None and not pol.attn_identity:
        out = PA.qattn_decode(q, cache.k[layer], cache.v[layer], start + S,
                              quant, scale=scale, kv_fmt=kv_fmt,
                              kv_block=cfg.attn_kv_block)
    else:
        k_f, v_f = cache.k[layer], cache.v[layer]
        if kv_fmt is not None:
            k_f = common.unpack_block(k_f, kv_fmt)
            v_f = common.unpack_block(v_f, kv_fmt)
        k_f, v_f = k_f.transpose(1, 2), v_f.transpose(1, 2)
        q_pos = start + torch.arange(S, device=x.device)
        k_pos = torch.arange(Skv, device=x.device)
        valid = k_pos[None, :] <= q_pos[:, None]
        mask = valid[None].expand(B, S, Skv)
        out = _sdpa(q, k_f.to(x.dtype), v_f.to(x.dtype), mask, scale)
    return L.qdense(out.reshape(B, S, nh * hd), params["wo"], quant,
                    QP.TAG_ATTN_O)


def _paged_attention(q, k, v, cache, layer: int, pol, scale: float):
    """The paged branch for layer ``layer``: request-keyed KV rounding,
    the append into the pool, then K10 (one token, rounded attention
    sites) or attention over the gathered view.  Returns (B, S, H, dv)."""
    B, S = q.shape[:2]
    spec = PA.kv_cache_spec(pol)
    kv_fmt = _kv_fmt(pol)
    words = cache.words[layer]                               # (B, 2)
    kv = torch.stack([k, v])
    if spec is not None:
        F = kv.shape[3] * kv.shape[4]                       # KV · d
        bits = cache.kv_bits(layer, spec, S, F) if spec.stochastic else None
        kv = PA.round_kv_request(kv, spec, PA.fold_words_vec(
            words, QP.TAG_ATTN_KV), cache.lengths, stream=(0, 1), bits=bits)
        if kv_fmt is not None:
            kv = common.pack_block(kv, kv_fmt)
    k_pages, v_pages = cache.k_pages[layer], cache.v_pages[layer]
    index = cache.append_index(S)
    PC.paged_append(k_pages, cache.tables, cache.lengths, cache.append,
                    kv[0], index)
    PC.paged_append(v_pages, cache.tables, cache.lengths, cache.append,
                    kv[1], index)
    if S == 1 and pol is not None and not pol.attn_sites_identity:
        return PA.qattn_decode_paged(
            q, k_pages, v_pages, cache.device_lengths(S), cache.tables,
            words, pol, scale=scale, kv_fmt=kv_fmt,
            seeds=cache.site_seeds(layer, k_pages.shape[1]))
    k_f = PC.paged_gather(k_pages, cache.tables)
    v_f = PC.paged_gather(v_pages, cache.tables)
    if kv_fmt is not None:
        k_f = common.unpack_block(k_f, kv_fmt)
        v_f = common.unpack_block(v_f, kv_fmt)
    # each appended row attends to its own slot's logical prefix
    q_pos = common.host_to_device(
        cache.lengths.astype(np.int64)[:, None] + np.arange(S)[None],
        q.device)
    k_pos = torch.arange(k_f.shape[1], device=q.device)
    valid = k_pos[None, None, :] <= q_pos[:, :, None]
    return _sdpa(q, k_f.to(q.dtype), v_f.to(q.dtype), valid, scale)
