"""Policy wiring for the rounded flash-attention kernels (counterpart of
``repro.precision.attention``).

``qattention`` is to ``kernels/flash_attention`` what ``qdot`` is to
``kernels/qmatmul``: a differentiable, policy-driven wrapper.  Its forward
runs K6 with the policy's qk/av/out specs; its backward runs K7 (dq) and
K7' (dk, dv), recomputing the rounded logits from the forward's qk words
(straight through every rounding), with dq and dk rounded on the qk spec
and dv on the av spec under DGRAD/WGRAD folds, then sums dk and dv over
each GQA group in float32.  ``qattn_decode`` runs K9 over the KV cache,
in place.

Seed discipline: the site tags TAG_ATTN_QK/AV/OUT fold straight off the
block context words (one attention op per block), then ``slice_words``
gives every (batch, head) row its own word pair.  The words are computed
on the host (numpy Threefry) and reach the card with the launch.

Under ``policy.oracle`` the forward, both backward passes and the decode
run the kernels' plain twins (``flash_fwd_plain``, ``flash_bwd_dq_plain``,
``flash_bwd_dkv_plain``, ``flash_decode_plain``) instead of K6, K7, K7'
and K9: the reference's oracle semantics, which route the same calls to
its jnp references (``repro/precision/attention.py:99,131,138,201``).  No
preset sets both oracle and rounded attention sites; the branch keeps
``oracle=True`` meaning the same thing in both packages.

``round_kv``/``kv_store`` implement the KV-cache storage site
(TAG_ATTN_KV): appended k/v round through ``policy.kv_cache_fmt``, keyed
by (absolute position, flat batch-feature index), and are stored as
packed code words (or float32 values without ``kv_cache_packed``).  They
are plain tensor code, as in the reference.

Serving (``repro_torch.serving``) keys every draw by the request instead
of the batch slot.  The fold chain, each depth in its own salted
namespace: request words --(_SALT_LAYER + layer)--> layer words; layer
words --(TAG_ATTN_KV)--> kv-store words, whose bits are keyed by
(absolute position, feature within the request) (``round_kv_request``);
layer words --(_SALT_POS + position)--(_SALT_HEAD + kv head)--(site
tag)--> the [qk | av | out] words of one paged decode step
(``request_site_seeds``).  Nothing in the chain names the batch slot, the
physical page or the co-scheduled requests, so a request's stream is the
same under any schedule.  ``qattn_decode_paged`` runs K10 over the page
pool with these seeds.  The words are numpy int64 arrays holding uint32
values, computed on the host like every other seed word of the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.rounding import RoundingSpec, parse_spec
from repro_torch.kernels import common
from repro_torch.kernels import flash_attention as FA
from repro_torch.core import prng
from repro_torch.precision.policy import (_FOLD_CONST, SITE_DGRAD, SITE_WGRAD,
                                          TAG_ATTN_AV, TAG_ATTN_KV,
                                          TAG_ATTN_OUT, TAG_ATTN_QK,
                                          QuantCtx, QuantPolicy, Words,
                                          fold_words, slice_words)

_FWD_TAGS = (TAG_ATTN_QK, TAG_ATTN_AV, TAG_ATTN_OUT)


class _Dims(NamedTuple):
    """Static geometry of one attention call."""
    n_heads: int
    n_kv: int
    scale: float
    causal: bool
    window: int
    q_block: int
    kv_block: int


def attn_specs(policy: QuantPolicy) -> FA.AttnSpecs:
    return FA.AttnSpecs(policy.attn_qk, policy.attn_av, policy.attn_out)


def _site_seeds(words: Words, n: int, tags: Sequence[int]) -> np.ndarray:
    """(n, 2·len(tags)) words [t0w0 t0w1 t1w0 ...]: row e of tag t is
    ``fold_words(fold_words(words, t), e)`` -- the kernels' seeds."""
    return slice_words([fold_words(words, t) for t in tags], n)


def kv_cache_spec(policy: Optional[QuantPolicy]) -> Optional[RoundingSpec]:
    """The KV-cache storage spec, or None when the cache is unrounded."""
    if policy is None or policy.kv_cache_fmt is None:
        return None
    return parse_spec(policy.kv_cache_fmt)


def round_kv(x: torch.Tensor, spec: Optional[RoundingSpec], words: Words,
             pos0: int = 0, stream=0) -> torch.Tensor:
    """Round an appended k/v tensor (B, S, ...) onto the cache grid
    (float32 grid values).  Element (b, s, f) draws the bits of global
    (row ``pos0 + s``, col ``b·F + f``), so token-by-token appends write
    the same values as one chunked append.  ``stream`` may be a sequence
    of streams: ``x`` then stacks that many appends on a new leading axis
    (k and v in one pass)."""
    if spec is None or spec.is_identity:
        return x.float()
    bits = None
    if spec.stochastic:
        many = isinstance(stream, (tuple, list))
        streams = np.asarray(stream if many else [stream], dtype=np.int64)
        B, S = x.shape[int(many)], x.shape[int(many) + 1]
        F = x.numel() // (len(streams) * B * S)
        rows = np.arange(pos0, pos0 + S, dtype=np.int64)[None, :, None]
        cols = (np.arange(B, dtype=np.int64)[:, None, None] * F
                + np.arange(F, dtype=np.int64)[None, None, :])
        bits = common.host_to_device(common.element_bits(
            words[0], words[1], rows, cols, spec.rand_bits,
            streams[:, None, None, None]), x.device).reshape(x.shape)
    return common.apply_spec_block(spec, x, bits)


def kv_store(x: torch.Tensor, quant: Optional[QuantCtx], pos0: int = 0,
             stream=0) -> torch.Tensor:
    """A k/v append ready for the cache: rounded on the policy's cache
    grid and packed into code words (float32 values without
    ``kv_cache_packed``); unchanged without a cache spec.  ``stream``
    decorrelates k (0) and v (1); a sequence of streams stores a stack of
    appends at once (see ``round_kv``)."""
    spec = kv_cache_spec(quant.policy) if quant is not None else None
    if spec is None:
        return x
    g = round_kv(x, spec, fold_words(quant.words, TAG_ATTN_KV), pos0, stream)
    return common.pack_block(g, spec.fmt) if quant.policy.kv_cache_packed \
        else g


# ---------------------------------------------------------------------------
# Request-keyed seeds (serving).
# ---------------------------------------------------------------------------
_SALT_LAYER = 0x5E471                         # serving layer-fold namespace
_SALT_POS = 0x705170                          # position-fold namespace
_SALT_HEAD = 0x4EAD0                          # kv-head-fold namespace


def _words(w) -> np.ndarray:
    return np.asarray(w, dtype=np.int64) & prng.M32


def fold_words_vec(words, tags) -> np.ndarray:
    """``fold_words`` over arrays: words (..., 2) uint32 values, tags
    broadcastable against ``words[..., 0]`` -> (..., 2) folded words."""
    w = _words(words)
    w0, w1 = prng.threefry2x32_tensor(w[..., 0], w[..., 1], _words(tags),
                                      _FOLD_CONST)
    w0, w1 = np.broadcast_arrays(w0, w1)
    return np.stack([w0, w1], axis=-1)


def request_layer_words(req_words, n_layers: int) -> np.ndarray:
    """Per-layer serving words: (B, 2) request words -> (L, B, 2)."""
    tags = _SALT_LAYER + np.arange(n_layers, dtype=np.int64)
    return fold_words_vec(_words(req_words)[None], tags[:, None])


def request_site_seeds(layer_words, positions, n_kv: int) -> np.ndarray:
    """The (B·KV, 6) [qk | av | out] words of one paged decode step:
    layer_words (B, 2) request×layer words, positions (B,) the decoded
    token's absolute position (an int32 position, -1 for an empty slot,
    folds as its uint32 pattern).  A pure function of (request seed,
    layer, position, kv head, site).  Leading axes of ``layer_words``
    (every layer at once: (L, B, 2)) lead the result."""
    lw = _words(layer_words)
    B = lw.shape[-2]
    pos = np.asarray(positions, dtype=np.int64).reshape(B)
    w_pos = fold_words_vec(lw, (_SALT_POS + (pos & prng.M32)) & prng.M32)
    heads = _SALT_HEAD + np.arange(n_kv, dtype=np.int64)
    w_h = fold_words_vec(w_pos[..., None, :], heads)     # (..., B, KV, 2)
    cols = [fold_words_vec(w_h, t) for t in _FWD_TAGS]
    return np.concatenate(cols, axis=-1).reshape(lw.shape[:-2]
                                                 + (B * n_kv, 6))


def kv_request_bits(words, pos0, S: int, F: int, rand_bits: int, streams,
                    device) -> torch.Tensor:
    """The bits ``round_kv_request`` draws, on ``device``: (..., n_streams,
    B, S, F) for kv-store words (..., B, 2) (leading axes: every layer at
    once) and first positions pos0 (B,): element (b, s, f) of a stream is
    keyed by (row ``pos0[b] + s``, col ``f``) under request b's words."""
    w = _words(words)
    B = w.shape[-2]
    p0 = np.asarray(pos0, dtype=np.int64).reshape(B)
    rows = (p0[:, None] + np.arange(S, dtype=np.int64)[None])[..., None]
    cols = np.arange(F, dtype=np.int64)
    st = np.asarray(streams, dtype=np.int64)[:, None, None, None]
    shape = w.shape[:-2] + (len(st), B, S, F)
    w, rows, cols, st = (common.host_to_device(np.ascontiguousarray(a),
                                               device)
                         for a in (w, rows, cols, st))
    k0 = w[..., None, :, None, None, 0]            # (..., 1, B, 1, 1)
    k1 = w[..., None, :, None, None, 1]
    bits = common.element_bits(k0, k1, rows, cols, rand_bits, st)
    return bits.expand(shape).contiguous()


def round_kv_request(x: torch.Tensor, spec: Optional[RoundingSpec], words,
                     pos0, stream=0, bits=None) -> torch.Tensor:
    """``round_kv`` keyed by the request: ``x`` (B, S, ...), ``words`` (B,
    2) per-request kv-store words, ``pos0`` (B,) the absolute position of
    each request's first appended row.  Element (b, s, f) draws the bits
    of (row ``pos0[b] + s``, col ``f``) under request b's words, so a
    cache cell's bits do not depend on the slot, the chunking or the
    co-scheduled requests.  ``stream`` may be a sequence of streams: ``x``
    then stacks that many appends on a new leading axis (k and v in one
    pass).  ``bits``: these bits (``kv_request_bits``) already on x's
    device.  Float32 grid values out."""
    if spec is None or spec.is_identity:
        return x.float()
    if not spec.stochastic:
        return common.apply_spec_block(spec, x, None)
    if bits is None:
        many = isinstance(stream, (tuple, list))
        streams = stream if many else [stream]
        B, S = x.shape[int(many)], x.shape[int(many) + 1]
        F = x.numel() // (len(streams) * B * S)
        bits = kv_request_bits(words, pos0, S, F, spec.rand_bits, streams,
                               device=x.device)
    return common.apply_spec_block(spec, x, bits.reshape(x.shape))


# ---------------------------------------------------------------------------
# Train attention (differentiable).
# ---------------------------------------------------------------------------
class _QFlash(torch.autograd.Function):
    """K6 forward; K7 and K7' backward with the reference's seed folds
    (``_qflash_bwd``)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, policy: QuantPolicy, dims: _Dims,
                words: Words):
        seeds = _site_seeds(words, q3.shape[0], _FWD_TAGS)
        fwd = FA.flash_fwd_plain if policy.oracle else FA.flash_fwd
        out, m, l = fwd(
            q3, k3, v3, seeds, attn_specs(policy), scale=dims.scale,
            n_heads=dims.n_heads, n_kv=dims.n_kv, causal=dims.causal,
            window=dims.window, q_block=dims.q_block, kv_block=dims.kv_block)
        ctx.save_for_backward(q3, k3, v3, out, m, l)
        ctx.policy, ctx.dims, ctx.words = policy, dims, words
        return out

    @staticmethod
    def backward(ctx, g):
        q3, k3, v3, out, m, l = ctx.saved_tensors
        policy, dims, words = ctx.policy, ctx.dims, ctx.words
        BH = q3.shape[0]
        do = g.float().contiguous()
        d = torch.sum(do * out, dim=-1)
        w_qk = fold_words(words, TAG_ATTN_QK)
        w_av = fold_words(words, TAG_ATTN_AV)
        kw = dict(scale=dims.scale, n_heads=dims.n_heads, n_kv=dims.n_kv,
                  causal=dims.causal, window=dims.window,
                  q_block=dims.q_block, kv_block=dims.kv_block)
        seeds = slice_words([w_qk, fold_words(w_qk, SITE_DGRAD),
                             fold_words(w_qk, SITE_WGRAD),
                             fold_words(w_av, SITE_DGRAD)], BH)
        seeds_dq = seeds[:, :4]
        dq_fn = FA.flash_bwd_dq_plain if policy.oracle else FA.flash_bwd_dq
        dkv_fn = FA.flash_bwd_dkv_plain if policy.oracle \
            else FA.flash_bwd_dkv
        dq = dq_fn(q3, k3, v3, do, m, l, d, seeds_dq, policy.attn_qk,
                   policy.attn_qk, **kw)
        seeds_dkv = np.concatenate([seeds[:, :2], seeds[:, 4:]], axis=1)
        dk_h, dv_h = dkv_fn(q3, k3, v3, do, m, l, d, seeds_dkv,
                            policy.attn_qk, policy.attn_qk, policy.attn_av,
                            **kw)
        # GQA group-sum in float32: per-query-head (B·H, Skv, ·) ->
        # per-kv-head (B·KV, Skv, ·)
        G = dims.n_heads // dims.n_kv
        dk3 = dk_h.reshape(-1, G, *dk_h.shape[1:]).sum(dim=1)
        dv3 = dv_h.reshape(-1, G, *dv_h.shape[1:]).sum(dim=1)
        return dq, dk3, dv3, None, None, None


def qattention(q, k, v, quant: QuantCtx, *, scale: float,
               causal: bool = True, window: int = 0, q_block: int = 512,
               kv_block: int = 512) -> torch.Tensor:
    """Policy-rounded differentiable flash attention.  q: (B, Sq, H, dk);
    k/v: (B, Skv, KV, dk/dv), heads of one GQA group contiguous.  Returns
    (B, Sq, H, dv) in q's dtype."""
    B, Sq, H, dk = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    policy, words = quant
    dims = _Dims(H, KV, float(scale), bool(causal), int(window),
                 int(q_block), int(kv_block))
    q3 = q.float().transpose(1, 2).reshape(B * H, Sq, dk)
    k3 = k.float().transpose(1, 2).reshape(B * KV, Skv, dk)
    v3 = v.float().transpose(1, 2).reshape(B * KV, Skv, dv)
    out3 = _QFlash.apply(q3, k3, v3, policy, dims, words)
    return out3.reshape(B, H, Sq, dv).transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# One-token decode over the KV cache.
# ---------------------------------------------------------------------------
def qattn_decode(q, k_cache, v_cache, length: int, quant: QuantCtx, *,
                 scale: float, window: int = 0, kv_fmt=None,
                 kv_block: int = 512) -> torch.Tensor:
    """Rounded decode attention for one new token.  q: (B, 1, H, dk);
    caches (B, KV, S_max, d) -- the layout K9 reads, so a contiguous cache
    goes to the kernel without a copy (the reference's caches are (B,
    S_max, KV, d)): float values or code words of ``kv_fmt``; ``length``
    counts valid cache rows including the new token."""
    B, S1, H, dk = q.shape
    if S1 != 1:
        raise ValueError(f"qattn_decode is single-token (got Sq={S1})")
    KV, Smax = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    policy, words = quant
    q3 = q.float().reshape(B * KV, H // KV, dk)
    k3 = k_cache.reshape(B * KV, Smax, dk)
    v3 = v_cache.reshape(B * KV, Smax, dv)
    fn = FA.flash_decode_plain if policy.oracle else FA.flash_decode
    out3 = fn(q3, k3, v3, _site_seeds(words, B * KV, _FWD_TAGS), length,
              attn_specs(policy), scale=scale, window=window,
              kv_block=kv_block, kv_fmt=kv_fmt)
    return out3.reshape(B, 1, H, dv).to(q.dtype)


def qattn_decode_paged(q, k_pages, v_pages, lengths, tables, layer_words,
                       policy: QuantPolicy, *, scale: float,
                       window: int = 0, kv_fmt=None,
                       seeds=None) -> torch.Tensor:
    """Rounded paged-decode attention for one new token per request (K10).
    q: (B, 1, H, dk); k/v pages (P, KV, page, d) pools, float values or
    code words of ``kv_fmt``; lengths (B,) valid rows including the new
    token (a tensor on q's device, or a host array); tables (B, n_max)
    logical -> physical page ids; layer_words (B, 2) request×layer words.
    The site seeds are derived per (request, position, kv head), so the
    output does not depend on slot order or page placement.  ``seeds``:
    those site seeds (``request_site_seeds``), when the caller has them
    (a serving step derives every layer's at once).  Under
    ``policy.oracle`` the plain twin runs, as the reference's oracle
    branch takes its jnp reference."""
    B, S1, H, dk = q.shape
    if S1 != 1:
        raise ValueError(f"qattn_decode_paged is single-token (got {S1})")
    P, KV, page = k_pages.shape[:3]
    dv = v_pages.shape[-1]
    if seeds is None:
        seeds = request_site_seeds(layer_words, np.asarray(
            lengths, dtype=np.int64) - 1, KV)
    q3 = q.float().reshape(B * KV, H // KV, dk)
    k3 = k_pages.reshape(P * KV, page, dk)
    v3 = v_pages.reshape(P * KV, page, dv)
    fn = FA.flash_decode_paged_plain if policy.oracle \
        else FA.flash_decode_paged
    out3 = fn(q3, k3, v3, seeds, lengths, tables, attn_specs(policy),
              scale=scale, n_kv=KV, window=window, kv_fmt=kv_fmt)
    return out3.reshape(B, 1, H, dv).to(q.dtype)
