"""Precision-policy subsystem (counterpart of ``repro.precision.policy``).

``QuantPolicy`` holds one ``RoundingSpec`` per site (fwd, dgrad, wgrad,
act); ``qdot`` is the policy-rounded matmul every weight GEMM of the model
routes through.  Seed discipline as in the reference: a block's rng key is
reduced to two uint32 words (``make_ctx``), every call site folds a static
tag and every site inside a call folds its site id, each fold one
Threefry-2x32 evaluation (``fold_words``).  The words are Python ints on the
host; the kernels draw their bits from them on the device.

``qdot`` is differentiable: its backward runs the dgrad and wgrad GEMMs
through the same rounded kernel (K3') at the DGRAD/WGRAD sites, as the
reference's ``custom_vjp`` does.  ``qeinsum`` is the batched contraction
(the MoE expert stacks) through the batched rounded kernel (K8'), forward
only: its backward (dgrad/wgrad through K8') is not ported yet and raises.
``qact`` rounds an activation tensor onto the ``act`` grid (K1') with a
straight-through gradient.

Under ``policy.oracle`` (the reference's bit-exact audit mode) every site
runs the explicit-bits kernel instead -- K3 for ``qdot``, K8 for
``qeinsum``, K1 for ``qact`` -- fed counter bits made by plain tensor code
on the operands' device, as the reference leaves them to XLA:
``common.counter_bits_reduced`` of the site's words over the output (the
words K3' and K8' draw in-kernel, so an oracle run equals the in-kernel
run bit for bit), and for ``qact`` over the flat index ``(x.numel(), 1)``
(another layout than K1''s 128 lanes, so K1 and K1' round differently).

The attention sites (the QKᵀ logits, each kv block's P·V partial product,
the normalised output) and the KV-cache storage spec ride on the same
policy; ``precision/attention.py`` wires them to the flash kernels.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.grids import get_grid
from repro_torch.core.rounding import IDENTITY, RoundingSpec, parse_spec, spec
from repro_torch.kernels import common
from repro_torch.kernels.qmatmul import (Words, qmatmul, qmatmul_batched,
                                         qmatmul_batched_prng, qmatmul_prng)
from repro_torch.kernels.sr_cast import sr_cast, sr_cast_prng

# GEMM/activation sites (folded into the per-call seed words).
SITE_FWD, SITE_DGRAD, SITE_WGRAD, SITE_ACT = 0, 1, 2, 3

# Static per-call-site tags (unique within a block), the reference's
# values for the sites this slice runs.
TAG_ATTN_Q, TAG_ATTN_K, TAG_ATTN_V, TAG_ATTN_O = 0, 1, 2, 3
TAG_FFN_UP, TAG_FFN_GATE, TAG_FFN_DOWN, TAG_FFN_ACT = 4, 5, 6, 7
TAG_ROUTER = 8
TAG_LOGITS = 18
# MoE stacked-expert einsums (the expert index is a per-slice fold inside
# qeinsum, not part of the tag)
TAG_MOE_GATE, TAG_MOE_UP, TAG_MOE_DOWN, TAG_MOE_ACT = 32, 33, 34, 35
# flash-attention rounding sites (folded off the block context words: one
# attention op per block) and the KV-cache store site
TAG_ATTN_QK, TAG_ATTN_AV, TAG_ATTN_OUT, TAG_ATTN_KV = 36, 37, 38, 39


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Per-site rounding policy.

    ``oracle=True`` switches every site from the in-kernel-bits kernels to
    the explicit-bits ones fed counter-derived bits -- the reference's
    bit-exact audit mode (a kernel equals its plain twin given the same
    words).  ``packed=True`` stores the fused GLU FFN's hidden as code
    words of the act grid (uint8 for 8-bit grids), which the down
    projection decodes on load, and its g_r/u_r residuals as code words of
    the fwd grid: 1 B per element instead of 4 across the widest tensor of
    the block, the same values.  The reference's block sizes (``bm``,
    ``bn``, ``bk``) have no counterpart (the CUDA kernels tile
    themselves).  ``kv_cache_packed`` stores a rounded KV cache as code
    words of its grid (1 B per element for 8-bit grids); without it the
    cache holds the rounded values as float32."""

    fwd: RoundingSpec = IDENTITY
    dgrad: RoundingSpec = IDENTITY
    wgrad: RoundingSpec = IDENTITY
    act: RoundingSpec = IDENTITY
    oracle: bool = False
    packed: bool = False
    # flash-attention sites: the QKᵀ logits, each kv block's P·V partial
    # product, the normalised output
    attn_qk: RoundingSpec = IDENTITY
    attn_av: RoundingSpec = IDENTITY
    attn_out: RoundingSpec = IDENTITY
    # KV-cache storage: a canonical spec name; appended k/v round through
    # it and are stored as packed code words (``kv_cache_packed``) or as
    # float32 grid values
    kv_cache_fmt: Optional[str] = None
    kv_cache_packed: bool = True

    @property
    def gemm_identity(self) -> bool:
        return (self.fwd.is_identity and self.dgrad.is_identity
                and self.wgrad.is_identity)

    @property
    def attn_sites_identity(self) -> bool:
        """The three in-op attention sites alone."""
        return (self.attn_qk.is_identity and self.attn_av.is_identity
                and self.attn_out.is_identity)

    @property
    def attn_identity(self) -> bool:
        return self.attn_sites_identity and self.kv_cache_fmt is None

    @property
    def is_identity(self) -> bool:
        return (self.gemm_identity and self.act.is_identity
                and self.attn_identity)


_SITE_ATTR = {SITE_FWD: "fwd", SITE_DGRAD: "dgrad", SITE_WGRAD: "wgrad",
              SITE_ACT: "act"}


def _check_gemm_spec(s: RoundingSpec, site: str) -> RoundingSpec:
    if not s.is_identity and s.scheme.needs_v:
        raise ValueError(
            f"{s.mode} is not supported for site {site!r} "
            "(result/STE rounding has no bias-direction operand); use "
            "'sr' / 'sr2' / 'sr_eps' or a deterministic mode")
    return s


def _check_kv_fmt(name: Optional[str], packed: bool = True
                  ) -> Optional[str]:
    """A KV-cache storage spec name, validated (None for an identity
    spec); a packed cache's grid must be packable."""
    if name is None:
        return None
    s = _check_gemm_spec(parse_spec(name), "kv_cache")
    if s.is_identity:
        return None
    if packed:
        common.pack_spec(s.fmt)          # raises for unpackable grids
    return name


def resolve_kv_cache_fmt(name: Optional[str],
                         packed: bool = True) -> Optional[str]:
    """A KV-cache storage spec name as ``QuantPolicy.kv_cache_fmt`` takes
    it: None passes, an identity spec becomes None (an unrounded cache),
    schemes that need a bias-direction operand raise, and a packed cache
    needs a packable grid (<= 16-bit codes).  For callers that build
    policies from CLI strings."""
    return _check_kv_fmt(name, packed)


def policy_with_kv_fmt(base, kv_cache_fmt: Optional[str]) -> QuantPolicy:
    """A copy of ``base`` (a policy, a preset name or None) with its
    KV-cache storage spec replaced by the validated ``kv_cache_fmt``."""
    pol = resolve_policy(base) or PRESETS["fp32"]
    return dataclasses.replace(
        pol, kv_cache_fmt=resolve_kv_cache_fmt(kv_cache_fmt,
                                               pol.kv_cache_packed))


# The schemes the attention kernels (K6, K7, K7', K9, K10) and the KV
# store round with: rn and sr on plain FP grids with subnormals,
# saturating.  The GEMM and activation sites take every spec their
# kernels' wide instances take (``_check_ported``).
_ATTN_SCHEMES = ("rn", "sr")


def _check_attn_site(s: RoundingSpec, site: str) -> None:
    """Raise NotImplementedError, naming the site, for an attention or KV
    store spec the kernels that would run it do not take."""
    if s.is_identity:
        return
    grid = get_grid(s.fmt)
    if grid.kind != "fp" or grid.transformed or not grid.fmt.subnormals:
        raise NotImplementedError(
            f"site {site!r}: grid {grid.name!r} is not ported yet (the "
            "attention kernels take plain FP grids with subnormals)")
    if s.scheme.name not in _ATTN_SCHEMES:
        raise NotImplementedError(
            f"site {site!r}: scheme {s.scheme.name!r} is not ported yet "
            f"(the attention kernels take {', '.join(_ATTN_SCHEMES)})")
    if s.eps:
        raise NotImplementedError(f"site {site!r}: eps is not ported yet")
    if s.overflow != "saturate":
        raise NotImplementedError(f"site {site!r}: overflow={s.overflow!r} "
                                  "is not ported yet (the attention kernels "
                                  "saturate)")


def _check_oracle_site(s: RoundingSpec, site: str,
                       saturating: bool) -> None:
    """Under ``oracle`` a site runs an explicit-bits kernel (K3, K4, K8 or
    K1), which has the first instances alone: raise NotImplementedError,
    naming the site, for a spec only a wide instance rounds.  The GEMM
    sites saturate whatever the spec says (``saturating``), as the
    reference's do."""
    if saturating and not s.is_identity:
        s = dataclasses.replace(s, overflow="saturate")
    if not common.fp_site(s):
        raise NotImplementedError(
            f"site {site!r}: {s} is not ported to the explicit-bits kernels "
            "(oracle; they take rn, sr and sr_eps on plain FP grids with "
            "subnormals, saturating)")


def _check_ported(pol: QuantPolicy) -> QuantPolicy:
    """The GEMM sites (fwd, dgrad, wgrad: K3', K4', K8') and the act site
    (K4''s act epilogue, K1') take every spec but those that need a bias
    direction (refused by ``_check_gemm_spec``): rn, sr and sr_eps on plain
    FP grids with subnormals run the kernels' first instances, the rest
    their wide ones.  The GEMM sites saturate, as the reference's do; the
    fused GLU's act site overflows as its spec says, the activation cast
    saturates (the reference's ``qact``).  What stays unported raises here,
    naming the site: the oracle's explicit-bits kernels under a wide spec,
    the attention sites and the KV store beyond rn and sr on plain FP
    grids."""
    if pol.oracle:
        for site in ("fwd", "dgrad", "wgrad"):
            _check_oracle_site(getattr(pol, site), site, True)
        _check_oracle_site(pol.act, "act", False)
    for site in ("attn_qk", "attn_av", "attn_out"):
        _check_attn_site(getattr(pol, site), site)
    if pol.kv_cache_fmt is not None:
        _check_attn_site(parse_spec(pol.kv_cache_fmt), "kv_cache")
    return pol


def make_policy(fwd=None, dgrad=None, wgrad=None, act=None, *, fmt=None,
                mode: str = "sr", eps: float = 0.0, rand_bits: int = 32,
                oracle: bool = False, packed: bool = False, attn=None,
                kv_cache_fmt: Optional[str] = None,
                kv_cache_packed: bool = True) -> QuantPolicy:
    """Build a QuantPolicy; ``fmt`` fills every unspecified GEMM site,
    ``attn`` all three attention sites, ``kv_cache_fmt`` names the
    KV-cache storage spec (stored as codes with ``kv_cache_packed``).  A
    site the kernels cannot round raises ``NotImplementedError`` here,
    naming it."""
    default = spec(fmt, mode, eps, rand_bits) if fmt is not None else IDENTITY
    attn_s = _check_gemm_spec(attn if attn is not None else IDENTITY, "attn")
    return _check_ported(QuantPolicy(
        fwd=_check_gemm_spec(fwd if fwd is not None else default, "fwd"),
        dgrad=_check_gemm_spec(dgrad if dgrad is not None else default,
                               "dgrad"),
        wgrad=_check_gemm_spec(wgrad if wgrad is not None else default,
                               "wgrad"),
        act=_check_gemm_spec(act if act is not None else IDENTITY, "act"),
        oracle=oracle, packed=packed,
        attn_qk=attn_s, attn_av=attn_s, attn_out=attn_s,
        kv_cache_fmt=_check_kv_fmt(kv_cache_fmt, kv_cache_packed),
        kv_cache_packed=kv_cache_packed))


# The reference's presets whose policies this slice can express (the same
# specs, hence the same streams).
PRESETS = {
    "fp32": QuantPolicy(),
    "bf16-rn": make_policy(fmt="bfloat16", mode="rn"),
    "e4m3-sr": make_policy(fmt="e4m3", mode="sr"),
    "binary8-paper": make_policy(fmt="binary8", mode="sr",
                                 act=spec("binary8", "sr")),
    # the fused FFN's hidden and residuals stored as packed uint8 codes
    "binary8-paper-packed": make_policy(fmt="binary8", mode="sr",
                                        act=spec("binary8", "sr"),
                                        packed=True),
    "binary8-paper-r16": make_policy(fmt="binary8", mode="sr", rand_bits=16,
                                     act=spec("binary8", "sr", rand_bits=16)),
    # the explicit-bits (audit) form of e4m3-sr
    "e4m3-sr-oracle": make_policy(fmt="e4m3", mode="sr", oracle=True),
    "binary8-rn": make_policy(fmt="binary8", mode="rn",
                              act=spec("binary8", "rn")),
    "binary8-sr": make_policy(fmt="binary8", mode="sr",
                              act=spec("binary8", "sr")),
    "bf16-sr": make_policy(fmt="bfloat16", mode="sr"),
    # the paper regime carried into the attention op: rounded QKᵀ/AV/out
    # sites and an e4m3-SR KV cache stored packed (1 B per element)
    "binary8-paper-attn": make_policy(fmt="binary8", mode="sr",
                                      act=spec("binary8", "sr"),
                                      attn=spec("binary8", "sr"),
                                      kv_cache_fmt="e4m3-sr"),
    "e4m3-attn": make_policy(fmt="e4m3", mode="sr", attn=spec("e4m3", "sr"),
                             kv_cache_fmt="e4m3-sr"),
}


def get_policy(name: str) -> QuantPolicy:
    """Named preset, or any canonical spec name applied to every site
    (raising ``NotImplementedError`` for a spec the kernels do not
    take)."""
    hit = PRESETS.get(name)
    if hit is not None:
        return hit
    try:
        s = parse_spec(name)
    except ValueError as exc:
        raise ValueError(
            f"unknown gemm policy {name!r}; known presets: "
            f"{sorted(PRESETS)}, or any canonical spec name") from exc
    if s.is_identity:
        return PRESETS["fp32"]
    return make_policy(s, s, s, s)


def resolve_policy(p: Any) -> Optional[QuantPolicy]:
    """None | preset name | QuantPolicy -> Optional[QuantPolicy]."""
    if p is None:
        return None
    if isinstance(p, QuantPolicy):
        return p
    return get_policy(p)


# ---------------------------------------------------------------------------
# Seed plumbing.
# ---------------------------------------------------------------------------
_FOLD_CONST = 0x243F6A88      # pi fractional bits; fixed second counter word
_CTX_SALT = 0x71D07          # "qdot" context salt folded into the base key


def fold_words(words: Words, tag: int) -> Words:
    """Fold a static tag into seed words (one Threefry evaluation)."""
    return prng.threefry2x32(words[0], words[1], tag, _FOLD_CONST)


def slice_words(words, n: int) -> np.ndarray:
    """Per-slice seed words: row e of the (n, 2) result is
    ``fold_words(words, e)``.  ``words`` may also be a sequence of P
    pairs: then the result is (n, 2P), pair j in columns 2j and 2j + 1.
    One vectorised Threefry on the host (numpy int64 holding uint32)."""
    k = np.asarray(words, dtype=np.int64).reshape(-1, 2)
    w0, w1 = prng.threefry2x32_tensor(k[:, :1], k[:, 1:],
                                      np.arange(n, dtype=np.int64)[None],
                                      _FOLD_CONST)
    return np.stack([w0, np.broadcast_to(w1, w0.shape)], axis=-1) \
        .transpose(1, 0, 2).reshape(n, -1)


class QuantCtx(NamedTuple):
    """A policy plus this call site's (k0, k1) seed words."""
    policy: QuantPolicy
    words: Words


def make_ctx(policy, key: prng.Key, step=None) -> Optional[QuantCtx]:
    """(policy-or-name, key[, step]) -> QuantCtx (None if identity)."""
    pol = resolve_policy(policy)
    if pol is None or pol.is_identity:
        return None
    return QuantCtx(pol, prng.derive_seed(key, step, _CTX_SALT))


def ctx_for(cfg, key: prng.Key) -> Optional[QuantCtx]:
    """Context from a ModelConfig's ``gemm_policy`` and a block key."""
    return make_ctx(getattr(cfg, "gemm_policy", None), key)


def fold_ctx(ctx: Optional[QuantCtx], tag: int) -> Optional[QuantCtx]:
    if ctx is None:
        return None
    return QuantCtx(ctx.policy, fold_words(ctx.words, tag))


# ---------------------------------------------------------------------------
# The differentiable rounded matmul.
# ---------------------------------------------------------------------------
def site_matmul(policy: QuantPolicy, site: int, a: torch.Tensor,
                b: torch.Tensor, words: Words, *, a_fmt=None,
                out_packed: bool = False) -> torch.Tensor:
    """One rounded 2-D GEMM at ``site`` (a float32, or code words of
    ``a_fmt`` decoded on load; b float32 or bf16): float32 out, or code
    words of the site's grid with ``out_packed``.  Under ``policy.oracle``
    the explicit-bits kernel (K3) is fed the counter bits K3' would draw
    from the same words."""
    s: RoundingSpec = getattr(policy, _SITE_ATTR[site])
    if s.is_identity:
        if a_fmt is not None:
            a = common.unpack_block(a, a_fmt)
        return a.float() @ b.float()
    w = fold_words(words, site)
    # no overflow: the reference's GEMM sites saturate whatever the spec
    kw = dict(eps=s.eps, a_fmt=a_fmt, out_packed=out_packed)
    if policy.oracle:
        bits = None
        if s.stochastic:
            bits = common.counter_bits_reduced(
                w[0], w[1], (a.shape[0], b.shape[1]), s.rand_bits,
                device=a.device)
        return qmatmul(a, b, bits, s.fmt, s.mode, s.rand_bits, **kw)
    return qmatmul_prng(a, b, w, s.fmt, s.mode, s.rand_bits, **kw)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd will differentiate through these operands."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _QDot(torch.autograd.Function):
    """The rounded 2-D GEMM with the reference's VJP (``_qdot2_bwd``):
    ``da = dgrad(g @ bᵀ)``, ``db = wgrad(aᵀ @ g)``, straight through the
    forward rounding."""

    @staticmethod
    def forward(ctx, a, b, policy: QuantPolicy, words: Words):
        ctx.save_for_backward(a, b)
        ctx.policy, ctx.words = policy, words
        return site_matmul(policy, SITE_FWD, a, b, words)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        policy, words = ctx.policy, ctx.words
        g = g.float().contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = site_matmul(policy, SITE_DGRAD, g, b.t().contiguous(), words)
        if ctx.needs_input_grad[1]:
            db = site_matmul(policy, SITE_WGRAD, a.t().contiguous(), g,
                             words).to(b.dtype)
        return da, db, None, None


def qdot(a: torch.Tensor, b: torch.Tensor, quant: Optional[QuantCtx],
         tag: int = 0) -> torch.Tensor:
    """Policy-rounded differentiable ``a @ b`` (a: (..., K); b: (K, N)).
    With no policy this is exactly ``a @ b``.  Otherwise a goes to float32
    and b as given (the kernel reads bf16 weights and widens them exactly),
    and the result is cast back to the operands' common dtype."""
    if quant is None or quant.policy.gemm_identity:
        return a @ b
    policy, words = quant
    words = fold_words(words, tag)
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1]).float()
    if needs_grad(a2, b):
        out = _QDot.apply(a2, b, policy, words)
    else:
        out = site_matmul(policy, SITE_FWD, a2, b, words)
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    return out.reshape(*lead, b.shape[-1]).to(out_dtype)


# ---------------------------------------------------------------------------
# The rounded batched contraction (einsum-capable), forward only.
# ---------------------------------------------------------------------------
def batched_site_matmul(policy: QuantPolicy, site: int, a: torch.Tensor,
                        b: torch.Tensor, words: Words) -> torch.Tensor:
    """One rounded batched GEMM (E, M, K) x (E, K, N) -> (E, M, N) float32
    at ``site``: slice e draws from ``fold_words(fold_words(words, site),
    e)`` (``slice_words``); under ``policy.oracle`` K8 is fed those
    slices' counter bits (``common.counter_bits_batch``)."""
    s: RoundingSpec = getattr(policy, _SITE_ATTR[site])
    if s.is_identity:
        return torch.bmm(a.float(), b.float())
    seeds = slice_words(fold_words(words, site), a.shape[0])
    kw = dict(eps=s.eps)            # saturating, as ``site_matmul``
    if policy.oracle:
        bits = None
        if s.stochastic:
            bits = common.counter_bits_batch(
                seeds, (a.shape[0], a.shape[1], b.shape[2]), s.rand_bits,
                device=a.device)
        return qmatmul_batched(a, b, bits, s.fmt, s.mode, s.rand_bits, **kw)
    return qmatmul_batched_prng(a, b, seeds, s.fmt, s.mode, s.rand_bits,
                                **kw)


class _QBmm(torch.autograd.Function):
    """The forward of the reference's ``_qbmm``; its VJP (dgrad/wgrad as
    K8' launches on transposed operands) is not ported yet, so a backward
    raises instead of returning a wrong gradient."""

    @staticmethod
    def forward(ctx, a, b, policy: QuantPolicy, words: Words):
        return batched_site_matmul(policy, SITE_FWD, a, b, words)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("the backward of qeinsum (MoE training) "
                                  "is not ported yet")


@functools.lru_cache(maxsize=None)
def _parse_einsum(eqn: str):
    """Decompose a two-operand einsum into (batch, contract, free_a,
    free_b) label groups.  Supported: unique labels per operand, no
    ellipsis, every non-contracted label present in the output."""
    eqn = eqn.replace(" ", "")
    if "->" not in eqn or "." in eqn:
        raise ValueError(f"qeinsum needs an explicit two-operand "
                         f"'ab,bc->ac'-style equation, got {eqn!r}")
    lhs, out = eqn.split("->")
    sa, sb = lhs.split(",")
    if len(set(sa)) != len(sa) or len(set(sb)) != len(sb) \
            or len(set(out)) != len(out):
        raise ValueError(f"qeinsum: repeated labels unsupported in {eqn!r}")
    batch = tuple(d for d in sa if d in sb and d in out)
    contract = tuple(d for d in sa if d in sb and d not in out)
    free_a = tuple(d for d in sa if d not in sb)
    free_b = tuple(d for d in sb if d not in sa)
    if set(out) != set(batch + free_a + free_b) or not contract:
        raise ValueError(f"qeinsum: {eqn!r} is not a pure contraction "
                         "(summed-out free labels are unsupported)")
    return sa, sb, out, batch, contract, free_a, free_b


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def qeinsum(eqn: str, a: torch.Tensor, b: torch.Tensor,
            quant: Optional[QuantCtx], tag: int = 0) -> torch.Tensor:
    """Policy-rounded ``torch.einsum(eqn, a, b)``: the operands are
    canonicalised to (G, M, K) x (G, K, N) stacks and run through K8'
    with per-slice seed folds.  a goes to float32; b keeps its dtype
    (the kernel widens bf16 exactly), as ``qdot``.  The result is cast to
    the operands' common dtype.  With no policy this is exactly
    ``torch.einsum(eqn, a, b)``."""
    if quant is None or quant.policy.gemm_identity:
        return torch.einsum(eqn, a, b)
    sa, sb, out, batch, contract, free_a, free_b = _parse_einsum(eqn)
    dim = {}
    for labels, shape in ((sa, a.shape), (sb, b.shape)):
        if len(labels) != len(shape):
            raise ValueError(f"{eqn!r} rank mismatch for shape "
                             f"{tuple(shape)}")
        for d, n in zip(labels, shape):
            if dim.setdefault(d, n) != n:
                raise ValueError(f"{eqn!r}: size mismatch on {d!r}")
    policy, words = quant
    words = fold_words(words, tag)
    a3 = a.permute([sa.index(d) for d in batch + free_a + contract]) \
        .reshape(_prod(dim[d] for d in batch), _prod(dim[d] for d in free_a),
                 _prod(dim[d] for d in contract)).float()
    b3 = b.permute([sb.index(d) for d in batch + contract + free_b]) \
        .reshape(a3.shape[0], a3.shape[2], _prod(dim[d] for d in free_b))
    if b3.dtype not in (torch.float32, torch.bfloat16):
        b3 = b3.float()
    if needs_grad(a3, b3):
        o3 = _QBmm.apply(a3, b3, policy, words)
    else:
        o3 = batched_site_matmul(policy, SITE_FWD, a3, b3, words)
    o = o3.reshape([dim[d] for d in batch + free_a + free_b])
    o = o.permute([(batch + free_a + free_b).index(d) for d in out])
    return o.to(torch.promote_types(a.dtype, b.dtype))


# ---------------------------------------------------------------------------
# Activation rounding (straight-through estimator).
# ---------------------------------------------------------------------------
def act_round(policy: QuantPolicy, x: torch.Tensor,
              words: Words) -> torch.Tensor:
    """The act site's rounding of float32 ``x`` with the words
    ``fold_words(words, SITE_ACT)``: K1', bits keyed by the flat 128-lane
    layout; under ``policy.oracle`` K1, one word per element keyed by the
    flat index (the reference's ``counter_bits_reduced`` over
    ``(x.size, 1)``)."""
    s = policy.act
    w = fold_words(words, SITE_ACT)
    # no overflow: the reference's qact saturates whatever the spec
    kw = dict(rand_bits=s.rand_bits)
    if policy.oracle:
        bits = None
        if s.stochastic:
            bits = common.counter_bits_reduced(
                w[0], w[1], (x.numel(), 1), s.rand_bits,
                device=x.device).reshape(x.shape)
        return sr_cast(x, bits, s.fmt, s.mode, eps=s.eps, **kw)
    return sr_cast_prng(x, w, s.fmt, s.mode, eps=s.eps, **kw)


class _QAct(torch.autograd.Function):
    """Rounding is piecewise constant; its gradient is taken as the
    identity on the carrier (the reference's straight-through ``_qact``)."""

    @staticmethod
    def forward(ctx, x, policy: QuantPolicy, words: Words):
        return act_round(policy, x, words)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def qact(x: torch.Tensor, quant: Optional[QuantCtx],
         tag: int = 0) -> torch.Tensor:
    """Round an activation tensor onto the policy's ``act`` grid (STE);
    computed in float32 and cast back to ``x``'s dtype."""
    if quant is None or quant.policy.act.is_identity:
        return x
    words = fold_words(quant.words, tag)
    xf = x.float()
    if needs_grad(xf):
        out = _QAct.apply(xf, quant.policy, words)
    else:
        out = act_round(quant.policy, xf, words)
    return out.to(x.dtype)
