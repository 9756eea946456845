"""Fused quantized GLU FFN (counterpart of
``repro.precision.fused.qffn_glu``).

The gate GEMM, up GEMM, activation (``act``: SiLU, or the reference's
other ``ACT_FNS``, gemma-7b's GeGLU taking ``gelu``), product and
activation-site rounding run as one kernel (``qmatmul_swiglu_prng``, K4',
the activation's instance); the down projection is a
rounded GEMM (``site_matmul``, K3').  The seed folds are the reference's:
the gate and up roundings use the (call-site tag, SITE_FWD) double fold,
the activation site (TAG_FFN_ACT, SITE_ACT) on stream 1, the down GEMM
TAG_FFN_DOWN.  Under ``policy.oracle`` the GLU prefix runs K4 instead, fed
``common.counter_bits_reduced`` of the same words (and the down GEMM K3,
through ``site_matmul``), which equals the in-kernel run bit for bit.

Under ``policy.packed`` the hidden leaves the GLU kernel as code words of
the act grid (``_h_pack_fmt``) and the down GEMM decodes them on load
(``a_fmt``); the residuals g_r and u_r are kept as code words of the fwd
grid.  Every packed value is already on its grid, so the result is the
unpacked run's, bit for bit, with the (M, d_ff) hidden crossing memory in
1 B per element instead of 4.

When autograd needs it, the forward also keeps K4''s rounded branches g_r
and u_r, and the backward is the reference's ``_qffn_glu_bwd``: the down
projection's dgrad/wgrad, the activation's pullback in float32 at the
*rounded* gate, straight through both rounding sites, and the gate/up
dgrad/wgrad -- six K3' launches.  The pullback is SiLU's (``silu_pullback``,
plain tensor ops) or GELU's: ``gelu_pullback`` op by op, as XLA computes
``jax.vjp(jax.nn.gelu)``, which on the card runs as one kernel with the
products dgate and dup (``kernels.geglu_pullback``, one launch per layer
and step).  Under relu and relu_sq (no ported config trains them) a
forward that autograd would differentiate raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.geglu_pullback import geglu_pullback
from repro_torch.kernels.qmatmul import (STREAM_ACT, gelu_pullback,
                                         qmatmul_swiglu, qmatmul_swiglu_prng)
from repro_torch.precision.policy import (SITE_ACT, SITE_DGRAD, SITE_FWD,
                                          SITE_WGRAD, TAG_FFN_ACT,
                                          TAG_FFN_DOWN, TAG_FFN_GATE,
                                          TAG_FFN_UP, QuantCtx, QuantPolicy,
                                          Words, fold_words, needs_grad,
                                          site_matmul)


def _packable(fmt) -> bool:
    try:
        return common.pack_bytes(fmt) <= 2
    except ValueError:
        return False


def _site_words(words: Words, tag: int, site: int) -> Words:
    """The (call-site tag, site id) double fold of the unfused chain."""
    return fold_words(fold_words(words, tag), site)


def _h_pack_fmt(policy: QuantPolicy) -> Optional[str]:
    """The grid the fused hidden is packed to (None: it stays float32)."""
    if (policy.packed and not policy.act.is_identity
            and _packable(policy.act.fmt)):
        return policy.act.fmt
    return None


def _res_pack_fmt(policy: QuantPolicy) -> Optional[str]:
    """The grid the g_r/u_r residuals are packed to (None: float32)."""
    if policy.packed and _packable(policy.fwd.fmt):
        return policy.fwd.fmt
    return None


def _glu(policy: QuantPolicy, act: str, x2, wg, wu, words: Words,
         residuals: bool):
    """The fused GLU kernel with the policy's seeds (K4') or, under
    ``policy.oracle``, their counter bits (K4)."""
    s = policy.fwd
    act_spec = None if policy.act.is_identity else policy.act
    seeds = (_site_words(words, TAG_FFN_GATE, SITE_FWD),
             _site_words(words, TAG_FFN_UP, SITE_FWD),
             _site_words(words, TAG_FFN_ACT, SITE_ACT))
    # the gate and up sites saturate (the reference passes no overflow);
    # the act site rounds as its spec says, overflow included
    kw = dict(act=act, act_spec=act_spec, rand_bits=s.rand_bits, eps=s.eps,
              residuals=residuals,
              out_packed=_h_pack_fmt(policy) is not None,
              residuals_packed=residuals and _res_pack_fmt(policy) is not None)
    if not policy.oracle:
        return qmatmul_swiglu_prng(x2, wg, wu, seeds, s.fmt, s.mode, **kw)
    shape, dev = (x2.shape[0], wg.shape[1]), x2.device
    bits = [None, None, None]
    if s.stochastic:
        bits[:2] = [common.counter_bits_reduced(w[0], w[1], shape,
                                                s.rand_bits, device=dev)
                    for w in seeds[:2]]
    if act_spec is not None and act_spec.stochastic:
        bits[2] = common.counter_bits_reduced(
            seeds[2][0], seeds[2][1], shape, act_spec.rand_bits,
            stream=STREAM_ACT, device=dev)
    return qmatmul_swiglu(x2, wg, wu, bits[0], bits[1], s.fmt, s.mode,
                          act_bits=bits[2], **kw)


def _down(policy: QuantPolicy, h, wd, words: Words):
    """The down GEMM, decoding a packed hidden on load."""
    return site_matmul(policy, SITE_FWD, h, wd,
                       fold_words(words, TAG_FFN_DOWN),
                       a_fmt=_h_pack_fmt(policy))


def _unpacked(t: torch.Tensor, fmt) -> torch.Tensor:
    return t if fmt is None else common.unpack_block(t, fmt)


def silu_pullback(g_r: torch.Tensor, ct: torch.Tensor):
    """(silu(g_r), the cotangent of g_r) for silu(g) = g * sigmoid(g), in
    the order of JAX's derivative of ``x * logistic(x)``."""
    s = 1.0 / (1.0 + torch.exp(-g_r))
    return g_r * s, ct * s + (ct * g_r) * (s * (1.0 - s))


# (act(g_r), the cotangent of g_r) of each activation whose backward is
# ported; gelu_pullback is kernels.qmatmul's (the unfused gelu's too)
ACT_PULLBACKS = {"silu": silu_pullback, "gelu": gelu_pullback}


class _QFfnGlu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, wg, wu, wd, policy: QuantPolicy, words: Words,
                act: str):
        h, g_r, u_r = _glu(policy, act, x2, wg, wu, words, residuals=True)
        ctx.save_for_backward(x2, wg, wu, wd, h, g_r, u_r)
        ctx.policy, ctx.words, ctx.act = policy, words, act
        return _down(policy, h, wd, words)

    @staticmethod
    def backward(ctx, g):
        x2, wg, wu, wd, h, g_r, u_r = ctx.saved_tensors
        policy, words = ctx.policy, ctx.words
        g = g.float().contiguous()
        # packed storage: the backward works on the grid values
        h = _unpacked(h, _h_pack_fmt(policy))
        g_r = _unpacked(g_r, _res_pack_fmt(policy))
        u_r = _unpacked(u_r, _res_pack_fmt(policy))
        # down projection, straight through its forward rounding
        w_down = fold_words(words, TAG_FFN_DOWN)
        dh = site_matmul(policy, SITE_DGRAD, g, wd.t().contiguous(), w_down)
        dwd = site_matmul(policy, SITE_WGRAD, h.t().contiguous(), g, w_down)
        # straight through the activation-site rounding; the activation's
        # pullback at the rounded gate
        if ctx.act == "gelu":
            dgate, dup = geglu_pullback(g_r, u_r, dh)
        else:
            act_out, dgate = silu_pullback(g_r, dh * u_r)
            dup = (dh * act_out).contiguous()
            dgate = dgate.contiguous()
        w_gate = fold_words(words, TAG_FFN_GATE)
        w_up = fold_words(words, TAG_FFN_UP)
        dx = (site_matmul(policy, SITE_DGRAD, dgate, wg.t().contiguous(),
                          w_gate)
              + site_matmul(policy, SITE_DGRAD, dup, wu.t().contiguous(),
                            w_up))
        xt = x2.t().contiguous()
        dwg = site_matmul(policy, SITE_WGRAD, xt, dgate, w_gate)
        dwu = site_matmul(policy, SITE_WGRAD, xt, dup, w_up)
        return (dx, dwg.to(wg.dtype), dwu.to(wu.dtype), dwd.to(wd.dtype),
                None, None, None)


def qffn_glu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor, quant: QuantCtx,
             act: str = "silu") -> torch.Tensor:
    """``round_act(act(round(x@w_gate)) * round(x@w_up)) @ w_down`` with
    the down GEMM result-rounded too, differentiable.  Callers guard on an
    active policy with a non-identity fwd site; ``x`` may carry leading
    batch dims."""
    policy, words = quant
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    # the reference casts weights into the activation dtype, then to the
    # float32 carrier; the kernels widen bf16 exactly, so only the first
    # cast is needed (a no-op for weights stored in bf16)
    wg, wu, wd = (w.to(x.dtype) for w in (w_gate, w_up, w_down))
    if needs_grad(x2, wg, wu, wd):
        if act not in ACT_PULLBACKS:
            raise NotImplementedError(f"qffn_glu: the backward under act="
                                      f"{act!r} is not ported yet (no ported "
                                      "config trains it)")
        out = _QFfnGlu.apply(x2, wg, wu, wd, policy, words, act)
    else:
        out = _down(policy, _glu(policy, act, x2, wg, wu, words, False), wd,
                    words)
    return out.reshape(*lead, w_down.shape[-1]).to(x.dtype)
