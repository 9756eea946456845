"""Fused quantized GLU FFN (counterpart of
``repro.precision.fused.qffn_glu``).

The gate GEMM, up GEMM, SiLU, product and activation-site rounding run as
one kernel (``qmatmul_swiglu_prng``, K4'); the down projection is a
rounded GEMM (``site_matmul``, K3').  The seed folds are the reference's:
the gate and up roundings use the (call-site tag, SITE_FWD) double fold,
the activation site (TAG_FFN_ACT, SITE_ACT) on stream 1, the down GEMM
TAG_FFN_DOWN.

When autograd needs it, the forward also keeps K4''s rounded branches g_r
and u_r, and the backward is the reference's ``_qffn_glu_bwd``: the down
projection's dgrad/wgrad, SiLU's pullback in float32 at the *rounded* gate,
straight through both rounding sites, and the gate/up dgrad/wgrad -- six
K3' launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.qmatmul import qmatmul_swiglu_prng
from repro_torch.precision.policy import (SITE_ACT, SITE_DGRAD, SITE_FWD,
                                          SITE_WGRAD, TAG_FFN_ACT,
                                          TAG_FFN_DOWN, TAG_FFN_GATE,
                                          TAG_FFN_UP, QuantCtx, QuantPolicy,
                                          Words, fold_words, needs_grad,
                                          site_matmul)


def _site_words(words: Words, tag: int, site: int) -> Words:
    """The (call-site tag, site id) double fold of the unfused chain."""
    return fold_words(fold_words(words, tag), site)


def _glu(policy: QuantPolicy, act: str, x2, wg, wu, words: Words,
         residuals: bool):
    s = policy.fwd
    act_spec = None if policy.act.is_identity else policy.act
    seeds = (_site_words(words, TAG_FFN_GATE, SITE_FWD),
             _site_words(words, TAG_FFN_UP, SITE_FWD),
             _site_words(words, TAG_FFN_ACT, SITE_ACT))
    return qmatmul_swiglu_prng(x2, wg, wu, seeds, s.fmt, s.mode, act=act,
                               act_spec=act_spec, rand_bits=s.rand_bits,
                               eps=s.eps, overflow=s.overflow,
                               residuals=residuals)


def _down(policy: QuantPolicy, h, wd, words: Words):
    return site_matmul(policy, SITE_FWD, h, wd,
                       fold_words(words, TAG_FFN_DOWN))


def silu_pullback(g_r: torch.Tensor, ct: torch.Tensor):
    """(silu(g_r), the cotangent of g_r) for silu(g) = g * sigmoid(g), in
    the order of JAX's derivative of ``x * logistic(x)``."""
    s = 1.0 / (1.0 + torch.exp(-g_r))
    return g_r * s, ct * s + (ct * g_r) * (s * (1.0 - s))


class _QFfnGlu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, wg, wu, wd, policy: QuantPolicy, words: Words,
                act: str):
        h, g_r, u_r = _glu(policy, act, x2, wg, wu, words, residuals=True)
        ctx.save_for_backward(x2, wg, wu, wd, h, g_r, u_r)
        ctx.policy, ctx.words = policy, words
        return _down(policy, h, wd, words)

    @staticmethod
    def backward(ctx, g):
        x2, wg, wu, wd, h, g_r, u_r = ctx.saved_tensors
        policy, words = ctx.policy, ctx.words
        g = g.float().contiguous()
        # down projection, straight through its forward rounding
        w_down = fold_words(words, TAG_FFN_DOWN)
        dh = site_matmul(policy, SITE_DGRAD, g, wd.t().contiguous(), w_down)
        dwd = site_matmul(policy, SITE_WGRAD, h.t().contiguous(), g, w_down)
        # straight through the activation-site rounding; SiLU's pullback at
        # the rounded gate
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
        out = _QFfnGlu.apply(x2, wg, wu, wd, policy, words, act)
    else:
        out = _down(policy, _glu(policy, act, x2, wg, wu, words, False), wd,
                    words)
    return out.reshape(*lead, w_down.shape[-1]).to(x.dtype)
