"""Fused quantized GLU FFN, forward only (counterpart of
``repro.precision.fused.qffn_glu``).

The gate GEMM, up GEMM, SiLU, product and activation-site rounding run as
one kernel (``qmatmul_swiglu_prng``); the down projection is a rounded GEMM
(``site_matmul``).  The seed folds are the reference's: the gate and up
roundings use the (call-site tag, SITE_FWD) double fold, the activation
site (TAG_FFN_ACT, SITE_ACT) on stream 1, the down GEMM TAG_FFN_DOWN.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.qmatmul import qmatmul_swiglu_prng
from repro_torch.precision.policy import (SITE_ACT, SITE_FWD, TAG_FFN_ACT,
                                          TAG_FFN_DOWN, TAG_FFN_GATE,
                                          TAG_FFN_UP, QuantCtx, Words,
                                          fold_words, site_matmul)


def _site_words(words: Words, tag: int, site: int) -> Words:
    """The (call-site tag, site id) double fold of the unfused chain."""
    return fold_words(fold_words(words, tag), site)


def qffn_glu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor, quant: QuantCtx,
             act: str = "silu") -> torch.Tensor:
    """``round_act(act(round(x@w_gate)) * round(x@w_up)) @ w_down`` with
    the down GEMM result-rounded too.  Callers guard on an active policy
    with a non-identity fwd site; ``x`` may carry leading batch dims."""
    policy, words = quant
    s = policy.fwd
    act_spec = None if policy.act.is_identity else policy.act
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()

    def _w(w):
        # the reference casts weights into the activation dtype, then to
        # the float32 carrier; the kernel widens bf16 exactly, so only the
        # first cast is needed (a no-op for weights stored in bf16)
        return w.to(x.dtype)

    seeds = (_site_words(words, TAG_FFN_GATE, SITE_FWD),
             _site_words(words, TAG_FFN_UP, SITE_FWD),
             _site_words(words, TAG_FFN_ACT, SITE_ACT))
    h = qmatmul_swiglu_prng(x2, _w(w_gate), _w(w_up), seeds, s.fmt, s.mode,
                            act=act, act_spec=act_spec,
                            rand_bits=s.rand_bits, eps=s.eps,
                            overflow=s.overflow)
    out = site_matmul(policy, SITE_FWD, h, _w(w_down),
                      fold_words(words, TAG_FFN_DOWN))
    return out.reshape(*lead, w_down.shape[-1]).to(x.dtype)
