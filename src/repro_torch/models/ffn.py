"""Dense GLU FFNs: SwiGLU and GeGLU (counterpart of ``repro.models.ffn``).

With an active policy whose fwd site is not the identity, the gate/up
GEMMs, the activation (SiLU, or GELU for ``geglu``) and the
activation-site rounding run as ONE kernel (``precision.fused.qffn_glu``)
and the down projection is a rounded GEMM.  Otherwise the hidden goes
through the act rounding site (``qact``) between the GEMMs, the
activation computed op by op in the activations' dtype as the reference's
``jax.nn.silu`` / ``jax.nn.gelu`` compute it (``kernels.qmatmul.silu``,
``gelu``), and differentiated as the reference differentiates them
(``gelu`` through ``kernels.qmatmul.gelu_pullback``, the bf16 ops of
``jax.vjp(jax.nn.gelu)``).  With no policy this is the plain bf16 FFN,
which trains too (gemma-7b under the ``fp32`` baseline).  The reference's
non-GLU FFNs (``gelu``, ``relu_sq``) need K3's activation epilogue
(``qdot_act``), which is not ported yet: they raise.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.qmatmul import gelu, silu
from repro_torch.models import layers as L
from repro_torch.precision import policy as QP
from repro_torch.precision.fused import qffn_glu

# the GLU FFNs: the activation of each, by the kernels' name and as the
# unfused path computes it
GLU_ACTS = {"swiglu": ("silu", silu), "geglu": ("gelu", gelu)}


def _check_act(act: str) -> None:
    if act not in GLU_ACTS:
        raise NotImplementedError(f"ffn act {act!r} is not ported yet (the "
                                  "GLU FFNs are: the non-GLU ones need "
                                  "K3's activation epilogue)")


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             n: Optional[int] = None, dtype: torch.dtype = torch.float32
             ) -> Dict[str, torch.Tensor]:
    _check_act(act)
    return {"w_up": L.dense_init(gen, d_model, d_ff, n=n, dtype=dtype),
            "w_down": L.dense_init(gen, d_ff, d_model, n=n, dtype=dtype),
            "w_gate": L.dense_init(gen, d_model, d_ff, n=n, dtype=dtype)}


def _fused_gemm_path(quant) -> bool:
    return quant is not None and not quant.policy.fwd.is_identity


def glu_apply(x, w_gate, w_up, w_down, quant=None, act: str = "swiglu"):
    """Quantized GLU FFN: gate/up GEMMs -> activation and product -> act
    rounding -> down GEMM."""
    name, fn = GLU_ACTS[act]
    if _fused_gemm_path(quant):
        return qffn_glu(x, w_gate, w_up, w_down, quant, act=name)
    gate = fn(L.qdense(x, w_gate, quant, QP.TAG_FFN_GATE))
    up = L.qdense(x, w_up, quant, QP.TAG_FFN_UP)
    h = QP.qact(gate * up, quant, QP.TAG_FFN_ACT)
    return L.qdense(h, w_down, quant, QP.TAG_FFN_DOWN)


def ffn_apply(params, x, act: str, quant=None):
    _check_act(act)
    return glu_apply(x, params["w_gate"], params["w_up"], params["w_down"],
                     quant, act)
