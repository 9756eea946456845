"""Dense SwiGLU FFN (counterpart of ``repro.models.ffn``).

With an active policy whose fwd site is not the identity, the gate/up
GEMMs, SiLU and activation-site rounding run as ONE kernel
(``precision.fused.qffn_glu``) and the down projection is a rounded GEMM.
Otherwise the hidden goes through the act rounding site (``qact``) between
the GEMMs.  With no policy this is the plain bf16 FFN.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.qmatmul import silu
from repro_torch.models import layers as L
from repro_torch.precision import policy as QP
from repro_torch.precision.fused import qffn_glu


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             n: Optional[int] = None, dtype: torch.dtype = torch.float32
             ) -> Dict[str, torch.Tensor]:
    if act != "swiglu":
        raise NotImplementedError(f"ffn act {act!r} is not ported yet")
    return {"w_up": L.dense_init(gen, d_model, d_ff, n=n, dtype=dtype),
            "w_down": L.dense_init(gen, d_ff, d_model, n=n, dtype=dtype),
            "w_gate": L.dense_init(gen, d_model, d_ff, n=n, dtype=dtype)}


def _fused_gemm_path(quant) -> bool:
    return quant is not None and not quant.policy.fwd.is_identity


def swiglu_apply(x, w_gate, w_up, w_down, quant=None):
    """Quantized SwiGLU: gate/up GEMMs -> act rounding -> down GEMM."""
    if _fused_gemm_path(quant):
        return qffn_glu(x, w_gate, w_up, w_down, quant, act="silu")
    gate = silu(L.qdense(x, w_gate, quant, QP.TAG_FFN_GATE))
    up = L.qdense(x, w_up, quant, QP.TAG_FFN_UP)
    h = QP.qact(gate * up, quant, QP.TAG_FFN_ACT)
    return L.qdense(h, w_down, quant, QP.TAG_FFN_DOWN)


def ffn_apply(params, x, act: str, quant=None):
    if act != "swiglu":
        raise NotImplementedError(f"ffn act {act!r} is not ported yet")
    return swiglu_apply(x, params["w_gate"], params["w_up"],
                        params["w_down"], quant)
