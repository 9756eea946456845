"""The GeGLU FFN's backward at its activation: wrapper, plain twin, launch
count (counterpart of no Pallas kernel of ``repro.kernels``).

``geglu_pullback`` -> CUDA kernel ``csrc/geglu_pullback.cu``: from the
rounded gate ``g_r``, the rounded up branch ``u_r`` and the hidden's
cotangent ``dh`` it computes ``dgate`` (the pullback of ``jax.nn.gelu`` at
``g_r`` applied to ``dh * u_r``) and ``dup = dh * gelu(g_r)``, as the
reference's ``_qffn_glu_bwd`` does under XLA (``repro/precision/
fused.py``).  The reference leaves this elementwise step to XLA; the port
runs it as a kernel because its twin's fused multiply-adds
(``core.fma``, float64 passes) synchronise with the host on every call.

A tensor on the CPU goes to the plain twin (``kernels.qmatmul.
gelu_pullback``, XLA's float32 operations one by one); a CUDA tensor
launches the kernel, bitwise the twin on any input (NaNs as NaNs).
``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.fma import flush
from repro_torch.kernels import build
from repro_torch.kernels.qmatmul import gelu_pullback

LAUNCHES: Dict[str, int] = {"geglu_pullback": 0}


def reset_launches() -> None:
    LAUNCHES["geglu_pullback"] = 0


def geglu_pullback_plain(g_r: torch.Tensor, u_r: torch.Tensor,
                         dh: torch.Tensor):
    """The plain twin: (dgate, dup)."""
    dh = flush(dh.float())
    act, dgate = gelu_pullback(g_r.float(), flush(dh * flush(u_r.float())))
    return dgate, flush(dh * act)


def _lib():
    lib = build.load("geglu_pullback")
    fn = lib.geglu_pullback
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64,
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def geglu_pullback(g_r: torch.Tensor, u_r: torch.Tensor, dh: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dgate, dup) of the GeGLU backward at the activation, float32 of
    ``g_r``'s shape."""
    ops = (g_r, u_r, dh)
    if any(t.shape != g_r.shape or t.device != g_r.device for t in ops):
        raise ValueError("g_r, u_r and dh must share one shape and device")
    if any(t.dtype != torch.float32 for t in ops):
        raise ValueError("g_r, u_r and dh must be float32")
    if g_r.device.type == "cpu":
        return geglu_pullback_plain(g_r, u_r, dh)
    if g_r.device.type != "cuda":
        raise ValueError(f"device {g_r.device} unsupported")
    g_r, u_r, dh = (t.contiguous() for t in ops)
    dgate, dup = torch.empty_like(g_r), torch.empty_like(g_r)
    if g_r.numel():
        rc = _lib().geglu_pullback(
            g_r.data_ptr(), u_r.data_ptr(), dh.data_ptr(), dgate.data_ptr(),
            dup.data_ptr(), g_r.numel(),
            torch.cuda.current_stream(g_r.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"geglu_pullback launch failed: cudaError {rc}")
        LAUNCHES["geglu_pullback"] += 1
    return dgate, dup
