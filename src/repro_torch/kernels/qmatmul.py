"""Rounded-result GEMMs (paper eq. 8a): wrappers, plain twins, launch counts
(counterpart of ``repro.kernels.qmatmul``).

``qmatmul_prng``        -> CUDA kernel ``csrc/qmatmul_sr.cu``, replacing
                           ``repro/kernels/qmatmul.py:qmatmul_prng_p``.
``qmatmul_swiglu_prng`` -> CUDA kernel ``csrc/qmatmul_swiglu_sr.cu``,
                           replacing ``qmatmul_swiglu_prng_p``.
``qmatmul_batched_prng`` -> CUDA kernel ``csrc/qmatmul_batched_sr.cu``,
                           replacing ``qmatmul_batched_prng_p`` (K8'): a
                           stack of GEMMs, each slice with its own seed
                           words.

A tensor on the CPU goes to the plain PyTorch twin (``*_plain``), which
computes the same function: an fp32 GEMM, then ``common.round_block`` fed
the counter bits the kernel draws in-kernel.  A CUDA tensor launches the
kernel; anything the kernel does not take raises.  ``LAUNCHES`` counts the
kernel launches, one per wrapper call that reaches a kernel.

The kernels are bound by bytes at decode (they stream each weight once);
see the notes at the top of the CUDA sources for their design.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.grids import get_grid
from repro_torch.core.rounding import RoundingSpec
from repro_torch.core.schemes import get_scheme
from repro_torch.kernels import build, common

# epilogue stream ids per seed-word pair: GEMM-result rounding vs the
# activation-site rounding
STREAM_FWD, STREAM_ACT = 0, 1
_MODES = {"rn": 0, "sr": 1}

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES: Dict[str, int] = {"qmatmul_sr": 0, "qmatmul_swiglu_sr": 0,
                            "qmatmul_batched_sr": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


Words = Tuple[int, int]


def _check_fmt_mode(fmt, mode: str, rand_bits: int, what: str):
    """The grids and schemes this slice implements: plain FP grids under
    rn or sr (r = 32, 16, 8).  Returns the grid."""
    grid = get_grid(fmt)
    if grid.kind != "fp" or grid.transformed:
        raise NotImplementedError(f"{what}: grid {grid.name!r} is not a "
                                  "plain FP grid (not ported yet)")
    if not grid.fmt.subnormals:
        raise NotImplementedError(f"{what}: grids without subnormals are "
                                  "not ported yet")
    scheme = get_scheme(mode).name
    if scheme not in _MODES:
        raise NotImplementedError(f"{what}: scheme {scheme!r} is not ported "
                                  "yet (this slice implements rn and sr)")
    if rand_bits not in (32, 16, 8):
        raise ValueError(f"{what}: rand_bits must be 32, 16 or 8")
    return grid


def _round_args(grid, mode: str, rand_bits: int):
    f = grid.fmt
    return (f.precision, f.emin, f.emax, ctypes.c_float(f.xmax),
            _MODES[get_scheme(mode).name], rand_bits)


def _check_unsupported(bias, act, act_spec, out_packed, a_fmt, eps,
                       overflow):
    if bias is not None:
        raise NotImplementedError("qmatmul bias epilogue is not ported yet")
    if act is not None or act_spec is not None:
        raise NotImplementedError("qmatmul activation epilogue is not "
                                  "ported yet (use qmatmul_swiglu_prng)")
    if out_packed or a_fmt is not None:
        raise NotImplementedError("packed operands/outputs are not ported "
                                  "yet")
    if eps:
        raise NotImplementedError("eps (sr_eps schemes) is not ported yet")
    if overflow != "saturate":
        raise NotImplementedError(f"overflow={overflow!r} is not ported yet "
                                  "(the kernels saturate at xmax)")


def _check_gemm_operands(a: torch.Tensor, bs: Sequence[torch.Tensor],
                         what: str):
    if a.dim() != 2 or a.dtype != torch.float32:
        raise ValueError(f"{what}: a must be a 2-D float32 tensor, got "
                         f"{tuple(a.shape)} {a.dtype}")
    for b in bs:
        if b.dim() != 2 or b.shape[0] != a.shape[1]:
            raise ValueError(f"{what}: shape mismatch {tuple(a.shape)} x "
                             f"{tuple(b.shape)}")
        if b.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{what}: b must be float32 or bfloat16, got "
                             f"{b.dtype}")
        if b.dtype != bs[0].dtype or b.shape != bs[0].shape:
            raise ValueError(f"{what}: weight operands must match")
        if b.device != a.device:
            raise ValueError(f"{what}: operands on different devices")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {a.device}")


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


# ---------------------------------------------------------------------------
# qmatmul_prng: rounded a @ b
# ---------------------------------------------------------------------------
def qmatmul_plain(a: torch.Tensor, b: torch.Tensor, seed_words: Words, fmt,
                  mode: str = "sr", rand_bits: int = 32) -> torch.Tensor:
    """The plain twin: fp32 GEMM, then round_block with the counter bits
    of the output's global (row, col), stream 0."""
    acc = a.float() @ b.float()
    bits = None
    if get_scheme(mode).stochastic:
        bits = common.counter_bits_reduced(
            seed_words[0], seed_words[1], tuple(acc.shape), rand_bits,
            stream=STREAM_FWD, device=acc.device)
    return common.round_block(acc, bits, fmt, mode, rand_bits=rand_bits)


def qmatmul_prng(a: torch.Tensor, b: torch.Tensor, seed_words: Words, fmt,
                 mode: str = "sr", rand_bits: int = 32, *, eps: float = 0.0,
                 overflow: str = "saturate", bias=None, act=None,
                 act_spec=None, out_packed=False, a_fmt=None
                 ) -> torch.Tensor:
    """Rounded ``a @ b`` (a: (M, K) float32; b: (K, N) float32 or bf16);
    ``seed_words``: the (k0, k1) uint32 pair of this GEMM site.  Returns
    (M, N) float32 grid values."""
    _check_unsupported(bias, act, act_spec, out_packed, a_fmt, eps, overflow)
    grid = _check_fmt_mode(fmt, mode, rand_bits, "qmatmul_prng")
    _check_gemm_operands(a, (b,), "qmatmul_prng")
    if a.device.type == "cpu":
        return qmatmul_plain(a, b, seed_words, grid, mode, rand_bits)
    M, K = a.shape
    N = b.shape[1]
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out                       # nothing to launch
    lib = _lib_qmatmul()
    rc = lib.qmatmul_sr(
        a.data_ptr(), b.data_ptr(), int(b.dtype == torch.bfloat16),
        out.data_ptr(), M, N, K, seed_words[0], seed_words[1],
        *_round_args(grid, mode, rand_bits),
        torch.cuda.current_stream(a.device).cuda_stream)
    _launch_check(rc, "qmatmul_sr")
    LAUNCHES["qmatmul_sr"] += 1
    return out


def _lib_qmatmul():
    lib = build.load("qmatmul_sr")
    fn = lib.qmatmul_sr
    if fn.argtypes is None:
        c = ctypes
        fn.argtypes = [c.c_void_p, c.c_void_p, c.c_int, c.c_void_p,
                       c.c_int, c.c_int, c.c_int, c.c_uint32, c.c_uint32,
                       c.c_int, c.c_int, c.c_int, c.c_float, c.c_int,
                       c.c_int, c.c_void_p]
        fn.restype = c.c_int
    return lib


# ---------------------------------------------------------------------------
# qmatmul_swiglu_prng: h = round_act(silu(round(x@wg)) * round(x@wu))
# ---------------------------------------------------------------------------
def silu(g: torch.Tensor) -> torch.Tensor:
    """SiLU exactly as the kernel computes it: g * (1 / (1 + exp(-g))).
    On a bf16 tensor each operation rounds to bf16, which is how the
    reference's ``jax.nn.silu`` computes it op by op (``F.silu`` would
    round once): the MoE experts and the unfused FFN use it so."""
    return g * (1.0 / (1.0 + torch.exp(-g)))


def qmatmul_swiglu_plain(x: torch.Tensor, wg: torch.Tensor,
                         wu: torch.Tensor, seeds: Sequence[Words], fmt,
                         mode: str = "sr", rand_bits: int = 32,
                         act_spec: Optional[RoundingSpec] = None,
                         residuals: bool = False):
    """The plain twin of the fused GLU prefix: h, or (h, g_r, u_r) with
    ``residuals``."""
    x = x.float()
    accg = x @ wg.float()
    accu = x @ wu.float()
    shape, dev = tuple(accg.shape), accg.device
    bg = bu = None
    if get_scheme(mode).stochastic:
        bg = common.counter_bits_reduced(*seeds[0], shape, rand_bits,
                                         stream=STREAM_FWD, device=dev)
        bu = common.counter_bits_reduced(*seeds[1], shape, rand_bits,
                                         stream=STREAM_FWD, device=dev)
    g_r = common.round_block(accg, bg, fmt, mode, rand_bits=rand_bits)
    u_r = common.round_block(accu, bu, fmt, mode, rand_bits=rand_bits)
    h = silu(g_r) * u_r
    if act_spec is not None and not act_spec.is_identity:
        ab = None
        if act_spec.stochastic:
            ab = common.counter_bits_reduced(*seeds[2], shape,
                                             act_spec.rand_bits,
                                             stream=STREAM_ACT, device=dev)
        h = common.apply_spec_block(act_spec, h, ab)
    return (h, g_r, u_r) if residuals else h


def qmatmul_swiglu_prng(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                        seeds: Sequence[Words], fmt, mode: str = "sr", *,
                        act: str = "silu",
                        act_spec: Optional[RoundingSpec] = None,
                        rand_bits: int = 32, eps: float = 0.0,
                        overflow: str = "saturate", out_packed: bool = False,
                        residuals: bool = False):
    """Fused GLU-FFN prefix: x (M, K) float32, wg/wu (K, N) float32 or
    bf16; ``seeds``: the gate, up and activation-site (k0, k1) pairs.
    Returns h (M, N) float32, or with ``residuals`` the tuple (h, g_r,
    u_r): the rounded gate and up branches (float32) the backward needs."""
    if act != "silu":
        raise NotImplementedError(f"activation {act!r} is not ported yet")
    if out_packed:
        raise NotImplementedError("packed outputs are not ported yet")
    if eps or overflow != "saturate":
        raise NotImplementedError("eps (sr_eps schemes) and overflow='inf' "
                                  "are not ported yet")
    if len(seeds) != 3:
        raise ValueError("seeds must hold three (k0, k1) pairs")
    grid = _check_fmt_mode(fmt, mode, rand_bits, "qmatmul_swiglu_prng")
    act_grid = None
    if act_spec is not None and act_spec.is_identity:
        act_spec = None
    if act_spec is not None:
        if act_spec.eps or act_spec.overflow != "saturate":
            raise NotImplementedError("act_spec eps/overflow not ported yet")
        act_grid = _check_fmt_mode(act_spec.fmt, act_spec.mode,
                                   act_spec.rand_bits, "act_spec")
    _check_gemm_operands(x, (wg, wu), "qmatmul_swiglu_prng")
    if x.device.type == "cpu":
        return qmatmul_swiglu_plain(x, wg, wu, seeds, grid, mode, rand_bits,
                                    act_spec, residuals)
    M, K = x.shape
    N = wg.shape[1]
    x, wg, wu = x.contiguous(), wg.contiguous(), wu.contiguous()
    outs = [torch.empty((M, N), dtype=torch.float32, device=x.device)
            for _ in range(3 if residuals else 1)]
    if outs[0].numel() == 0:
        return tuple(outs) if residuals else outs[0]   # nothing to launch
    res_ptrs = (outs[1].data_ptr(), outs[2].data_ptr()) if residuals \
        else (None, None)
    if act_spec is not None:
        act_args = (1, *_round_args(act_grid, act_spec.mode,
                                    act_spec.rand_bits))
    else:
        act_args = (0, 0, 0, 0, ctypes.c_float(0.0), 0, 32)
    lib = _lib_swiglu()
    rc = lib.qmatmul_swiglu_sr(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        int(wg.dtype == torch.bfloat16), outs[0].data_ptr(), *res_ptrs,
        M, N, K,
        *seeds[0], *seeds[1], *seeds[2],
        *_round_args(grid, mode, rand_bits), *act_args,
        torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(rc, "qmatmul_swiglu_sr")
    LAUNCHES["qmatmul_swiglu_sr"] += 1
    return tuple(outs) if residuals else outs[0]


def _lib_swiglu():
    lib = build.load("qmatmul_swiglu_sr")
    fn = lib.qmatmul_swiglu_sr
    if fn.argtypes is None:
        c = ctypes
        fn.argtypes = ([c.c_void_p] * 3 + [c.c_int] + [c.c_void_p] * 3
                       + [c.c_int] * 3 + [c.c_uint32] * 6
                       + [c.c_int] * 3 + [c.c_float] + [c.c_int] * 2
                       + [c.c_int] * 4 + [c.c_float] + [c.c_int] * 2
                       + [c.c_void_p])
        fn.restype = c.c_int
    return lib


# ---------------------------------------------------------------------------
# qmatmul_batched_prng: rounded a[e] @ b[e], per-slice seed words
# ---------------------------------------------------------------------------
def qmatmul_batched_plain(a: torch.Tensor, b: torch.Tensor, seeds, fmt,
                          mode: str = "sr", rand_bits: int = 32
                          ) -> torch.Tensor:
    """The plain twin: a batched fp32 GEMM, then round_block fed slice
    e's counter bits from ``seeds[e]`` at within-slice (row, col), stream
    0 (``common.counter_bits_batch``)."""
    acc = torch.bmm(a.float(), b.float())
    bits = None
    if get_scheme(mode).stochastic:
        bits = common.counter_bits_batch(_host_seeds(seeds, acc.shape[0]),
                                         tuple(acc.shape), rand_bits,
                                         stream=STREAM_FWD,
                                         device=acc.device)
    return common.round_block(acc, bits, fmt, mode, rand_bits=rand_bits)


def _host_seeds(seeds, E: int) -> np.ndarray:
    """Per-slice seed words as an (E, 2) int64 array of uint32 values."""
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.cpu().numpy()
    arr = np.asarray(seeds, dtype=np.int64) & 0xFFFFFFFF
    if arr.shape != (E, 2):
        raise ValueError(f"seeds must be ({E}, 2) uint32 words, got "
                         f"{arr.shape}")
    return arr


def qmatmul_batched_prng(a: torch.Tensor, b: torch.Tensor, seeds, fmt,
                         mode: str = "sr", rand_bits: int = 32, *,
                         eps: float = 0.0, overflow: str = "saturate",
                         act=None, act_spec=None, out_packed=False,
                         a_fmt=None) -> torch.Tensor:
    """Rounded ``a[e] @ b[e]`` for every slice e (a: (E, M, K) float32;
    b: (E, K, N) float32 or bf16); ``seeds``: (E, 2) uint32 words, one
    pair per slice (numpy array or tensor; ``policy.slice_words``).
    Returns (E, M, N) float32 grid values."""
    _check_unsupported(None, act, act_spec, out_packed, a_fmt, eps, overflow)
    grid = _check_fmt_mode(fmt, mode, rand_bits, "qmatmul_batched_prng")
    if a.dim() != 3 or a.dtype != torch.float32:
        raise ValueError("qmatmul_batched_prng: a must be a 3-D float32 "
                         f"tensor, got {tuple(a.shape)} {a.dtype}")
    if b.dim() != 3 or b.shape[0] != a.shape[0] or b.shape[1] != a.shape[2]:
        raise ValueError("qmatmul_batched_prng: shape mismatch "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if b.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("qmatmul_batched_prng: b must be float32 or "
                         f"bfloat16, got {b.dtype}")
    if b.device != a.device:
        raise ValueError("qmatmul_batched_prng: operands on different "
                         "devices")
    E, M, K = a.shape
    N = b.shape[2]
    host = _host_seeds(seeds, E)
    if a.device.type == "cpu":
        return qmatmul_batched_plain(a, b, host, grid, mode, rand_bits)
    if a.device.type != "cuda":
        raise ValueError(f"qmatmul_batched_prng: unsupported device "
                         f"{a.device}")
    if E > 65535 or -(-M // 4) > 65535:
        raise ValueError(f"qmatmul_batched_prng: E={E}, M={M} exceed the "
                         "kernel's grid")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((E, M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out                       # nothing to launch
    dev_seeds = common.host_to_device(
        host.astype(np.uint32).view(np.int32), a.device)
    rc = _lib_batched().qmatmul_batched_sr(
        a.data_ptr(), b.data_ptr(), int(b.dtype == torch.bfloat16),
        dev_seeds.data_ptr(), out.data_ptr(), E, M, N, K,
        *_round_args(grid, mode, rand_bits),
        torch.cuda.current_stream(a.device).cuda_stream)
    _launch_check(rc, "qmatmul_batched_sr")
    LAUNCHES["qmatmul_batched_sr"] += 1
    return out


def _lib_batched():
    lib = build.load("qmatmul_batched_sr")
    fn = lib.qmatmul_batched_sr
    if fn.argtypes is None:
        c = ctypes
        fn.argtypes = [c.c_void_p, c.c_void_p, c.c_int, c.c_void_p,
                       c.c_void_p, c.c_int, c.c_int, c.c_int, c.c_int,
                       c.c_int, c.c_int, c.c_int, c.c_float, c.c_int,
                       c.c_int, c.c_void_p]
        fn.restype = c.c_int
    return lib
