"""Rounding a tensor onto a low-precision grid with in-kernel random bits:
wrapper, plain twin, launch count (counterpart of
``repro.kernels.sr_cast``).

``sr_cast_prng`` -> CUDA kernel ``csrc/sr_cast.cu``, replacing
                    ``repro/kernels/sr_cast.py:sr_cast_prng_p`` (K1').

The tensor is read as its flat 128-lane layout: element ``i`` is rounded
with the random field at (i // 128, i % 128) of the seed words, stream 0
(``common.lane_bits``), whatever the tensor's shape.  A tensor on the CPU
goes to the plain PyTorch twin ``sr_cast_prng_plain`` (``round_block`` fed
those bits); a CUDA tensor launches the kernel, and what the kernel does
not take raises.  ``LAUNCHES`` counts the kernel launches.

Scope: rn and sr on plain FP grids with 32-, 16- or 8-bit draws, as the
GEMM kernels.  The signed-SRε branch (a ``v`` operand) and the eps schemes
are not ported yet and raise.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.core.schemes import get_scheme
from repro_torch.kernels import build, common
from repro_torch.kernels.qmatmul import (Words, _check_fmt_mode,
                                         _launch_check, _round_args)

LAUNCHES: Dict[str, int] = {"sr_cast_prng": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sr_cast_prng_plain(x: torch.Tensor, seed_words: Words, fmt,
                       mode: str = "sr", rand_bits: int = 32
                       ) -> torch.Tensor:
    """The plain twin: ``round_block`` of the flat float32 values with the
    128-lane counter bits; returns float32 of ``x``'s shape."""
    flat = x.float().reshape(-1)
    bits = None
    if get_scheme(mode).stochastic:
        bits = common.lane_bits(seed_words[0], seed_words[1], flat.numel(),
                                rand_bits, device=flat.device)
    return common.round_block(flat, bits, fmt, mode,
                              rand_bits=rand_bits).reshape(x.shape)


def sr_cast_prng(x: torch.Tensor, seed_words: Words, fmt, mode: str = "sr",
                 eps: float = 0.0, v=None, *, rand_bits: int = 32,
                 overflow: str = "saturate") -> torch.Tensor:
    """Round float32 ``x`` (any shape) onto ``fmt``; ``seed_words``: the
    (k0, k1) uint32 pair of this rounding site.  Returns float32 grid
    values of ``x``'s shape."""
    if v is not None or get_scheme(mode).needs_v:
        raise NotImplementedError("sr_cast_prng: the signed-SRε branch (v "
                                  "operand) is not ported yet")
    if eps or overflow != "saturate":
        raise NotImplementedError("sr_cast_prng: eps schemes and "
                                  "overflow='inf' are not ported yet")
    grid = _check_fmt_mode(fmt, mode, rand_bits, "sr_cast_prng")
    if x.dtype != torch.float32:
        raise ValueError(f"sr_cast_prng: x must be float32, got {x.dtype}")
    if x.device.type == "cpu":
        return sr_cast_prng_plain(x, seed_words, grid, mode, rand_bits)
    if x.device.type != "cuda":
        raise ValueError(f"sr_cast_prng: unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out                       # nothing to launch
    vec_ok = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    rc = _lib().sr_cast_prng(
        x.data_ptr(), out.data_ptr(), x.numel(), vec_ok, seed_words[0],
        seed_words[1], *_round_args(grid, mode, rand_bits),
        torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(rc, "sr_cast_prng")
    LAUNCHES["sr_cast_prng"] += 1
    return out


def _lib():
    lib = build.load("sr_cast")
    fn = lib.sr_cast_prng
    if fn.argtypes is None:
        c = ctypes
        fn.argtypes = [c.c_void_p, c.c_void_p, c.c_longlong, c.c_int,
                       c.c_uint32, c.c_uint32, c.c_int, c.c_int, c.c_int,
                       c.c_float, c.c_int, c.c_int, c.c_void_p]
        fn.restype = c.c_int
    return lib
