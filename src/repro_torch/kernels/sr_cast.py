"""Rounding a tensor onto a low-precision grid: wrappers, plain twins,
launch counts (counterpart of ``repro.kernels.sr_cast``).

``sr_cast_prng`` -> CUDA kernel ``csrc/sr_cast.cu`` (``sr_cast_prng``,
                    K1'), replacing ``repro/kernels/sr_cast.py:
                    sr_cast_prng_p``: the bits are drawn in the kernel.
``sr_cast``      -> the same source's ``sr_cast_bits`` (K1), replacing
                    ``sr_cast_p``: one explicit uint32 word per element.

K1' reads the tensor as its flat 128-lane layout: element ``i`` is rounded
with the random field at (i // 128, i % 128) of the seed words, stream 0
(``common.lane_bits``), whatever the tensor's shape.  K1 takes word ``i``
of the flat bits operand (its low ``rand_bits`` bits).  A tensor on the
CPU goes to the plain PyTorch twin (``round_block`` fed those bits); a
CUDA tensor launches the kernel, and what the kernel does not take raises.
``LAUNCHES`` counts the kernel launches.

K1' is compiled three times: an instance for the serving path's spec (sr
with 32-bit draws, no ``v``) with the scheme and the draw width fixed at
compile time, a generic one for rn, sr, sr_eps and signed_sr_eps on plain
FP grids with subnormals, saturating (``csrc/rounding.cuh``'s
``round_value``), and a wide one for every other scheme x grid x overflow
pair of the reference's ``round_block`` (``round_value_wide``: rz, ra, rd,
ru, sr2, the bit trick, fixed-point and shifted grids, formats without
subnormals, overflow to ±inf); ``sr_cast_instance`` chooses.  Each of its
threads rounds the ``prng_group(rand_bits)`` consecutive elements whose
fields one Threefry evaluation gives.  K1 is compiled the first two ways
(``sr_cast_bits_instance``: the oracle act site's spec is the same sr
with 32-bit draws), each thread rounding 4 elements, and takes the
generic instance's sites alone (its wide instance is not ported yet).

Draws of 32, 16 or 8 bits.  signed_sr_eps takes the bias direction ``v``
(broadcast to ``x``'s shape) and, as the reference's signed kernels do,
draws 32-bit fields whatever ``rand_bits`` says.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.core.grids import get_grid
from repro_torch.core.rounding import RoundingSpec, spec
from repro_torch.core.schemes import get_scheme
from repro_torch.kernels import build, common
from repro_torch.kernels.qmatmul import (Words, _bits_words, _launch_check,
                                         _stream)

LAUNCHES: Dict[str, int] = {"sr_cast_prng": 0, "sr_cast_bits": 0}
# K1''s and K1's compiled instances, by the index their entry points take
# (K1 has the first two)
SR_CAST_INSTANCES = ("generic", "sr_r32", "wide")
# K1' launches (counted in LAUNCHES too) by instance
INSTANCE_LAUNCHES: Dict[str, int] = dict.fromkeys(SR_CAST_INSTANCES, 0)
# True launches K1''s wide instance on every site, the other instances'
# too (the card checks hold them against each other)
FORCE_WIDE = False


def reset_launches() -> None:
    for counts in (LAUNCHES, INSTANCE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _spec(fmt, mode: str, rand_bits: int, eps: float,
          overflow: str) -> RoundingSpec:
    return spec(get_grid(fmt).name, mode, eps, rand_bits, overflow)


def _check(x: torch.Tensor, fmt, mode: str, v, rand_bits: int, eps: float,
           overflow: str, what: str, wide: bool = True):
    """The sites the kernels take (``wide``: K1''s, every scheme x grid x
    overflow pair of the reference's ``round_block``; else K1's, the
    generic instance's alone); returns (grid, flat float32 v or None, the
    rand_bits the rounding uses)."""
    grid = get_grid(fmt)
    scheme = get_scheme(mode)
    if not wide and not common.fp_site(_spec(grid, mode, rand_bits, eps,
                                             overflow)):
        raise NotImplementedError(
            f"{what}: {_spec(grid, mode, rand_bits, eps, overflow)} needs a "
            "wide instance, which K1 does not have yet (rn, sr, sr_eps, "
            "signed_sr_eps on plain FP grids with subnormals, saturating)")
    if rand_bits not in (32, 16, 8):
        raise ValueError(f"{what}: rand_bits must be 32, 16 or 8")
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: x must be float32, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    vf = None
    if scheme.needs_v:
        if v is None:
            raise ValueError(f"{mode} requires v")
        if not torch.is_tensor(v):
            v = torch.as_tensor(v, dtype=torch.float32, device=x.device)
        if v.device != x.device:
            raise ValueError(f"{what}: v on another device than x")
        vf = v.float().expand(x.shape).reshape(-1)
        rand_bits = 32        # the reference's signed kernels draw 32 bits
    return grid, vf, rand_bits


@functools.lru_cache(maxsize=None)
def sr_cast_instance(mode: str, rand_bits: int, has_v: bool, fmt=None,
                     eps: float = 0.0, overflow: str = "saturate") -> str:
    """Which compiled instance of K1' a call runs: ``"wide"`` where the
    site (on grid ``fmt``; None: a plain FP grid) is not the generic
    instance's (``common.fp_site``), ``"sr_r32"`` (sr, its 32-bit draws
    and no ``v`` fixed at compile time: the MoE act site's spec), else
    ``"generic"``.  The entry points refuse an ``sr_r32`` launch that does
    not fit."""
    if fmt is not None and not common.fp_site(
            _spec(fmt, mode, rand_bits, eps, overflow)):
        return "wide"
    if get_scheme(mode).name == "sr" and rand_bits == 32 and not has_v:
        return "sr_r32"
    return "generic"


def sr_cast_bits_instance(mode: str, rand_bits: int, has_v: bool) -> str:
    """Which compiled instance of K1 a call runs: ``"sr_r32"`` (sr, its
    32-bit draws and no ``v`` fixed at compile time: the oracle MoE act
    site's spec, ``policy.act`` of ``binary8-paper``) or ``"generic"``;
    the same split as K1''s.  The entry point refuses an ``sr_r32``
    launch that does not fit."""
    return sr_cast_instance(mode, rand_bits, has_v)


def prng_group(rand_bits: int) -> int:
    """Elements per K1' thread: one Threefry evaluation gives two 32-bit
    words, so 2 elements at 32-bit fields, 4 at 16, 8 at 8.  Thread ``t``
    rounds elements ``[t·g, t·g + g)``; with g dividing 128 they lie in
    one row of the 128-lane layout, and their words are the pair keyed
    (row, (i % 128) // g) (``common.lane_bits``)."""
    return 64 // rand_bits


def _round_args(grid, mode: str, rand_bits: int, eps: float):
    f = grid.fmt
    return (f.precision, f.emin, f.emax, ctypes.c_float(f.xmax),
            common.SCHEME_CODES[get_scheme(mode).name], rand_bits,
            ctypes.c_float(eps))


@functools.lru_cache(maxsize=None)
def _wide_row(grid, mode: str, rand_bits: int, eps: float, overflow: str):
    return common.wide_row(_spec(grid, mode, rand_bits, eps, overflow))


def sr_cast_prng_plain(x: torch.Tensor, seed_words: Words, fmt,
                       mode: str = "sr", rand_bits: int = 32,
                       eps: float = 0.0, v: Optional[torch.Tensor] = None,
                       overflow: str = "saturate") -> torch.Tensor:
    """The plain twin of K1': ``round_block`` of the flat float32 values
    with the 128-lane counter bits; returns float32 of ``x``'s shape."""
    flat = x.float().reshape(-1)
    bits = None
    if get_scheme(mode).stochastic:
        bits = common.lane_bits(seed_words[0], seed_words[1], flat.numel(),
                                rand_bits, device=flat.device)
    vf = None if v is None else v.float().reshape(-1)
    return common.round_block(flat, bits, fmt, mode, eps, v=vf,
                              rand_bits=rand_bits,
                              overflow=overflow).reshape(x.shape)


def sr_cast_plain(x: torch.Tensor, bits: Optional[torch.Tensor], fmt,
                  mode: str = "sr", rand_bits: int = 32, eps: float = 0.0,
                  v: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain twin of K1: ``round_block`` of the flat float32 values
    fed word i of ``bits`` (uint32 values in int64) for element i."""
    flat = x.float().reshape(-1)
    words = None
    if get_scheme(mode).stochastic:
        words = bits.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    vf = None if v is None else v.float().reshape(-1)
    return common.round_block(flat, words, fmt, mode, eps, v=vf,
                              rand_bits=rand_bits).reshape(x.shape)


def _launch(name: str, x, bits, vf, seed_words, grid, mode, rand_bits, eps,
            overflow: str, instance: str):
    x = x.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out                       # nothing to launch
    vf = None if vf is None else vf.contiguous()
    vec_ok = int(all(t.data_ptr() % 16 == 0
                     for t in (x, out, bits, vf) if t is not None))
    lib = _lib()
    v_ptr = None if vf is None else vf.data_ptr()
    if instance == "wide":
        ints, floats = _wide_row(grid, mode, rand_bits, eps, overflow)
        rc = lib.sr_cast_prng_wide(x.data_ptr(), v_ptr, out.data_ptr(),
                                   x.numel(), vec_ok, seed_words[0],
                                   seed_words[1], (ctypes.c_int * 8)(*ints),
                                   (ctypes.c_float * 4)(*floats), _stream(x))
    elif name == "sr_cast_prng":
        rc = lib.sr_cast_prng(x.data_ptr(), v_ptr, out.data_ptr(), x.numel(),
                              vec_ok, seed_words[0], seed_words[1],
                              *_round_args(grid, mode, rand_bits, eps),
                              SR_CAST_INSTANCES.index(instance), _stream(x))
    else:
        rc = lib.sr_cast_bits(x.data_ptr(),
                              None if bits is None else bits.data_ptr(),
                              v_ptr, out.data_ptr(), x.numel(), vec_ok,
                              *_round_args(grid, mode, rand_bits, eps),
                              SR_CAST_INSTANCES.index(instance), _stream(x))
    _launch_check(rc, name)
    LAUNCHES[name] += 1
    if name == "sr_cast_prng":
        INSTANCE_LAUNCHES[instance] += 1
    return out


def sr_cast_prng(x: torch.Tensor, seed_words: Words, fmt, mode: str = "sr",
                 eps: float = 0.0, v=None, *, rand_bits: int = 32,
                 overflow: str = "saturate",
                 instance: Optional[str] = None) -> torch.Tensor:
    """Round float32 ``x`` (any shape) onto ``fmt``; ``seed_words``: the
    (k0, k1) uint32 pair of this rounding site; ``v``: the bias direction
    of signed_sr_eps.  Returns float32 grid values of ``x``'s shape.
    ``instance``: on the card, ``"generic"`` launches the generic instance
    whatever ``sr_cast_instance`` chooses (the checks hold the instances
    against each other; ``FORCE_WIDE`` launches the wide one, which takes
    every site)."""
    grid, vf, rand_bits = _check(x, fmt, mode, v, rand_bits, eps, overflow,
                                 "sr_cast_prng")
    chosen = sr_cast_instance(mode, rand_bits, vf is not None, grid, eps,
                              overflow)
    if FORCE_WIDE:
        chosen = "wide"
    if instance not in (None, chosen) + (("generic",) if chosen != "wide"
                                         else ()):
        raise ValueError(f"sr_cast_prng: cannot launch instance "
                         f"{instance!r} for this spec (it takes {chosen!r})")
    if x.device.type == "cpu":
        return sr_cast_prng_plain(x, seed_words, grid, mode, rand_bits, eps,
                                  vf, overflow)
    return _launch("sr_cast_prng", x, None, vf, seed_words, grid, mode,
                   rand_bits, eps, overflow, instance or chosen)


def sr_cast(x: torch.Tensor, bits: Optional[torch.Tensor], fmt,
            mode: str = "sr", eps: float = 0.0, v=None, *,
            rand_bits: int = 32, overflow: str = "saturate",
            instance: Optional[str] = None) -> torch.Tensor:
    """K1: round float32 ``x`` onto ``fmt`` with explicit ``bits``, uint32
    words of ``x``'s shape (int64, or int32 bit patterns; None for rn; with
    ``rand_bits < 32`` the low bits of each).  Options and result as
    :func:`sr_cast_prng` (``instance`` picks from ``sr_cast_bits_instance``'s
    instances)."""
    grid, vf, rand_bits = _check(x, fmt, mode, v, rand_bits, eps, overflow,
                                 "sr_cast", wide=False)
    chosen = sr_cast_bits_instance(mode, rand_bits, vf is not None)
    if instance not in (None, chosen, "generic"):
        raise ValueError(f"sr_cast: cannot launch instance {instance!r} "
                         f"for this spec (it takes {chosen!r})")
    stoch = get_scheme(mode).stochastic
    if stoch and bits is None:
        raise ValueError("sr_cast: a stochastic scheme needs the bits "
                         "operand")
    words = _bits_words(bits if stoch else None, tuple(x.shape), x.device,
                        "sr_cast")
    if x.device.type == "cpu":
        return sr_cast_plain(x, words, grid, mode, rand_bits, eps, vf)
    return _launch("sr_cast_bits", x,
                   None if words is None else words.reshape(-1), vf, None,
                   grid, mode, rand_bits, eps, overflow, instance or chosen)


def _lib():
    lib = build.load("sr_cast")
    if lib.sr_cast_prng.argtypes is None:
        c = ctypes
        rnd = [c.c_int, c.c_int, c.c_int, c.c_float, c.c_int, c.c_int,
               c.c_float, c.c_void_p]
        lib.sr_cast_prng.argtypes = ([c.c_void_p] * 3
                                     + [c.c_longlong, c.c_int, c.c_uint32,
                                        c.c_uint32] + rnd[:-1]
                                     + [c.c_int, c.c_void_p])
        lib.sr_cast_prng.restype = c.c_int
        lib.sr_cast_bits.argtypes = ([c.c_void_p] * 4
                                     + [c.c_longlong, c.c_int] + rnd[:-1]
                                     + [c.c_int, c.c_void_p])
        lib.sr_cast_bits.restype = c.c_int
        lib.sr_cast_prng_wide.argtypes = ([c.c_void_p] * 3
                                          + [c.c_longlong, c.c_int,
                                             c.c_uint32, c.c_uint32,
                                             c.POINTER(c.c_int),
                                             c.POINTER(c.c_float),
                                             c.c_void_p])
        lib.sr_cast_prng_wide.restype = c.c_int
    return lib
