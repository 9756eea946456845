"""Rounded-result GEMMs (paper eq. 8a): wrappers, plain twins, launch counts
(counterpart of ``repro.kernels.qmatmul``).

``qmatmul_prng``         -> CUDA kernel ``csrc/qmatmul_sr.cu``
                            (``qmatmul_sr``, K3'), replacing
                            ``repro/kernels/qmatmul.py:qmatmul_prng_p``.
``qmatmul``              -> the same source's ``qmatmul_bits`` (K3),
                            replacing ``qmatmul_p``: explicit (M, N) bits.
``qmatmul_swiglu_prng``  -> CUDA kernel ``csrc/qmatmul_swiglu_sr.cu``
                            (K4'), replacing ``qmatmul_swiglu_prng_p``;
                            the reference's other activations (``act``
                            gelu, relu, relu_sq: ``ACT_FNS``) are their
                            own instances and libraries,
                            ``csrc/qmatmul_swiglu_<act>.cu``.
``qmatmul_swiglu``       -> the same sources' ``qmatmul_swiglu_bits``
                            (K4), replacing ``qmatmul_swiglu_p``.
``qmatmul_batched_prng`` -> CUDA kernel ``csrc/qmatmul_batched_sr.cu``
                            (K8'), replacing ``qmatmul_batched_prng_p``: a
                            stack of GEMMs, each slice with its own seed
                            words.
``qmatmul_batched``      -> the same source's ``qmatmul_batched_bits``
                            (K8), replacing ``qmatmul_batched_p``: explicit
                            (E, M, N) bits, one plane per slice.

Each explicit-bits kernel runs the main loop of its in-kernel-bits twin
and differs only in where an output's 32-bit word comes from, so fed
``common.counter_bits_reduced`` of the same seed words (the reference's
oracle draw) it equals that twin bit for bit.

A tensor on the CPU goes to the plain PyTorch twin (``*_plain``), which
computes the same function: an fp32 GEMM, then ``common.round_block`` fed
the bits (given, or the counter bits the kernel draws in-kernel), then,
where asked, ``common.pack_block``.  A CUDA tensor launches the kernel;
anything the kernel does not take raises.  ``LAUNCHES`` counts the kernel
launches, one per wrapper call that reaches a kernel.

Storage options of the reference's shared epilogue: ``a_fmt`` (A holds
code words of that grid, decoded on load) and ``out_packed`` (the result
leaves as code words of its grid); the fused GLU kernels pack the hidden
to the act grid (``out_packed``) and the g_r/u_r residuals to the GEMM
grid (``residuals_packed``).  Bits operands are uint32 words, held in
int64 tensors (as the port's counter draws make them) or as int32 bit
patterns; the kernels read 32-bit words.

The kernels are bound by bytes at decode (they stream each weight once);
see the notes at the top of the CUDA sources for their design.  K3'/K3
and K4'/K4 have two routes (``csrc/gemm_routes.cuh``): M <=
``DECODE_MAX_M`` runs the decode route (a weight stream, one lane per
output), larger M the large-M route (register tiles).  K8'/K8 have a
weight-stream route for M <= ``BATCHED_STREAM_MAX_M`` (a thread holds
all rows of its columns, up to 16, so each expert's weights are read
once per 16 rows) and the same large-M route, one grid plane per slice.
Every route sums each output in one ascending chain, the first version's
order, so the routes equal each other and that kernel bit for bit on
every input, and the twins on exact sums.

K3', K4' and K8' take every scheme x grid pair of the reference's
``round_block`` but those that need a bias direction (as the reference's
``_check_mode``): rn, sr and sr_eps on plain FP grids with subnormals run
their first instances, everything else (rz, ra, rd, ru, SR 2.0, the bit
trick, fixed-point and shifted grids, formats without subnormals; K4''s
act site overflowing to ±inf) a wide instance of the same kernels whose
epilogue is ``csrc/rounding.cuh``'s ``round_value_wide``
(``gemm_instance``, ``swiglu_instance``; ``INSTANCE_LAUNCHES`` counts
them).  The GEMM result sites saturate, as the reference's (they take no
``overflow``).  The explicit-bits kernels K3, K4 and K8 have the first
instances alone.  On the card:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
      tests/test_torch_gpu.py -k "qmatmul or swiglu"

(a test forces a route by setting ``DECODE_MAX_M`` or
``BATCHED_STREAM_MAX_M``), and an A/B of two trees' K3' and K4', or with
``--kernel k8`` K8' and K8 (times, device times by graph replay and
output digests), in one call: ``python
src/repro_torch/launch/time_gemm.py --src <tree>/src --tag <name>`` for
parent, change, change, parent.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fma import flush, fma
from repro_torch.core.grids import get_grid
from repro_torch.core.prng import int32_words
from repro_torch.core.rounding import RoundingSpec, spec
from repro_torch.core.schemes import get_scheme
from repro_torch.core.xla_math import tanh_f32
from repro_torch.kernels import build, common

# epilogue stream ids per seed-word pair: GEMM-result rounding vs the
# activation-site rounding
STREAM_FWD, STREAM_ACT = 0, 1
_TINY = 2.0 ** -126       # float32's least normal magnitude

# K3'/K3 and K4'/K4 calls with M at or below this run the decode route of
# csrc/gemm_routes.cuh, larger M its large-M route: every decode step (M =
# batch) and engine prefill chunk (8 rows) the first, prompts (M = 128) and
# the train step the second (the threshold from the routes' times at M = 4,
# 8, 16 and 128: PERF.md)
DECODE_MAX_M = 16

# K8'/K8 calls with M (rows per slice) at or below this run the weight-stream
# route of csrc/qmatmul_batched_sr.cu (a slice's weights read once per 16
# rows: every MoE decode step, M = 1, and a whole-prompt forward, M = 10),
# larger M its large-M route (gemm_routes.cuh's tiles, one grid plane per
# slice).  From the routes' device times at M = 1 to 128 (128 experts, 2048
# -> 768): the stream route faster up to M = 96, the large-M route at 128
# (PERF.md)
BATCHED_STREAM_MAX_M = 96
# rows of a slice per block on each route (the large-M route's least tile):
# the grid's row dimension is at most 65535 blocks
_BATCHED_TILE_ROWS = {"stream": 16, "large": 32}

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES: Dict[str, int] = {"qmatmul_sr": 0, "qmatmul_swiglu_sr": 0,
                            "qmatmul_batched_sr": 0, "qmatmul_bits": 0,
                            "qmatmul_swiglu_bits": 0,
                            "qmatmul_batched_bits": 0}


# K4' and K4 launches (both counted in LAUNCHES too) by activation, each
# its own compiled library (_swiglu_source)
ACT_LAUNCHES: Dict[str, int] = {"silu": 0, "gelu": 0, "relu": 0,
                                "relu_sq": 0}

# The compiled instances of K3', K4' and K8' (gemm_instance): "fp", the
# first ones (csrc/rounding.cuh's round_value: rn, sr and sr_eps on plain FP
# grids with subnormals), and "wide" (round_value_wide: every other scheme
# x grid pair of the reference's round_block).  The explicit-bits kernels
# K3, K4 and K8 have the first alone.
GEMM_INSTANCES = ("fp", "wide")
# launches of K3', K4' and K8' (counted in LAUNCHES too) by instance
INSTANCE_LAUNCHES: Dict[str, Dict[str, int]] = {
    name: dict.fromkeys(GEMM_INSTANCES, 0)
    for name in ("qmatmul_sr", "qmatmul_swiglu_sr", "qmatmul_batched_sr")}
# True launches the wide instances of K3', K4' and K8' on every site, the
# first instances' too (the card checks hold the two against each other)
FORCE_WIDE = False


def reset_launches() -> None:
    for counts in (LAUNCHES, ACT_LAUNCHES, *INSTANCE_LAUNCHES.values()):
        for name in counts:
            counts[name] = 0


Words = Tuple[int, int]


def _site(fmt, mode: str, rand_bits: int, eps: float) -> RoundingSpec:
    """A GEMM result site as a spec: saturating, as the reference's GEMM
    kernels round (they take no overflow)."""
    return spec(get_grid(fmt).name, mode, eps, rand_bits)


@functools.lru_cache(maxsize=None)
def gemm_instance(fmt, mode: str, rand_bits: int = 32,
                  eps: float = 0.0) -> str:
    """The compiled instance of K3', K4' and K8' (``GEMM_INSTANCES``) a
    GEMM result site runs: "fp" where ``round_value`` takes it
    (``common.fp_site``), else "wide"."""
    return "fp" if common.fp_site(_site(fmt, mode, rand_bits, eps)) \
        else "wide"


def _check_fmt_mode(fmt, mode: str, rand_bits: int, what: str,
                    eps: float = 0.0, wide: bool = True):
    """The sites the GEMM kernels take: every scheme x grid pair of the
    reference's ``round_block`` but the schemes that need a bias-direction
    operand (the reference's ``_check_mode`` raises ValueError for them
    too), with 32-, 16- or 8-bit draws; without ``wide`` (the
    explicit-bits kernels K3, K4 and K8, whose wide instances are not
    ported) only the first instances' sites.  Returns the grid."""
    grid = get_grid(fmt)
    scheme = get_scheme(mode)
    if scheme.needs_v:
        raise ValueError(f"{what}: {scheme.name} is not supported for GEMM "
                         "result rounding (no bias-direction operand)")
    if rand_bits not in (32, 16, 8):
        raise ValueError(f"{what}: rand_bits must be 32, 16 or 8")
    if not wide and gemm_instance(grid, mode, rand_bits, eps) == "wide":
        raise NotImplementedError(
            f"{what}: {_site(grid, mode, rand_bits, eps)} needs a wide "
            "instance, which the explicit-bits kernels do not have yet (they "
            "take rn, sr and sr_eps on plain FP grids with subnormals)")
    return grid


def _round_args(grid, mode: str, rand_bits: int, eps: float):
    f = grid.fmt
    return (f.precision, f.emin, f.emax, ctypes.c_float(f.xmax),
            common.SCHEME_CODES[get_scheme(mode).name], rand_bits,
            ctypes.c_float(eps))


def _site_array(grid, mode: str, rand_bits: int, eps: float = 0.0,
                enabled: bool = True, with_enabled: bool = False):
    """A first-instance rounding site as the GLU kernels' int array:
    {[enabled,] precision, emin, emax, mode, rand_bits, eps bits}, and its
    xmax."""
    if not enabled:
        vals, xmax = [0, 0, 0, 0, 32, 0], 0.0
    else:
        f = grid.fmt
        vals = [f.precision, f.emin, f.emax,
                common.SCHEME_CODES[get_scheme(mode).name], rand_bits,
                _float_bits(eps)]
        xmax = f.xmax
    if with_enabled:
        vals = [int(enabled)] + vals
    return (ctypes.c_int * len(vals))(*vals), ctypes.c_float(xmax)


def _wide_args(s: Optional[RoundingSpec]):
    """A site as the wide instances' (int[8], float[4]) row
    (``common.wide_row``); None is a disabled site."""
    ints, floats = common.wide_row(s if s is not None else spec())
    return (ctypes.c_int * 8)(*ints), (ctypes.c_float * 4)(*floats)


def _float_bits(v: float) -> int:
    return int(np.array(v, dtype=np.float32).view(np.int32))


def _code_arg(fmt):
    """A tensor's storage as the kernels' int[7] {bytes, ebits, mbits,
    emin, has_nf, xmax bits, xmin bits}; None (a null pointer) for
    float32."""
    if fmt is None:
        return None
    f = get_grid(fmt).fmt
    ebits, mbits, width, has_nf = common.pack_spec(fmt)
    return (ctypes.c_int * 7)(width, ebits, mbits, f.emin, int(has_nf),
                              _float_bits(f.xmax), _float_bits(f.xmin))


def _check_unsupported(bias, act, act_spec, overflow):
    if bias is not None:
        raise NotImplementedError("qmatmul bias epilogue is not ported yet")
    if act is not None or act_spec is not None:
        raise NotImplementedError("qmatmul activation epilogue is not "
                                  "ported yet (use qmatmul_swiglu*)")
    _check_overflow(overflow)


def _check_overflow(overflow: str) -> None:
    """A GEMM result site saturates at xmax: the reference's GEMM kernels
    take no ``overflow``, so a spec's overflow to ±inf is not theirs."""
    if overflow != "saturate":
        raise NotImplementedError(f"overflow={overflow!r}: the GEMM result "
                                  "sites saturate at xmax, as the "
                                  "reference's GEMM kernels do")


def _pack_grid(fmt, what: str):
    """The grid of a packed operand or output (raises ValueError for a
    grid wider than a 16-bit code word, as the reference's pack_spec)."""
    grid = get_grid(fmt)
    common.pack_spec(grid)
    if grid.kind != "fp" or grid.transformed:
        raise NotImplementedError(f"{what}: packed grid {grid.name!r} is "
                                  "not a plain FP grid")
    return grid


def _check_a(a: torch.Tensor, a_fmt, dims: int, what: str):
    """A float32 A, or code words of ``a_fmt``; returns a_fmt's grid."""
    if a_fmt is None:
        want = torch.float32
        grid = None
    else:
        grid = _pack_grid(a_fmt, what)
        want = common.pack_dtype(grid)
    if a.dim() != dims or a.dtype != want:
        raise ValueError(f"{what}: a must be a {dims}-D {want} tensor, got "
                         f"{tuple(a.shape)} {a.dtype}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {a.device}")
    return grid


def _check_weights(a: torch.Tensor, bs: Sequence[torch.Tensor], what: str):
    for b in bs:
        if b.dim() != a.dim() or b.shape[-2] != a.shape[-1] \
                or b.shape[:-2] != a.shape[:-2]:
            raise ValueError(f"{what}: shape mismatch {tuple(a.shape)} x "
                             f"{tuple(b.shape)}")
        if b.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{what}: b must be float32 or bfloat16, got "
                             f"{b.dtype}")
        if b.dtype != bs[0].dtype or b.shape != bs[0].shape:
            raise ValueError(f"{what}: weight operands must match")
        if b.device != a.device:
            raise ValueError(f"{what}: operands on different devices")


def _a_values(a: torch.Tensor, a_grid) -> torch.Tensor:
    """A as float32 values (code words decoded)."""
    return a.float() if a_grid is None else common.unpack_block(a, a_grid)


def _bits_words(bits: Optional[torch.Tensor], shape, device,
                what: str) -> Optional[torch.Tensor]:
    """A bits operand checked, as int64 uint32 values (CPU) or int32 bit
    patterns (card); None stays None."""
    if bits is None:
        return None
    if tuple(bits.shape) != tuple(shape) \
            or bits.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: bits must be int32/int64 {tuple(shape)}, "
                         f"got {bits.dtype} {tuple(bits.shape)}")
    if bits.device != device:
        raise ValueError(f"{what}: bits on another device than the "
                         "operands")
    if device.type == "cpu":
        return bits.to(torch.int64) & 0xFFFFFFFF
    return (bits if bits.dtype == torch.int32
            else int32_words(bits)).contiguous()


def _need_bits(stochastic: bool, what: str, *bits) -> None:
    if stochastic and any(b is None for b in bits):
        raise ValueError(f"{what}: a stochastic scheme needs the bits "
                         "operand")


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _emit(acc, bits, grid, mode: str, rand_bits: int, eps: float,
          out_packed: bool):
    """The twins' epilogue: round, then pack where asked."""
    y = common.round_block(acc, bits, grid, mode, eps, rand_bits=rand_bits)
    return common.pack_block(y, grid) if out_packed else y


# ---------------------------------------------------------------------------
# K3' / K3: rounded a @ b
# ---------------------------------------------------------------------------
def qmatmul_plain(a: torch.Tensor, b: torch.Tensor, seed_words: Words, fmt,
                  mode: str = "sr", rand_bits: int = 32, *, eps: float = 0.0,
                  a_fmt=None, out_packed: bool = False) -> torch.Tensor:
    """The plain twin of K3': fp32 GEMM, then round_block with the counter
    bits of the output's global (row, col), stream 0."""
    a_grid = None if a_fmt is None else get_grid(a_fmt)
    acc = _a_values(a, a_grid) @ b.float()
    bits = None
    if get_scheme(mode).stochastic:
        bits = common.counter_bits_reduced(
            seed_words[0], seed_words[1], tuple(acc.shape), rand_bits,
            stream=STREAM_FWD, device=acc.device)
    return _emit(acc, bits, get_grid(fmt), mode, rand_bits, eps, out_packed)


def qmatmul_bits_plain(a: torch.Tensor, b: torch.Tensor,
                       bits: Optional[torch.Tensor], fmt, mode: str = "sr",
                       rand_bits: int = 32, *, eps: float = 0.0, a_fmt=None,
                       out_packed: bool = False) -> torch.Tensor:
    """The plain twin of K3: fp32 GEMM, then round_block fed ``bits``
    (uint32 words in int64; the low ``rand_bits`` of each are used)."""
    a_grid = None if a_fmt is None else get_grid(a_fmt)
    acc = _a_values(a, a_grid) @ b.float()
    if bits is not None:
        bits = bits.to(torch.int64) & 0xFFFFFFFF
    return _emit(acc, bits if get_scheme(mode).stochastic else None,
                 get_grid(fmt), mode, rand_bits, eps, out_packed)


@functools.lru_cache(maxsize=None)
def _gemm_site_args(grid, mode: str, rand_bits: int, eps: float,
                    force_wide: bool):
    """(instance, round arguments) of a K3' or K8' result site: the
    instance ``gemm_instance`` picks (the wide one with ``force_wide``) and
    its C arguments, once per site."""
    if force_wide or gemm_instance(grid, mode, rand_bits, eps) == "wide":
        return "wide", _wide_args(_site(grid, mode, rand_bits, eps))
    return "fp", _round_args(grid, mode, rand_bits, eps)


def _qmatmul_launch(name: str, a, a_grid, b, bits, seed_words, grid, mode,
                    rand_bits, eps, out_packed):
    """One K3' (``qmatmul_sr``, on the instance ``gemm_instance`` picks)
    or K3 (``qmatmul_bits``) launch: the decode route for M <=
    ``DECODE_MAX_M``, else the large-M route."""
    M, K = a.shape
    N = b.shape[1]
    a, b = a.contiguous(), b.contiguous()
    out_dtype = common.pack_dtype(grid) if out_packed else torch.float32
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out                       # nothing to launch
    head = (a.data_ptr(), _code_arg(a_grid), b.data_ptr(),
            int(b.dtype == torch.bfloat16))
    tail = (M, N, K)
    out_arg = (out.data_ptr(), _code_arg(grid if out_packed else None))
    entry = name + ("_decode" if M <= DECODE_MAX_M else "")
    if name == "qmatmul_bits":
        args = (*head, _ptr(bits), *out_arg, *tail,
                *_round_args(grid, mode, rand_bits, eps))
    else:
        instance, rnd = _gemm_site_args(grid, mode, rand_bits, eps,
                                        FORCE_WIDE)
        if instance == "wide":
            entry = entry.replace(name, name + "_wide")
        args = (*head, *out_arg, *tail, seed_words[0], seed_words[1], *rnd)
    rc = getattr(_lib_qmatmul(), entry)(*args, _stream(a))
    _launch_check(rc, name)
    LAUNCHES[name] += 1
    if name == "qmatmul_sr":
        INSTANCE_LAUNCHES[name][instance] += 1
    return out


def qmatmul_prng(a: torch.Tensor, b: torch.Tensor, seed_words: Words, fmt,
                 mode: str = "sr", rand_bits: int = 32, *, eps: float = 0.0,
                 overflow: str = "saturate", bias=None, act=None,
                 act_spec=None, out_packed: bool = False, a_fmt=None
                 ) -> torch.Tensor:
    """Rounded ``a @ b`` (a: (M, K) float32, or code words of ``a_fmt``;
    b: (K, N) float32 or bf16); ``seed_words``: the (k0, k1) uint32 pair
    of this GEMM site.  Returns (M, N) float32 grid values, or their code
    words with ``out_packed``.  Every scheme x grid pair of the
    reference's ``round_block`` but those that need a bias direction:
    rn, sr and sr_eps on plain FP grids with subnormals on the first
    instance, the rest on the wide one (``gemm_instance``; ``FORCE_WIDE``
    takes the wide one for every site on the card)."""
    _check_unsupported(bias, act, act_spec, overflow)
    grid = _check_fmt_mode(fmt, mode, rand_bits, "qmatmul_prng", eps)
    a_grid = _check_a(a, a_fmt, 2, "qmatmul_prng")
    _check_weights(a, (b,), "qmatmul_prng")
    if out_packed:
        _pack_grid(grid, "qmatmul_prng")
    if a.device.type == "cpu":
        return qmatmul_plain(a, b, seed_words, grid, mode, rand_bits,
                             eps=eps, a_fmt=a_grid, out_packed=out_packed)
    return _qmatmul_launch("qmatmul_sr", a, a_grid, b, None, seed_words,
                           grid, mode, rand_bits, eps, out_packed)


def qmatmul(a: torch.Tensor, b: torch.Tensor, bits: Optional[torch.Tensor],
            fmt, mode: str = "sr", rand_bits: int = 32, *, eps: float = 0.0,
            overflow: str = "saturate", bias=None, act=None, act_spec=None,
            act_bits=None, out_packed: bool = False, a_fmt=None
            ) -> torch.Tensor:
    """K3: rounded ``a @ b`` with explicit bits, ``bits`` (M, N) uint32
    words (int64, or int32 bit patterns; None for a deterministic mode;
    with ``rand_bits < 32`` the low bits of each word).  Operands, options
    and result as :func:`qmatmul_prng`, on the first instance's sites
    alone."""
    _check_unsupported(bias, act, act_spec, overflow)
    if act_bits is not None:
        raise NotImplementedError("qmatmul act_bits: the activation "
                                  "epilogue is not ported yet")
    grid = _check_fmt_mode(fmt, mode, rand_bits, "qmatmul", eps, wide=False)
    a_grid = _check_a(a, a_fmt, 2, "qmatmul")
    _check_weights(a, (b,), "qmatmul")
    if out_packed:
        _pack_grid(grid, "qmatmul")
    stoch = get_scheme(mode).stochastic
    _need_bits(stoch, "qmatmul", bits)
    words = _bits_words(bits if stoch else None, (a.shape[0], b.shape[1]),
                        a.device, "qmatmul")
    if a.device.type == "cpu":
        return qmatmul_bits_plain(a, b, words, grid, mode, rand_bits,
                                  eps=eps, a_fmt=a_grid,
                                  out_packed=out_packed)
    return _qmatmul_launch("qmatmul_bits", a, a_grid, b, words, None, grid,
                           mode, rand_bits, eps, out_packed)


def _lib_qmatmul():
    lib = build.load("qmatmul_sr")
    if lib.qmatmul_sr.argtypes is None:
        c = ctypes
        head = [c.c_void_p, c.POINTER(c.c_int), c.c_void_p, c.c_int]
        out = [c.c_void_p, c.POINTER(c.c_int)]
        rnd = [c.c_int, c.c_int, c.c_int, c.c_float, c.c_int, c.c_int,
               c.c_float, c.c_void_p]
        wide = [c.POINTER(c.c_int), c.POINTER(c.c_float), c.c_void_p]
        sr = head + out + [c.c_int] * 3 + [c.c_uint32] * 2
        bits = head + [c.c_void_p] + out + [c.c_int] * 3 + rnd
        for fn, args in ((lib.qmatmul_sr, sr + rnd),
                         (lib.qmatmul_bits, bits),
                         (lib.qmatmul_sr_decode, sr + rnd),
                         (lib.qmatmul_bits_decode, bits),
                         (lib.qmatmul_sr_wide, sr + wide),
                         (lib.qmatmul_sr_wide_decode, sr + wide)):
            fn.argtypes = args
            fn.restype = c.c_int
    return lib


# ---------------------------------------------------------------------------
# K4' / K4: h = round_act(act(round(x@wg)) * round(x@wu))
# ---------------------------------------------------------------------------
def silu(g: torch.Tensor) -> torch.Tensor:
    """SiLU exactly as the kernel computes it: g * (1 / (1 + exp(-g))).
    On a bf16 tensor each operation rounds to bf16, which is how the
    reference's ``jax.nn.silu`` computes it op by op (``F.silu`` would
    round once): the MoE experts and the unfused FFN use it so."""
    return g * (1.0 / (1.0 + torch.exp(-g)))


def _mul(a: torch.Tensor, b, dtype: torch.dtype) -> torch.Tensor:
    """``a * b`` as XLA's CPU code computes it in ``dtype``: in float32
    with subnormal results flushed (the operands are flushed already),
    then rounded to ``dtype``."""
    return flush(a.float() * b).to(dtype)


def _add(a: torch.Tensor, b, dtype: torch.dtype) -> torch.Tensor:
    return flush(a.float() + b).to(dtype)


# jax.nn.gelu's constants: sqrt(2 / pi) cast to the input's dtype, 0.044715
# and 0.5 weakly typed (so also in the input's dtype)
_SQRT_2_OVER_PI = float(np.sqrt(2 / np.pi))
_GELU_K = 0.044715


def _in(v: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(v, dtype=dtype))


def _gelu_ops(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh form) as the reference computes
    it, op by op: ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))``
    with XLA's tanh (``core.xla_math.tanh_f32``) and flushes.  On float32
    (the GLU kernels' epilogue: jitted, so XLA fuses the inner sum into
    one multiply-add) ``x + 0.044715 * x**3`` is ``fma(0.044715, x**3,
    x)``; on bf16 (the unfused FFN under ``xla_allow_excess_precision =
    False``) every operation rounds to bf16 and the tanh runs in float32
    on the bf16 argument."""
    dt = g.dtype
    x = flush(g.float()).to(dt)
    x3 = _mul(_mul(x, x, dt), x.float(), dt)
    k = _in(_GELU_K, dt)
    if dt == torch.float32:
        inner = fma(torch.full_like(x, k), x3, x)
    else:
        inner = _add(x, _mul(x3, k, dt).float(), dt)
    t = tanh_f32(_mul(inner, _in(_SQRT_2_OVER_PI, dt), dt).float()).to(dt)
    return _mul(x, _mul(_add(t, 1.0, dt), 0.5, dt).float(), dt)


@functools.lru_cache(maxsize=None)
def _bf16_tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_gelu_ops`` of every bf16 value, and XLA's float32 tanh of it
    rounded to bf16, each indexed by the value's bit pattern + 2^15
    (computed once on the CPU)."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    return (_gelu_ops(x).to(device),
            tanh_f32(x.float()).to(torch.bfloat16).to(device))


def _bf16_lookup(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return table[x.contiguous().view(torch.int16).long() + 2 ** 15]


def gelu_pullback(g: torch.Tensor, ct: torch.Tensor):
    """(gelu(g), the cotangent of g) for the cotangent ``ct``:
    ``jax.vjp(jax.nn.gelu, g)`` as the reference's compiled code computes
    it, op by op in ``g``'s dtype, every operand and result flushed.  On
    float32 (the fused FFN's pullback at the rounded gate) XLA fuses
    three sums and folds two constants: with c = float32(sqrt(2 / pi)), t
    = tanh(fma(0.044715, x² x, x) c) and cdf = (t + 1) 0.5, m = ((x ct)
    0.5)(1 - t), a = fma(m, t, m), and the cotangent is fma(a k, x² 3,
    fma(ct, cdf, a c)), k = float32(c 0.044715).  On bf16 (the unfused
    FFN, compiled without excess precision) every operation rounds to
    bf16, constants too, nothing fuses, and the tanh runs in float32 on
    the bf16 argument: a lookup in a table of all 65,536 (no host sync on
    the card).  ``csrc/geglu_pullback.cu`` is the card's float32 form."""
    dt = g.dtype

    def r(v):            # one operation's result, rounded to dt
        return flush(v).to(dt).float()
    x, ct = r(g.float()), r(ct.float())
    c, k = _in(_SQRT_2_OVER_PI, dt), _in(_GELU_K, dt)
    x2 = r(x * x)
    x3 = r(x2 * x)
    if dt == torch.float32:
        t = tanh_f32(r(fma(k, x3, x) * c))
    else:
        t = _bf16_lookup(_bf16_tables(g.device)[1],
                         r(r(x + r(x3 * k)) * c).to(dt)).float()
    cdf = r(r(t + 1.0) * 0.5)
    m = r(r(r(x * ct) * 0.5) * r(1.0 - t))
    if dt == torch.float32:
        a = fma(m, t, m)
        dx = fma(r(a * float(np.float32(c) * np.float32(_GELU_K))),
                 r(x2 * 3.0), fma(ct, cdf, r(a * c)))
    else:
        ac = r(r(m + r(m * t)) * c)
        dx = r(r(r(ct * cdf) + ac) + r(r(ac * k) * r(x2 * 3.0)))
    return r(x * cdf).to(dt), dx.to(dt)


class _Gelu(torch.autograd.Function):
    """``gelu`` with the reference's derivative (``gelu_pullback``)."""

    @staticmethod
    def forward(ctx, g):
        ctx.save_for_backward(g)
        if g.dtype == torch.bfloat16:
            return _bf16_lookup(_bf16_tables(g.device)[0], g)
        return _gelu_ops(g)

    @staticmethod
    def backward(ctx, ct):
        (g,) = ctx.saved_tensors
        return gelu_pullback(g, ct)[1]


def gelu(g: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu`` (``_gelu_ops``), differentiable
    with its derivative (``gelu_pullback``); on bf16 by a lookup in
    ``_gelu_ops``' table of all 65,536 bf16 values, the same bits in one
    gather (the op-by-op form's fused multiply-adds would synchronise the
    card at every call).  ``csrc/rounding.cuh:gelu`` is the card's float32
    form."""
    return _Gelu.apply(g)


def relu(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.relu`` (``max(x, 0)``) as XLA's CPU code computes it: x
    where x is a positive normal number, NaN kept, else +0 (-0 and
    positive subnormals included: their comparison reads them as 0)."""
    keep = (g.float() >= _TINY) | torch.isnan(g)
    return torch.where(keep, g, torch.zeros_like(g))


def relu_sq(g: torch.Tensor) -> torch.Tensor:
    """``jnp.square(jax.nn.relu(x))``: relu's result times itself."""
    r = relu(g)
    return _mul(r, r.float(), g.dtype)


# the GLU kernels' activations, the reference's ACT_FNS
ACT_FNS = {"silu": silu, "gelu": gelu, "relu": relu, "relu_sq": relu_sq}


def _swiglu_emit(accg, accu, bg, bu, ab, grid, mode, rand_bits, eps,
                 act_spec: Optional[RoundingSpec], residuals: bool,
                 out_packed: bool, residuals_packed: bool, act: str):
    """The fused GLU epilogue of the twins: round both branches, the
    activation and product, the act site, then the storage of h and the
    residuals.  SiLU's product rounds as torch's; the other activations'
    is XLA's (its operands and result flushed)."""
    g_r = common.round_block(accg, bg, grid, mode, eps, rand_bits=rand_bits)
    u_r = common.round_block(accu, bu, grid, mode, eps, rand_bits=rand_bits)
    if act == "silu":
        h = silu(g_r) * u_r
    else:
        h = _mul(ACT_FNS[act](g_r), flush(u_r), torch.float32)
    if act_spec is not None:
        h = common.apply_spec_block(act_spec, h, ab)
        if out_packed:
            h = common.pack_block(h, act_spec.fmt)
    if not residuals:
        return h
    if residuals_packed:
        g_r, u_r = common.pack_block(g_r, grid), common.pack_block(u_r, grid)
    return h, g_r, u_r


def qmatmul_swiglu_plain(x: torch.Tensor, wg: torch.Tensor,
                         wu: torch.Tensor, seeds: Sequence[Words], fmt,
                         mode: str = "sr", rand_bits: int = 32,
                         act_spec: Optional[RoundingSpec] = None,
                         residuals: bool = False, out_packed: bool = False,
                         residuals_packed: bool = False, act: str = "silu",
                         eps: float = 0.0):
    """The plain twin of K4': h, or (h, g_r, u_r) with ``residuals``,
    drawing the counter bits of the three seed pairs."""
    x = x.float()
    accg = x @ wg.float()
    accu = x @ wu.float()
    shape, dev = tuple(accg.shape), accg.device
    bg = bu = ab = None
    if get_scheme(mode).stochastic:
        bg = common.counter_bits_reduced(*seeds[0], shape, rand_bits,
                                         stream=STREAM_FWD, device=dev)
        bu = common.counter_bits_reduced(*seeds[1], shape, rand_bits,
                                         stream=STREAM_FWD, device=dev)
    if act_spec is not None and act_spec.stochastic:
        ab = common.counter_bits_reduced(*seeds[2], shape,
                                         act_spec.rand_bits,
                                         stream=STREAM_ACT, device=dev)
    return _swiglu_emit(accg, accu, bg, bu, ab, get_grid(fmt), mode,
                        rand_bits, eps, act_spec, residuals, out_packed,
                        residuals_packed, act)


def qmatmul_swiglu_bits_plain(x: torch.Tensor, wg: torch.Tensor,
                              wu: torch.Tensor, bits_g, bits_u, fmt,
                              mode: str = "sr", rand_bits: int = 32,
                              act_spec: Optional[RoundingSpec] = None,
                              act_bits=None, residuals: bool = False,
                              out_packed: bool = False,
                              residuals_packed: bool = False,
                              act: str = "silu", eps: float = 0.0):
    """The plain twin of K4: as :func:`qmatmul_swiglu_plain` with the
    given (M, N) words for the gate, the up branch and the act site."""
    x = x.float()
    accg = x @ wg.float()
    accu = x @ wu.float()
    stoch = get_scheme(mode).stochastic

    def words(b):
        return None if b is None else b.to(torch.int64) & 0xFFFFFFFF
    return _swiglu_emit(accg, accu, words(bits_g) if stoch else None,
                        words(bits_u) if stoch else None, words(act_bits),
                        get_grid(fmt), mode, rand_bits, eps, act_spec,
                        residuals, out_packed, residuals_packed, act)


def _check_swiglu(x, wg, wu, fmt, mode, act, act_spec, rand_bits, eps,
                  overflow, out_packed, residuals_packed, what,
                  wide: bool = True):
    """The checks both GLU flavours share (``wide``: K4' takes every site
    its wide instance rounds, K4 the first instance's alone); returns
    (grid, act_spec or None, act grid or None)."""
    if act not in ACT_FNS:
        raise ValueError(f"unknown GLU activation {act!r}; known: "
                         f"{sorted(ACT_FNS)}")
    _check_overflow(overflow)
    grid = _check_fmt_mode(fmt, mode, rand_bits, what, eps, wide)
    act_grid = None
    if act_spec is not None and act_spec.is_identity:
        act_spec = None
    if act_spec is not None:
        if act_spec.scheme.needs_v:
            raise ValueError(f"{what}: {act_spec.mode} is not supported for "
                             "the activation rounding site (no "
                             "bias-direction operand)")
        act_grid = _check_fmt_mode(act_spec.fmt, act_spec.mode,
                                   act_spec.rand_bits, "act_spec")
        if not wide and not common.fp_site(act_spec):
            raise NotImplementedError(
                f"{what}: act_spec {act_spec} needs a wide instance, which "
                "the explicit-bits kernels do not have yet")
    if out_packed:
        if act_spec is None:
            raise ValueError("out_packed with an activation requires a "
                             "non-identity act_spec (the packed values "
                             "must land on a rounding grid)")
        _pack_grid(act_grid, what)
    if residuals_packed:
        _pack_grid(grid, what)
    _check_a(x, None, 2, what)
    _check_weights(x, (wg, wu), what)
    return grid, act_spec, act_grid


def swiglu_instance(fmt, mode: str, rand_bits: int = 32, eps: float = 0.0,
                    act_spec: Optional[RoundingSpec] = None) -> str:
    """The compiled instance of K4' (``GEMM_INSTANCES``) a call runs:
    "wide" where its GEMM site (``gemm_instance``) or its act site is not
    the first instance's (an act site may overflow to ±inf: the
    reference's act site rounds as its spec says), else "fp"."""
    if act_spec is not None and not common.fp_site(act_spec):
        return "wide"
    return gemm_instance(fmt, mode, rand_bits, eps)


@functools.lru_cache(maxsize=None)
def _swiglu_site_args(name: str, grid, mode: str, rand_bits: int,
                      eps: float, act_spec: Optional[RoundingSpec],
                      force_wide: bool):
    """(instance, the GEMM and act sites' C arguments) of a K4' or K4
    launch: the instance ``swiglu_instance`` picks for K4' (the wide one
    with ``force_wide``), the first for K4; once per site pair."""
    instance = "fp"
    if name == "qmatmul_swiglu_sr" and (force_wide or swiglu_instance(
            grid, mode, rand_bits, eps, act_spec) == "wide"):
        instance = "wide"
    if instance == "wide":
        return instance, (*_wide_args(_site(grid, mode, rand_bits, eps)),
                          *_wide_args(act_spec))
    if act_spec is not None:
        return instance, (
            *_site_array(grid, mode, rand_bits, eps),
            *_site_array(get_grid(act_spec.fmt), act_spec.mode,
                         act_spec.rand_bits, act_spec.eps, with_enabled=True))
    return instance, (*_site_array(grid, mode, rand_bits, eps),
                      *_site_array(None, "rn", 32, enabled=False,
                                   with_enabled=True))


def _swiglu_launch(name: str, x, wg, wu, bits3, seeds, grid, mode,
                   rand_bits, eps, act_spec, act_grid, residuals, out_packed,
                   residuals_packed, act):
    """One K4' (``qmatmul_swiglu_sr``, on the instance ``swiglu_instance``
    picks) or K4 (``qmatmul_swiglu_bits``) launch: the decode route for M
    <= ``DECODE_MAX_M``, else the large-M route; the activation's own
    library (``_swiglu_source``)."""
    M, K = x.shape
    N = wg.shape[1]
    x, wg, wu = x.contiguous(), wg.contiguous(), wu.contiguous()
    h_dtype = common.pack_dtype(act_grid) if out_packed else torch.float32
    r_dtype = common.pack_dtype(grid) if residuals_packed else torch.float32
    outs = [torch.empty((M, N), dtype=h_dtype, device=x.device)]
    if residuals:
        outs += [torch.empty((M, N), dtype=r_dtype, device=x.device)
                 for _ in range(2)]
    result = tuple(outs) if residuals else outs[0]
    if outs[0].numel() == 0:
        return result                    # nothing to launch
    res_ptrs = (outs[1].data_ptr(), outs[2].data_ptr()) if residuals \
        else (None, None)
    instance, sites = _swiglu_site_args(name, grid, mode, rand_bits, eps,
                                        act_spec, FORCE_WIDE)
    head = (x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            int(wg.dtype == torch.bfloat16))
    tail = (outs[0].data_ptr(), _code_arg(act_grid if out_packed else None),
            *res_ptrs, _code_arg(grid if residuals_packed else None),
            M, N, K, *sites, _stream(x))
    entry = name + ("_wide" if instance == "wide" else "") \
        + ("_decode" if M <= DECODE_MAX_M else "")
    fn = getattr(_lib_swiglu(act), entry)
    if name == "qmatmul_swiglu_sr":
        words = (ctypes.c_uint32 * 6)(*[w & 0xFFFFFFFF for pair in seeds
                                        for w in pair])
        rc = fn(*head, words, *tail)
    else:
        rc = fn(*head, *(_ptr(b) for b in bits3), *tail)
    _launch_check(rc, name)
    LAUNCHES[name] += 1
    ACT_LAUNCHES[act] += 1
    if name == "qmatmul_swiglu_sr":
        INSTANCE_LAUNCHES[name][instance] += 1
    return result


def qmatmul_swiglu_prng(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                        seeds: Sequence[Words], fmt, mode: str = "sr", *,
                        act: str = "silu",
                        act_spec: Optional[RoundingSpec] = None,
                        rand_bits: int = 32, eps: float = 0.0,
                        overflow: str = "saturate", out_packed: bool = False,
                        residuals: bool = False,
                        residuals_packed: bool = False):
    """Fused GLU-FFN prefix (K4'): x (M, K) float32, wg/wu (K, N) float32
    or bf16; ``seeds``: the gate, up and activation-site (k0, k1) pairs.
    Returns h (M, N), or with ``residuals`` the tuple (h, g_r, u_r): the
    rounded gate and up branches the backward needs.  h is float32, or
    code words of the act grid with ``out_packed``; g_r/u_r float32, or
    code words of ``fmt`` with ``residuals_packed``.  The instance as
    ``swiglu_instance`` picks (``FORCE_WIDE``: the wide one on the
    card)."""
    if len(seeds) != 3:
        raise ValueError("seeds must hold three (k0, k1) pairs")
    grid, act_spec, act_grid = _check_swiglu(
        x, wg, wu, fmt, mode, act, act_spec, rand_bits, eps, overflow,
        out_packed, residuals_packed, "qmatmul_swiglu_prng")
    if x.device.type == "cpu":
        return qmatmul_swiglu_plain(x, wg, wu, seeds, grid, mode, rand_bits,
                                    act_spec, residuals, out_packed,
                                    residuals_packed, act, eps)
    return _swiglu_launch("qmatmul_swiglu_sr", x, wg, wu, None, seeds, grid,
                          mode, rand_bits, eps, act_spec, act_grid,
                          residuals, out_packed, residuals_packed, act)


def qmatmul_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   bits_g: Optional[torch.Tensor],
                   bits_u: Optional[torch.Tensor], fmt, mode: str = "sr", *,
                   act: str = "silu",
                   act_spec: Optional[RoundingSpec] = None, act_bits=None,
                   rand_bits: int = 32, eps: float = 0.0,
                   overflow: str = "saturate", out_packed: bool = False,
                   residuals: bool = False, residuals_packed: bool = False):
    """K4: the fused GLU-FFN prefix with explicit bits: ``bits_g`` and
    ``bits_u`` (M, N) uint32 words for the two GEMM-result roundings (None
    for a deterministic mode), ``act_bits`` (M, N) for a stochastic act
    site.  Operands, options and result as :func:`qmatmul_swiglu_prng`."""
    what = "qmatmul_swiglu"
    grid, act_spec, act_grid = _check_swiglu(
        x, wg, wu, fmt, mode, act, act_spec, rand_bits, eps, overflow,
        out_packed, residuals_packed, what, wide=False)
    shape = (x.shape[0], wg.shape[1])
    stoch = get_scheme(mode).stochastic
    act_stoch = act_spec is not None and act_spec.stochastic
    _need_bits(stoch, what, bits_g, bits_u)
    if act_stoch and act_bits is None:
        raise ValueError("stochastic act_spec in explicit-bits mode "
                         "requires act_bits")
    bits3 = [_bits_words(b, shape, x.device, what)
             for b in (bits_g if stoch else None, bits_u if stoch else None,
                       act_bits if act_stoch else None)]
    if x.device.type == "cpu":
        return qmatmul_swiglu_bits_plain(x, wg, wu, bits3[0], bits3[1], grid,
                                         mode, rand_bits, act_spec, bits3[2],
                                         residuals, out_packed,
                                         residuals_packed, act, eps)
    return _swiglu_launch("qmatmul_swiglu_bits", x, wg, wu, bits3, None,
                          grid, mode, rand_bits, eps, act_spec, act_grid,
                          residuals, out_packed, residuals_packed, act)


def _swiglu_source(act: str) -> str:
    """The CUDA source (and library) of ``act``'s GLU kernels."""
    return "qmatmul_swiglu_sr" if act == "silu" else f"qmatmul_swiglu_{act}"


def _lib_swiglu(act: str = "silu"):
    lib = build.load(_swiglu_source(act))
    if lib.qmatmul_swiglu_sr.argtypes is None:
        c = ctypes
        ints = c.POINTER(c.c_int)
        head = [c.c_void_p] * 3 + [c.c_int]
        floats = c.POINTER(c.c_float)
        out = [c.c_void_p, ints, c.c_void_p, c.c_void_p, ints] + [c.c_int] * 3
        tail = out + [ints, c.c_float, ints, c.c_float, c.c_void_p]
        wide = out + [ints, floats, ints, floats, c.c_void_p]
        sr = head + [c.POINTER(c.c_uint32)]
        bits = head + [c.c_void_p] * 3 + tail
        for fn, args in ((lib.qmatmul_swiglu_sr, sr + tail),
                         (lib.qmatmul_swiglu_bits, bits),
                         (lib.qmatmul_swiglu_sr_decode, sr + tail),
                         (lib.qmatmul_swiglu_bits_decode, bits),
                         (lib.qmatmul_swiglu_sr_wide, sr + wide),
                         (lib.qmatmul_swiglu_sr_wide_decode, sr + wide)):
            fn.argtypes = args
            fn.restype = c.c_int
    return lib


# ---------------------------------------------------------------------------
# K8' / K8: rounded a[e] @ b[e]
# ---------------------------------------------------------------------------
def qmatmul_batched_plain(a: torch.Tensor, b: torch.Tensor, seeds, fmt,
                          mode: str = "sr", rand_bits: int = 32, *,
                          eps: float = 0.0, a_fmt=None,
                          out_packed: bool = False) -> torch.Tensor:
    """The plain twin of K8': a batched fp32 GEMM, then round_block fed
    slice e's counter bits from ``seeds[e]`` at within-slice (row, col),
    stream 0 (``common.counter_bits_batch``)."""
    a_grid = None if a_fmt is None else get_grid(a_fmt)
    acc = torch.bmm(_a_values(a, a_grid), b.float())
    bits = None
    if get_scheme(mode).stochastic:
        bits = common.counter_bits_batch(_host_seeds(seeds, acc.shape[0]),
                                         tuple(acc.shape), rand_bits,
                                         stream=STREAM_FWD,
                                         device=acc.device)
    return _emit(acc, bits, get_grid(fmt), mode, rand_bits, eps, out_packed)


def qmatmul_batched_bits_plain(a: torch.Tensor, b: torch.Tensor, bits,
                               fmt, mode: str = "sr", rand_bits: int = 32,
                               *, eps: float = 0.0, a_fmt=None,
                               out_packed: bool = False) -> torch.Tensor:
    """The plain twin of K8: a batched fp32 GEMM, then round_block fed the
    (E, M, N) ``bits``."""
    a_grid = None if a_fmt is None else get_grid(a_fmt)
    acc = torch.bmm(_a_values(a, a_grid), b.float())
    if bits is not None:
        bits = bits.to(torch.int64) & 0xFFFFFFFF
    return _emit(acc, bits if get_scheme(mode).stochastic else None,
                 get_grid(fmt), mode, rand_bits, eps, out_packed)


def _host_seeds(seeds, E: int) -> np.ndarray:
    """Per-slice seed words as an (E, 2) int64 array of uint32 values."""
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.cpu().numpy()
    arr = np.asarray(seeds, dtype=np.int64) & 0xFFFFFFFF
    if arr.shape != (E, 2):
        raise ValueError(f"seeds must be ({E}, 2) uint32 words, got "
                         f"{arr.shape}")
    return arr


def _check_batched(a, b, a_fmt, fmt, mode, rand_bits, eps, out_packed, what,
                   wide: bool = True):
    grid = _check_fmt_mode(fmt, mode, rand_bits, what, eps, wide)
    a_grid = _check_a(a, a_fmt, 3, what)
    _check_weights(a, (b,), what)
    if out_packed:
        _pack_grid(grid, what)
    E, M, _ = a.shape
    rows = _BATCHED_TILE_ROWS[batched_route(M)]
    if a.device.type == "cuda" and (E > 65535 or -(-M // rows) > 65535):
        raise ValueError(f"{what}: E={E}, M={M} exceed the kernel's grid")
    return grid, a_grid


def batched_route(M: int) -> str:
    """The route a K8'/K8 call of M rows per slice takes: "stream" (the
    weight-stream route) or "large" (the large-M route)."""
    return "stream" if M <= BATCHED_STREAM_MAX_M else "large"


def _batched_launch(name: str, a, a_grid, b, bits, seeds, grid, mode,
                    rand_bits, eps, out_packed):
    """One K8' (``qmatmul_batched_sr``, on the instance ``gemm_instance``
    picks) or K8 (``qmatmul_batched_bits``) launch on the route
    ``batched_route`` picks."""
    E, M, K = a.shape
    N = b.shape[2]
    a, b = a.contiguous(), b.contiguous()
    out_dtype = common.pack_dtype(grid) if out_packed else torch.float32
    out = torch.empty((E, M, N), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out                       # nothing to launch
    head = (a.data_ptr(), _code_arg(a_grid), b.data_ptr(),
            int(b.dtype == torch.bfloat16))
    tail = (out.data_ptr(), _code_arg(grid if out_packed else None), E, M, N,
            K)
    if name == "qmatmul_batched_sr":
        instance, rnd = _gemm_site_args(grid, mode, rand_bits, eps,
                                        FORCE_WIDE)
        dev_seeds = common.host_to_device(
            seeds.astype(np.uint32).view(np.int32), a.device)
        operand = dev_seeds.data_ptr()
    else:
        instance, rnd = "fp", _round_args(grid, mode, rand_bits, eps)
        operand = _ptr(bits)
    entry = name + ("_wide" if instance == "wide" else "") + (
        "_stream" if batched_route(M) == "stream" else "")
    rc = getattr(_lib_batched(), entry)(*head, operand, *tail, *rnd,
                                        _stream(a))
    _launch_check(rc, name)
    LAUNCHES[name] += 1
    if name == "qmatmul_batched_sr":
        INSTANCE_LAUNCHES[name][instance] += 1
    return out


def qmatmul_batched_prng(a: torch.Tensor, b: torch.Tensor, seeds, fmt,
                         mode: str = "sr", rand_bits: int = 32, *,
                         eps: float = 0.0, overflow: str = "saturate",
                         act=None, act_spec=None, out_packed: bool = False,
                         a_fmt=None) -> torch.Tensor:
    """Rounded ``a[e] @ b[e]`` for every slice e (a: (E, M, K) float32, or
    code words of ``a_fmt``; b: (E, K, N) float32 or bf16); ``seeds``: (E,
    2) uint32 words, one pair per slice (numpy array or tensor;
    ``policy.slice_words``).  Returns (E, M, N) float32 grid values, or
    their code words with ``out_packed``.  Sites and instances as
    :func:`qmatmul_prng`'s."""
    _check_unsupported(None, act, act_spec, overflow)
    grid, a_grid = _check_batched(a, b, a_fmt, fmt, mode, rand_bits, eps,
                                  out_packed, "qmatmul_batched_prng")
    host = _host_seeds(seeds, a.shape[0])
    if a.device.type == "cpu":
        return qmatmul_batched_plain(a, b, host, grid, mode, rand_bits,
                                     eps=eps, a_fmt=a_grid,
                                     out_packed=out_packed)
    return _batched_launch("qmatmul_batched_sr", a, a_grid, b, None, host,
                           grid, mode, rand_bits, eps, out_packed)


def qmatmul_batched(a: torch.Tensor, b: torch.Tensor,
                    bits: Optional[torch.Tensor], fmt, mode: str = "sr",
                    rand_bits: int = 32, *, eps: float = 0.0,
                    overflow: str = "saturate", act=None, act_spec=None,
                    act_bits=None, out_packed: bool = False, a_fmt=None
                    ) -> torch.Tensor:
    """K8: rounded ``a[e] @ b[e]`` with explicit bits, ``bits`` (E, M, N)
    uint32 words, one plane per slice (None for a deterministic mode).
    Operands, options and result as :func:`qmatmul_batched_prng`, on the
    first instance's sites alone."""
    _check_unsupported(None, act, act_spec, overflow)
    if act_bits is not None:
        raise NotImplementedError("qmatmul_batched act_bits: the "
                                  "activation epilogue is not ported yet")
    grid, a_grid = _check_batched(a, b, a_fmt, fmt, mode, rand_bits, eps,
                                  out_packed, "qmatmul_batched", wide=False)
    stoch = get_scheme(mode).stochastic
    _need_bits(stoch, "qmatmul_batched", bits)
    words = _bits_words(bits if stoch else None,
                        (a.shape[0], a.shape[1], b.shape[2]), a.device,
                        "qmatmul_batched")
    if a.device.type == "cpu":
        return qmatmul_batched_bits_plain(a, b, words, grid, mode, rand_bits,
                                          eps=eps, a_fmt=a_grid,
                                          out_packed=out_packed)
    return _batched_launch("qmatmul_batched_bits", a, a_grid, b, words,
                           None, grid, mode, rand_bits, eps, out_packed)


def _lib_batched():
    lib = build.load("qmatmul_batched_sr")
    if lib.qmatmul_batched_sr.argtypes is None:
        c = ctypes
        ints = c.POINTER(c.c_int)
        head = ([c.c_void_p, ints, c.c_void_p, c.c_int, c.c_void_p,
                 c.c_void_p, ints] + [c.c_int] * 4)
        rnd = [c.c_int, c.c_int, c.c_int, c.c_float, c.c_int, c.c_int,
               c.c_float, c.c_void_p]
        wide = [ints, c.POINTER(c.c_float), c.c_void_p]
        for fn, args in ((lib.qmatmul_batched_sr, head + rnd),
                         (lib.qmatmul_batched_bits, head + rnd),
                         (lib.qmatmul_batched_sr_stream, head + rnd),
                         (lib.qmatmul_batched_bits_stream, head + rnd),
                         (lib.qmatmul_batched_sr_wide, head + wide),
                         (lib.qmatmul_batched_sr_wide_stream, head + wide)):
            fn.argtypes = args
            fn.restype = c.c_int
    return lib
