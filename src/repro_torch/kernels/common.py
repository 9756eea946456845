"""Shared rounding math and counter-based random bits, plain PyTorch
(counterpart of ``repro.kernels.common``).

These are the plain versions of what the CUDA kernels compute in their
epilogues (``csrc/rounding.cuh``): ``round_block`` is the block rounding
the kernels apply to a GEMM result, and ``counter_bits_reduced`` the random
words they draw.  The words are those the reference draws in interpret
mode: element (r, c) of an output takes word ``c % 2`` of
``threefry(k0, k1 + 0x9E3779B9 * stream, r, c // 2)`` keyed by its global
(row, col), so they do not depend on how the output is tiled.  (The
reference's TPU hardware-PRNG branches have no counterpart: the port always
draws these counter bits, which makes it bit-comparable with the
reference.)  The eq.-8 update draws per element instead
(``kernel_bits3``): both words of ``threefry(k0, k1 + 0x9E3779B9 * stream,
row, col)`` on the flat (rows, 128) layout, element n at
(n // 128, n % 128).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.grids import get_grid
from repro_torch.core.prng import M32, threefry2x32_tensor as threefry2x32
from repro_torch.core.rounding import (RoundingSpec, _ceil_from_decompose,
                                       _exact_scale, _finish, _flush_tiny,
                                       _uniform_from_bits,
                                       magnitude_decompose)
from repro_torch.core.schemes import get_scheme

GOLDEN = 0x9E3779B9          # stream offsets fold into the Threefry key

# The kernels' scheme codes (``csrc/rounding.cuh``'s ``Mode``): sr2 and the
# bit trick are SR with another draw (``RANDOMNESS``, ``rounding.cuh``'s
# ``Randomness`` by scheme randomness; 3 is the bit trick's integer path on
# bfloat16 at r = 16)
SCHEME_CODES = {"rn": 0, "sr": 1, "sr_eps": 2, "signed_sr_eps": 3, "rz": 4,
                "ra": 5, "rd": 6, "ru": 7, "sr2": 1, "sr_bittrick": 1}
RANDOMNESS = {"none": 0, "uniform": 0, "comparison": 1, "bittrick": 2}
# the schemes of ``rounding.cuh``'s ``round_value`` (the kernels' first
# instances; their wide instances take every scheme)
FP_SCHEMES = ("rn", "sr", "sr_eps", "signed_sr_eps")


def round_block(x: torch.Tensor, bits: Optional[torch.Tensor], fmt, mode,
                eps: float = 0.0, v: Optional[torch.Tensor] = None,
                rand_bits: int = 32, overflow: str = "saturate"
                ) -> torch.Tensor:
    """Round a block of float32 values; the same math as round_to_format,
    with the reference kernels' two fast paths (bf16 bit-trick SR and
    pure SR), each bit-identical to the generic rule."""
    grid = get_grid(fmt)
    scheme = get_scheme(mode)
    fmt = grid.fmt
    x = x.float()
    z = _flush_tiny(grid.to_grid(x))

    if (scheme.randomness == "bittrick" and bits is not None
            and not grid.transformed and fmt.name == "bfloat16"
            and rand_bits == 16):
        # add 16 random bits to the float32 word, keep the top 16: the
        # carry out of the low half is the round-up event
        zb = z.contiguous().view(torch.int32).to(torch.int64) & M32
        r = (zb + (bits & 0xFFFF)) & 0xFFFF0000
        r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32)
        out = r.view(torch.float32)
        if overflow != "inf":
            out = torch.where(torch.isfinite(out), out,
                              torch.sign(z) * fmt.xmax)
        return torch.where(torch.isfinite(x), out, x)

    floor_mag, quantum, frac, fy = magnitude_decompose(z, fmt)
    sign_x = torch.sign(z)
    if bits is None:
        u = torch.full_like(x, 0.5)
    else:
        u = _uniform_from_bits(bits, rand_bits, scheme.randomness)

    if scheme.p_up_is_frac and fmt.quantum_min_exp >= -126:
        # pure-SR fast path: ceil = floor + quantum exactly, and the
        # frac == 0 fix-up is a no-op (u >= 0 never rounds up)
        mag = torch.where(u < frac, floor_mag + quantum, floor_mag)
    else:
        ceil_mag = _ceil_from_decompose(z, fy, fmt)
        sign_v = torch.sign(v.float()) if v is not None \
            else torch.zeros_like(z)
        p_up = scheme.p_up(frac, fy, sign_x, eps, sign_v)
        mag = torch.where(u < p_up, ceil_mag, floor_mag)
        mag = torch.where(frac == 0.0, torch.abs(z), mag)
    return _finish(x, z, mag, sign_x, grid, overflow)


def apply_spec_block(spec: RoundingSpec, x: torch.Tensor,
                     bits: Optional[torch.Tensor], v=None) -> torch.Tensor:
    """RoundingSpec-dispatched block rounding (identity-aware)."""
    if spec.is_identity:
        return x.float()
    return round_block(x, bits if spec.stochastic else None, spec.fmt,
                       spec.mode, spec.eps, v=v, rand_bits=spec.rand_bits,
                       overflow=spec.overflow)


def fp_site(s: RoundingSpec) -> bool:
    """Whether a site is one ``rounding.cuh``'s ``round_value`` rounds
    (the kernels' first instances): an identity site, or rn, sr, sr_eps or
    signed-SRe on a plain FP grid with subnormals, saturating.  Every
    other site needs a kernel's wide instance (``round_value_wide``)."""
    if s.is_identity:
        return True
    grid = get_grid(s.fmt)
    return (grid.kind == "fp" and not grid.transformed
            and grid.fmt.subnormals and s.scheme.name in FP_SCHEMES
            and s.overflow == "saturate")


def wide_flags(s: RoundingSpec) -> int:
    """Slot 7 of a wide site row (``rounding.cuh``'s ``wide_params``):
    bits 0-1 the draw (``RANDOMNESS``; 3: the bit trick's integer path,
    taken as the reference's ``round_block`` takes it), bit 2 overflow to
    ±inf, bit 3 no subnormals, bit 4 a shifted grid, bit 5 a fixed-point
    grid.  0 for every site of the first instances (``fp_site``)."""
    grid = get_grid(s.fmt)
    flags = RANDOMNESS[s.scheme.randomness]
    if s.scheme.randomness == "bittrick" and not grid.transformed \
            and grid.fmt.name == "bfloat16" and s.rand_bits == 16:
        flags = 3
    return (flags | 4 * (s.overflow == "inf") | 8 * (not grid.fmt.subnormals)
            | 16 * grid.transformed | 32 * (grid.kind == "fxp"))


def wide_row(s: RoundingSpec, v_source: int = 0):
    """A site as the kernels' wide row: ([enabled, precision, emin, emax,
    mode, rand_bits, v source, flags], [xmax, eps, scale, mu]); an
    identity site is disabled (zeros, scale 1).  The update kernels (K2',
    K2: three rows a chain) and the wide instances of K3', K4', K8' and K1'
    read it (``rounding.cuh``'s ``wide_params``)."""
    if s.is_identity:
        return [0] * 8, [0.0, 0.0, 1.0, 0.0]
    grid = get_grid(s.fmt)
    f = grid.fmt
    return ([1, f.precision, f.emin, f.emax, SCHEME_CODES[s.scheme.name],
             s.rand_bits, v_source, wide_flags(s)],
            [f.xmax, s.eps, grid.scale, grid.mu])


def _stream_key(k1: int, stream: int) -> int:
    return (k1 + GOLDEN * stream) & M32


def counter_bits(k0: int, k1: int, shape: Tuple[int, int], row0: int = 0,
                 col0: int = 0, stream: int = 0, device=None
                 ) -> torch.Tensor:
    """One uint32 word (in int64) per element of a 2-D block at global
    offset (row0, col0): Threefry over column *pairs* (row, col // 2),
    both output words consumed (``repro.kernels.common._interleaved_words``).
    """
    rows, cols = shape
    off = col0 % 2
    n_pairs = (off + cols + 1) // 2
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None] + row0
    c = torch.arange(n_pairs, dtype=torch.int64, device=device)[None, :] \
        + col0 // 2
    r, c = torch.broadcast_tensors(r, c)
    x0, x1 = threefry2x32(k0 & M32, _stream_key(k1, stream), r, c)
    inter = torch.stack([x0, x1], dim=-1).reshape(rows, 2 * n_pairs)
    return inter[:, off:off + cols]


def counter_bits_pair(k0: int, k1: int, shape: Tuple[int, int],
                      row0: int = 0, col0: int = 0, stream: int = 0,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both Threefry words of ``threefry(k0, k1 + GOLDEN * stream, row,
    col)`` for each element of a 2-D block at global offset (row0, col0):
    two independent planes keyed by the element's own (row, col), not by
    column pairs (``repro.kernels.common.counter_bits_pair``)."""
    rows, cols = shape
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None] + row0
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :] + col0
    r, c = torch.broadcast_tensors(r, c)
    return threefry2x32(k0 & M32, _stream_key(k1, stream), r, c)


def kernel_bits3(words: Tuple[int, int], shape: Tuple[int, int], row0: int,
                 need: Tuple[bool, bool, bool], device=None):
    """The eq.-8 update's three bit planes, ``None`` where a step is
    deterministic (``repro.kernels.common.kernel_bits3``, interpret path):
    the stochastic steps take, in order, word 0 of pair stream 0, word 1 of
    it, then word 0 of pair stream 1."""
    out = [None, None, None]
    pair, drawn = None, 0
    for i, n in enumerate(need):
        if not n:
            continue
        if pair is None:
            pair = counter_bits_pair(words[0], words[1], shape, row0=row0,
                                     stream=drawn, device=device)
            drawn += 1
            out[i] = pair[0]
        else:
            out[i] = pair[1]
            pair = None
    return out


def counter_bits_reduced(k0: int, k1: int, shape: Tuple[int, int],
                         rand_bits: int, row0: int = 0, col0: int = 0,
                         stream: int = 0, device=None) -> torch.Tensor:
    """``rand_bits``-bit fields, ``32 / rand_bits`` columns per word: the
    word grid is keyed by global (row, col // ratio), element (r, c) takes
    field ``c % ratio`` (low bits of the result).  ``rand_bits == 32`` is
    exactly :func:`counter_bits`."""
    if rand_bits == 32:
        return counter_bits(k0, k1, shape, row0, col0, stream, device)
    ratio = 32 // rand_bits
    rows, cols = shape
    off = col0 % ratio
    n_words = (off + cols + ratio - 1) // ratio
    words = counter_bits(k0, k1, (rows, n_words), row0, col0 // ratio,
                         stream, device)
    rep = torch.repeat_interleave(words, ratio, dim=-1)[:, off:off + cols]
    sub = (torch.arange(cols, dtype=torch.int64, device=device) + off) \
        % ratio
    return (rep >> (sub * rand_bits)) & ((1 << rand_bits) - 1)


def element_bits(k0, k1, rows, cols, rand_bits: int, stream: int = 0):
    """The random field of each element at global (row, col), computed
    element by element as the CUDA kernels do (``element_bits`` in
    ``csrc/rounding.cuh``): word ``c' % 2`` of ``threefry(k0, k1 + GOLDEN *
    stream, row, c' // 2)`` with ``c' = col // ratio``, then field
    ``col % ratio`` of it (``ratio = 32 // rand_bits``).  The same values as
    :func:`counter_bits_reduced` on any block.  Works on int64 torch
    tensors or numpy arrays; ``k0``/``k1`` (ints or per-slice arrays),
    ``rows`` and ``cols`` broadcast."""
    ratio = 32 // rand_bits
    wc = cols // ratio
    x0, x1 = threefry2x32(k0, (k1 + GOLDEN * stream) & M32, rows, wc >> 1)
    w = x0 + (x1 - x0) * (wc & 1)
    if rand_bits == 32:
        return w
    return (w >> ((cols % ratio) * rand_bits)) & ((1 << rand_bits) - 1)


def counter_bits_batch(words, shape: Tuple[int, int, int], rand_bits: int,
                       stream: int = 0, device=None) -> torch.Tensor:
    """Per-slice counter bits of an (E, rows, cols) block
    (``repro.kernels.common.counter_bits_batch``): slice ``e`` draws
    exactly :func:`counter_bits_reduced` of its own seed pair
    ``words[e]`` at within-slice coordinates, so a batched result is
    recomputable slice by slice.  ``words``: (E, 2) uint32 values (numpy
    array, tensor or nested sequence)."""
    E, rows, cols = shape
    w = torch.as_tensor(np.asarray(words, dtype=np.int64).reshape(E, 2),
                        device=device)
    r = torch.arange(rows, dtype=torch.int64, device=device)[None, :, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, None, :]
    return element_bits(w[:, 0, None, None], w[:, 1, None, None], r, c,
                        rand_bits, stream)


LANES = 128                  # the flat 128-lane layout of the sr_cast family


def lane_bits(k0: int, k1: int, n: int, rand_bits: int,
              device=None) -> torch.Tensor:
    """The random fields of a flat tensor of ``n`` elements under the
    sr_cast kernels' layout (``repro.kernels.sr_cast.sr_cast_prng_p``):
    the tensor is laid out as (ceil(n / 128), 128) rows and element ``i``
    draws :func:`counter_bits_reduced`'s field at (i // 128, i % 128),
    stream 0."""
    rows = -(-n // LANES)
    bits = counter_bits_reduced(k0, k1, (rows, LANES), rand_bits,
                                device=device)
    return bits.reshape(-1)[:n]


def host_to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``.  To a card it goes through pinned
    memory and a non-blocking copy: a copy from pageable memory would
    make the host wait for the card's queue, which stalls a decode step
    that draws words on the host for every layer."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# Packed low-precision storage: grid values <-> integer code words
# (``repro.kernels.common.pack_block``/``unpack_block``).
# ---------------------------------------------------------------------------
def pack_spec(fmt):
    """(ebits, mbits, width_bytes, has_nonfinite_field) of a packable
    grid: the code word is sign | biased exponent | mantissa with ``mbits =
    precision - 1`` and the smallest exponent field covering ``emin..emax``
    plus the subnormal field 0 (IEEE's layout for binary8, binary16 and
    bfloat16; e4m3 uses all 16 fields for finite values, so non-finite
    inputs saturate to ±xmax).  Raises for grids wider than 16 bits."""
    fmt = get_grid(fmt).fmt
    mbits = fmt.precision - 1
    n_fields = fmt.emax - fmt.emin + 2
    ebits = max(1, (n_fields - 1).bit_length())
    total = 1 + ebits + mbits
    if total > 16:
        raise ValueError(f"format {fmt.name!r} does not fit a packed "
                         f"16-bit code word ({total} bits)")
    return ebits, mbits, 1 if total <= 8 else 2, (1 << ebits) - 1 >= n_fields


def pack_bytes(fmt) -> int:
    """Bytes per element of the packed representation of ``fmt``."""
    return pack_spec(fmt)[2]


def pack_dtype(fmt) -> torch.dtype:
    return torch.uint8 if pack_bytes(fmt) == 1 else torch.uint16


def pack_block(x: torch.Tensor, fmt) -> torch.Tensor:
    """Encode float32 values already on the grid of ``fmt`` as code words
    (uint8 or uint16).  Non-finite values take the spare all-ones exponent
    field where the format has one, else saturate to ±xmax.  A normal
    value's field and mantissa are its float32 exponent rebased and the
    top ``mbits`` of its float32 mantissa; a subnormal's mantissa is its
    magnitude over the grid's smallest step (both exact on grid values)."""
    fmt = get_grid(fmt).fmt
    ebits, mbits, _, has_nf = pack_spec(fmt)
    x = x.float()
    finite = torch.isfinite(x)
    mag = torch.where(finite, torch.abs(x), fmt.xmax)
    bits = mag.view(torch.int32)
    n = mbits - fmt.emin                 # mag * 2**n: the subnormal code
    sub = (mag * 2.0 ** (n // 2) * 2.0 ** (n - n // 2)).to(torch.int32)
    normal = (((bits >> 23) - (126 + fmt.emin)) << mbits) \
        | ((bits & 0x7FFFFF) >> (23 - mbits))
    code = torch.where(mag >= fmt.xmin, normal, sub) \
        | (torch.signbit(x).to(torch.int32) << (ebits + mbits))
    if has_nf:
        nf = (torch.signbit(x).to(torch.int32) << (ebits + mbits)) \
            | (((1 << ebits) - 1) << mbits) \
            | torch.where(torch.isnan(x), (1 << mbits) - 1, 0)
        code = torch.where(finite, code, nf)
    return code.to(pack_dtype(fmt))


def unpack_block(codes: torch.Tensor, fmt) -> torch.Tensor:
    """Decode code words back to exact float32 grid values."""
    fmt = get_grid(fmt).fmt
    ebits, mbits, _, has_nf = pack_spec(fmt)
    c = codes.to(torch.int64)
    sign = (c >> (ebits + mbits)) & 1
    field = (c >> mbits) & ((1 << ebits) - 1)
    m = c & ((1 << mbits) - 1)
    is_sub = field == 0
    e = torch.where(is_sub, fmt.emin, field - 1 + fmt.emin)
    sig = torch.where(is_sub, m, m + (1 << mbits)).to(torch.float32)
    mag = _exact_scale(sig, e - mbits)
    out = torch.where(sign == 1, -mag, mag)
    if has_nf:
        inf = torch.where(sign == 1, -float("inf"), float("inf"))
        nf = torch.where(m == 0, inf, float("nan"))
        out = torch.where(field == (1 << ebits) - 1, nf.float(), out)
    return out
