"""The paper's fused three-step rounded GD update (eq. 8) over a flat
float32 vector: wrappers, plain twins, launch counts (counterpart of
``repro.kernels.fused_update``).

    ĝ = Q₁(g),  upd = Q₂(t · ĝ),  x⁺ = Q₃(x − upd)

``fused_qupdate_prng`` -> CUDA kernel ``csrc/fused_qupdate.cu``
    (``fused_qupdate_prng``, K2'), replacing
    ``repro/kernels/fused_update.py:fused_qupdate_prng_p``: the bits are
    drawn in the kernel.
``fused_qupdate``      -> the same source's ``fused_qupdate_bits`` (K2),
    replacing ``fused_qupdate_p``: explicit (3, n) bits.
``momentum_fma``       -> the same source's ``momentum_fma``: the
    optimizer's ``momentum * m + g`` with one rounding, as XLA contracts it
    in the reference's step (no Pallas kernel there); its plain twin is the
    float64 emulation ``core.fma.fma``.

Random bits of K2': element n of the flat vector sits at
(n // 128, n % 128) of the reference's (rows, 128) layout, and its
stochastic steps take ``common.kernel_bits3``'s words there, so the result
does not depend on how the vector is cut into blocks.  A tensor on the CPU
goes to the plain twin, which works through the vector in chunks of
``CHUNK`` elements (the bits are keyed by position, so chunking changes
nothing); a CUDA tensor launches the kernel.  Both kernels are bound by
bytes (12 and 24 per element) or, for K2', by its Threefry integer work.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core.fma import fma
from repro_torch.core.gd import GDRounding, _resolve_v, f32
from repro_torch.core.grids import get_grid
from repro_torch.core.prng import M32, int32_words
from repro_torch.core.rounding import RoundingSpec
from repro_torch.kernels import build, common

LANES = 128                 # the reference's flat (rows, LANES) layout
CHUNK = 1 << 24             # plain twins: elements per pass (LANES | CHUNK)
_MODES = {"rn": 0, "sr": 1, "sr_eps": 2, "signed_sr_eps": 3}
_V_SOURCES = {"self": 0, "grad": 1, "neg_grad": 2}

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES: Dict[str, int] = {"fused_qupdate_prng": 0, "fused_qupdate_bits": 0,
                            "momentum_fma": 0}

Words = Tuple[int, int]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def need(cfg: GDRounding) -> Tuple[bool, bool, bool]:
    """Which of the three steps draw random bits (static per config)."""
    return tuple(s.stochastic for s in cfg.step_specs())


def _check_spec(s: RoundingSpec, what: str) -> None:
    if s.is_identity:
        return
    grid = get_grid(s.fmt)
    if grid.kind != "fp" or grid.transformed or not grid.fmt.subnormals:
        raise NotImplementedError(f"{what}: grid {grid.name!r} is not a "
                                  "plain FP grid (not ported yet)")
    if s.scheme.name not in _MODES:
        raise NotImplementedError(f"{what}: scheme {s.scheme.name!r} is not "
                                  "ported yet (rn, sr, sr_eps, "
                                  "signed_sr_eps)")
    if s.overflow != "saturate":
        raise NotImplementedError(f"{what}: overflow={s.overflow!r} is not "
                                  "ported yet")


def _check(cfg: GDRounding, x: torch.Tensor, g: torch.Tensor) -> None:
    for s, v, name in zip(cfg.step_specs(), (cfg.grad_v, cfg.mul_v,
                                             cfg.sub_v),
                          ("grad", "mul", "sub")):
        _check_spec(s, f"fused update, step {name}")
        if v not in _V_SOURCES:
            raise ValueError(f"unknown v_source {v!r}")
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"x and g must be float32, got {x.dtype}/{g.dtype}")
    if x.shape != g.shape:
        raise ValueError(f"x/g shape mismatch {tuple(x.shape)} vs "
                         f"{tuple(g.shape)}")
    if x.device != g.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x/g devices {x.device}/{g.device} unsupported")


def update_chain(cfg: GDRounding, x, g, t: float, b1, b2, b3):
    """The eq.-8 chain on a block, plain PyTorch (the reference's
    ``_update_chain``)."""
    g_hat = common.apply_spec_block(cfg.grad, g, b1,
                                    v=_resolve_v(cfg.grad_v, g, x))
    upd = common.apply_spec_block(cfg.mul, t * g_hat, b2,
                                  v=_resolve_v(cfg.mul_v, g_hat, x))
    z = x - upd
    return common.apply_spec_block(cfg.sub, z, b3,
                                   v=_resolve_v(cfg.sub_v, g_hat, x))


def _chunks(n: int):
    for lo in range(0, n, CHUNK):
        yield lo, min(n, lo + CHUNK)


# ---------------------------------------------------------------------------
# K2': in-kernel bits
# ---------------------------------------------------------------------------
def fused_qupdate_prng_plain(x, g, t: float, seed: Words,
                             cfg: GDRounding) -> torch.Tensor:
    """The plain twin of K2': the chain fed ``kernel_bits3`` at each
    element's (n // 128, n % 128)."""
    xf, gf = x.reshape(-1), g.reshape(-1)
    res = torch.empty_like(xf)
    nd, t = need(cfg), f32(t)
    for lo, hi in _chunks(xf.numel()):
        rows = -(-(hi - lo) // LANES)
        bits = common.kernel_bits3(seed, (rows, LANES), lo // LANES, nd,
                                   device=x.device)
        bits = [None if b is None else b.reshape(-1)[:hi - lo] for b in bits]
        res[lo:hi] = update_chain(cfg, xf[lo:hi], gf[lo:hi], t, *bits)
    return res.view(x.shape)


def fused_qupdate_prng(x: torch.Tensor, g: torch.Tensor, t: float,
                       seed: Words, cfg: GDRounding) -> torch.Tensor:
    """Fused rounded GD update with in-kernel bits.  ``x``, ``g``: float32
    of one shape; ``seed``: the (k0, k1) words of ``derive_seed(key,
    step)``.  Returns x⁺ (a new tensor)."""
    _check(cfg, x, g)
    if x.device.type == "cpu":
        return fused_qupdate_prng_plain(x, g, t, seed, cfg)
    x, g = x.contiguous(), g.contiguous()
    res = torch.empty_like(x)
    if x.numel() == 0:
        return res
    lib = _lib()
    rc = lib.fused_qupdate_prng(
        x.data_ptr(), g.data_ptr(), res.data_ptr(), x.numel(), f32(t),
        seed[0] & M32, seed[1] & M32, *_site_args(cfg),
        torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(rc, "fused_qupdate_prng")
    LAUNCHES["fused_qupdate_prng"] += 1
    return res


# ---------------------------------------------------------------------------
# K2: explicit bits
# ---------------------------------------------------------------------------
def _words_int64(b: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int32 (bit patterns) or int64 -> int64."""
    return b.to(torch.int64) & M32


def fused_qupdate_plain(x, g, t: float, bits3: torch.Tensor,
                        cfg: GDRounding) -> torch.Tensor:
    """The plain twin of K2: the chain fed rows 0, 1, 2 of ``bits3``."""
    xf, gf = x.reshape(-1), g.reshape(-1)
    bf = bits3.reshape(3, -1)
    res = torch.empty_like(xf)
    nd, t = need(cfg), f32(t)
    for lo, hi in _chunks(xf.numel()):
        bits = [_words_int64(bf[s, lo:hi]) if nd[s] else None
                for s in range(3)]
        res[lo:hi] = update_chain(cfg, xf[lo:hi], gf[lo:hi], t, *bits)
    return res.view(x.shape)


def fused_qupdate(x: torch.Tensor, g: torch.Tensor, t: float,
                  bits3: torch.Tensor, cfg: GDRounding) -> torch.Tensor:
    """Fused rounded GD update with explicit bits: ``bits3`` (3, *x.shape)
    uint32 words in int64 or as int32 bit patterns (rows of deterministic
    steps are not read)."""
    _check(cfg, x, g)
    if tuple(bits3.shape) != (3, *x.shape) \
            or bits3.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"bits3 must be int32/int64 (3, *{tuple(x.shape)}),"
                         f" got {bits3.dtype} {tuple(bits3.shape)}")
    if bits3.device != x.device:
        raise ValueError("bits3 on another device than x")
    if x.device.type == "cpu":
        return fused_qupdate_plain(x, g, t, bits3, cfg)
    x, g = x.contiguous(), g.contiguous()
    words = (bits3 if bits3.dtype == torch.int32
             else int32_words(bits3)).contiguous()
    res = torch.empty_like(x)
    if x.numel() == 0:
        return res
    lib = _lib()
    rc = lib.fused_qupdate_bits(
        x.data_ptr(), g.data_ptr(), words.data_ptr(), res.data_ptr(),
        x.numel(), f32(t), *_site_args(cfg),
        torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(rc, "fused_qupdate_bits")
    LAUNCHES["fused_qupdate_bits"] += 1
    return res


# ---------------------------------------------------------------------------
# the momentum step
# ---------------------------------------------------------------------------
def momentum_fma_plain(a: float, m: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """The plain twin of ``momentum_fma``."""
    return fma(a, m, g)


def momentum_fma(a: float, m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``a * m + g`` with one rounding: ``a`` a Python float (taken as
    float32), ``m`` and ``g`` float32 of one shape.  Returns a new tensor."""
    if m.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"m and g must be float32, got {m.dtype}/{g.dtype}")
    if m.shape != g.shape or m.device != g.device:
        raise ValueError(f"m/g mismatch {tuple(m.shape)} on {m.device} vs "
                         f"{tuple(g.shape)} on {g.device}")
    if m.device.type == "cpu":
        return momentum_fma_plain(a, m, g)
    if m.device.type != "cuda":
        raise ValueError(f"device {m.device} unsupported")
    m, g = m.contiguous(), g.contiguous()
    res = torch.empty_like(m)
    if m.numel() == 0:
        return res
    rc = _lib().momentum_fma(m.data_ptr(), g.data_ptr(), res.data_ptr(),
                             m.numel(), f32(a),
                             torch.cuda.current_stream(m.device).cuda_stream)
    _launch_check(rc, "momentum_fma")
    LAUNCHES["momentum_fma"] += 1
    return res


# ---------------------------------------------------------------------------
# the C interface
# ---------------------------------------------------------------------------
def _site_args(cfg: GDRounding):
    """(int[24] sites, float[3] xmax, float[3] eps) host arrays."""
    sites, xmax, eps = [], [], []
    for s, v in zip(cfg.step_specs(), (cfg.grad_v, cfg.mul_v, cfg.sub_v)):
        if s.is_identity:
            sites += [0] * 8
            xmax.append(0.0)
            eps.append(0.0)
            continue
        f = get_grid(s.fmt).fmt
        sites += [1, f.precision, f.emin, f.emax, _MODES[s.scheme.name],
                  s.rand_bits, _V_SOURCES[v], 0]
        xmax.append(f.xmax)
        eps.append(s.eps)
    return ((ctypes.c_int * 24)(*sites), (ctypes.c_float * 3)(*xmax),
            (ctypes.c_float * 3)(*eps))


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _lib():
    lib = build.load("fused_qupdate")
    c = ctypes
    tail = [c.POINTER(c.c_int), c.POINTER(c.c_float), c.POINTER(c.c_float),
            c.c_void_p]
    if lib.fused_qupdate_prng.argtypes is None:
        lib.fused_qupdate_prng.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_float,
            c.c_uint32, c.c_uint32] + tail
        lib.fused_qupdate_prng.restype = c.c_int
        lib.fused_qupdate_bits.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,
            c.c_float] + tail
        lib.fused_qupdate_bits.restype = c.c_int
        lib.momentum_fma.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                     c.c_int64, c.c_float, c.c_void_p]
        lib.momentum_fma.restype = c.c_int
    return lib
