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
``fused_qadam_prng``   -> the same source's ``fused_qadam_prng`` (K5),
    replacing ``fused_qadam_prng_p``: one pass of QAdam -- the rounded
    (optionally packed, optionally Kahan-compensated) m and v EMAs, the
    bias-corrected direction and the eq.-8 chain on it.

Random bits of K2': element n of the flat vector sits at
(n // 128, n % 128) of the reference's (rows, 128) layout, and its
stochastic steps take ``common.kernel_bits3``'s words there, so the result
does not depend on how the vector is cut into blocks.  K5's moment
sites draw ``counter_bits_reduced`` fields of streams 8 (m) and 9 (v) at
the same coordinates.  A tensor on the CPU
goes to the plain twin, which works through the vector in chunks of
``CHUNK`` elements (the bits are keyed by position, so chunking changes
nothing); a CUDA tensor launches the kernel.  K2' moves 12 bytes per
element and runs one Threefry evaluation per two stochastic steps, which
bounds it; K2 moves 12 bytes plus 4 per stochastic step.  Both are
compiled three times over (``k2_instance``): a trainer instance for
``train.PAPER_RUN``'s chain, a generic one for rn / sr / sr_eps /
signed-SRe sites on plain FP grids with subnormals, saturating, and a wide
one for every scheme x grid x overflow pair of the reference's
``round_block`` (rz / ra / rd / ru, sr2, the bit trick, fixed-point and
shifted grids, formats without subnormals, overflow to ±inf: the paper's
GD experiments, ``repro_torch.paper``).  K5 has the first two
(``k5_instance``) and takes the generic instance's sites only.  K5
moves 20 bytes per element with bf16 codes and runs two Threefry
evaluations per element (r = 32 moments, a two-step chain).

K5 computes what the reference's kernel computes *as XLA's CPU backend
compiles it* (its interpret mode, the port's bitwise reference), found by
bitwise tests: float32 subnormal operands and results count as zero
(``core.fma.flush``); ``beta * m + (1 - beta) * a`` is one fused
multiply-add, ``fma(beta, m, (1 - beta) * a)`` for float32 carries and
``fma(1 - beta, a, beta * m)`` for unpacked codes; the Kahan update's
``(1 - beta) * (a - m) - c`` is ``fma(1 - beta, a - m, -c)`` with ``g * g
- v`` itself ``fma(g, g, -v)``; ``(m / c1) / (sqrt(v / c2) + eps)`` is
rewritten to ``m / (c1 * (sqrt(v / c2) + eps))``; and ``... + wd * x`` is
``fma(wd, x, ...)``.  ``1 - beta`` is the Python float rounded to float32.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.fma import flush, fma
from repro_torch.core.gd import GDRounding, _resolve_v, f32
from repro_torch.core.grids import get_grid
from repro_torch.core.prng import M32, int32_words
from repro_torch.core.rounding import RoundingSpec
from repro_torch.kernels import build, common

LANES = 128                 # the reference's flat (rows, LANES) layout
CHUNK = 1 << 24             # plain twins: elements per pass (LANES | CHUNK)
_V_SOURCES = {"self": 0, "grad": 1, "neg_grad": 2}

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES: Dict[str, int] = {"fused_qupdate_prng": 0, "fused_qupdate_bits": 0,
                            "momentum_fma": 0, "fused_qadam_prng": 0}
# K2' and K2 launches (together) by compiled instance, since the last reset
INSTANCE_LAUNCHES: Dict[str, int] = {"generic": 0, "trainer": 0, "wide": 0}
# K5's moment sites draw from these counter streams (the chain takes pair
# streams 0 and 1), as the reference's kernel does
STREAM_MOMENT_M = 8
STREAM_MOMENT_V = 9

Words = Tuple[int, int]


def reset_launches() -> None:
    for counts in (LAUNCHES, INSTANCE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def need(cfg: GDRounding) -> Tuple[bool, bool, bool]:
    """Which of the three steps draw random bits (static per config)."""
    return tuple(s.stochastic for s in cfg.step_specs())


def _check_spec(s: RoundingSpec, what: str) -> None:
    """K2' and K2 take every registered scheme on every grid, saturating
    or overflowing (the wide instance); only a scheme the kernels do not
    know is refused."""
    if not s.is_identity and s.scheme.name not in common.SCHEME_CODES:
        raise NotImplementedError(f"{what}: scheme {s.scheme.name!r} has no "
                                  "rule in the update kernels")


def _check_generic_spec(s: RoundingSpec, what: str) -> None:
    """K5's sites: the generic instance's only."""
    if not common.fp_site(s):
        raise NotImplementedError(
            f"{what}: {s} is not ported to K5 (rn, sr, sr_eps, "
            "signed_sr_eps on a plain FP grid with subnormals, saturating)")


def _check(cfg: GDRounding, x: torch.Tensor, g: torch.Tensor,
           check_spec=_check_spec) -> None:
    for s, v, name in zip(cfg.step_specs(), (cfg.grad_v, cfg.mul_v,
                                             cfg.sub_v),
                          ("grad", "mul", "sub")):
        check_spec(s, f"fused update, step {name}")
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
                       seed: Words, cfg: GDRounding,
                       instance: Optional[str] = None) -> torch.Tensor:
    """Fused rounded GD update with in-kernel bits.  ``x``, ``g``: float32
    of one shape; ``seed``: the (k0, k1) words of ``derive_seed(key,
    step)``; ``instance``: the compiled instance to launch (default
    ``k2_instance(cfg)``).  Returns x⁺ (a new tensor)."""
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
        seed[0] & M32, seed[1] & M32, *_site_args(cfg), _shift_args(cfg),
        _k2_index(cfg, instance),
        torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(rc, "fused_qupdate_prng")
    _count_k2("fused_qupdate_prng", cfg, instance)
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
                  bits3: torch.Tensor, cfg: GDRounding,
                  instance: Optional[str] = None) -> torch.Tensor:
    """Fused rounded GD update with explicit bits: ``bits3`` (3, *x.shape)
    uint32 words in int64 or as int32 bit patterns (rows of deterministic
    steps are not read); ``instance`` as for ``fused_qupdate_prng``."""
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
        x.numel(), f32(t), *_site_args(cfg), _shift_args(cfg),
        _k2_index(cfg, instance),
        torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(rc, "fused_qupdate_bits")
    _count_k2("fused_qupdate_bits", cfg, instance)
    return res


# ---------------------------------------------------------------------------
# K5: the fused QAdam step
# ---------------------------------------------------------------------------
def _check_moment_spec(s: RoundingSpec, what: str) -> None:
    """A moment site: the identity, a site of K2''s generic instance, or
    the bf16 bit-trick SR with 16-bit draws."""
    if not s.is_identity and s.scheme.randomness == "bittrick":
        if get_grid(s.fmt).name != "bfloat16" or s.rand_bits != 16 \
                or s.overflow != "saturate":
            raise NotImplementedError(f"{what}: bit-trick SR is ported for "
                                      "bfloat16 with 16-bit draws only")
        return
    _check_generic_spec(s, what)


def _check_adam(cfg, x, g, m, v, cm, cv, m_spec, v_spec, packed) -> bool:
    """Validate K5's operands; returns whether the carries are Kahan-
    compensated."""
    _check(cfg, x, g, _check_generic_spec)
    _check_moment_spec(m_spec, "fused QAdam, m")
    _check_moment_spec(v_spec, "fused QAdam, v")
    kahan = cm is not None
    if kahan != (cv is not None):
        raise ValueError("Kahan compensation needs both cm and cv")
    if packed and (m_spec.is_identity or v_spec.is_identity):
        raise ValueError("packed moments require non-identity m/v specs")
    n = x.numel()
    for name, c, spec in (("m", m, m_spec), ("v", v, v_spec)):
        want = common.pack_dtype(spec.fmt) if packed else torch.float32
        if c.dtype != want or c.numel() != n or c.device != x.device:
            raise ValueError(f"{name} must be {want} of {n} elements on "
                             f"{x.device}, got {c.dtype} {tuple(c.shape)} "
                             f"on {c.device}")
    for name, c in (("cm", cm), ("cv", cv)):
        if c is not None and (c.dtype != torch.float32 or c.numel() != n
                              or c.device != x.device):
            raise ValueError(f"{name} must be float32 of {n} elements on "
                             f"{x.device}")
    return kahan


def _scalars(scal) -> Tuple[float, float, float, float, float]:
    """``[t, c1, c2, eps, wd]`` as the float32 values the kernel reads."""
    vals = scal.tolist() if torch.is_tensor(scal) else list(scal)
    if len(vals) != 5:
        raise ValueError(f"scal must hold [t, c1, c2, eps, wd], got {vals}")
    return tuple(f32(v) for v in vals)


def _moment_ema(spec: RoundingSpec, m, a, beta: float, bits, comp, packed,
                g=None):
    """One rounded EMA carry, ``Q(beta * m + (1 - beta) * a)`` (the
    reference's ``_moment_ema``), with XLA's contractions and flushes.
    With ``comp`` (Kahan): ``y = (1 - beta)(a - m) - comp``, ``s = Q(m +
    y)``, ``comp' = (s - m) - y``.  ``g``: for the second moment, the
    gradient whose square ``a`` is."""
    b, ob = f32(beta), f32(1.0 - beta)
    if comp is None:
        s = fma(ob, a, flush(b * m)) if packed else fma(b, m, flush(ob * a))
        return common.apply_spec_block(spec, s, bits), None
    diff = fma(g, g, -m) if g is not None else flush(a - m)
    y = fma(ob, diff, -comp)
    s = common.apply_spec_block(spec, flush(m + y), bits)
    return s, flush(flush(s - m) - y)


def adam_quotient(m, v, c1: float, c2: float, eps: float):
    """``(m / c1) / (sqrt(v / c2) + eps)`` as XLA rewrites it: ``m / (c1 *
    (sqrt(v / c2) + eps))``, every operation rounded once.  The divisor
    ``c2`` goes in as a tensor (PyTorch's CUDA division by a Python number
    multiplies by its reciprocal), and the square root is taken in float64
    and rounded once, the correctly rounded float32 root (PyTorch's
    float32 ``sqrt`` on the CPU is off by an ulp on some inputs)."""
    c2 = torch.tensor(c2, dtype=torch.float32, device=v.device)
    den = flush(torch.sqrt(flush(v / c2).double()).float() + eps)
    return flush(m / flush(c1 * den))


def _direction(m, v, x, c1, c2, eps, wd):
    """The Adam direction plus ``wd * x`` as one fused multiply-add."""
    return fma(wd, x, adam_quotient(m, v, c1, c2, eps))


# K5's compiled instances, by the index its entry point takes
K5_INSTANCES = ("generic", "trainer")


def _narrow(spec: RoundingSpec) -> bool:
    """Whether a grid's scaled values stay in float32's exponent range
    (``rounding.cuh``'s ``narrow``)."""
    f = get_grid(spec.fmt).fmt
    return f.emin - f.precision + 1 >= -126 and f.emax - f.precision < 126


def _trainer_chain(cfg: GDRounding) -> bool:
    """Whether the eq.-8 chain is ``train.PAPER_RUN``'s kind, which the
    trainer instances of K2', K2 and K5 compile in: rn / sr / signed-SRe
    on narrow grids, the stochastic steps with 32-bit draws (``csrc/
    fused_qupdate.cu``'s ``trainer_chain_case``)."""
    chain = list(cfg.step_specs())
    modes = tuple(None if s.is_identity else s.scheme.name for s in chain)
    return modes == ("rn", "sr", "signed_sr_eps") \
        and all(common.fp_site(s) and _narrow(s) for s in chain) \
        and all(s.rand_bits == 32 for s in chain[1:])


# K2' and K2's compiled instances, by the index their entry points take
K2_INSTANCES = ("generic", "trainer", "wide")


def k2_instance(cfg: GDRounding) -> str:
    """Which compiled instance of K2' and K2 a config runs: ``"wide"``
    where a site is not the generic instance's (``common.fp_site``);
    ``"trainer"`` for ``train.PAPER_RUN``'s chain (every scheme, draw width
    and the signed-SRe direction ``sub_v="grad"`` fixed at compile time, the
    sites' grids read at run time); else ``"generic"`` (the ``Chain`` read
    at run time).  The wide instance takes every chain; the entry points
    refuse a trainer launch that does not fit and a generic or trainer
    launch of a chain that needs the wide instance."""
    if not all(common.fp_site(s) for s in cfg.step_specs()):
        return "wide"
    return "trainer" if _trainer_chain(cfg) and cfg.sub_v == "grad" \
        else "generic"


def _k2_index(cfg: GDRounding, instance: Optional[str]) -> int:
    return K2_INSTANCES.index(k2_instance(cfg) if instance is None
                              else instance)


def _count_k2(name: str, cfg: GDRounding, instance: Optional[str]) -> None:
    LAUNCHES[name] += 1
    INSTANCE_LAUNCHES[K2_INSTANCES[_k2_index(cfg, instance)]] += 1


def k5_instance(cfg: GDRounding, m_spec: RoundingSpec, v_spec: RoundingSpec,
                packed: bool, kahan: bool) -> str:
    """Which compiled instance of K5 a case runs: ``"trainer"`` for
    ``train.ADAM_RUN``'s case -- bf16 moment codes rounded by SR with
    32-bit draws, no Kahan carries, the chain rn / sr / signed-SRe on
    narrow grids with 32-bit draws -- whose schemes and storage are fixed
    at compile time, else ``"generic"``.  The kernel's entry point
    refuses a trainer launch that does not fit."""
    moments = packed and not kahan and all(
        not s.is_identity and get_grid(s.fmt).fmt.name == "bfloat16"
        and s.scheme.name == "sr" and s.rand_bits == 32
        for s in (m_spec, v_spec))
    return "trainer" if moments and _trainer_chain(cfg) else "generic"


def fused_qadam_prng_plain(x, g, m, v, scal, seed: Words, cfg: GDRounding,
                           *, m_spec: RoundingSpec, v_spec: RoundingSpec,
                           b1: float, b2: float, packed: bool, cm=None,
                           cv=None):
    """The plain twin of K5, ``CHUNK`` elements at a time; returns
    ``(x⁺, m', v')`` or ``(x⁺, m', v', cm', cv')``."""
    t, c1, c2, eps, wd = _scalars(scal)
    xf, gf = x.reshape(-1), g.reshape(-1)
    carries = [c.reshape(-1) for c in (m, v)]
    comps = None if cm is None else [c.reshape(-1) for c in (cm, cv)]
    outs = [torch.empty_like(xf), torch.empty_like(carries[0]),
            torch.empty_like(carries[1])]
    if comps is not None:
        outs += [torch.empty_like(comps[0]), torch.empty_like(comps[1])]
    nd = need(cfg)
    for lo, hi in _chunks(xf.numel()):
        rows, row0, k = -(-(hi - lo) // LANES), lo // LANES, hi - lo

        def bits(spec, stream):
            if not spec.stochastic:
                return None
            return common.counter_bits_reduced(
                seed[0], seed[1], (rows, LANES), spec.rand_bits, row0=row0,
                stream=stream, device=x.device).reshape(-1)[:k]

        xs, gs = flush(xf[lo:hi]), flush(gf[lo:hi])
        mv = []
        for i, spec in enumerate((m_spec, v_spec)):
            c = carries[i][lo:hi]
            mv.append(flush(common.unpack_block(c, spec.fmt) if packed
                            else c))
        cs = (None, None) if comps is None else [flush(c[lo:hi])
                                                 for c in comps]
        m_new, cm_new = _moment_ema(m_spec, mv[0], gs, b1,
                                    bits(m_spec, STREAM_MOMENT_M), cs[0],
                                    packed)
        v_new, cv_new = _moment_ema(v_spec, mv[1], flush(gs * gs), b2,
                                    bits(v_spec, STREAM_MOMENT_V), cs[1],
                                    packed, g=gs)
        d = _direction(m_new, v_new, xs, c1, c2, eps, wd)
        b3 = common.kernel_bits3(seed, (rows, LANES), row0, nd,
                                 device=x.device)
        b3 = [None if b is None else b.reshape(-1)[:k] for b in b3]
        outs[0][lo:hi] = update_chain(cfg, xs, d, t, *b3)
        for i, (spec, val) in enumerate(((m_spec, m_new), (v_spec, v_new))):
            outs[1 + i][lo:hi] = common.pack_block(val, spec.fmt) \
                if packed else val
        if comps is not None:
            outs[3][lo:hi], outs[4][lo:hi] = cm_new, cv_new
    shapes = [x.shape, m.shape, v.shape] + (
        [] if comps is None else [cm.shape, cv.shape])
    return tuple(o.view(s) for o, s in zip(outs, shapes))


def fused_qadam_prng(x: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, scal, seed: Words, cfg: GDRounding,
                     *, m_spec: RoundingSpec, v_spec: RoundingSpec,
                     b1: float, b2: float, packed: bool,
                     cm: Optional[torch.Tensor] = None,
                     cv: Optional[torch.Tensor] = None):
    """Fused QAdam step with in-kernel bits (the reference's
    ``fused_qadam_prng_p``).

    ``x``, ``g``: float32 parameters and gradient (same shape); ``m``,
    ``v``: the moment carries over the same elements, float32 or, when
    ``packed``, the uint8/uint16 codes of ``common.pack_dtype``; ``scal``:
    ``[t, c1, c2, eps, weight_decay]``; ``seed``: the (k0, k1) words of
    ``derive_seed(key, step)``; ``cm``/``cv``: float32 Kahan carries (both
    or neither).  Returns new tensors ``(x⁺, m', v')`` or ``(x⁺, m', v',
    cm', cv')``, the moments in the representation they arrived in."""
    kahan = _check_adam(cfg, x, g, m, v, cm, cv, m_spec, v_spec, packed)
    if x.device.type == "cpu":
        return fused_qadam_prng_plain(x, g, m, v, scal, seed, cfg,
                                      m_spec=m_spec, v_spec=v_spec, b1=b1,
                                      b2=b2, packed=packed, cm=cm, cv=cv)
    ins = [c.contiguous() for c in (x, g, m, v)]
    comps = [c.contiguous() for c in (cm, cv)] if kahan else [None, None]
    outs = [torch.empty_like(c) for c in ins[:1] + ins[2:]]
    outs += [torch.empty_like(c) for c in comps] if kahan else [None, None]
    if x.numel() == 0:
        return tuple(o for o in outs if o is not None)

    def ptr(c):
        return None if c is None else c.data_ptr()
    t, c1, c2, eps, wd = _scalars(scal)
    rc = _lib().fused_qadam_prng(
        *(ptr(c) for c in ins + comps + outs), x.numel(), t, c1, c2, eps,
        wd, f32(b1), f32(1.0 - b1), f32(b2), f32(1.0 - b2),
        seed[0] & M32, seed[1] & M32, *_site_args(cfg),
        _moment_args(m_spec, v_spec, packed),
        K5_INSTANCES.index(k5_instance(cfg, m_spec, v_spec, packed, kahan)),
        torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(rc, "fused_qadam_prng")
    LAUNCHES["fused_qadam_prng"] += 1
    return tuple(o.view(s.shape) for o, s in zip(
        outs, [x, m, v, cm, cv]) if o is not None)


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
    """(int[24] sites, float[3] xmax, float[3] eps) host arrays: each
    site's ``common.wide_row`` (slot 6 its v source, slot 7 the flags the
    wide instance reads)."""
    sites, xmax, eps = [], [], []
    for s, v in zip(cfg.step_specs(), (cfg.grad_v, cfg.mul_v, cfg.sub_v)):
        ints, floats = common.wide_row(s, _V_SOURCES[v])
        sites += ints
        xmax.append(floats[0])
        eps.append(floats[1])
    return ((ctypes.c_int * 24)(*sites), (ctypes.c_float * 3)(*xmax),
            (ctypes.c_float * 3)(*eps))


def _shift_args(cfg: GDRounding):
    """float[6]: (scale, mu) of each site's grid ((1, 0) unshifted)."""
    out = []
    for s in cfg.step_specs():
        grid = None if s.is_identity else get_grid(s.fmt)
        out += [1.0, 0.0] if grid is None else [grid.scale, grid.mu]
    return (ctypes.c_float * 6)(*out)


def _moment_args(m_spec: RoundingSpec, v_spec: RoundingSpec, packed: bool):
    """int[2 * 16] per moment site: {enabled, precision, emin, emax, mode,
    rand_bits, bittrick, code bytes (0: float32), ebits, mbits, has_nf,
    xmax, xmin, eps, 0, 0}, the floats as their bit patterns."""
    out = []
    for s in (m_spec, v_spec):
        site = [0] * 16
        if not s.is_identity:
            f = get_grid(s.fmt).fmt
            bittrick = s.scheme.randomness == "bittrick"
            site[:7] = [1, f.precision, f.emin, f.emax,
                        common.SCHEME_CODES["sr" if bittrick else s.scheme.name],
                        s.rand_bits, int(bittrick)]
            if packed:
                ebits, mbits, width, has_nf = common.pack_spec(s.fmt)
                site[7:11] = [width, ebits, mbits, int(has_nf)]
            site[11:14] = [_float_bits(v) for v in (f.xmax, f.xmin, s.eps)]
        out += site
    return (ctypes.c_int * 32)(*out)


def _float_bits(v: float) -> int:
    return int(torch.tensor(v, dtype=torch.float32).view(torch.int32))


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _lib():
    lib = build.load("fused_qupdate")
    c = ctypes
    tail = [c.POINTER(c.c_int), c.POINTER(c.c_float), c.POINTER(c.c_float),
            c.c_void_p]
    if lib.fused_qupdate_prng.argtypes is None:
        k2_tail = tail[:3] + [c.POINTER(c.c_float), c.c_int, c.c_void_p]
        lib.fused_qupdate_prng.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64, c.c_float,
            c.c_uint32, c.c_uint32] + k2_tail
        lib.fused_qupdate_prng.restype = c.c_int
        lib.fused_qupdate_bits.argtypes = [
            c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,
            c.c_float] + k2_tail
        lib.fused_qupdate_bits.restype = c.c_int
        lib.momentum_fma.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                     c.c_int64, c.c_float, c.c_void_p]
        lib.momentum_fma.restype = c.c_int
        lib.fused_qadam_prng.argtypes = [c.c_void_p] * 11 + [
            c.c_int64] + [c.c_float] * 9 + [c.c_uint32, c.c_uint32] \
            + tail[:3] + [c.POINTER(c.c_int), c.c_int, c.c_void_p]
        lib.fused_qadam_prng.restype = c.c_int
    return lib
