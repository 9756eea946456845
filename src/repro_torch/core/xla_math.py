"""XLA's CPU float32 math functions, op by op, where the reference's
results depend on them (counterpart of no reference module).

XLA's CPU backend computes ``exp``, ``log`` and ``log1p`` with its own
polynomials (Cephes' constants, as in J. Pommier's sse_mathfun), fuses
their multiply-adds, and flushes float32 subnormal results to zero; jax
lowers ``erf_inv`` to a polynomial in ``log1p`` and ``exp2(x)`` to
``exp(float32(ln 2) · x)``; ``tanh`` is XLA's rational approximation
(``tanh_f32``).  PyTorch's functions differ from these by float32 ulps on
some inputs (``torch.tanh`` on 59 % of N(0, 9) inputs), so the port's
``prng.normal`` (Xavier init of the paper's NN), ``gd.tau`` (the
stagnation diagnostic) and the GLU kernels' ``gelu`` (``kernels.qmatmul``)
use these: bitwise equal to jax's on the inputs the tests draw
(``tests/test_torch_qarith.py``, ``tests/test_torch_ffn_act.py``).  The fused steps go through
``core.fma`` (a float64 emulation, so they run on the card too).
"""
from __future__ import annotations

import torch

from repro_torch.core.fma import flush, fma

# XLA's CPU log1p: a Cephes rational for |x| < sqrt(2) - 1 (coefficients
# highest degree first), else log(1 + x) by XLA's CPU log, a polynomial
# after splitting off the exponent (J. Pommier's sse_mathfun constants)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _full(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.full_like(x, c)


def log_f32(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log of a positive normal v, op by op (its
    multiply-adds fused as XLA's CPU backend emits them, ``core.fma``)."""
    bits = v.float().contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF).float() - 126.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < 0.707106781186547524
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    x2 = x * x
    x3 = x2 * x
    c = [_full(x, k) for k in _LOG_P]
    y = fma(fma(c[0], x, c[1]), x, c[2])
    y1 = fma(fma(c[3], x, c[4]), x, c[5])
    y2 = fma(fma(c[6], x, c[7]), x, c[8])
    y = fma(fma(fma(y, x3, y1), x3, y2), x3, e * -2.12194440e-4)
    x = (x - x2 * 0.5) + y
    return x + e * 0.693359375


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p`` on arguments in (-1, 0] (what erfinv
    gives it), op by op."""
    x = x.float()

    def poly(coefs):
        r = torch.zeros_like(x)
        for k in coefs:
            r = fma(r, x, _full(x, k))
        return r
    x2 = x * x
    small = x + fma(_full(x, -0.5), x2,
                    (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)))
    return torch.where(torch.abs(x) < 0.41421356237309504880, small,
                       log_f32(x + 1.0))


# XLA's float32 erfinv (the CHLO decomposition jax lowers ``erf_inv`` to):
# a degree-8 polynomial in w = -log1p(-x * x) - 2.5 (w < 5) or
# sqrt(w) - 3, times x
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function on (-1, 1], op by op, its
    Horner steps ``c + p * w`` fused as XLA's CPU backend emits them
    (``core.fma``).  ±1 maps to ±inf."""
    x = x.float()
    w = -log1p_f32(-(x * x))
    lt = w < 5.0

    def coef(i):
        return torch.where(lt, _full(x, _ERFINV_LT5[i]),
                           _full(x, _ERFINV_GE5[i]))
    # the correctly rounded root (PyTorch's float32 sqrt on the CPU is an
    # ulp off on some inputs)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, w, coef(i))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 exp: n = floor(x log2(e) + 1/2) clamped to
    [-127, 127], a = x - n ln 2 in two parts, a Cephes polynomial for
    e^a, times 2^n built in the exponent field; subnormals flushed."""
    x = torch.clamp(x.float(), -87.8, 88.8)
    n = torch.clamp(torch.floor(fma(x, _full(x, 1.44269504088896341),
                                    _full(x, 0.5))), -127.0, 127.0)
    a = fma(_full(x, -0.693359375), n, x)
    a = fma(_full(x, 2.12194440e-4), n, a)
    z = fma(a, _full(x, _EXP_P[0]), _full(x, _EXP_P[1]))
    for p in _EXP_P[2:]:
        z = fma(z, a, _full(x, p))
    z = 1.0 + fma(z, a * a, a)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return flush(z * pow2)


def exp2_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` as jax lowers it: exp(float32(ln 2) · x)."""
    return exp_f32(x.float() * 0.6931471824645996)


# XLA's float32 tanh (its polynomial approximation on the CPU): the input
# clamped to +-_TANH_CLAMP, then x P(x^2) / Q(x^2), each a Horner chain of
# fused multiply-adds (coefficients highest degree first); |x| below
# _TANH_TINY returns x itself
_TANH_CLAMP = 7.99881172180175781
_TANH_TINY = 0.0004
_TANH_P = (-2.76076847742355e-16, 2.00018790482477e-13,
           -8.60467152213735e-11, 5.12229709037114e-08,
           1.48572235717979e-05, 6.37261928875436e-04,
           4.89352455891786e-03)
_TANH_Q = (1.19825839466702e-06, 1.18534705686654e-04,
           2.26843463243900e-03, 4.89352518554385e-03)


def tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``tanh``, op by op: bitwise ``jnp.tanh`` (jitted
    or not) on every float32 input the tests give it, signed zeros, the
    clamp and the 0.0004 edges, subnormals (returned as they are),
    +-inf and NaN included (``csrc/rounding.cuh:tanh_xla`` on the
    card)."""
    x = x.float()
    c = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    c2 = c * c

    def horner(coefs):
        r = _full(x, coefs[0])
        for k in coefs[1:]:
            r = fma(c2, r, _full(x, k))
        return r
    r = flush((c * horner(_TANH_P)) / horner(_TANH_Q))
    return torch.where(torch.abs(x) < _TANH_TINY, x, r)
