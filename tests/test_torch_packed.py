"""The port's packed storage against the JAX reference: packed GEMM
operands and outputs (``a_fmt``, ``out_packed``), the fused GLU's packed
hidden and residuals, and ``binary8-paper-packed`` end to end.

The port's wrappers on CPU tensors run their plain twins; the reference
runs its kernels in Pallas interpret mode, both fed the same words.

Tolerances (the repo's parity contract):
* code words, packing and unpacking: bitwise (-0.0, e4m3's largest value
  480, binary8's inf and NaN included);
* GEMM paths: bitwise on exact-sum inputs; the fused GLU's hidden goes
  through SiLU, whose ``exp`` may differ by a float32 ulp, so it is held to
  one act-grid ulp and the gradients behind SiLU's pullback to 1e-4 of the
  elements, one grid ulp each (``tests/test_torch_train.py``);
* packing binary8 values loses nothing, so every packed run of the port
  equals its unpacked (``binary8-paper``) run bitwise;
* reduced serving and a reduced train step: the serve and train tests'
  bounds (``tests/test_torch_serve.py``, ``tests/test_torch_train.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.core import rounding as jr
from repro.kernels import common as jcommon
from repro.kernels import qmatmul as jq
from repro.precision import fused as jfused
from repro.precision import policy as jp
from repro_torch.core import rounding as tr
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import qmatmul as tq
from repro_torch.precision import fused as tfused
from repro_torch.precision import policy as tp

SEEDS = ((0x12345678, 0x9ABCDEF0), (7, 0xFFFFFFFF), (0xDEADBEEF, 3))


@pytest.fixture
def interpret_params(monkeypatch):
    """The reference kernels build ``pltpu.TPUCompilerParams``, which newer
    jax names ``CompilerParams``; alias it only where it is missing."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _exact(shape, div, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, shape) / div).astype(np.float32)


def _u32(bits: torch.Tensor):
    return jnp.asarray(bits.numpy().astype(np.uint32))


def _i32(x):
    return np.asarray(x, np.float32).view(np.int32)


def _same(ref, got: torch.Tensor):
    """Bitwise equality of a reference array and a port tensor (float32
    by bit pattern, code words by value)."""
    ref = np.asarray(ref)
    if got.dtype == torch.float32:
        return np.array_equal(_i32(ref), _i32(got.numpy()))
    return np.array_equal(ref.astype(np.int64), got.to(torch.int64).numpy())


def _grid_codes(shape, fmt, seed):
    """Code words of grid values of ``fmt`` (N(0, 1) rounded to nearest)
    and their values, with -0.0 among them."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                         .astype(np.float32))
    vals = tr.round_to_format(x, fmt, "rn")
    vals.view(-1)[:3] = -0.0
    return tcommon.pack_block(vals, fmt), vals


# ---------------------------------------------------------------------------
# code words
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["binary8", "e4m3", "bfloat16", "binary16"])
def test_pack_block_matches_reference_at_the_edges(fmt):
    xmax = tr.get_grid(fmt).fmt.xmax
    edge = [0.0, -0.0, xmax, -xmax, 2.0 ** -30, -(2.0 ** -30)]
    if fmt == "binary8":
        edge += [float("inf"), -float("inf"), float("nan")]
    codes_in, _ = _grid_codes((7, 9), fmt, 1)
    vals = torch.cat([tr.round_to_format(torch.tensor(edge), fmt, "rn"),
                      tcommon.unpack_block(codes_in, fmt).reshape(-1)])
    ref = jcommon.pack_block(jnp.asarray(vals.numpy()), fmt)
    got = tcommon.pack_block(vals, fmt)
    assert got.dtype == tcommon.pack_dtype(fmt)
    assert _same(ref, got)
    back = tcommon.unpack_block(got, fmt)
    assert _same(jcommon.unpack_block(ref, fmt), back)
    assert torch.signbit(back[1]) and float(back[1]) == 0.0    # -0.0
    if fmt == "e4m3":
        assert float(back[2]) == 480.0


# ---------------------------------------------------------------------------
# K3 / K3' and K8 / K8': packed A decoded on load, packed output
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["binary8", "e4m3", "bfloat16"])
def test_qmatmul_packed_twins_match_reference(interpret_params, fmt):
    M, K, N = 9, 37, 70
    a_codes, a_vals = _grid_codes((M, K), fmt, 2)
    b = _exact((K, N), 4.0, 3)
    bits = tcommon.counter_bits_reduced(*SEEDS[0], (M, N), 16)
    ta, tb = a_codes, torch.from_numpy(b)
    ja = jnp.asarray(a_codes.numpy())
    for out_packed in (False, True):
        kw = dict(a_fmt=fmt, out_packed=out_packed, rand_bits=16)
        ref = jq.qmatmul_p(ja, jnp.asarray(b), _u32(bits), fmt, "sr", **kw)
        got = tq.qmatmul(ta, tb, bits, fmt, "sr", 16, a_fmt=fmt,
                         out_packed=out_packed)
        assert _same(ref, got), out_packed
        ref = jq.qmatmul_prng_p(ja, jnp.asarray(b),
                                jnp.asarray(SEEDS[0], jnp.uint32), fmt, "sr",
                                **kw)
        got_prng = tq.qmatmul_prng(ta, tb, SEEDS[0], fmt, "sr", 16,
                                   a_fmt=fmt, out_packed=out_packed)
        assert _same(ref, got_prng) and torch.equal(got, got_prng)
    # decoding on load sums as the values do
    assert torch.equal(tq.qmatmul_prng(ta, tb, SEEDS[0], fmt, a_fmt=fmt),
                       tq.qmatmul_prng(a_vals, tb, SEEDS[0], fmt))


def test_qmatmul_batched_packed_twins_match_reference(interpret_params):
    E, M, K, N = 4, 3, 33, 20
    a_codes, _ = _grid_codes((E, M, K), "binary8", 4)
    b = _exact((E, K, N), 4.0, 5)
    seeds = np.random.default_rng(6).integers(0, 2 ** 32, (E, 2),
                                              dtype=np.int64)
    bits = tcommon.counter_bits_batch(seeds, (E, M, N), 32)
    for out_packed in (False, True):
        ref = jq.qmatmul_batched_p(jnp.asarray(a_codes.numpy()),
                                   jnp.asarray(b), _u32(bits), "binary8",
                                   a_fmt="binary8", out_packed=out_packed)
        got = tq.qmatmul_batched(a_codes, torch.from_numpy(b), bits,
                                 "binary8", a_fmt="binary8",
                                 out_packed=out_packed)
        assert _same(ref, got)
        prng_ = tq.qmatmul_batched_prng(a_codes, torch.from_numpy(b), seeds,
                                        "binary8", a_fmt="binary8",
                                        out_packed=out_packed)
        assert torch.equal(prng_, got)


def test_packed_operands_are_checked():
    a = torch.zeros(2, 4, dtype=torch.uint8)
    b = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="uint8"):
        tq.qmatmul_prng(a.float(), b, SEEDS[0], "binary8", a_fmt="binary8")
    with pytest.raises(ValueError):                   # 32-bit words
        tq.qmatmul_prng(a, b, SEEDS[0], "binary8", a_fmt="binary32")
    with pytest.raises(ValueError):
        tq.qmatmul_prng(a.float(), b, SEEDS[0], "binary32", "rn",
                        out_packed=True)


# ---------------------------------------------------------------------------
# K4 / K4': packed hidden and residuals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["binary8-sr", "e4m3-rn", "bf16-sr"])
def test_swiglu_packed_twins_match_reference(interpret_params, act):
    M, K, N = 21, 40, 33
    x, wg, wu = (_exact((M, K), 8.0, 7), _exact((K, N), 4.0, 8),
                 _exact((K, N), 4.0, 9))
    jspec, tspec = jr.parse_spec(act), tr.parse_spec(act)
    bg = tcommon.counter_bits_reduced(*SEEDS[0], (M, N), 32)
    bu = tcommon.counter_bits_reduced(*SEEDS[1], (M, N), 32)
    ab = tcommon.counter_bits_reduced(*SEEDS[2], (M, N), tspec.rand_bits,
                                      stream=1)
    kw = dict(act="silu", out_packed=True, residuals=True,
              residuals_packed=True)
    ref = jq.qmatmul_swiglu_p(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu), _u32(bg), _u32(bu),
        "binary8", "sr", act_spec=jspec,
        act_bits=_u32(ab) if tspec.stochastic else None, **kw)
    got = tq.qmatmul_swiglu(
        torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu), bg,
        bu, "binary8", "sr", act_spec=tspec,
        act_bits=ab if tspec.stochastic else None, **kw)
    assert got[0].dtype == tcommon.pack_dtype(tspec.fmt)
    assert all(g.dtype == torch.uint8 for g in got[1:])
    for r, g in zip(ref[1:], got[1:]):          # packed g_r, u_r
        assert _same(r, g)
    # the hidden, decoded: one act-grid ulp at most (SiLU's exp)
    hr = np.asarray(jcommon.unpack_block(ref[0], jspec.fmt))
    hg = tcommon.unpack_block(got[0], tspec.fmt).numpy()
    diff = _i32(hr) != _i32(hg)
    if diff.any():
        lo = np.minimum(np.abs(hr[diff]), np.abs(hg[diff]))
        assert np.all(np.abs(hr[diff] - hg[diff])
                      == np.asarray(jr.ulp(jnp.asarray(lo), jspec.fmt)))
    # the packed outputs are the codes of the float outputs; K4' agrees
    flt = tq.qmatmul_swiglu(
        torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu), bg,
        bu, "binary8", "sr", act_spec=tspec,
        act_bits=ab if tspec.stochastic else None, residuals=True)
    assert torch.equal(got[0], tcommon.pack_block(flt[0], tspec.fmt))
    prng_ = tq.qmatmul_swiglu_prng(
        torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu),
        SEEDS, "binary8", "sr", act_spec=tspec, out_packed=True,
        residuals=True, residuals_packed=True)
    assert all(torch.equal(p, g) for p, g in zip(prng_, got))


# ---------------------------------------------------------------------------
# qffn_glu under binary8-paper-packed
# ---------------------------------------------------------------------------
def _dyadic(shape, div, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, shape) / div).astype(np.float32)


def _port_grads(fn, *arrays, ct):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(ct))
    return out.detach(), [t.grad for t in ts]


def _flips_ok(ref, got, fmt):
    ref = torch.from_numpy(np.asarray(ref, np.float32).copy())
    n, adjacent = tr.grid_flips(ref, got, fmt)
    return n <= max(1, 1e-4 * ref.numel()) and adjacent


@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "prng"])
def test_qffn_glu_packed_matches_reference(interpret_params, oracle):
    """The reference's own bit-exact check of the fused chain runs packed
    and oracle together (tests/test_qdot.py); here the port's chain,
    forward and backward, against the reference's under the same policy,
    and against the port's unpacked run."""
    words = SEEDS[1]
    jpol = dataclasses.replace(jp.get_policy("binary8-paper-packed"),
                               oracle=oracle)
    tpol = dataclasses.replace(tp.get_policy("binary8-paper-packed"),
                               oracle=oracle)
    jctx = jp.QuantCtx(jpol, jnp.asarray(np.array(words, np.uint32)))
    tctx = tp.QuantCtx(tpol, words)
    x = _dyadic((2, 3, 32), 4.0, 17)
    wg, wu = _dyadic((32, 48), 8.0, 18), _dyadic((32, 48), 8.0, 19)
    wd, ct = _dyadic((48, 32), 8.0, 20), _dyadic((2, 3, 32), 2.0, 21)
    out, vjp = jax.vjp(lambda *a: jfused.qffn_glu(*a, jctx),
                       *(jnp.asarray(v) for v in (x, wg, wu, wd)))
    ref = vjp(jnp.asarray(ct))
    got, grads = _port_grads(lambda *a: tfused.qffn_glu(*a, tctx),
                             x, wg, wu, wd, ct=ct)
    assert _same(out, got)
    assert _same(ref[3], grads[3])
    for r, g in zip(ref[:3], grads[:3]):
        assert _flips_ok(r, g, "binary8")
    # packing binary8 values loses nothing: the unpacked policy's run
    unpacked = tp.QuantCtx(dataclasses.replace(tpol, packed=False), words)
    got_u, grads_u = _port_grads(lambda *a: tfused.qffn_glu(*a, unpacked),
                                 x, wg, wu, wd, ct=ct)
    assert torch.equal(got.view(torch.int32), got_u.view(torch.int32))
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(grads, grads_u))


def test_packed_policy_stores_the_hidden_as_codes(monkeypatch):
    """Under binary8-paper-packed the GLU kernel emits uint8 h, g_r, u_r
    and the down GEMM reads h as codes."""
    seen = {}
    orig_swiglu, orig_q = tq.qmatmul_swiglu_prng, tq.qmatmul_prng

    def swiglu(*a, **k):
        out = orig_swiglu(*a, **k)
        seen["glu"] = [t.dtype for t in (out if isinstance(out, tuple)
                                         else (out,))]
        return out

    def qmm(a, *rest, **k):
        seen.setdefault("down", []).append((a.dtype, k.get("a_fmt")))
        return orig_q(a, *rest, **k)
    monkeypatch.setattr(tfused, "qmatmul_swiglu_prng", swiglu)
    monkeypatch.setattr(tp, "qmatmul_prng", qmm)
    ctx = tp.QuantCtx(tp.get_policy("binary8-paper-packed"), SEEDS[0])
    x = torch.from_numpy(_dyadic((5, 32), 4.0, 22))
    w = torch.from_numpy(_dyadic((32, 48), 8.0, 23))
    tfused.qffn_glu(x, w, w, w.t().contiguous(), ctx)
    assert seen["glu"] == [torch.uint8]
    assert seen["down"] == [(torch.uint8, "binary8")]
    xg = x.clone().requires_grad_()
    tfused.qffn_glu(xg, w, w, w.t().contiguous(), ctx).sum().backward()
    assert seen["glu"] == [torch.uint8] * 3
