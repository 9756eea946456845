"""The port's explicit-bits ("oracle") mode against the JAX reference.

The explicit-bits kernels K3, K4, K8 and K1 take their random words as an
operand.  On the CPU the port's wrappers run their plain twins; the
reference runs ``qmatmul_p``, ``qmatmul_swiglu_p``, ``qmatmul_batched_p``
and ``sr_cast_p`` in Pallas interpret mode.  Both are fed the same words
(drawn once, by the port's ``common`` counters, and handed to both as
numpy arrays).

Tolerances (the repo's parity contract):
* elementwise paths (K1, K1''s ``v`` branch, the ``ops`` wrappers of the
  SR cast and the eq.-8 update, the oracles of ``kernels.ref``): bitwise;
* GEMM paths: bitwise on exact-sum inputs (dyadic values, every partial
  sum exact); on N(0, 1) inputs at most 1e-4 of the elements differ, each
  by one grid ulp (float32 sums in another order than XLA's); the fused
  GLU's hidden goes through SiLU, whose ``exp`` may differ by a float32
  ulp, so it is held to the same one-ulp rule on exact sums;
* the oracle site GEMMs equal the in-kernel (prng) flavour bitwise in both
  packages, the SR casts excepted (the oracle ``qact`` keys its bits by
  the flat index, K1' by 128 lanes);
* reduced serving: the serve tests' statistical logit bound and greedy
  picks up to near-ties (``tests/test_torch_serve.py``); the oracle run
  of the port equals its in-kernel run bitwise;
* a reduced train step: the losses within 5e-7 relative and at most 8
  parameters different (``tests/test_torch_train.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.core import gd as jgd
from repro.core import rounding as jr
from repro.kernels import ops as jops
from repro.kernels import qmatmul as jq
from repro.kernels import ref as jref
from repro.kernels import sr_cast as jsr
from repro.precision import policy as jp
from repro_torch.core import gd as tgd
from repro_torch.core import prng
from repro_torch.core import rounding as tr
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmatmul as tq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sr_cast as tsr
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


def _normal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _u32(bits: torch.Tensor):
    """Port bits (int64 uint32 values) as the reference's uint32 operand."""
    return jnp.asarray(bits.numpy().astype(np.uint32))


def _i32(x):
    return np.asarray(x, np.float32).view(np.int32)


def _assert_one_ulp(ref, got, fmt, share=1e-4):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    diff = ref.view(np.int32) != got.view(np.int32)
    n = int(diff.sum())
    assert n <= max(share * ref.size, 0), (n, ref.size)
    if n:
        lo = np.minimum(np.abs(ref[diff]), np.abs(got[diff]))
        ulp = np.asarray(jr.ulp(jnp.asarray(lo), fmt))
        assert np.all(np.abs(ref[diff] - got[diff]) == ulp)
    return n


def _bits(words, shape, rb, stream=0):
    return tcommon.counter_bits_reduced(words[0], words[1], shape, rb,
                                        stream=stream)


# ---------------------------------------------------------------------------
# K3, K8: the explicit-bits GEMMs
# ---------------------------------------------------------------------------
GEMM_CASES = [("binary8", "sr", 32), ("binary8", "sr", 16),
              ("binary8", "sr", 8), ("e4m3", "sr", 32),
              ("bfloat16", "sr", 16), ("binary8", "rn", 32),
              ("e4m3", "rn", 32)]


@pytest.mark.parametrize("fmt,mode,rb", GEMM_CASES)
def test_qmatmul_bits_twin_matches_reference(interpret_params, fmt, mode,
                                             rb):
    for (M, K, N), seed in (((37, 45, 70), 1), ((1, 130, 3), 2)):
        a, b = _exact((M, K), 8.0, seed), _exact((K, N), 4.0, seed + 10)
        bits = _bits(SEEDS[0], (M, N), rb)
        ref = jq.qmatmul_p(jnp.asarray(a), jnp.asarray(b), _u32(bits), fmt,
                           mode, rand_bits=rb)
        got = tq.qmatmul(torch.from_numpy(a), torch.from_numpy(b), bits,
                         fmt, mode, rb)
        np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))
        # fed the in-kernel draw's words, K3 is K3'
        prng_ = tq.qmatmul_prng(torch.from_numpy(a), torch.from_numpy(b),
                                SEEDS[0], fmt, mode, rb)
        assert torch.equal(prng_.view(torch.int32), got.view(torch.int32))


def test_qmatmul_bits_random_inputs_one_ulp(interpret_params):
    a, b = _normal((128, 64), 3), _normal((64, 96), 4)
    bits = tcommon.counter_bits(*SEEDS[2], (128, 96))
    ref = jq.qmatmul_p(jnp.asarray(a), jnp.asarray(b), _u32(bits), "binary8")
    got = tq.qmatmul(torch.from_numpy(a), torch.from_numpy(b), bits,
                     "binary8")
    _assert_one_ulp(ref, got.numpy(), "binary8")


@pytest.mark.parametrize("fmt,mode,rb", GEMM_CASES[:3] + GEMM_CASES[5:6])
def test_qmatmul_batched_bits_twin_matches_reference(interpret_params, fmt,
                                                     mode, rb):
    """M = 3, a whole prompt's capacity M = 10 and M = 17 (two row tiles of the
    card's weight-stream route)."""
    E, K, N = 5, 70, 50
    seeds = np.random.default_rng(7).integers(0, 2 ** 32, (E, 2),
                                              dtype=np.int64)
    for M in (3, 10, 17):
        a, b = _exact((E, M, K), 8.0, 5 + M), _exact((E, K, N), 4.0, 6 + M)
        bits = tcommon.counter_bits_batch(seeds, (E, M, N), rb)
        ref = jq.qmatmul_batched_p(jnp.asarray(a), jnp.asarray(b),
                                   _u32(bits), fmt, mode, rand_bits=rb)
        got = tq.qmatmul_batched(torch.from_numpy(a), torch.from_numpy(b),
                                 bits, fmt, mode, rb)
        np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()),
                                      err_msg=f"M={M}")
        prng_ = tq.qmatmul_batched_prng(torch.from_numpy(a),
                                        torch.from_numpy(b), seeds, fmt,
                                        mode, rb)
        assert torch.equal(prng_.view(torch.int32), got.view(torch.int32))


# ---------------------------------------------------------------------------
# K4: the explicit-bits fused GLU prefix
# ---------------------------------------------------------------------------
ACT_CASES = {"binary8-sr": ("sr", 32), "binary8-sr-r16": ("sr", 16),
             "binary8-rn": ("rn", 32), "none": ("sr", 32)}


@pytest.mark.parametrize("act", sorted(ACT_CASES))
def test_swiglu_bits_twin_matches_reference(interpret_params, act):
    mode, rb = ACT_CASES[act]
    M, K, N = 21, 40, 33
    x, wg, wu = (_exact((M, K), 8.0, 11), _exact((K, N), 4.0, 12),
                 _exact((K, N), 4.0, 13))
    jspec = None if act == "none" else jr.parse_spec(act)
    tspec = None if act == "none" else tr.parse_spec(act)
    bg, bu = _bits(SEEDS[0], (M, N), rb), _bits(SEEDS[1], (M, N), rb)
    ab = None
    if tspec is not None and tspec.stochastic:
        ab = _bits(SEEDS[2], (M, N), tspec.rand_bits, stream=1)
    ref = jq.qmatmul_swiglu_p(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu), _u32(bg), _u32(bu),
        "binary8", mode, act="silu", act_spec=jspec,
        act_bits=None if ab is None else _u32(ab), residuals=True,
        rand_bits=rb)
    got = tq.qmatmul_swiglu(torch.from_numpy(x), torch.from_numpy(wg),
                            torch.from_numpy(wu), bg, bu, "binary8", mode,
                            act_spec=tspec, act_bits=ab, rand_bits=rb,
                            residuals=True)
    for r, g in zip(ref[1:], got[1:]):          # the rounded branches
        np.testing.assert_array_equal(_i32(r), _i32(g.numpy()))
    if act == "none":
        np.testing.assert_allclose(np.asarray(ref[0]), got[0].numpy(),
                                   rtol=2e-6, atol=0)
    else:
        assert _assert_one_ulp(ref[0], got[0].numpy(), "binary8",
                               share=0.0) == 0
    # K4 fed K4''s words is K4'
    prng_ = tq.qmatmul_swiglu_prng(
        torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu),
        SEEDS, "binary8", mode, act_spec=tspec, rand_bits=rb,
        residuals=True)
    assert all(torch.equal(p.view(torch.int32), g.view(torch.int32))
               for p, g in zip(prng_, got))


def test_swiglu_bits_requires_its_operands():
    x, w = torch.ones(2, 4), torch.ones(4, 3)
    with pytest.raises(ValueError, match="bits"):
        tq.qmatmul_swiglu(x, w, w, None, None, "binary8", "sr")
    with pytest.raises(ValueError, match="act_bits"):
        tq.qmatmul_swiglu(x, w, w, None, None, "binary8", "rn",
                          act_spec=tr.spec("binary8", "sr"))
    with pytest.raises(ValueError, match="bits"):
        tq.qmatmul(x, w, torch.zeros(3, 3, dtype=torch.int64), "binary8")


# ---------------------------------------------------------------------------
# K1 and the signed-SRe branch of K1 and K1'
# ---------------------------------------------------------------------------
CAST_CASES = [("binary8", "sr", 32, 0.0), ("binary8", "sr", 8, 0.0),
              ("e4m3", "sr_eps", 16, 0.1), ("binary8", "rn", 32, 0.0),
              ("binary8", "signed_sr_eps", 32, 0.1),
              ("bfloat16", "signed_sr_eps", 32, 0.3)]


@pytest.mark.parametrize("fmt,mode,rb,eps", CAST_CASES)
def test_sr_cast_bits_twin_matches_reference(fmt, mode, rb, eps):
    shape = (3, 7, 61)                          # n not a multiple of 128
    x = _normal(shape, 21, 4.0)
    v = _normal(shape, 22)
    v.reshape(-1)[::5] = 0.0
    needs_v = tr.spec(fmt, mode).scheme.needs_v
    vj = jnp.asarray(v) if needs_v else None
    vt = torch.from_numpy(v) if needs_v else None
    bits = prng.random_bits((5, 6), shape)
    ref = jsr.sr_cast_p(jnp.asarray(x), _u32(bits), fmt, mode, eps, vj,
                        rand_bits=rb, interpret=True)
    got = tsr.sr_cast(torch.from_numpy(x), bits, fmt, mode, eps, vt,
                      rand_bits=rb)
    np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))
    ref = jsr.sr_cast_prng_p(jnp.asarray(x), jnp.asarray(SEEDS[1],
                                                         jnp.uint32),
                             fmt, mode, eps, vj, rand_bits=rb,
                             interpret=True)
    got = tsr.sr_cast_prng(torch.from_numpy(x), SEEDS[1], fmt, mode, eps, vt,
                           rand_bits=rb)
    np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))


# ---------------------------------------------------------------------------
# kernels.ops and kernels.ref against the reference's, one PRNGKey
# ---------------------------------------------------------------------------
def test_ops_match_reference_given_the_same_key(interpret_params):
    jkey, tkey = jax.random.PRNGKey(42), prng.PRNGKey(42)
    x = _normal((5, 77), 31, 3.0)
    v = _normal((5, 77), 32)
    for mode, eps, vv in (("sr", 0.0, None), ("signed_sr_eps", 0.1, v)):
        ja = dict(v=None if vv is None else jnp.asarray(vv), interpret=True)
        ta = dict(v=None if vv is None else torch.from_numpy(vv))
        for jf, tf in ((jops.sr_cast, tops.sr_cast),
                       (jops.sr_cast_prng, tops.sr_cast_prng)):
            ref = jf(jnp.asarray(x), jkey, "binary8", mode, eps, **ja)
            got = tf(torch.from_numpy(x), tkey, "binary8", mode, eps, **ta)
            np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))
    a, b = _exact((9, 24), 8.0, 33), _exact((24, 13), 4.0, 34)
    for jf, tf in ((jops.qmatmul_lowp, tops.qmatmul_lowp),
                   (jops.qmatmul_lowp_prng, tops.qmatmul_lowp_prng)):
        ref = jf(jnp.asarray(a), jnp.asarray(b), jkey, "e4m3", "sr")
        got = tf(torch.from_numpy(a), torch.from_numpy(b), tkey, "e4m3",
                 "sr")
        np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))
    xs, g = _normal(300, 35, 0.05), _normal(300, 36, 0.3)
    names = ("binary8-rn", "binary8-sr", "binary8-signed_sr_eps-e0.1")
    jcfg = jgd.GDRounding(*(jr.parse_spec(n) for n in names))
    tcfg = tgd.GDRounding(*(tr.parse_spec(n) for n in names))
    for jf, tf in ((jops.fused_qupdate, tops.fused_qupdate),
                   (jops.fused_qupdate_prng, tops.fused_qupdate_prng)):
        ref = jf(jnp.asarray(xs), jnp.asarray(g), 0.05, jkey, jcfg,
                 interpret=True)
        got = tf(torch.from_numpy(xs), torch.from_numpy(g), 0.05, tkey,
                 tcfg)
        np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))


def test_ref_oracles_match_reference():
    x = _normal((4, 50), 41, 2.0)
    v = _normal((4, 50), 42)
    bits = prng.random_bits((1, 2), (4, 50))
    for mode, eps, vv in (("sr", 0.0, None), ("sr_eps", 0.2, None),
                          ("signed_sr_eps", 0.1, v)):
        ref = jref.sr_cast_ref(jnp.asarray(x), _u32(bits), "binary8", mode,
                               eps, None if vv is None else jnp.asarray(vv))
        got = tref.sr_cast_ref(torch.from_numpy(x), bits, "binary8", mode,
                               eps, None if vv is None
                               else torch.from_numpy(vv))
        np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))
    a, b = _exact((6, 20), 8.0, 43), _exact((20, 9), 4.0, 44)
    bits = prng.random_bits((3, 4), (6, 9))
    for mode in ("sr", "rn"):
        ref = jref.qmatmul_ref(jnp.asarray(a), jnp.asarray(b), _u32(bits),
                               "binary8", mode)
        got = tref.qmatmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                               bits, "binary8", mode)
        np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))
        # the oracle agrees with K3's twin on exact sums
        twin = tq.qmatmul(torch.from_numpy(a), torch.from_numpy(b), bits,
                          "binary8", mode)
        assert torch.equal(twin.view(torch.int32), got.view(torch.int32))
    xs, g = _normal(200, 45, 0.05), _normal(200, 46, 0.3)
    bits3 = prng.random_bits((7, 8), (3, 200))
    names = ("binary8-rn", "binary8-sr", "binary8-signed_sr_eps-e0.1")
    ref = jref.fused_qupdate_ref(
        jnp.asarray(xs), jnp.asarray(g), 0.05, _u32(bits3),
        jgd.GDRounding(*(jr.parse_spec(n) for n in names)))
    got = tref.fused_qupdate_ref(
        torch.from_numpy(xs), torch.from_numpy(g), 0.05, bits3,
        tgd.GDRounding(*(tr.parse_spec(n) for n in names)))
    np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))


# ---------------------------------------------------------------------------
# The policy sites under oracle
# ---------------------------------------------------------------------------
def _policies(preset):
    return (dataclasses.replace(jp.get_policy(preset), oracle=True),
            dataclasses.replace(tp.get_policy(preset), oracle=True),
            jp.get_policy(preset), tp.get_policy(preset))


@pytest.mark.parametrize("preset", ["e4m3-sr", "binary8-paper-r16",
                                    "bf16-rn"])
def test_site_matmul_oracle_equals_prng_in_both_packages(interpret_params,
                                                         preset):
    jor, tor, jpr, tpr = _policies(preset)
    a, b = _exact((6, 40), 8.0, 51), _exact((40, 19), 4.0, 52)
    words = SEEDS[0]
    jw = jnp.asarray(np.array(words, np.uint32))
    for site in (tp.SITE_FWD, tp.SITE_DGRAD, tp.SITE_WGRAD):
        got = tp.site_matmul(tor, site, torch.from_numpy(a),
                             torch.from_numpy(b), words)
        same = tp.site_matmul(tpr, site, torch.from_numpy(a),
                              torch.from_numpy(b), words)
        ref = jp.site_matmul(jor, site, jnp.asarray(a), jnp.asarray(b), jw)
        ref_prng = jp.site_matmul(jpr, site, jnp.asarray(a), jnp.asarray(b),
                                  jw)
        np.testing.assert_array_equal(_i32(ref), _i32(ref_prng))
        np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))
        assert torch.equal(got.view(torch.int32), same.view(torch.int32))
    E = 4
    a3, b3 = _exact((E, 2, 40), 8.0, 53), _exact((E, 40, 11), 4.0, 54)
    got = tp.batched_site_matmul(tor, tp.SITE_FWD, torch.from_numpy(a3),
                                 torch.from_numpy(b3), words)
    same = tp.batched_site_matmul(tpr, tp.SITE_FWD, torch.from_numpy(a3),
                                  torch.from_numpy(b3), words)
    ref = jp.batched_site_matmul(jor, tp.SITE_FWD, jnp.asarray(a3),
                                 jnp.asarray(b3), jw)
    ref_prng = jp.batched_site_matmul(jpr, tp.SITE_FWD, jnp.asarray(a3),
                                      jnp.asarray(b3), jw)
    np.testing.assert_array_equal(_i32(ref), _i32(ref_prng))
    np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))
    assert torch.equal(got.view(torch.int32), same.view(torch.int32))


def test_qact_oracle_matches_reference():
    """The oracle act site keys its bits by the flat index (K1): equal to
    the reference's, and another draw than K1''s 128-lane one."""
    jor, tor, _, tpr = _policies("binary8-paper")
    x = _normal((2, 3, 100), 61, 3.0)
    words = SEEDS[1]
    jctx = jp.QuantCtx(jor, jnp.asarray(np.array(words, np.uint32)))
    ref = jp.qact(jnp.asarray(x), jctx, tp.TAG_MOE_ACT)
    got = tp.qact(torch.from_numpy(x), tp.QuantCtx(tor, words),
                  tp.TAG_MOE_ACT)
    np.testing.assert_array_equal(_i32(ref), _i32(got.numpy()))
    lanes = tp.qact(torch.from_numpy(x), tp.QuantCtx(tpr, words),
                    tp.TAG_MOE_ACT)
    assert not torch.equal(lanes, got)


# ---------------------------------------------------------------------------
# Resolution: a spec the kernels do not take raises when the policy is made
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,site", [("binary8-sr_eps-e0.1", "fwd"),
                                       ("binary8-sr2", "fwd"),
                                       ("fxp16.8-sr", "fwd"),
                                       ("binary8-rz", "fwd")])
def test_policy_resolution_names_the_unported_site(name, site):
    """Every spec name the reference's policies take resolves to the same
    sites (the GEMM kernels' wide instances round what their first
    instances do not); under ``oracle`` the explicit-bits kernels have the
    first instances alone, so a spec that needs a wide one raises there,
    naming the site."""
    pol, ref = tp.get_policy(name), jp.get_policy(name)
    for attr in ("fwd", "dgrad", "wgrad", "act"):
        assert getattr(pol, attr) == tr.parse_spec(str(getattr(ref, attr)))
    s = getattr(pol, site)
    if tcommon.fp_site(s):
        assert tp.make_policy(s, s, s, s, oracle=True).oracle
    else:
        with pytest.raises(NotImplementedError, match=repr(site)):
            tp.make_policy(s, s, s, s, oracle=True)


def test_policy_resolution_checks_each_site():
    sr2 = tr.spec("binary8", "sr2", rand_bits=8)
    with pytest.raises(NotImplementedError, match="'act'"):
        tp.make_policy(fmt="binary8", act=sr2, oracle=True)
    with pytest.raises(NotImplementedError, match="'wgrad'"):
        tp.make_policy(fmt="binary8", wgrad=sr2, oracle=True)
    # the GEMM sites saturate whatever the spec says, the oracle's too
    inf = tr.spec("binary8", "sr", overflow="inf")
    assert tp.make_policy(fmt="binary8", wgrad=inf, oracle=True).wgrad == inf
    # the fused GLU's act site and the activation cast alone take sr_eps
    eps = tr.spec("binary8", "sr_eps", eps=0.1)
    assert tp.make_policy(fmt="binary8", act=eps).act == eps
    pol = tp.make_policy(act=eps)
    x = torch.from_numpy(_normal((3, 40), 62))
    got = tp.qact(x, tp.QuantCtx(pol, SEEDS[0]), 1)
    assert torch.equal(got, tsr.sr_cast_prng(
        x, tp.fold_words(tp.fold_words(SEEDS[0], 1), tp.SITE_ACT),
        "binary8", "sr_eps", 0.1))
    for name in tp.PRESETS:
        tp.get_policy(name)
    assert tp.get_policy("e4m3-sr-oracle").oracle
    assert tp.get_policy("binary8-paper-packed").packed


def test_attention_oracle_routes_to_the_plain_twins(monkeypatch):
    """Under ``oracle`` the flash forward, both backward passes and the
    decode run the kernels' plain twins (the reference's oracle routes
    them to its jnp references), never the kernel wrappers."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.precision import attention as tpa

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper ran under oracle")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_decode"):
        monkeypatch.setattr(tfa, name, refuse)
    pol = dataclasses.replace(tp.get_policy("binary8-paper-attn"),
                              oracle=True)
    ctx = tp.QuantCtx(pol, SEEDS[0])
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 8, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 8, 2, 16, generator=g, requires_grad=True)
    out = tpa.qattention(q, k, v, ctx, scale=0.25, q_block=4, kv_block=4)
    out.sum().backward()
    assert q.grad is not None and k.grad is not None
    dec = tpa.qattn_decode(q[:, :1].detach(), k.detach().transpose(1, 2),
                           v.detach().transpose(1, 2), 5, ctx, scale=0.25)
    assert dec.shape == (2, 1, 4, 16) and bool(torch.isfinite(dec).all())
