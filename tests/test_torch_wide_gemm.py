"""The GEMM and cast kernels' wide instances (K3', K4', K8', K1') on the
CPU: their plain twins against the reference's interpret kernels under
every spec family the reference's ``round_block`` takes, and the policy
sites that reach them.

Families (``WIDE_FAMILIES``, ``chip_smoke.py``'s kernel sweep): fixed
point, SR 2.0 at r = 8, 16 and 32, the bit trick (bfloat16's integer path
at r = 16, the complemented draw on binary8 at r = 8), the directed
roundings, overflow to ±inf, a shifted grid, a format without
subnormals, and sr_eps (the paper's SRε, on the first instances).

Tolerances: exact-sum inputs (dyadic values, K <= 64) are bitwise; the
SiLU hidden may flip at most max(1, 1e-4 n) act-grid decisions by one
step (its exp differs by float32 ulps), as ``tests/test_torch_qmatmul.py``
allows.  The policy sites (``qdot``, ``qffn_glu``, ``qeinsum``, ``qact``
under ``get_policy(<spec>)``) are held to the same limits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.core import rounding as jr
from repro.kernels import qmatmul as jq
from repro.kernels import sr_cast as jsr
from repro.precision import fused as jfused
from repro.precision import policy as jp
from repro_torch.core import rounding as tr
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import qmatmul as tq
from repro_torch.kernels import sr_cast as tsr
from repro_torch.precision import fused as tfused
from repro_torch.precision import policy as tp
from test_torch_update import _register_wide_grids

SEEDS = ((0x12345678, 0x9ABCDEF0), (7, 0xFFFFFFFF), (0xDEADBEEF, 3))

# one case per family: its spec names (K3', K8' and K1' run each; K4' the
# first as its GEMM and the last as its act site), and whether the family
# needs the wide instances
WIDE_FAMILIES = {
    "fxp": (("fxp16.8-sr2", "fxp8.4-rn"), True),
    "sr2": (("binary8-sr2", "binary8-sr2-r16", "binary8-sr2-r32"), True),
    "bittrick": (("bf16-sr-bittrick", "binary8-sr-bittrick-r8"), True),
    "directed": (("binary8-rz", "binary8-ra", "binary8-rd", "binary8-ru"),
                 True),
    "inf": (("binary8-rn-inf", "e4m3-sr-inf"), True),
    "shifted": (("shift8-sr", "shift8-rn"), True),
    "nosub": (("b8nosub-sr", "b8nosub-rn"), True),
    "sr_eps": (("binary8-sr_eps-e0.1", "binary8-sr_eps-e0.25"), False),
}


@pytest.fixture
def interpret_params(monkeypatch):
    """The reference kernels build ``pltpu.TPUCompilerParams``, which newer
    jax names ``CompilerParams``; alias it only where it is missing."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)
    _register_wide_grids()


def _exact(shape, seed, scale):
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, shape) * scale).astype(np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _seeds(rows):
    return jnp.asarray(np.array(rows, dtype=np.uint32))


def _saturating(s: tr.RoundingSpec) -> tr.RoundingSpec:
    """The spec a GEMM result site rounds with (the reference's GEMM
    kernels take no overflow)."""
    return tr.spec(s.fmt, s.mode, s.eps, s.rand_bits)


@pytest.mark.parametrize("family", sorted(WIDE_FAMILIES))
def test_k3_k8_twins_match_reference(interpret_params, family):
    """K3''s and K8''s twins bitwise the reference's ``qmatmul_prng_p`` and
    ``qmatmul_batched_prng_p`` on exact sums (large enough to reach xmax of
    the narrow grids), each spec on the instance ``gemm_instance`` picks."""
    names, wide = WIDE_FAMILIES[family]
    wide = wide and family != "inf"     # the GEMM sites saturate
    a, b = _exact((5, 40), 1, 1.0), _exact((40, 37), 2, 0.25)
    a3, b3 = _exact((3, 2, 24), 3, 0.5), _exact((3, 24, 10), 4, 0.5)
    e_seeds = np.array(SEEDS, dtype=np.int64)
    for name in names:
        s = _saturating(tr.parse_spec(name))
        assert (tq.gemm_instance(s.fmt, s.mode, s.rand_bits, s.eps)
                == "wide") == wide
        ref = jq.qmatmul_prng_p(jnp.asarray(a), jnp.asarray(b),
                                _seeds(SEEDS[0]), s.fmt, s.mode, s.eps,
                                rand_bits=s.rand_bits)
        got = tq.qmatmul_prng(torch.from_numpy(a), torch.from_numpy(b),
                              SEEDS[0], s.fmt, s.mode, s.rand_bits, eps=s.eps)
        np.testing.assert_array_equal(_bits(ref), _bits(got.numpy()), name)
        ref = jq.qmatmul_batched_prng_p(jnp.asarray(a3), jnp.asarray(b3),
                                        _seeds(SEEDS), s.fmt, s.mode, s.eps,
                                        rand_bits=s.rand_bits)
        got = tq.qmatmul_batched_prng(torch.from_numpy(a3),
                                      torch.from_numpy(b3), e_seeds, s.fmt,
                                      s.mode, s.rand_bits, eps=s.eps)
        np.testing.assert_array_equal(_bits(ref), _bits(got.numpy()), name)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("family", sorted(WIDE_FAMILIES))
def test_k4_twin_matches_reference(interpret_params, family, act):
    """K4''s twin with residuals against ``qmatmul_swiglu_prng_p``: the
    family's first spec at the GEMM sites (saturating), its last at the
    act site (overflow as the spec says, as the reference's act site
    rounds); g_r and u_r bitwise, the hidden bitwise under gelu and within
    SiLU's flips under silu."""
    names, wide = WIDE_FAMILIES[family]
    s = _saturating(tr.parse_spec(names[0]))
    act_spec = tr.parse_spec(names[-1])
    x, wg = _exact((6, 32), 5, 0.25), _exact((32, 36), 6, 0.25)
    wu = _exact((32, 36), 7, 0.25)
    assert tq.swiglu_instance(s.fmt, s.mode, s.rand_bits, s.eps,
                              act_spec) == ("wide" if wide else "fp")
    ref = jq.qmatmul_swiglu_prng_p(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu), _seeds(SEEDS),
        s.fmt, s.mode, s.eps, act=act,
        act_spec=jr.parse_spec(str(act_spec)), rand_bits=s.rand_bits,
        residuals=True)
    got = tq.qmatmul_swiglu_prng(
        torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu),
        SEEDS, s.fmt, s.mode, act=act, act_spec=act_spec,
        rand_bits=s.rand_bits, eps=s.eps, residuals=True)
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(_bits(r), _bits(g.numpy()))
    h_ref = np.asarray(ref[0], np.float32)
    if act == "gelu":
        np.testing.assert_array_equal(_bits(h_ref), _bits(got[0].numpy()))
    else:
        n, adjacent = tr.grid_flips(torch.from_numpy(h_ref.copy()), got[0],
                                    act_spec.fmt)
        assert n <= max(1, 1e-4 * h_ref.size) and adjacent, n


@pytest.mark.parametrize("family", sorted(WIDE_FAMILIES))
def test_k1_twin_matches_reference(interpret_params, family):
    """K1''s twin bitwise ``sr_cast_prng_p`` in interpret mode, overflow as
    the spec says (the reference's cast takes it), on N(0, 1) values with
    a tail past the narrow grids' xmax and -0s; K1 (explicit bits) refuses
    the wide sites."""
    names, wide = WIDE_FAMILIES[family]
    rng = np.random.default_rng(9)
    x = rng.standard_normal(3 * 128 + 37).astype(np.float32)
    x[::23] *= 3e4
    x[5::41] = -0.0
    for name in names:
        s = tr.parse_spec(name)
        assert (tsr.sr_cast_instance(s.mode, s.rand_bits, False, s.fmt,
                                     s.eps, s.overflow) == "wide") == wide
        ref = jsr.sr_cast_prng_p(jnp.asarray(x), _seeds(SEEDS[1]), s.fmt,
                                 s.mode, s.eps, rand_bits=s.rand_bits,
                                 overflow=s.overflow, interpret=True)
        got = tsr.sr_cast_prng(torch.from_numpy(x), SEEDS[1], s.fmt, s.mode,
                               s.eps, rand_bits=s.rand_bits,
                               overflow=s.overflow)
        np.testing.assert_array_equal(_bits(ref), _bits(got.numpy()), name)
        if wide:
            with pytest.raises(NotImplementedError, match="wide instance"):
                tsr.sr_cast(torch.from_numpy(x), torch.zeros(x.size),
                            s.fmt, s.mode, s.eps, rand_bits=s.rand_bits,
                            overflow=s.overflow)
    if family == "inf":
        assert np.isinf(np.asarray(ref)).any()


@pytest.mark.parametrize("name", ["binary8-sr_eps", "fxp16.8-sr2",
                                  "e4m3-sr2-r16", "binary8-rn-inf"])
def test_policy_sites_match_reference(interpret_params, name):
    """``qdot`` (forward and its dgrad/wgrad VJP), ``qffn_glu``,
    ``qeinsum`` and ``qact`` under ``get_policy(<spec>)``, the reference's
    functions under its own ``get_policy``, on exact sums: bitwise but for
    SiLU's act-grid flips, which the down GEMM then spreads over their
    rows.  The GEMM sites saturate a spec that overflows to ±inf."""
    jpol, pol = jp.get_policy(name), tp.get_policy(name)
    words = SEEDS[2]
    jctx, ctx = jp.QuantCtx(jpol, _seeds(words)), tp.QuantCtx(pol, words)
    a, b = _exact((6, 24), 11, 16.0), _exact((24, 20), 12, 16.0)

    def qdot_ref(a_, b_):
        return jp.qdot(a_, b_, jctx, tp.TAG_ATTN_Q)
    ref, vjp = jax.vjp(qdot_ref, jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = tp.qdot(ta, tb, ctx, tp.TAG_ATTN_Q)
    np.testing.assert_array_equal(_bits(ref), _bits(got.detach().numpy()))
    assert np.all(np.isfinite(np.asarray(ref)))
    ct = _exact((6, 20), 13, 0.5)
    da, db = vjp(jnp.asarray(ct))
    got.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(_bits(da), _bits(ta.grad.numpy()))
    np.testing.assert_array_equal(_bits(db), _bits(tb.grad.numpy()))

    x = _exact((1, 4, 24), 14, 0.25)
    wg, wu = _exact((24, 32), 15, 0.25), _exact((24, 32), 16, 0.25)
    wd = _exact((32, 24), 17, 0.25)
    ref = np.asarray(jfused.qffn_glu(jnp.asarray(x), jnp.asarray(wg),
                                     jnp.asarray(wu), jnp.asarray(wd),
                                     jctx), np.float32)
    got = tfused.qffn_glu(torch.from_numpy(x), torch.from_numpy(wg),
                          torch.from_numpy(wu), torch.from_numpy(wd), ctx)
    rows = np.any(_bits(ref) != _bits(got.numpy()), axis=-1)
    assert rows.sum() <= 1, int(rows.sum())

    a3, b3 = _exact((4, 3, 40), 18, 0.125), _exact((4, 40, 24), 19, 0.25)
    ref = jp.qeinsum("ecd,edf->ecf", jnp.asarray(a3), jnp.asarray(b3), jctx,
                     tp.TAG_MOE_UP)
    got = tp.qeinsum("ecd,edf->ecf", torch.from_numpy(a3),
                     torch.from_numpy(b3), ctx, tp.TAG_MOE_UP)
    np.testing.assert_array_equal(_bits(ref), _bits(got.numpy()))

    xa = (np.random.default_rng(20).standard_normal((3, 5, 37))
          * 2e4).astype(np.float32)
    ref = jp.qact(jnp.asarray(xa), jctx, tp.TAG_MOE_ACT)
    got = tp.qact(torch.from_numpy(xa), ctx, tp.TAG_MOE_ACT)
    np.testing.assert_array_equal(_bits(ref), _bits(got.numpy()))
    if pol.act.overflow == "inf":          # the reference's qact saturates
        assert np.all(np.isfinite(np.asarray(ref)))


def test_wide_sites_need_the_wide_instances():
    """Which instance each site runs, and the packed storage that stays
    refused on grids that are not plain FP (``_pack_grid``)."""
    _register_wide_grids()
    assert tq.gemm_instance("binary8", "sr") == "fp"
    assert tq.gemm_instance("binary8", "sr_eps", eps=0.1) == "fp"
    assert tq.gemm_instance("binary8", "sr2", 8) == "wide"
    assert tq.gemm_instance("fxp16.8", "rn") == "wide"
    assert tq.swiglu_instance("binary8", "sr", act_spec=tr.parse_spec(
        "binary8-sr-inf")) == "wide"
    assert tq.swiglu_instance("binary8", "sr", act_spec=tr.parse_spec(
        "binary8-sr")) == "fp"
    assert tsr.sr_cast_instance("sr", 32, False, "binary8", 0.0,
                                "inf") == "wide"
    assert tcommon.fp_site(tr.parse_spec("binary8-signed_sr_eps"))
    a = torch.ones((2, 8))
    with pytest.raises(NotImplementedError, match="not a plain FP grid"):
        tq.qmatmul_prng(a, torch.ones((8, 4)), SEEDS[0], "shift8", "sr",
                        out_packed=True)
    with pytest.raises(NotImplementedError, match="not a plain FP grid"):
        tq.qmatmul_prng(torch.zeros((2, 8), dtype=torch.uint8),
                        torch.ones((8, 4)), SEEDS[0], "binary8", "sr",
                        a_fmt="shift8")
