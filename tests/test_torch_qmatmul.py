"""The port's rounded-GEMM kernel modules against the JAX reference.

The port's wrappers on CPU tensors run their plain twins; the reference
runs ``qmatmul_prng_p`` / ``qmatmul_swiglu_prng_p`` in Pallas interpret
mode, which draws the same counter bits from the same seed words.

Tolerances:
* exact-sum inputs (dyadic values, K <= 64): bitwise equal;
* N(0, 1) inputs: the float32 GEMMs sum in another order (and SiLU's exp
  differs by ulps), which can move a value across a rounding decision, so
  at most 1e-4 of the elements may differ, each by exactly one grid ulp.

The CUDA kernels are held against the same twins on the card in
tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.core import rounding as jr
from repro.kernels import qmatmul as jq
from repro_torch.core import rounding as tr
from repro_torch.kernels import qmatmul as tq
from repro_torch.precision import fused as tfused
from repro_torch.precision import policy as tp


@pytest.fixture
def interpret_params(monkeypatch):
    """The reference kernels build ``pltpu.TPUCompilerParams``, which newer
    jax names ``CompilerParams``; alias it only where it is missing."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


SEEDS = ((0x12345678, 0x9ABCDEF0), (7, 0xFFFFFFFF), (0xDEADBEEF, 3))


def _exact_inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    a = (rng.integers(-8, 9, (M, K)) / 8.0).astype(np.float32)
    b = (rng.integers(-8, 9, (K, N)) / 4.0).astype(np.float32)
    return a, b


def _normal_inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _assert_one_ulp(ref, got, fmt, share=1e-4):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    diff = ref.view(np.int32) != got.view(np.int32)
    n = int(diff.sum())
    assert n <= share * ref.size, (n, ref.size)
    if n:
        # neighbours on the grid are one spacing of the smaller magnitude
        lo = np.minimum(np.abs(ref[diff]), np.abs(got[diff]))
        ulp = np.asarray(jr.ulp(jnp.asarray(lo), fmt))
        assert np.all(np.abs(ref[diff] - got[diff]) == ulp)
    return n


def _seed_arr(w):
    return jnp.asarray(np.array(w, dtype=np.uint32))


@pytest.mark.parametrize("fmt,mode,rb", [("binary8", "sr", 32),
                                         ("binary8", "sr", 16),
                                         ("binary8", "sr", 8),
                                         ("binary8", "rn", 32),
                                         ("e4m3", "sr", 32),
                                         ("binary16", "sr", 16)])
def test_qmatmul_plain_bitwise_on_exact_sums(interpret_params, fmt, mode, rb):
    a, b = _exact_inputs(37, 45, 70, seed=rb)
    for words in SEEDS[:2]:
        ref = jq.qmatmul_prng_p(jnp.asarray(a), jnp.asarray(b),
                                _seed_arr(words), fmt, mode, rand_bits=rb)
        got = tq.qmatmul_prng(torch.from_numpy(a), torch.from_numpy(b),
                              words, fmt, mode, rb)
        assert np.array_equal(np.asarray(ref).view(np.int32),
                              got.numpy().view(np.int32))


@pytest.mark.parametrize("fmt,mode", [("binary8", "sr"), ("e4m3", "rn")])
def test_qmatmul_plain_random_inputs_one_ulp(interpret_params, fmt, mode):
    a, b = _normal_inputs(128, 64, 96, seed=3)
    words = SEEDS[2]
    ref = jq.qmatmul_prng_p(jnp.asarray(a), jnp.asarray(b), _seed_arr(words),
                            fmt, mode)
    got = tq.qmatmul_prng(torch.from_numpy(a), torch.from_numpy(b), words,
                          fmt, mode)
    _assert_one_ulp(ref, got.numpy(), fmt)


def test_qmatmul_bf16_weights_equal_f32_weights():
    """The kernels take bf16 weights and widen them exactly: the same
    result as bf16-rounded weights passed as float32 (the reference)."""
    a, b = _normal_inputs(9, 33, 20, seed=5)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    got16 = tq.qmatmul_prng(torch.from_numpy(a), bt, SEEDS[0], "binary8")
    got32 = tq.qmatmul_prng(torch.from_numpy(a), bt.float(), SEEDS[0],
                            "binary8")
    assert torch.equal(got16.view(torch.int32), got32.view(torch.int32))


ACT_SPECS = {"binary8-sr": tr.spec("binary8", "sr"),
             "binary8-rn": tr.spec("binary8", "rn"),
             "binary8-sr-r16": tr.spec("binary8", "sr", rand_bits=16),
             "none": None}


def _jspec(name):
    return None if name == "none" else jr.parse_spec(name)


@pytest.mark.parametrize("mode,rb,act", [("sr", 32, "binary8-sr"),
                                         ("sr", 16, "binary8-sr-r16"),
                                         ("rn", 32, "binary8-rn"),
                                         ("sr", 32, "none")])
def test_swiglu_plain_matches(interpret_params, mode, rb, act):
    seeds = SEEDS
    # exact sums: bitwise on the two rounded branches; SiLU keeps the
    # product within one ulp of the act grid (exp differs by ulps)
    x, wg = _exact_inputs(21, 40, 33, seed=11)
    _, wu = _exact_inputs(21, 40, 33, seed=12)
    ref = jq.qmatmul_swiglu_prng_p(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
        _seed_arr(seeds), "binary8", mode, act="silu",
        act_spec=_jspec(act), rand_bits=rb)[0]
    got = tq.qmatmul_swiglu_prng(torch.from_numpy(x), torch.from_numpy(wg),
                                 torch.from_numpy(wu), seeds, "binary8",
                                 mode, act_spec=ACT_SPECS[act],
                                 rand_bits=rb)
    if act == "none":
        np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=2e-6,
                                   atol=0)
    else:
        assert _assert_one_ulp(ref, got.numpy(), "binary8", share=0.0) == 0

    # random inputs: at most 1e-4 one-ulp flips of the hidden
    x, wg = _normal_inputs(128, 64, 96, seed=13)
    _, wu = _normal_inputs(128, 64, 96, seed=14)
    ref = jq.qmatmul_swiglu_prng_p(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
        _seed_arr(seeds), "binary8", mode, act="silu",
        act_spec=_jspec(act), rand_bits=rb)[0]
    got = tq.qmatmul_swiglu_prng(torch.from_numpy(x), torch.from_numpy(wg),
                                 torch.from_numpy(wu), seeds, "binary8",
                                 mode, act_spec=ACT_SPECS[act],
                                 rand_bits=rb)
    if act == "none":
        np.testing.assert_allclose(np.asarray(ref), got.numpy(), rtol=1e-4,
                                   atol=1e-5)
    else:
        _assert_one_ulp(ref, got.numpy(), "binary8")


def test_qffn_glu_matches_reference(interpret_params):
    """The fused FFN forward (seed folds, bf16 weight cast, down GEMM)
    against the reference's qffn_glu on exact-sum inputs."""
    from repro.precision import fused as jfused
    from repro.precision import policy as jp
    rng = np.random.default_rng(21)
    x = (rng.integers(-4, 5, (2, 3, 32)) / 4.0).astype(np.float32)
    wg = (rng.integers(-4, 5, (32, 48)) / 8.0).astype(np.float32)
    wu = (rng.integers(-4, 5, (32, 48)) / 8.0).astype(np.float32)
    wd = (rng.integers(-4, 5, (48, 32)) / 8.0).astype(np.float32)
    words = (0x01234567, 0x89ABCDEF)
    jctx = jp.QuantCtx(jp.PRESETS["binary8-paper"], _seed_arr(words))
    tctx = tp.QuantCtx(tp.PRESETS["binary8-paper"], words)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jfused.qffn_glu(xb, jnp.asarray(wg), jnp.asarray(wu),
                          jnp.asarray(wd), jctx)
    got = tfused.qffn_glu(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(wg), torch.from_numpy(wu),
                          torch.from_numpy(wd), tctx)
    ref = np.asarray(ref.astype(jnp.float32))
    diff = ref != got.float().numpy()
    # the hidden's SiLU may flip one act-grid decision; the down GEMM then
    # differs in that row only
    assert diff.sum() <= 2 * 32, int(diff.sum())


def test_qdot_matches_reference(interpret_params):
    from repro.precision import policy as jp
    a, b = _exact_inputs(6, 24, 40, seed=31)
    words = (11, 22)
    for preset in ("binary8-paper", "e4m3-sr", "binary8-rn", "fp32"):
        jctx = jp.QuantCtx(jp.PRESETS[preset], _seed_arr(words)) \
            if preset != "fp32" else None
        tctx = tp.QuantCtx(tp.PRESETS[preset], words) \
            if preset != "fp32" else None
        ref = jp.qdot(jnp.asarray(a), jnp.asarray(b), jctx, tp.TAG_ATTN_V)
        got = tp.qdot(torch.from_numpy(a), torch.from_numpy(b), tctx,
                      tp.TAG_ATTN_V)
        assert np.array_equal(np.asarray(ref), got.numpy()), preset


def test_cpu_tensors_take_the_plain_twin_and_count_no_launch():
    tq.reset_launches()
    a, b = _normal_inputs(4, 16, 8, seed=1)
    tq.qmatmul_prng(torch.from_numpy(a), torch.from_numpy(b), SEEDS[0],
                    "binary8")
    tq.qmatmul_swiglu_prng(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(b), SEEDS, "binary8")
    tq.qmatmul_batched_prng(torch.from_numpy(a)[None],
                            torch.from_numpy(b)[None], [SEEDS[0]],
                            "binary8")
    tq.qmatmul(torch.from_numpy(a), torch.from_numpy(b), None, "binary8",
               "rn")
    assert tq.LAUNCHES == dict.fromkeys(tq.LAUNCHES, 0)
    assert set(tq.LAUNCHES) == {"qmatmul_sr", "qmatmul_swiglu_sr",
                                "qmatmul_batched_sr", "qmatmul_bits",
                                "qmatmul_swiglu_bits", "qmatmul_batched_bits"}


@pytest.mark.parametrize("kwargs", [dict(bias=torch.zeros(8)),
                                    dict(eps=0.1),
                                    dict(act_spec=tr.spec("binary8", "sr")),
                                    dict(overflow="inf"),
                                    dict(act="gelu"), dict(act="silu")])
def test_qmatmul_raises_on_unported_options(interpret_params, kwargs):
    """The bias and activation epilogues of K3/K3' (no ported config has a
    non-GLU FFN) raise, and so does overflow='inf' (the reference's GEMM
    kernels take no overflow: their results saturate); eps is ported (here
    under sr, where it changes nothing, as in the reference's kernel); a_fmt
    and out_packed are ported (tests/test_torch_packed.py)."""
    a, b = _normal_inputs(4, 16, 8, seed=1)
    if "eps" in kwargs:
        ref = jq.qmatmul_prng_p(jnp.asarray(a), jnp.asarray(b),
                                _seed_arr(SEEDS[0]), "binary8", "sr",
                                kwargs["eps"])
        got = tq.qmatmul_prng(torch.from_numpy(a), torch.from_numpy(b),
                              SEEDS[0], "binary8", **kwargs)
        _assert_one_ulp(ref, got.numpy(), "binary8")
        return
    with pytest.raises(NotImplementedError):
        tq.qmatmul_prng(torch.from_numpy(a), torch.from_numpy(b), SEEDS[0],
                        "binary8", **kwargs)


@pytest.mark.parametrize("fmt,mode", [("binary8", "sr_eps"),
                                      ("binary8", "sr2"),
                                      ("bfloat16", "sr_bittrick"),
                                      ("binary8", "signed_sr_eps"),
                                      ("fxp16.8", "sr")])
def test_qmatmul_raises_on_unported_schemes_and_grids(interpret_params, fmt,
                                                      mode):
    """Every scheme x grid pair of the reference's round_block is ported
    to K3' and K4' (their wide instances on the card): bitwise the
    reference's interpret kernels on exact sums, K4''s rounded branches
    too.  signed_sr_eps needs a bias direction that a GEMM result has not:
    ValueError, as the reference's ``_check_mode`` raises."""
    a, b = _exact_inputs(4, 16, 8, seed=1)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    if mode == "signed_sr_eps":
        with pytest.raises(ValueError):
            jq.qmatmul_prng_p(jnp.asarray(a), jnp.asarray(b),
                              _seed_arr(SEEDS[0]), fmt, mode)
        with pytest.raises(ValueError):
            tq.qmatmul_prng(at, bt, SEEDS[0], fmt, mode)
        with pytest.raises(ValueError):
            tq.qmatmul_swiglu_prng(at, bt, bt, SEEDS, fmt, mode)
        return
    eps = 0.25 if mode == "sr_eps" else 0.0
    ref = jq.qmatmul_prng_p(jnp.asarray(a), jnp.asarray(b),
                            _seed_arr(SEEDS[0]), fmt, mode, eps)
    got = tq.qmatmul_prng(at, bt, SEEDS[0], fmt, mode, eps=eps)
    assert np.array_equal(np.asarray(ref).view(np.int32),
                          got.numpy().view(np.int32))
    ref = jq.qmatmul_swiglu_prng_p(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(b), _seed_arr(SEEDS), fmt,
                                   mode, eps, residuals=True)
    got = tq.qmatmul_swiglu_prng(at, bt, bt, SEEDS, fmt, mode, eps=eps,
                                 residuals=True)
    for r, g in zip(ref[1:], got[1:]):
        assert np.array_equal(np.asarray(r).view(np.int32),
                              g.numpy().view(np.int32))


def test_swiglu_raises_on_unported_options(interpret_params):
    a, b = _normal_inputs(4, 16, 8, seed=1)
    args = (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(b),
            SEEDS, "binary8")
    # eps is ported (under sr it changes nothing, as in the reference's
    # kernel); overflow='inf' of the GEMM sites is not the reference's
    ref = jq.qmatmul_swiglu_prng_p(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(b), _seed_arr(SEEDS),
                                   "binary8", "sr", 0.1, residuals=True)
    got = tq.qmatmul_swiglu_prng(*args, eps=0.1, residuals=True)
    for r, g in zip(ref[1:], got[1:]):
        _assert_one_ulp(r, g.numpy(), "binary8")
    with pytest.raises(NotImplementedError):
        tq.qmatmul_swiglu_prng(*args, overflow="inf")
    # an activation the reference's ACT_FNS does not know (its
    # _resolve_epilogue raises ValueError too)
    with pytest.raises(ValueError, match="unknown GLU activation"):
        tq.qmatmul_swiglu_prng(*args, act="tanh")
    # a packed hidden must land on a rounding grid (the reference's rule)
    with pytest.raises(ValueError):
        tq.qmatmul_swiglu_prng(*args, out_packed=True)


def test_policies_the_kernels_cannot_honour_raise(interpret_params):
    """A spec that overflows to +-inf resolves as in the reference, which
    rounds its GEMM sites (``qdot``: fwd, dgrad, wgrad) saturating whatever
    the spec says, and its fused GLU's act site as the spec says: both
    packages give the same bits on inputs that overflow, the GEMM results
    saturated at xmax, never +-inf."""
    from repro.precision import fused as jfused
    from repro.precision import policy as jp
    rng = np.random.default_rng(1)
    a = (rng.integers(-8, 9, (4, 16)) * 512.0).astype(np.float32)
    b = (rng.integers(-8, 9, (16, 8)) * 64.0).astype(np.float32)
    name = "binary8-rn-inf"
    pol, jpol = tp.get_policy(name), jp.get_policy(name)
    assert pol.fwd == tr.parse_spec(name) and pol.fwd.overflow == "inf"
    words = SEEDS[0]
    ref = jp.qdot(jnp.asarray(a), jnp.asarray(b),
                  jp.QuantCtx(jpol, _seed_arr(words)))
    got = tp.qdot(torch.from_numpy(a), torch.from_numpy(b),
                  tp.QuantCtx(pol, words))
    ref = np.asarray(ref)
    assert np.array_equal(ref.view(np.int32), got.numpy().view(np.int32))
    xmax = float(tr.get_grid("binary8").fmt.xmax)
    assert np.all(np.isfinite(ref)) and np.abs(ref).max() == xmax
    x = a.reshape(1, 4, 16) / 64.0
    wd = np.ascontiguousarray(b.T) / 64.0
    ref = jfused.qffn_glu(jnp.asarray(x), jnp.asarray(b), jnp.asarray(b),
                          jnp.asarray(wd), jp.QuantCtx(jpol,
                                                       _seed_arr(words)))
    got = tfused.qffn_glu(torch.from_numpy(x), torch.from_numpy(b),
                          torch.from_numpy(b), torch.from_numpy(wd),
                          tp.QuantCtx(pol, words))
    assert np.array_equal(np.asarray(ref).view(np.int32),
                          got.numpy().view(np.int32))
