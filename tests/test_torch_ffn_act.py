"""The GLU kernels' activations (gelu, relu, relu_sq beside silu) and
XLA's float32 tanh against the JAX reference.

``core.xla_math.tanh_f32`` is XLA's CPU tanh op by op, and the twins
``kernels.qmatmul.gelu`` / ``relu`` / ``relu_sq`` are ``jax.nn.gelu`` /
``jax.nn.relu`` / ``jnp.square(jax.nn.relu(.))`` as XLA computes them:
on float32 as the reference's jitted K4 epilogue does (gelu's inner sum
fused into one multiply-add), on bf16 op by op as its unfused FFN does
under ``xla_allow_excess_precision=False``.  The reference's kernels run
in Pallas interpret mode (the ``interpret_params`` fixture).

Tolerances:
* tanh, the activations: bitwise on every input drawn, signed zeros,
  subnormals, the clamp and 0.0004 edges, +-inf and NaN included (any NaN
  counts as equal to any NaN);
* the GLU kernels (K4', K4) under gelu, relu and relu_sq: bitwise on
  exact-sum inputs (the hidden and both rounded branches); on N(0, 1)
  inputs at most 1e-4 of the outputs one grid step apart (the GEMM sums
  in another order: the GEMM contract, held on the 8-bit grids as in
  tests/test_torch_qmatmul.py);
* ``qffn_glu(act="gelu")`` and the unfused GeGLU FFN: bitwise on
  exact-sum inputs.
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
from repro_torch.core import rounding as tr
from repro_torch.core.xla_math import tanh_f32
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import qmatmul as tq
from repro_torch.precision import fused as tfused
from repro_torch.precision import policy as tp

SEEDS = ((0x12345678, 0x9ABCDEF0), (7, 0xFFFFFFFF), (0xDEADBEEF, 3))
ACTS = ("gelu", "relu", "relu_sq")
JAX_ACTS = {"gelu": jax.nn.gelu, "relu": jax.nn.relu,
            "relu_sq": lambda x: jnp.square(jax.nn.relu(x))}


@pytest.fixture
def interpret_params(monkeypatch):
    """The reference kernels build ``pltpu.TPUCompilerParams``, which newer
    jax names ``CompilerParams``; alias it only where it is missing."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _edges():
    e = np.array([0.0, -0.0, 0.0004, -0.0004, 7.99881172180175781,
                  -7.99881172180175781, 8.0, -8.0, 1e-40, -1e-40, 3e-39,
                  1.2e-38, np.inf, -np.inf, np.nan, 20.0, -20.0, 1e30,
                  -1e30], np.float32)
    return np.concatenate([e, np.nextafter(e, np.float32(np.inf)),
                           np.nextafter(e, np.float32(-np.inf))])


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        _edges(), (rng.standard_normal(n) * 3).astype(np.float32),
        rng.uniform(-1e-3, 1e-3, n // 16).astype(np.float32)])


def _same(ref, got):
    """Bitwise equal float32 arrays, any NaN equal to any NaN (a NaN's sign
    and payload carry nothing)."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got.numpy() if torch.is_tensor(got) else got,
                     np.float32)
    nan = np.isnan(ref)
    return np.array_equal(nan, np.isnan(got)) and np.array_equal(
        ref[~nan].view(np.int32), got[~nan].view(np.int32))


def test_tanh_f32_matches_jnp_tanh():
    """XLA's tanh, bitwise, jitted and eager (eager jnp.tanh is one jitted
    op), on 1 M N(0, 9) draws, 65 k tiny ones and the edges; torch.tanh
    differs on most of them."""
    x = _inputs(1 << 20, 0)
    got = tanh_f32(torch.from_numpy(x))
    ref = np.asarray(jax.jit(jnp.tanh)(x))
    assert _same(ref, got)
    assert _same(np.asarray(jnp.tanh(x)), got)
    assert not _same(ref, torch.tanh(torch.from_numpy(x)))


@pytest.mark.parametrize("act", ACTS)
def test_act_twins_match_jax_float32(act):
    """The float32 twins against the jitted reference activation (the K4
    epilogue's form), bitwise."""
    x = _inputs(1 << 18, 1)
    ref = np.asarray(jax.jit(JAX_ACTS[act])(x))
    assert _same(ref, tq.ACT_FNS[act](torch.from_numpy(x)))


@pytest.mark.parametrize("act", ACTS)
def test_act_twins_match_jax_bf16(act):
    """On bf16 the twins round every operation to bf16, as the reference's
    compiled step does without excess precision, bitwise."""
    x = _inputs(1 << 18, 2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    step = jax.jit(JAX_ACTS[act]).lower(xb).compile(
        {"xla_allow_excess_precision": False})
    ref = np.asarray(step(xb).astype(jnp.float32))
    got = tq.ACT_FNS[act](torch.from_numpy(x).to(torch.bfloat16)).float()
    assert _same(ref, got)


def _exact(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return ((rng.integers(-8, 9, (M, K)) / 8.0).astype(np.float32),
            (rng.integers(-8, 9, (K, N)) / 4.0).astype(np.float32),
            (rng.integers(-8, 9, (K, N)) / 4.0).astype(np.float32))


def _normal(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            *((rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
              for _ in range(2)))


def _assert_one_ulp(ref, got, fmt, share=1e-4):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    diff = ref.view(np.int32) != got.view(np.int32)
    n = int(diff.sum())
    assert n <= share * ref.size, (n, ref.size)
    if n:
        lo = np.minimum(np.abs(ref[diff]), np.abs(got[diff]))
        ulp = np.asarray(jr.ulp(jnp.asarray(lo), fmt))
        assert np.all(np.abs(ref[diff] - got[diff]) == ulp)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("fmt,mode,rb,act_spec", [
    ("binary8", "sr", 32, "binary8-sr"), ("e4m3", "sr", 8, None)])
def test_glu_twin_matches_reference_kernel(interpret_params, act, fmt, mode,
                                           rb, act_spec):
    """K4''s twin under each activation against ``qmatmul_swiglu_prng_p``
    (h and the rounded branches): bitwise on exact sums, the GEMM contract
    on N(0, 1) inputs."""
    jspec = None if act_spec is None else jr.parse_spec(act_spec)
    tspec = None if act_spec is None else tr.parse_spec(act_spec)
    seeds = jnp.asarray(np.array(SEEDS, np.uint32))
    for inputs, exact in ((_exact(21, 40, 33, 11), True),
                          (_normal(96, 64, 80, 12), False)):
        ref = jq.qmatmul_swiglu_prng_p(*_j(*inputs), seeds, fmt, mode,
                                       act=act, act_spec=jspec,
                                       rand_bits=rb, residuals=True)
        got = tq.qmatmul_swiglu_prng(*_t(*inputs), SEEDS, fmt, mode, act=act,
                                     act_spec=tspec, rand_bits=rb,
                                     residuals=True)
        for r, g, grid in zip(ref, got, (act_spec or fmt, fmt, fmt)):
            if exact:
                assert _same(r, g)
            elif act_spec is not None or g is not got[0]:
                _assert_one_ulp(r, g.numpy(), grid.split("-")[0])


@pytest.mark.parametrize("act", ACTS)
def test_glu_bits_twin_matches_reference_kernel(interpret_params, act):
    """K4's twin (explicit words) against ``qmatmul_swiglu_p`` on
    exact-sum inputs, bitwise, with packed h and residuals; and equal to
    K4''s twin fed the words K4' draws."""
    x, wg, wu = _exact(17, 24, 40, 3)
    shape = (17, 40)
    words = [jcommon.counter_bits_reduced(*SEEDS[i], shape, 32,
                                          stream=i // 2) for i in range(3)]
    spec = jr.parse_spec("binary8-sr")
    ref = jq.qmatmul_swiglu_p(*_j(x, wg, wu), *words[:2], "binary8", "sr",
                              act=act, act_spec=spec, act_bits=words[2],
                              residuals=True, out_packed=True,
                              residuals_packed=True)
    tw = [torch.from_numpy(np.asarray(w).astype(np.int64)) for w in words]
    got = tq.qmatmul_swiglu(*_t(x, wg, wu), tw[0], tw[1], "binary8", "sr",
                            act=act, act_spec=tr.parse_spec("binary8-sr"),
                            act_bits=tw[2], residuals=True, out_packed=True,
                            residuals_packed=True)
    prng = tq.qmatmul_swiglu_prng(*_t(x, wg, wu), SEEDS, "binary8", "sr",
                                  act=act,
                                  act_spec=tr.parse_spec("binary8-sr"),
                                  residuals=True, out_packed=True,
                                  residuals_packed=True)
    for r, g, p in zip(ref, got, prng):
        assert np.array_equal(np.asarray(r), g.numpy())
        assert torch.equal(g, p)


def test_glu_acts_share_the_launch_count_and_refuse_unknown_acts():
    """CPU tensors take the twins (no launch); an activation the reference
    does not know raises ValueError as its ``_resolve_epilogue`` does."""
    x, wg, wu = _t(*_exact(4, 16, 8, 1))
    tq.reset_launches()
    for act in ("silu",) + ACTS:
        tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, "binary8", act=act)
    assert tq.ACT_LAUNCHES == dict.fromkeys(tq.ACT_LAUNCHES, 0)
    assert tq.LAUNCHES == dict.fromkeys(tq.LAUNCHES, 0)
    for bad in ("tanh", "swiglu", None):
        with pytest.raises(ValueError, match="unknown GLU activation"):
            tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, "binary8", act=bad)


def _ffn_inputs(seed):
    rng = np.random.default_rng(seed)
    return ((rng.integers(-4, 5, (2, 3, 32)) / 4.0).astype(np.float32),
            *((rng.integers(-4, 5, shape) / 8.0).astype(np.float32)
              for shape in ((32, 48), (32, 48), (48, 32))))


@pytest.mark.parametrize("preset", ["binary8-paper", "binary8-paper-packed",
                                    "e4m3-sr-oracle"])
def test_qffn_glu_gelu_matches_reference(interpret_params, preset):
    """The fused GeGLU FFN forward (seed folds, bf16 weight cast, K4' under
    gelu, the down GEMM; packed h and residuals; the oracle's K4), bitwise
    on exact-sum inputs."""
    from repro.precision import fused as jfused
    from repro.precision import policy as jp
    x, wg, wu, wd = _ffn_inputs(21)
    words = (0x01234567, 0x89ABCDEF)
    jctx = jp.QuantCtx(jp.get_policy(preset),
                       jnp.asarray(np.array(words, np.uint32)))
    tctx = tp.QuantCtx(tp.get_policy(preset), words)
    ref = jfused.qffn_glu(jnp.asarray(x).astype(jnp.bfloat16),
                          *_j(wg, wu, wd), jctx, act="gelu")
    got = tfused.qffn_glu(torch.from_numpy(x).to(torch.bfloat16),
                          *_t(wg, wu, wd), tctx, act="gelu")
    assert _same(np.asarray(ref.astype(jnp.float32)), got.float())


def test_qffn_glu_gelu_backward_is_not_ported():
    """Under relu and relu_sq the backward is not ported (no ported config
    trains them): a forward that autograd would differentiate raises;
    gelu's is ported now (tests/test_torch_gemma_train.py holds it to the
    reference) and runs; the forward alone (no autograd) runs under each."""
    x, wg, wu, wd = _t(*_ffn_inputs(22))
    tctx = tp.QuantCtx(tp.get_policy("binary8-paper"), (1, 2))
    wg.requires_grad_(True)
    for act in ("relu", "relu_sq"):
        with pytest.raises(NotImplementedError, match="not ported"):
            tfused.qffn_glu(x, wg, wu, wd, tctx, act=act)
    out = tfused.qffn_glu(x, wg, wu, wd, tctx, act="gelu")
    out.sum().backward()
    assert wg.grad.shape == wg.shape
    # the forward alone (no autograd) runs
    with torch.no_grad():
        for act in ("gelu", "relu", "relu_sq"):
            out = tfused.qffn_glu(x, wg, wu, wd, tctx, act=act)
            assert out.shape == (2, 3, 32)


@pytest.mark.parametrize("policy", [None, "engine"])
def test_geglu_ffn_unfused_matches_reference(policy):
    """The unfused GeGLU FFN (bf16 GEMMs, ``jax.nn.gelu`` op by op in
    bf16, the act site, the down GEMM) under no policy and the engine's
    (rounded attention only), against the reference's ``ffn_apply``
    compiled without excess precision, bitwise on exact-sum inputs."""
    from repro.models import ffn as jffn
    from repro.precision import policy as jp
    from repro.core.rounding import parse_spec as jparse
    from repro_torch.core.rounding import parse_spec as tparse
    from repro_torch.models import ffn as tffn
    x, wg, wu, wd = _ffn_inputs(23)
    params = {"w_gate": wg, "w_up": wu, "w_down": wd}
    jq_ = tq_ = None
    if policy == "engine":
        jq_ = jp.QuantCtx(jp.make_policy(attn=jparse("binary8-sr"),
                                         kv_cache_fmt="e4m3-sr"),
                          jnp.asarray(np.array([5, 6], np.uint32)))
        tq_ = tp.QuantCtx(tp.make_policy(attn=tparse("binary8-sr"),
                                         kv_cache_fmt="e4m3-sr"), (5, 6))

    def ref_fn(p, xb):
        return jffn.ffn_apply(p, xb, "geglu", quant=jq_)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    step = jax.jit(ref_fn).lower(jparams, xb).compile(
        {"xla_allow_excess_precision": False})
    ref = np.asarray(step(jparams, xb).astype(jnp.float32))
    tparams = {k: torch.from_numpy(v).to(torch.bfloat16)
               for k, v in params.items()}
    got = tffn.ffn_apply(tparams, torch.from_numpy(x).to(torch.bfloat16),
                         "geglu", quant=tq_)
    assert _same(ref, got.float())
    with pytest.raises(NotImplementedError, match="not ported"):
        tffn.ffn_apply(tparams, torch.from_numpy(x), "relu_sq")
