"""The port's training slice against the JAX reference: the backward
passes of the rounded GEMMs, the fused FFN's residuals, the train step, the
synthetic tokens and the CLI.

Tolerances:
* ``qdot`` / ``qffn_glu`` gradients: bitwise where every sum is exact
  (dyadic inputs and cotangents); otherwise the float32 GEMM sums in
  another order than XLA's and SiLU's ``exp`` may differ by a float32 ulp,
  which can move a value across a rounding decision: at most 1e-4 of the
  elements (one, on these small shapes) may differ, each by one grid step.
* The train step on reduced tinyllama, two steps, from one fixed draw of
  parameters (numpy seed 17) and tokens: the losses within 5e-7 relative
  (about five float32 ulps: the cross-entropy sums in another order) and
  at most 8 of the 90,432 parameters different.  This draw reads bitwise
  equal parameters and losses within 9.1e-8 on all three update paths.
  Other draws can differ more: where a GEMM sum lands within a float32 ulp
  of a rounding decision (the order tolerance above), the flipped value
  changes the gradients behind it, and the second step's stochastic
  updates then differ for ~2 % of the parameters (over eight parameter
  draws: six bitwise, one 0.04 %, one 2.2 %); the limit is set for this
  draw, so that a fault which moves a few percent of the updates fails.
  The reference is compiled with
  ``xla_allow_excess_precision=False``: by default XLA keeps bf16
  intermediates in float32 inside its fusions, and then differs from its
  own op-by-op execution, and from the port, wherever a bf16 rounding was
  skipped (most hidden values differ).
* Synthetic tokens: equal (the Zipf map's float32 power comes from another
  library; it may move a rank by one at an integer boundary, which these
  draws do not hit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.core import rounding as jr
from repro.kernels import qmatmul as jq
from repro.precision import fused as jfused
from repro.precision import policy as jp
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core import prng
from repro_torch.core.rounding import grid_flips
from repro_torch.kernels import fused_update as tfu
from repro_torch.kernels import qmatmul as tq
from repro_torch.kernels.tree_update import tree_leaves
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.optim import qsgd
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


def _dyadic(shape, div, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, shape) / div).astype(np.float32)


def _normal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bits_equal(ref, got):
    return np.array_equal(np.asarray(ref, np.float32).view(np.int32),
                          np.asarray(got, np.float32).view(np.int32))


def _assert_flips(ref, got, fmt):
    ref = torch.from_numpy(np.asarray(ref, np.float32).copy())
    got = torch.from_numpy(np.asarray(got, np.float32).copy())
    n, adjacent = grid_flips(ref, got, fmt)
    assert n <= max(1, 1e-4 * ref.numel()), (n, ref.numel())
    assert adjacent


def _ctxs(preset, words):
    return (jp.QuantCtx(jp.PRESETS[preset],
                        jnp.asarray(np.array(words, np.uint32))),
            tp.QuantCtx(tp.PRESETS[preset], words))


def _port_grads(fn, *arrays, ct):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(ct))
    return out.detach(), [t.grad for t in ts]


# --------------------------------------------------------------- backward --
@pytest.mark.parametrize("preset", ["binary8-paper", "e4m3-sr", "binary8-rn"])
def test_qdot_backward_matches_vjp(interpret_params, preset):
    fmt = "e4m3" if preset.startswith("e4m3") else "binary8"
    jctx, tctx = _ctxs(preset, SEEDS[0])
    for exact in (True, False):
        if exact:
            a, b = _dyadic((12, 40), 8.0, 1), _dyadic((40, 24), 4.0, 2)
            ct = _dyadic((12, 24), 2.0, 3)
        else:
            a, b = _normal((64, 48), 4), _normal((48, 40), 5, 48 ** -0.5)
            ct = _normal((64, 40), 6)
        out, vjp = jax.vjp(lambda a_, b_: jp.qdot(a_, b_, jctx, 2),
                           jnp.asarray(a), jnp.asarray(b))
        da, db = vjp(jnp.asarray(ct))
        got, (ga, gb) = _port_grads(lambda a_, b_: tp.qdot(a_, b_, tctx, 2),
                                    a, b, ct=ct)
        for ref, port in ((out, got), (da, ga), (db, gb)):
            if exact:
                assert _bits_equal(ref, port.numpy()), preset
            else:
                _assert_flips(ref, port.numpy(), fmt)


def test_qffn_glu_backward_matches_vjp(interpret_params):
    jctx, tctx = _ctxs("binary8-paper", SEEDS[1])
    x = _dyadic((2, 3, 32), 4.0, 7)
    wg, wu = _dyadic((32, 48), 8.0, 8), _dyadic((32, 48), 8.0, 9)
    wd, ct = _dyadic((48, 32), 8.0, 10), _dyadic((2, 3, 32), 2.0, 11)
    out, vjp = jax.vjp(lambda *a: jfused.qffn_glu(*a, jctx),
                       *(jnp.asarray(v) for v in (x, wg, wu, wd)))
    ref = vjp(jnp.asarray(ct))
    got, grads = _port_grads(lambda *a: tfused.qffn_glu(*a, tctx),
                             x, wg, wu, wd, ct=ct)
    # the hidden is exact on these inputs up to SiLU's exp, so the forward
    # and the down projection's gradient are bitwise; the gate/up gradients
    # go through SiLU's pullback (not exact sums)
    assert _bits_equal(out, got.numpy())
    assert _bits_equal(ref[3], grads[3].numpy())
    for r, g in zip(ref[:3], grads[:3]):
        _assert_flips(r, g.numpy(), "binary8")


@pytest.mark.parametrize("mode,rb", [("sr", 32), ("rn", 32), ("sr", 16)])
def test_swiglu_residuals_match_reference(interpret_params, mode, rb):
    """K4''s backward residuals g_r, u_r (the rounded branches): bitwise
    on exact-sum inputs."""
    x = _dyadic((21, 40), 8.0, 12)
    wg, wu = _dyadic((40, 33), 4.0, 13), _dyadic((40, 33), 4.0, 14)
    act = jr.parse_spec("binary8-sr")
    ref = jq.qmatmul_swiglu_prng_p(
        jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
        jnp.asarray(np.array(SEEDS, np.uint32)), "binary8", mode,
        act="silu", act_spec=act, rand_bits=rb, residuals=True)
    got = tq.qmatmul_swiglu_prng(
        torch.from_numpy(x), torch.from_numpy(wg), torch.from_numpy(wu),
        SEEDS, "binary8", mode, act_spec=tp.spec("binary8", "sr"),
        rand_bits=rb, residuals=True)
    assert len(got) == 3
    for r, g in zip(ref[1:], got[1:]):
        assert _bits_equal(r, g.numpy())
    _assert_flips(ref[0], got[0].numpy(), "binary8")


# -------------------------------------------------------------- train step --
def _reference_steps(path, jparams, batches):
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.launch import steps as jsteps
    from repro.launch.train import rounding_config
    from repro.models import build_model as jbuild
    from repro.optim import qsgd as jqsgd
    cfg = dataclasses.replace(jreduced(jget("tinyllama-1.1b")),
                              gemm_policy="binary8-paper")
    opt = jqsgd(lr=0.05, momentum=0.9,
                cfg=rounding_config("signed_sr_eps", "binary8", 0.1),
                update_path=path)
    state = opt.init(jparams, jax.random.PRNGKey(1))
    step = jax.jit(jsteps.make_train_step(jbuild(cfg), opt))
    params, losses = jparams, []
    for batch in batches:
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
        compiled = step.lower(params, state, jb).compile(
            compiler_options={"xla_allow_excess_precision": False})
        params, state, metrics = compiled(params, state, jb)
        losses.append(float(metrics["loss"]))
    return params, losses


def _numpy_params(jparams):
    """The reference's parameter tree with values drawn by numpy (its own
    init folds ``hash()`` of a block name, which Python salts per
    process): norm scales small, weights N(0, 1/fan_in)."""
    rng = np.random.default_rng(17)
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    out = []
    for leaf in leaves:
        if leaf.ndim == 1 or (leaf.ndim == 2 and leaf.shape[0] == 2):
            v = rng.standard_normal(leaf.shape) * 0.1       # norm scales
        else:
            v = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        out.append(jnp.asarray(v.astype(np.float32)))
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.mark.parametrize("path", ["fused", "fused_bits", "jnp"])
def test_train_step_matches_reference(interpret_params, path):
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models import build_model as jbuild
    jcfg = jreduced(jget("tinyllama-1.1b"))
    jparams = _numpy_params(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, 128, (2, 2, 9))
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    ref_params, ref_losses = _reference_steps(path, jparams, batches)

    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              gemm_policy="binary8-paper")
    opt = qsgd(lr=0.05, momentum=0.9,
               cfg=ttrain.rounding_config("signed_sr_eps", "binary8", 0.1),
               update_path=path)
    params = convert.master_params_from_jax(jax.device_get(jparams))
    state = opt.init(params, prng.PRNGKey(1))
    step = tsteps.make_train_step(build_model(cfg), opt)
    losses = []
    for batch in batches:
        params, state, metrics = step(
            params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-7)
    ref_leaves = jax.tree_util.tree_leaves(ref_params)
    leaves = tree_leaves(params)
    assert len(leaves) == len(ref_leaves)
    n_diff = n = 0
    for r, g in zip(ref_leaves, leaves):
        assert tuple(r.shape) == tuple(g.shape)
        r = np.asarray(r, np.float32)
        n_diff += int(np.sum(r.view(np.int32) != g.numpy().view(np.int32)))
        n += r.size
    assert n_diff <= 8, (n_diff, n)
    assert state.step == 2


def test_train_step_launches_per_step(monkeypatch, tmp_path):
    """The launch arithmetic the chip run checks, counted at the plain
    twins' call sites: per step K3' runs 19 L + 3 times (5 forward GEMMs,
    8 dgrad/wgrad of the attention projections and 6 of the FFN per layer;
    the lm head's forward, dgrad and wgrad), K4' L times, K2' and the
    momentum FMA once."""
    calls = {"qmatmul": 0, "swiglu": 0, "update": 0, "momentum": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper
    monkeypatch.setattr(tq, "qmatmul_plain", counted("qmatmul",
                                                     tq.qmatmul_plain))
    monkeypatch.setattr(tq, "qmatmul_swiglu_plain",
                        counted("swiglu", tq.qmatmul_swiglu_plain))
    monkeypatch.setattr(tfu, "fused_qupdate_prng_plain",
                        counted("update", tfu.fused_qupdate_prng_plain))
    monkeypatch.setattr(tfu, "momentum_fma_plain",
                        counted("momentum", tfu.momentum_fma_plain))
    out = ttrain.run("tinyllama-1.1b", reduced=True, steps=2, batch=2, seq=8,
                     rounding_kind="signed_sr_eps", fmt="binary8",
                     update_path="fused", gemm_policy="binary8-paper",
                     device="cpu", verbose=False, ckpt_dir=str(tmp_path))
    L = reduced(get_config("tinyllama-1.1b")).n_layers
    assert calls == {"qmatmul": 2 * (19 * L + 3), "swiglu": 2 * L,
                     "update": 2, "momentum": 2}
    assert all(np.isfinite(h["loss"]) for h in out["history"])


# -------------------------------------------------------------------- data --
@pytest.mark.parametrize("step", [0, 7])
def test_synthetic_tokens_match(step):
    from repro.data.synthetic import SyntheticTokens as JTokens
    from repro_torch.data import SyntheticTokens
    ref = JTokens(32000, 64, 4, seed=3).batch_at(step)
    got = SyntheticTokens(32000, 64, 4, seed=3).batch_at(step)
    for k in ("tokens", "labels"):
        assert np.array_equal(np.asarray(ref[k]), got[k].numpy())


# --------------------------------------------------------------------- CLI --
def test_train_cli_needs_a_device_or_cpu(capsys, tmp_path):
    args = ["--arch", "tinyllama-1.1b", "--reduced", "--steps", "2",
            "--batch", "1", "--seq", "8", "--gemm-policy", "binary8-paper",
            "--rounding", "signed_sr_eps", "--fmt", "binary8",
            "--update-path", "fused", "--ckpt-dir", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(args)
    out = ttrain.main(args + ["--device", "cpu"])
    assert "tok/s" in capsys.readouterr().out
    assert len(out["history"]) == 2
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ttrain.main(args + ["--device", "cpu", "--watchdog"])
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrain.build_optimizer("lion", lr=0.1, momentum=0.0, cfg=None,
                               update_path="fused")


def test_train_cli_takes_presets_and_spec_names(capsys, tmp_path):
    """``--gemm-policy`` takes a preset or any canonical spec name, as the
    reference's CLI does (e.g. 'fxp16.8-sr2', 'e4m3-sr2-r16'); an unknown
    name is a usage error."""
    base = ["--arch", "tinyllama-1.1b", "--reduced", "--steps", "1",
            "--batch", "1", "--seq", "8", "--device", "cpu"]
    for i, name in enumerate(("binary8-sr_eps", "e4m3-sr2-r16")):
        out = ttrain.main(base + ["--gemm-policy", name, "--ckpt-dir",
                                  str(tmp_path / str(i))])
        assert len(out["history"]) == 1
        assert np.isfinite(out["history"][0]["loss"])
    with pytest.raises(SystemExit):
        ttrain.main(base + ["--gemm-policy", "binary8-nonsense"])
    assert "invalid" in capsys.readouterr().err


def test_profile_train_needs_a_card():
    """The profiling entry point measures the device: with no card it
    raises rather than timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the profile would run")
    from repro_torch.launch import profile_train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_train.main(["--steps", "1"])
