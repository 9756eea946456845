"""The port's serving slice against the JAX reference, end to end.

Reduced tinyllama (2 layers, d_model 64, the reference's ``reduced()``):
the reference's ``Model.init`` parameters, with the blocks drawn by numpy
(``_numpy_blocks``), go through ``convert.params_from_jax``; both packages absorb the same 8-token prompts
and decode 4 tokens, teacher-forced on the reference's greedy picks, so
every step sees the same inputs.

Tolerances (stated before measuring, from the dtypes):
* ``fp32`` policy (bf16 GEMMs): logits within 0.02 absolute (logits are
  O(0.1); bf16 keeps 8 bits, and the two frameworks round bf16 at other
  places);
* ``binary8-paper``: every GEMM result lands on the binary8 grid (3
  significand bits) by SR.  A bf16 difference upstream can flip an SR
  decision by one binary8 ulp (12.5-25 % of the value), which then
  propagates, so the bound is statistical: the median absolute logit
  difference stays below 0.02 and at most 10 % of logits differ by more
  than 0.05.
* Greedy picks: bf16 logits tie often (resolution 2^-9 at 0.5), so a pick
  may differ only where the reference's top logits are within the logit
  tolerance: the reference logit of every port pick is within 0.02
  (``fp32``) or 0.1 (``binary8-paper``) of the reference maximum.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import qmatmul as tq
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model

B, PROMPT, GEN = 2, 8, 4


@pytest.fixture
def interpret_params(monkeypatch):
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _reference_run(policy, prompts):
    cfg = dataclasses.replace(jreduced(jget_config("tinyllama-1.1b")),
                              gemm_policy=policy)
    model = jbuild_model(cfg)
    params = _numpy_blocks(model.init(jax.random.PRNGKey(0)))
    step = jax.jit(model.decode_step, static_argnames=("compute_logits",))
    caches = model.init_decode_cache(B, PROMPT + GEN)
    p = jnp.asarray(prompts)
    for pos in range(PROMPT):
        _, caches = step(params, caches, p[:, pos:pos + 1], jnp.int32(pos),
                         compute_logits=False)
    tok = p[:, -1:]
    picks, logits = [], []
    for t in range(GEN):
        lg, caches = step(params, caches, tok, jnp.int32(PROMPT + t))
        tok = jnp.argmax(lg[:, -1, :], axis=-1)[:, None]
        picks.append(np.asarray(tok))
        logits.append(np.asarray(lg[:, -1, :].astype(jnp.float32)))
    return (jax.device_get(params), np.concatenate(picks, 1),
            np.stack(logits, 1))


def _numpy_blocks(params):
    """The reference's parameters with the blocks drawn by numpy as its
    init draws them (norm scales zero, weights N(0, 1/fan_in)): its block
    init folds ``hash()`` of a block name, which Python salts per
    process, so ``init`` alone gives every process other weights."""
    rng = np.random.default_rng(0)
    paths, treedef = jax.tree_util.tree_flatten_with_path(params["blocks"])
    out = []
    for path, leaf in paths:
        if "norm" in jax.tree_util.keystr(path):
            v = np.zeros(leaf.shape)
        else:
            v = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        out.append(jnp.asarray(v.astype(np.float32)))
    return dict(params, blocks=jax.tree_util.tree_unflatten(treedef, out))


def _port_run(policy, jparams, prompts, forced):
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              gemm_policy=policy)
    params = convert.params_from_jax(jparams)
    return tserve.serve_batch(build_model(cfg), params,
                              torch.from_numpy(prompts),
                              GEN, forced=torch.from_numpy(forced))


def _assert_near_max_picks(ref_logits, picks, tol):
    chosen = np.take_along_axis(ref_logits, picks[..., None], -1)[..., 0]
    assert np.all(chosen >= ref_logits.max(-1) - tol)


def _prompts():
    return np.random.default_rng(0).integers(0, 128, (B, PROMPT))


def test_serve_fp32_matches_reference():
    prompts = _prompts()
    jparams, picks, logits = _reference_run("fp32", prompts)
    out = _port_run("fp32", jparams, prompts, picks)
    np.testing.assert_allclose(out["logits"].numpy(), logits, atol=0.02,
                               rtol=0)
    _assert_near_max_picks(logits, out["tokens"].numpy(), 0.02)


def test_serve_binary8_paper_matches_reference(interpret_params):
    prompts = _prompts()
    jparams, picks, logits = _reference_run("binary8-paper", prompts)
    out = _port_run("binary8-paper", jparams, prompts, picks)
    got = out["logits"].numpy()
    assert np.all(np.isfinite(got))
    d = np.abs(got - logits)
    assert np.median(d) < 0.02, float(np.median(d))
    assert np.mean(d > 0.05) <= 0.10, float(np.mean(d > 0.05))
    _assert_near_max_picks(logits, out["tokens"].numpy(), 0.1)


def test_serve_counts_kernel_work_per_step():
    """Launch arithmetic the chip run asserts: 5 rounded GEMMs + 1 fused
    FFN per layer per token, + the lm head per generated token (counted
    here through the plain twins' call sites)."""
    calls = {"qmatmul": 0, "swiglu": 0}
    orig_q, orig_s = tq.qmatmul_plain, tq.qmatmul_swiglu_plain

    def count_q(*a, **k):
        calls["qmatmul"] += 1
        return orig_q(*a, **k)

    def count_s(*a, **k):
        calls["swiglu"] += 1
        return orig_s(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(tq, "qmatmul_plain", count_q)
    mp.setattr(tq, "qmatmul_swiglu_plain", count_s)
    try:
        out = tserve.run("tinyllama-1.1b", reduced=True, batch=2,
                         prompt_len=5, gen=3, gemm_policy="binary8-paper",
                         device="cpu")
    finally:
        mp.undo()
    n_layers = reduced(get_config("tinyllama-1.1b")).n_layers
    assert calls["qmatmul"] == 5 * n_layers * (5 + 3) + 3
    assert calls["swiglu"] == n_layers * (5 + 3)
    toks = out["tokens"]
    assert toks.shape == (2, 3) and int(toks.min()) >= 0 \
        and int(toks.max()) < 128


def test_serve_cli_needs_a_device_or_cpu(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--arch", "tinyllama-1.1b", "--reduced"])
    tserve.main(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
                 "--batch", "1", "--prompt-len", "3", "--gen", "2",
                 "--gemm-policy", "binary8-paper"])
    assert "decode" in capsys.readouterr().out


def test_unported_arch_and_policy_raise():
    with pytest.raises(NotImplementedError):
        get_config("deepseek-v2-236b")
    from repro_torch.precision import policy as tp
    # a spec name resolves at every site (the GEMM kernels' wide instances
    # take what their first instances do not), but the explicit-bits
    # kernels of the oracle have the first instances alone
    assert tp.get_policy("binary8-sr_eps").fwd.scheme.name == "sr_eps"
    with pytest.raises(NotImplementedError, match="fwd"):
        tp.make_policy(fmt="binary8", mode="sr2", oracle=True)
