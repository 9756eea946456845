"""The three serving paths of the oracle and packed modes, and a train step
under each new preset, on the reduced models against the JAX reference.

* tinyllama under ``e4m3-sr-oracle`` (K3, K4) and ``binary8-paper-packed``
  (K4' with a packed hidden, K3' decoding it on load);
* qwen3-moe under the oracle form of ``binary8-paper``
  (``dataclasses.replace(get_policy("binary8-paper"), oracle=True)``, the
  form the reference's own tests use: K3, K8, K1);
* two train steps of reduced tinyllama under ``e4m3-sr-oracle`` and
  ``binary8-paper-packed``.

Tolerances: serving as ``tests/test_torch_serve.py`` (median |dlogit| <
0.02, at most 10 % over 0.05, greedy picks within 0.1 of the reference's
best logit); the train step as ``tests/test_torch_train.py`` (losses within
5e-7 relative, at most 8 parameters different).  Within the port, the
oracle runs equal the in-kernel runs of the same specs and the packed
runs equal the unpacked ones, bitwise (tinyllama; qwen3-moe's oracle act
site draws another layout than K1', so it is a different draw there).
The references are compiled with ``xla_allow_excess_precision=False``.
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
from repro.precision import policy as jp
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core import prng
from repro_torch.kernels import qmatmul as tq
from repro_torch.kernels import sr_cast as tsr
from repro_torch.kernels.tree_update import tree_leaves
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.optim import qsgd
from repro_torch.precision import policy as tp

B, PROMPT, GEN = 2, 6, 3
BASE = {"e4m3-sr-oracle": "e4m3-sr", "binary8-paper-packed": "binary8-paper"}


@pytest.fixture
def interpret_params(monkeypatch):
    """The reference kernels build ``pltpu.TPUCompilerParams``, which newer
    jax names ``CompilerParams``; alias it only where it is missing."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _numpy_tree(jcfg, seed):
    """The reference's parameter tree with numpy values (its own init
    folds ``hash()`` of a block name): weights N(0, 1/fan_in), the router
    N(0, 0.3^2), norms small."""
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in paths:
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            v = rng.standard_normal(leaf.shape) * 0.1
        elif "router" in name:
            v = rng.standard_normal(leaf.shape) * 0.3
        else:
            v = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        out.append(v.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def _reference_serve(jcfg, jparams, prompts):
    model = jbuild_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, jparams)
    caches = model.init_decode_cache(B, PROMPT + GEN)
    p = jnp.asarray(prompts)
    step = jax.jit(model.decode_step).lower(
        params, caches, p[:, :1], jnp.int32(0)).compile(
            compiler_options={"xla_allow_excess_precision": False})
    for pos in range(PROMPT):
        _, caches = step(params, caches, p[:, pos:pos + 1], jnp.int32(pos))
    tok = p[:, -1:]
    picks, logits = [], []
    for t in range(GEN):
        lg, caches = step(params, caches, tok, jnp.int32(PROMPT + t))
        tok = jnp.argmax(lg[:, -1, :], axis=-1)[:, None]
        picks.append(np.asarray(tok))
        logits.append(np.asarray(lg[:, -1, :].astype(jnp.float32)))
    return np.concatenate(picks, 1), np.stack(logits, 1)


def _port_serve(arch, policy, jparams, prompts, picks):
    cfg = dataclasses.replace(reduced(get_config(arch)), gemm_policy=policy)
    return tserve.serve_batch(build_model(cfg),
                              convert.params_from_jax(jparams),
                              torch.from_numpy(prompts), GEN,
                              forced=torch.from_numpy(picks))


def _assert_serve_close(logits, out):
    got = out["logits"].numpy()
    assert np.all(np.isfinite(got))
    d = np.abs(got - logits)
    assert np.median(d) < 0.02, float(np.median(d))
    assert np.mean(d > 0.05) <= 0.10, float(np.mean(d > 0.05))
    chosen = np.take_along_axis(logits, out["tokens"].numpy()[..., None],
                                -1)[..., 0]
    assert np.all(chosen >= logits.max(-1) - 0.1)


@pytest.mark.parametrize("preset", sorted(BASE))
def test_serve_matches_reference_and_base_preset(interpret_params, preset):
    arch = "tinyllama-1.1b"
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               gemm_policy=preset)
    jparams = _numpy_tree(jcfg, 5)
    prompts = np.random.default_rng(1).integers(0, 128, (B, PROMPT))
    picks, logits = _reference_serve(jcfg, jparams, prompts)
    out = _port_serve(arch, preset, jparams, prompts, picks)
    _assert_serve_close(logits, out)
    base = _port_serve(arch, BASE[preset], jparams, prompts, picks)
    assert torch.equal(out["logits"].view(torch.int32),
                       base["logits"].view(torch.int32))
    assert torch.equal(out["tokens"], base["tokens"])


def test_moe_serve_oracle_matches_reference(interpret_params):
    arch = "qwen3-moe-30b-a3b"
    jpol = dataclasses.replace(jp.get_policy("binary8-paper"), oracle=True)
    tpol = dataclasses.replace(tp.get_policy("binary8-paper"), oracle=True)
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), gemm_policy=jpol)
    jparams = _numpy_tree(jcfg, 11)
    prompts = np.random.default_rng(2).integers(0, 128, (B, PROMPT))
    picks, logits = _reference_serve(jcfg, jparams, prompts)
    out = _port_serve(arch, tpol, jparams, prompts, picks)
    _assert_serve_close(logits, out)


@pytest.mark.parametrize("arch,policy", [
    ("tinyllama-1.1b", "e4m3-sr-oracle"),
    ("tinyllama-1.1b", "binary8-paper-packed"),
    ("qwen3-moe-30b-a3b", "binary8-paper-oracle")])
def test_serve_launch_arithmetic(monkeypatch, arch, policy):
    """The launch counts the chip run asserts, counted at the plain twins'
    call sites: per layer and token 5 K3 (or K3') GEMMs and one K4 (or
    K4') for the dense model, 5 K3, 3 K8 and one K1 for the MoE model,
    plus the lm head per generated token; no in-kernel-bits kernel under
    oracle and no explicit-bits one without."""
    calls = dict.fromkeys(("q", "q_bits", "glu", "glu_bits", "bmm",
                           "bmm_bits", "cast", "cast_bits"), 0)
    for name, key in (("qmatmul_plain", "q"), ("qmatmul_bits_plain",
                                                "q_bits"),
                      ("qmatmul_swiglu_plain", "glu"),
                      ("qmatmul_swiglu_bits_plain", "glu_bits"),
                      ("qmatmul_batched_plain", "bmm"),
                      ("qmatmul_batched_bits_plain", "bmm_bits")):
        monkeypatch.setattr(tq, name, _counting(getattr(tq, name), calls,
                                                key))
    for name, key in (("sr_cast_prng_plain", "cast"),
                      ("sr_cast_plain", "cast_bits")):
        monkeypatch.setattr(tsr, name, _counting(getattr(tsr, name), calls,
                                                 key))
    pol = policy
    if policy == "binary8-paper-oracle":
        pol = dataclasses.replace(tp.get_policy("binary8-paper"),
                                  oracle=True)
    prompt, gen = 4, 2
    tserve.run(arch, reduced=True, batch=2, prompt_len=prompt, gen=gen,
               gemm_policy=pol, device="cpu")
    L = reduced(get_config(arch)).n_layers
    steps = prompt + gen
    oracle = policy != "binary8-paper-packed"
    want = dict.fromkeys(calls, 0)
    want["q_bits" if oracle else "q"] = 5 * L * steps + gen
    if arch == "tinyllama-1.1b":
        want["glu_bits" if oracle else "glu"] = L * steps
    else:
        want["bmm_bits"] = 3 * L * steps
        want["cast_bits"] = L * steps
    assert calls == want


def _counting(fn, calls, key):
    def wrapped(*a, **k):
        calls[key] += 1
        return fn(*a, **k)
    return wrapped


# ---------------------------------------------------------------------------
# A reduced train step under each new preset
# ---------------------------------------------------------------------------
def _reference_steps(policy, jparams, batches):
    from repro.launch import steps as jsteps
    from repro.launch.train import rounding_config
    from repro.optim import qsgd as jqsgd
    cfg = dataclasses.replace(jreduced(jget_config("tinyllama-1.1b")),
                              gemm_policy=policy)
    opt = jqsgd(lr=0.05, momentum=0.9,
                cfg=rounding_config("signed_sr_eps", "binary8", 0.1),
                update_path="fused")
    state = opt.init(jparams, jax.random.PRNGKey(1))
    step = jax.jit(jsteps.make_train_step(jbuild_model(cfg), opt))
    params, losses = jparams, []
    for batch in batches:
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
        compiled = step.lower(params, state, jb).compile(
            compiler_options={"xla_allow_excess_precision": False})
        params, state, metrics = compiled(params, state, jb)
        losses.append(float(metrics["loss"]))
    return params, losses


def _port_steps(policy, jparams, batches):
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              gemm_policy=policy)
    opt = qsgd(lr=0.05, momentum=0.9,
               cfg=ttrain.rounding_config("signed_sr_eps", "binary8", 0.1),
               update_path="fused")
    params = convert.master_params_from_jax(jax.device_get(jparams))
    state = opt.init(params, prng.PRNGKey(1))
    step = tsteps.make_train_step(build_model(cfg), opt)
    losses = []
    for batch in batches:
        params, state, metrics = step(
            params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    return params, losses


@pytest.mark.parametrize("preset", sorted(BASE))
def test_train_step_matches_reference_and_base_preset(interpret_params,
                                                      preset):
    jcfg = jreduced(jget_config("tinyllama-1.1b"))
    jparams = jax.tree_util.tree_map(jnp.asarray, _numpy_tree(jcfg, 17))
    toks = np.random.default_rng(0).integers(0, 128, (2, 2, 9))
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    ref_params, ref_losses = _reference_steps(preset, jparams, batches)
    params, losses = _port_steps(preset, jparams, batches)
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-7)
    n_diff = 0
    for r, g in zip(jax.tree_util.tree_leaves(ref_params),
                    tree_leaves(params)):
        r = np.asarray(r, np.float32)
        n_diff += int(np.sum(r.view(np.int32) != g.numpy().view(np.int32)))
    assert n_diff <= 8, n_diff
    base_params, base_losses = _port_steps(BASE[preset], jparams, batches)
    assert losses == base_losses
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(tree_leaves(params), tree_leaves(base_params)))
