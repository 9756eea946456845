"""Reduced models end to end under spec names that need the GEMM and cast
kernels' wide instances (K3', K4', K8', K1'), against the reference on the
CPU: two QSGD train steps of reduced tinyllama-1.1b under
``binary8-sr_eps`` (the paper's SRε at every GEMM and act site, the first
instances) and ``fxp16.8-sr2`` (SR 2.0 on a fixed-point grid, the wide
ones), and greedy decoding of reduced qwen3-moe-30b-a3b under
``e4m3-sr2-r16`` (K8''s and K1''s wide instances).

Limits: the train steps as ``tests/test_torch_attention.py``'s (losses
within 5e-7 relative, at most 8 of 90,432 parameters different; the
reference compiled without excess precision), the MoE logits as
``tests/test_torch_moe.py``'s (teacher-forced on the reference's picks;
median difference below 0.02, at most 10 % above 0.05, each greedy pick
within 0.1 of the best logit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from test_torch_attention import _numpy_params, interpret_params  # noqa: F401
from test_torch_moe import B, GEN, PROMPT, _numpy_tree, _reference_serve

COMPILE = {"xla_allow_excess_precision": False}


@pytest.mark.parametrize("policy", ["binary8-sr_eps", "fxp16.8-sr2"])
def test_train_steps_match_reference(interpret_params, policy):
    """Two QSGD steps (lr 0.05, momentum 0.9, the signed-SRe binary8
    update) of reduced tinyllama from one numpy draw, against the
    reference's compiled step.  Readings: binary8-sr_eps 0 parameters
    apart, losses within 8.8e-8 and 9.1e-8 relative; fxp16.8-sr2 0 apart,
    losses within 0 and 1.9e-7 (a float32 ulp or two of the
    cross-entropy)."""
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.launch import steps as jsteps
    from repro.launch.train import rounding_config as jrounding
    from repro.models import build_model as jbuild
    from repro.optim import qsgd as jqsgd
    from repro_torch.core import prng
    from repro_torch.kernels.tree_update import tree_leaves
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.train import rounding_config
    from repro_torch.optim import qsgd

    jcfg = dataclasses.replace(jreduced(jget("tinyllama-1.1b")),
                               gemm_policy=policy)
    jparams = _numpy_params(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, 128, (2, 2, 9))
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    jopt = jqsgd(lr=0.05, momentum=0.9,
                 cfg=jrounding("signed_sr_eps", "binary8", 0.1),
                 update_path="fused")
    state = jopt.init(jparams, jax.random.PRNGKey(1))
    step = jax.jit(jsteps.make_train_step(jbuild(jcfg), jopt))
    ref, ref_losses, compiled = jparams, [], None
    for batch in batches:
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
        if compiled is None:
            compiled = step.lower(ref, state, jb).compile(COMPILE)
        ref, state, metrics = compiled(ref, state, jb)
        ref_losses.append(float(metrics["loss"]))

    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              gemm_policy=policy)
    opt = qsgd(lr=0.05, momentum=0.9,
               cfg=rounding_config("signed_sr_eps", "binary8", 0.1),
               update_path="fused")
    params = convert.master_params_from_jax(jax.device_get(jparams))
    tstate = opt.init(params, prng.PRNGKey(1))
    tstep = tsteps.make_train_step(build_model(cfg), opt)
    losses = []
    for batch in batches:
        params, tstate, metrics = tstep(
            params, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-7)
    n_diff = n = 0
    for r, g in zip(jax.tree_util.tree_leaves(ref), tree_leaves(params)):
        r = np.asarray(r, np.float32)
        n_diff += int(np.sum(r.view(np.int32) != g.numpy().view(np.int32)))
        n += r.size
    assert n == 90_432
    assert n_diff <= 8, (n_diff, n)


def test_moe_serve_matches_reference(interpret_params):
    """Reduced qwen3-moe-30b-a3b decoded greedily under ``e4m3-sr2-r16``
    (K3', K8' and K1' on their wide instances' twins), teacher-forced on
    the reference's picks (its decode step compiled once).  Reading: the
    logits bitwise (median difference 0), every greedy pick the
    reference's."""
    from repro.configs import get_config as jget, reduced as jreduced
    policy = "e4m3-sr2-r16"
    arch = "qwen3-moe-30b-a3b"
    jcfg = dataclasses.replace(jreduced(jget(arch)), gemm_policy=policy)
    tcfg = dataclasses.replace(reduced(get_config(arch)), gemm_policy=policy)
    jparams = _numpy_tree(jcfg)
    prompts = np.random.default_rng(0).integers(0, 128, (B, PROMPT))
    picks, logits = _reference_serve(jcfg, jparams, prompts)
    out = tserve.serve_batch(build_model(tcfg),
                             convert.params_from_jax(jparams),
                             torch.from_numpy(prompts), GEN,
                             forced=torch.from_numpy(picks))
    got = out["logits"].numpy()
    assert np.all(np.isfinite(got))
    d = np.abs(got - logits)
    assert np.median(d) < 0.02, float(np.median(d))
    assert np.mean(d > 0.05) <= 0.10, float(np.mean(d > 0.05))
    chosen = np.take_along_axis(logits, out["tokens"].numpy()[..., None],
                                -1)[..., 0]
    assert np.all(chosen >= logits.max(-1) - 0.1)
