"""gemma-7b (GeGLU, head dim 256, tied embeddings) and phi3-medium-14b
served by the port against the JAX reference, on reduced models.

The reduced configs are ``configs.reduced``'s (2 layers, d_model 64, 4
heads) with gemma's head dim of 256 put back on both sides, so every
attention kernel runs at gemma's d = 256.  The parameters are the
reference's tree drawn by numpy (its own init folds ``hash()`` of a
block name, which Python salts per process) and reach the port through
``convert.params_from_jax``; both packages absorb the same prompts and
decode teacher-forced on the reference's picks.  The reference's steps
are compiled once per test, without excess precision.

Limits: ``tests/test_torch_serve.py``'s for ``binary8-paper`` (a GEMM sum
in another order can move an SR decision by one binary8 step, which
propagates): median |d logit| below 0.02, at most 10 % of logits off by
more than 0.05, every port pick within 0.1 of the reference's best logit;
the engine's token streams equal the reference engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core.rounding import parse_spec as jparse
from repro.models import build_model as jbuild_model
from repro.precision import policy as jp
from repro.serving import engine as jengine
from repro.serving import paged_cache as jpc
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.rounding import parse_spec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import qmatmul as tq
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.precision import policy as tp
from repro_torch.serving import engine as tengine

B, PROMPT, GEN = 2, 6, 3
HEAD_DIM = 256


@pytest.fixture
def interpret_params(monkeypatch):
    """The reference kernels build ``pltpu.TPUCompilerParams``, which newer
    jax names ``CompilerParams``; alias it only where it is missing."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _cfgs(arch, jpolicy, tpolicy):
    """The reduced reference and port configs, gemma's head dim kept."""
    over = {"head_dim": HEAD_DIM} if arch == "gemma-7b" else {}
    return (dataclasses.replace(jreduced(jget_config(arch)),
                                gemm_policy=jpolicy, **over),
            dataclasses.replace(reduced(get_config(arch)),
                                gemm_policy=tpolicy, **over))


def _numpy_params(jparams, seed=23):
    """The reference's initial distributions drawn by numpy (norm scales
    0, embedding N(0, 0.02²), projections N(0, 1/fan_in))."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return jnp.zeros(leaf.shape, jnp.float32)
        std = 0.02 if ("embed" in name or "lm_head" in name) \
            else 1 / np.sqrt(leaf.shape[-2])
        return jnp.asarray((rng.standard_normal(leaf.shape) * std)
                           .astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, jparams)


def _reference_serve(jcfg, prompts):
    model = jbuild_model(jcfg)
    params = _numpy_params(jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    step = jax.jit(model.decode_step, static_argnames=("compute_logits",),
                   compiler_options={"xla_allow_excess_precision": False})
    caches = model.init_decode_cache(prompts.shape[0], PROMPT + GEN)
    p = jnp.asarray(prompts)
    for pos in range(PROMPT):
        _, caches = step(params, caches, p[:, pos:pos + 1], jnp.int32(pos),
                         compute_logits=False)
    tok, picks, logits = p[:, -1:], [], []
    for t in range(GEN):
        lg, caches = step(params, caches, tok, jnp.int32(PROMPT + t))
        tok = jnp.argmax(lg[:, -1, :], axis=-1)[:, None]
        picks.append(np.asarray(tok))
        logits.append(np.asarray(lg[:, -1, :].astype(jnp.float32)))
    return (jax.device_get(params), np.concatenate(picks, 1),
            np.stack(logits, 1))


def _assert_serve_limits(ref, got, picks):
    d = np.abs(got - ref)
    assert np.all(np.isfinite(got))
    assert np.median(d) < 0.02, float(np.median(d))
    assert np.mean(d > 0.05) <= 0.10, float(np.mean(d > 0.05))
    chosen = np.take_along_axis(ref, picks[..., None], -1)[..., 0]
    assert np.all(chosen >= ref.max(-1) - 0.1)


@pytest.mark.parametrize("arch,policy", [
    ("gemma-7b", "binary8-paper"), ("gemma-7b", "binary8-paper-attn"),
    ("phi3-medium-14b", "binary8-paper")])
def test_serve_matches_reference(interpret_params, arch, policy):
    """Reduced gemma (K4' under gelu; with ``-attn`` K9 at d = 256 over
    the e4m3 cache) and reduced phi3 served by both packages, held to the
    serve test's limits; the port's launches counted by activation."""
    prompts = np.random.default_rng(0).integers(0, 128, (B, PROMPT))
    jcfg, tcfg = _cfgs(arch, policy, policy)
    jparams, picks, ref = _reference_serve(jcfg, prompts)
    tq.reset_launches()
    out = tserve.serve_batch(build_model(tcfg),
                             convert.params_from_jax(jparams),
                             torch.from_numpy(prompts), GEN,
                             forced=torch.from_numpy(picks))
    _assert_serve_limits(ref, out["logits"].numpy(), out["tokens"].numpy())
    assert tq.ACT_LAUNCHES == dict.fromkeys(tq.ACT_LAUNCHES, 0)   # CPU


def _engine_policy(pkg, parse):
    return pkg.make_policy(attn=parse("binary8-sr"), kv_cache_fmt="e4m3-sr")


def _requests(pkg, n=4):
    """The reference's engine-test requests (``tests/test_serving.py``)."""
    rng = np.random.default_rng(1)
    return [pkg.Request(rid=i, prompt=rng.integers(1, 128, 5 + 3 * i)
                        .tolist(), max_new_tokens=3 + i, tenant="ab"[i % 2],
                        seed=100 + i) for i in range(n)]


def _engine_cfg(pkg):
    return pkg.EngineConfig(n_slots=3, page_size=8, total_pages=12,
                            max_pages_per_request=4, prefill_chunk=4,
                            token_budget=8)


def _reference_engine(model, params, ecfg):
    """The reference's engine with its step functions compiled here
    without excess precision (``tests/test_torch_serving.py``)."""
    eng = jengine.ContinuousBatchingEngine(model, params, ecfg)
    opts = {"xla_allow_excess_precision": False}

    def step(params, caches, tokens, pos, rng=None, compute_logits=True):
        return model.decode_step(params, caches, tokens, pos, rng=rng,
                                 compute_logits=compute_logits)

    def decode(params, k_pages, v_pages, tables, lengths, words, append,
               tokens, pos, rng):
        cache = jpc.PagedKVCache(k_pages=k_pages, v_pages=v_pages,
                                 tables=tables, lengths=lengths,
                                 words=words, append=append)
        logits, nc = model.decode_step(params, {"attn": cache}, tokens, pos,
                                       rng=rng, compute_logits=True)
        return (jnp.argmax(logits[:, -1], axis=-1), nc["attn"].k_pages,
                nc["attn"].v_pages)

    eng._step_fn = jax.jit(step, static_argnames=("compute_logits",),
                           compiler_options=opts)
    eng._decode_fn = jax.jit(decode, compiler_options=opts)
    return eng


def test_engine_streams_match_reference(interpret_params):
    """Reduced gemma under the engine's policy (bf16 GEMMs, the unfused
    GeGLU with ``jax.nn.gelu`` op by op in bf16; K10 at d = 256 over an
    e4m3 pool): the port's engine serves the reference engine's requests
    with the reference engine's token streams."""
    jcfg, tcfg = _cfgs("gemma-7b", _engine_policy(jp, jparse),
                       _engine_policy(tp, parse_spec))
    jmodel = jbuild_model(jcfg)
    jparams = _numpy_params(jax.eval_shape(jmodel.init,
                                           jax.random.PRNGKey(0)))
    arrivals = [0, 0, 1, 4]
    ref = _reference_engine(jmodel, jparams, _engine_cfg(jengine)) \
        .run(_requests(jengine), arrivals=arrivals)
    eng = tengine.ContinuousBatchingEngine(
        build_model(tcfg), convert.params_from_jax(jax.device_get(jparams)),
        _engine_cfg(tengine))
    got = eng.run(_requests(tengine), arrivals=arrivals)
    assert {r: v.tokens for r, v in got.items()} == \
        {r: v.tokens for r, v in ref.items()}
    assert eng.free_pages == 11


def test_params_from_jax_gemma_tree():
    """The reference's gemma tree (GeGLU blocks, no lm_head: the logits
    read the embedding) maps onto the port's: the same keys, the GEMM
    weights and the embedding bf16 of the same values, norms float32; the
    port's tied logits equal the embedding's transpose product."""
    jcfg, tcfg = _cfgs("gemma-7b", None, None)
    jmodel = jbuild_model(jcfg)
    jparams = jax.device_get(_numpy_params(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)), seed=5))
    assert "lm_head" not in jparams
    params = convert.params_from_jax(jparams)
    assert set(params) == {"embed", "blocks", "final_norm"}
    b = params["blocks"]["attn"]
    assert set(b["mlp"]) == {"w_gate", "w_up", "w_down"}
    assert b["attn"]["wq"].shape == (2, 64, 4 * HEAD_DIM)
    for key in ("w_gate", "w_up", "w_down"):
        ref = np.asarray(jparams["blocks"]["attn"]["mlp"][key])
        assert b["mlp"][key].dtype == torch.bfloat16
        assert torch.equal(b["mlp"][key],
                           torch.from_numpy(ref).to(torch.bfloat16))
    assert params["embed"].dtype == torch.bfloat16
    h = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 2, 64)).astype(np.float32)).to(torch.bfloat16)
    logits = build_model(tcfg)._logits(params, h)
    assert torch.equal(logits, h @ params["embed"].T)


def test_configs_match_reference_and_count_parameters():
    """gemma-7b and phi3-medium-14b as the reference defines them, with
    the parameter counts of the reference's estimate (gemma: 8,537,680,896
    with the tied 256000 x 3072 embedding)."""
    for arch, n in (("gemma-7b", 8_537_680_896),
                    ("phi3-medium-14b", 14_659_507_200)):
        cfg, jcfg = get_config(arch), jget_config(arch)
        for f in dataclasses.fields(cfg):
            if f.name != "gemm_policy":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        d, hd, L = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
        attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
            + cfg.n_heads * hd * d
        embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
        count = L * (attn + 3 * d * cfg.d_ff + 2 * d) + embed + d
        assert count == n
        assert abs(jcfg.param_count_estimate - count) <= L * 2 * d + d


def test_attention_head_dim_limits():
    """Every attention kernel (K6, K7, K7', K9, K10) takes head dims up to
    256, gemma-7b's, and refuses wider ones before any work, on the CPU
    twins too."""
    assert tfa.D_MAX == {"flash_fwd": 256, "flash_decode": 256,
                         "flash_decode_paged": 256, "flash_bwd_dq": 256,
                         "flash_bwd_dkv": 256}
    q = torch.zeros((2, 3, 512))
    sp = [parse_spec("binary8-sr")] * 3
    seeds = np.zeros((2, 6), np.uint64)
    with pytest.raises(NotImplementedError, match="above 256"):
        tfa.flash_fwd(q, q, q, seeds, sp, scale=0.1, n_heads=2, n_kv=2)
    st = torch.ones((2, 3))
    with pytest.raises(NotImplementedError, match="above 256"):
        tfa.flash_bwd_dq(q, q, q, q, st, st, st, seeds[:, :4], sp[0], sp[0],
                         scale=0.1, n_heads=2, n_kv=2)
    with pytest.raises(NotImplementedError, match="above 256"):
        tfa.flash_bwd_dkv(q, q, q, q, st, st, st, seeds, *sp, scale=0.1,
                          n_heads=2, n_kv=2)
    q = q[..., :256]
    dq = tfa.flash_bwd_dq(q, q, q, q, st, st, st, seeds[:, :4], sp[0], sp[0],
                          scale=0.1, n_heads=2, n_kv=2)
    dk, dv = tfa.flash_bwd_dkv(q, q, q, q, st, st, st, seeds, *sp, scale=0.1,
                               n_heads=2, n_kv=2)
    assert dq.shape == dk.shape == dv.shape == (2, 3, 256)


def test_serve_run_gemma_and_phi3_cli_reduced(capsys):
    """``serve.run`` and the CLI take both families (reduced, on the CPU),
    the engine too; the full-size runs chip_smoke.py drives are named."""
    assert tserve.GEMMA_SERVE_RUN == dict(arch="gemma-7b", batch=4,
                                          prompt_len=32, gen=16)
    assert tserve.PHI3_SERVE_RUN["arch"] == "phi3-medium-14b"
    tserve.main(["--arch", "gemma-7b", "--reduced", "--device", "cpu",
                 "--batch", "1", "--prompt-len", "3", "--gen", "2",
                 "--gemm-policy", "binary8-paper"])
    tserve.main(["--arch", "phi3-medium-14b", "--reduced", "--device", "cpu",
                 "--batch", "1", "--prompt-len", "3", "--gen", "2"])
    out = capsys.readouterr().out
    assert "arch=gemma-7b" in out and "arch=phi3-medium-14b" in out
