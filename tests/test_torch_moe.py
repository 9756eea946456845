"""The port's MoE serving slice against the JAX reference.

Kernel twins: the port's wrappers on CPU tensors run their plain twins;
the reference runs ``sr_cast_prng_p`` / ``qmatmul_batched_prng_p`` in
Pallas interpret mode, which draws the same counter bits from the same
seed words.  The MoE layer and the whole reduced qwen3-moe decoder run
through both packages on the same numpy-drawn parameters (the reference's
block init folds ``hash()`` of a name, salted per process).

Tolerances (stated before measuring):
* K1' (``sr_cast_prng``): bitwise, any shape, any input.
* K8' (``qmatmul_batched_prng``) and ``qeinsum``: bitwise on exact-sum
  inputs (dyadic values); on N(0, 1) inputs at most 1e-4 of the elements
  may differ, each by one grid ulp (float32 summation order).
* ``qact``: bitwise forward; its gradient is the incoming one (STE).
* ``moe_apply`` (reference run op by op): ``topi`` and the drop mask
  equal; ``aux`` within 1e-6 relative and ``y`` within one bf16 ulp
  (relative 2^-7) of the reference: softmax's ``exp`` and the combine's
  float32 sum over k may differ by float32 ulps, which can move a bf16
  rounding.
* Reduced serve (reference decode step compiled with
  ``xla_allow_excess_precision=False``, as XLA otherwise skips the bf16
  roundings of the SwiGLU chain inside its fusions): as
  ``test_torch_serve``'s binary8 bound, the median absolute logit
  difference below 0.02, at most 10 % of logits off by more than 0.05, and
  greedy picks equal up to near-ties (within 0.1 of the reference
  maximum).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.kernels import qmatmul as jq
from repro.kernels import sr_cast as jsr
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.precision import policy as jp
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core import prng
from repro_torch.core.rounding import grid_flips
from repro_torch.kernels import qmatmul as tq
from repro_torch.kernels import sr_cast as tsr
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model, moe as tmoe
from repro_torch.models.model import store_params
from repro_torch.precision import policy as tp

ARCH = "qwen3-moe-30b-a3b"
POLICY = "binary8-paper"
WORDS = (0x12345678, 0x9ABCDEF0)


@pytest.fixture
def interpret_params(monkeypatch):
    """The reference kernels build ``pltpu.TPUCompilerParams``, which newer
    jax names ``CompilerParams``; alias it only where it is missing."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _cfgs(**over):
    jcfg = dataclasses.replace(jreduced(jget_config(ARCH)),
                               gemm_policy=POLICY, **over)
    tcfg = dataclasses.replace(reduced(get_config(ARCH)), gemm_policy=POLICY,
                               **over)
    return jcfg, tcfg


# ---------------------------------------------------------------------------
# K1': the SR cast with in-kernel bits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["binary8", "e4m3", "bfloat16"])
def test_sr_cast_twin_matches_reference(fmt):
    rng = np.random.default_rng(0)
    # n not a multiple of 128; rn draws no bits, so one width covers it
    for shape, cases in (((1000,), (("sr", 32), ("sr", 16), ("sr", 8),
                                    ("rn", 32))),
                         ((3, 7, 11), (("sr", 32),))):
        x = (rng.standard_normal(shape) * 4).astype(np.float32)
        for mode, rb in cases:
            ref = jsr.sr_cast_prng_p(jnp.asarray(x),
                                     jnp.asarray(WORDS, jnp.uint32), fmt,
                                     mode, rand_bits=rb, interpret=True)
            got = tsr.sr_cast_prng(torch.from_numpy(x), WORDS, fmt, mode,
                                   rand_bits=rb)
            assert got.shape == shape
            np.testing.assert_array_equal(_bits(ref), _bits(got.numpy()),
                                          err_msg=f"{mode} r{rb}")


def test_sr_cast_unported_branches_raise():
    """K1' takes sr2 and overflow='inf' (its wide instance on the card),
    bitwise the reference's interpret kernel; K1 keeps the generic
    instance's sites, so a fixed-point grid raises there; signed_sr_eps
    without its bias direction raises ValueError (the v branch and sr_eps
    are ported: tests/test_torch_oracle.py)."""
    x = np.array([0.3, -1.7, 2.2e5, -9e4, 1.0], np.float32)
    for mode, kw in (("sr2", {}), ("sr", dict(overflow="inf"))):
        ref = jsr.sr_cast_prng_p(jnp.asarray(x),
                                 jnp.asarray(np.array(WORDS, np.uint32)),
                                 "binary8", mode, interpret=True, **kw)
        got = tsr.sr_cast_prng(torch.from_numpy(x), WORDS, "binary8", mode,
                               **kw)
        np.testing.assert_array_equal(_bits(ref), _bits(got.numpy()))
    assert np.isinf(_bits(got.numpy()).view(np.float32)).any()
    with pytest.raises(NotImplementedError):
        tsr.sr_cast(torch.ones(5), None, "fxp16.8", "rn")
    with pytest.raises(ValueError):
        tsr.sr_cast_prng(torch.ones(5), WORDS, "binary8", "signed_sr_eps",
                         eps=0.1)


# ---------------------------------------------------------------------------
# K8': the batched rounded GEMM
# ---------------------------------------------------------------------------
def _seeds(E, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (E, 2),
                                                dtype=np.int64)


def _assert_one_ulp(ref, got, fmt, share=1e-4):
    ref = torch.from_numpy(np.array(ref, np.float32))
    n, adjacent = grid_flips(ref, got, fmt)
    assert n <= share * ref.numel(), (n, ref.numel())
    assert adjacent


@pytest.mark.parametrize("b_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_qmatmul_batched_twin_matches_reference(interpret_params, b_dtype):
    """M = 3, a whole prompt's capacity M = 10 and M = 17 (two row tiles of the
    card's weight-stream route)."""
    rng = np.random.default_rng(1)
    E, K, N = 4, 70, 50
    seeds = _seeds(E, 2)
    for M in (3, 10, 17):
        a = (rng.integers(-8, 9, (E, M, K)) / 8).astype(np.float32)
        b = (rng.integers(-8, 9, (E, K, N)) / 4).astype(np.float32)
        tb = torch.from_numpy(b).to(b_dtype)
        for fmt, mode, rb in (("binary8", "sr", 32), ("binary8", "rn", 32),
                              ("e4m3", "sr", 16), ("binary8", "sr", 8)):
            ref = jq.qmatmul_batched_prng_p(
                jnp.asarray(a), jnp.asarray(b),
                jnp.asarray(seeds, jnp.uint32), fmt, mode, rand_bits=rb,
                interpret=True)
            got = tq.qmatmul_batched_prng(torch.from_numpy(a), tb, seeds,
                                          fmt, mode, rb)
            np.testing.assert_array_equal(_bits(ref), _bits(got.numpy()),
                                          err_msg=f"M={M} {fmt} {mode} r{rb}")
    # N(0, 1) inputs, b on its bf16 grid so both operands are the same
    K, N = 300, 130
    for M in (5, 10, 17):
        a = rng.standard_normal((E, M, K)).astype(np.float32)
        b = torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32)
                             / np.sqrt(K)).to(b_dtype)
        ref = jq.qmatmul_batched_prng_p(
            jnp.asarray(a), jnp.asarray(b.float().numpy()),
            jnp.asarray(seeds, jnp.uint32), "binary8", "sr", interpret=True)
        got = tq.qmatmul_batched_prng(torch.from_numpy(a), b, seeds,
                                      "binary8")
        _assert_one_ulp(ref, got, "binary8")


@pytest.mark.parametrize("M,route", [(1, "stream"), (10, "stream"),
                                     (17, "stream"), (96, "stream"),
                                     (97, "large"), (1024, "large")])
def test_qmatmul_batched_route_choice(monkeypatch, M, route):
    """K8'/K8 take the weight-stream route up to BATCHED_STREAM_MAX_M rows
    per slice (every MoE decode call, M = 1, and a whole prompt's capacity,
    M = 10), the large-M route past it; the limit moves the choice."""
    assert tq.BATCHED_STREAM_MAX_M == 96
    assert tq.batched_route(M) == route
    monkeypatch.setattr(tq, "BATCHED_STREAM_MAX_M", 0)
    assert tq.batched_route(M) == "large"
    monkeypatch.setattr(tq, "BATCHED_STREAM_MAX_M", 1 << 30)
    assert tq.batched_route(M) == "stream"


def test_qmatmul_batched_slices_draw_their_own_words():
    """Slice e of a batched call is the 2-D K3' twin on seeds[e]."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy((rng.integers(-8, 9, (3, 4, 20)) / 8)
                         .astype(np.float32))
    b = torch.from_numpy((rng.integers(-8, 9, (3, 20, 9)) / 4)
                         .astype(np.float32))
    seeds = _seeds(3, 4)
    got = tq.qmatmul_batched_prng(a, b, seeds, "binary8", "sr", 8)
    for e in range(3):
        ref = tq.qmatmul_plain(a[e], b[e], tuple(int(w) for w in seeds[e]),
                               "binary8", "sr", 8)
        assert torch.equal(got[e], ref)
    with pytest.raises(ValueError):
        tq.qmatmul_batched_prng(a, b, seeds[:2], "binary8")
    with pytest.raises(NotImplementedError):
        tq.qmatmul_batched_prng(a, b, seeds, "binary8", act="silu")


# ---------------------------------------------------------------------------
# qeinsum and qact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("eqn,sa,sb", [
    ("ecd,edf->ecf", (4, 3, 40), (4, 40, 24)),
    ("ecf,efd->ecd", (4, 3, 24), (4, 24, 40)),
    ("ecd,efd->fce", (4, 3, 40), (4, 24, 40)),
])
def test_qeinsum_matches_reference(interpret_params, eqn, sa, sb):
    rng = np.random.default_rng(5)
    a = (rng.integers(-8, 9, sa) / 8).astype(np.float32)
    b = (rng.integers(-8, 9, sb) / 4).astype(np.float32)
    jctx = jp.make_ctx(POLICY, jax.random.PRNGKey(2))
    tctx = tp.make_ctx(POLICY, prng.PRNGKey(2))
    ref = jp.qeinsum(eqn, jnp.asarray(a, jnp.bfloat16),
                     jnp.asarray(b, jnp.bfloat16), jctx, jp.TAG_MOE_UP)
    got = tp.qeinsum(eqn, torch.from_numpy(a).to(torch.bfloat16),
                     torch.from_numpy(b).to(torch.bfloat16), tctx,
                     tp.TAG_MOE_UP)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)),
                                  got.float().numpy())
    # no policy: exactly torch.einsum
    plain = tp.qeinsum(eqn, torch.from_numpy(a), torch.from_numpy(b), None)
    assert torch.equal(plain, torch.einsum(eqn, torch.from_numpy(a),
                                           torch.from_numpy(b)))


def test_qeinsum_backward_raises():
    ctx = tp.make_ctx(POLICY, prng.PRNGKey(0))
    a = torch.ones((2, 3, 4), requires_grad=True)
    out = tp.qeinsum("ecd,edf->ecf", a, torch.ones((2, 4, 5)), ctx)
    with pytest.raises(NotImplementedError, match="not ported"):
        out.sum().backward()


def test_qact_matches_reference_with_ste_gradient():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 5, 37)) * 2).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jctx = jp.make_ctx(POLICY, jax.random.PRNGKey(4))
    tctx = tp.make_ctx(POLICY, prng.PRNGKey(4))
    ref = jp.qact(jnp.asarray(x), jctx, jp.TAG_MOE_ACT)
    jgrad = jax.grad(lambda v: jnp.sum(jp.qact(v, jctx, jp.TAG_MOE_ACT)
                                       * w))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tp.qact(tx, tctx, tp.TAG_MOE_ACT)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(_bits(ref), _bits(got.detach().numpy()))
    np.testing.assert_array_equal(np.asarray(jgrad), tx.grad.numpy())
    np.testing.assert_array_equal(tx.grad.numpy(), w)
    # bf16 in, bf16 out; no policy: the identity
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tp.qact(xb, tctx, tp.TAG_MOE_ACT).dtype == torch.bfloat16
    assert tp.qact(xb, None) is xb


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------
def _moe_params(tcfg, rng, router_scale):
    m, D = tcfg.moe, tcfg.d_model
    p = {"router": rng.standard_normal((D, m.n_experts)) * router_scale,
         "w_gate": rng.standard_normal((m.n_experts, D, m.d_expert))
         / np.sqrt(D),
         "w_up": rng.standard_normal((m.n_experts, D, m.d_expert))
         / np.sqrt(D),
         "w_down": rng.standard_normal((m.n_experts, m.d_expert, D))
         / np.sqrt(m.d_expert)}
    if m.n_shared:
        F = m.n_shared * m.d_expert
        p["shared"] = {"w_gate": rng.standard_normal((D, F)) / np.sqrt(D),
                       "w_up": rng.standard_normal((D, F)) / np.sqrt(D),
                       "w_down": rng.standard_normal((F, D)) / np.sqrt(F)}
    return jax.tree_util.tree_map(lambda v: v.astype(np.float32), p)


def _reference_keep(topi, E, C):
    """The reference's drop mask, its own lines
    (``repro.models.moe._dispatch_compute_combine``)."""
    e_flat = topi.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    p_flat = jnp.take_along_axis(pos, e_flat[:, None], axis=1)[:, 0]
    return np.asarray(p_flat < C)


@pytest.mark.parametrize("case", ["routed", "tied", "shared"])
def test_moe_apply_matches_reference(interpret_params, case):
    over = {}
    if case == "shared":
        over["moe"] = dataclasses.replace(reduced(get_config(ARCH)).moe,
                                          n_shared=1)
    jcfg, tcfg = _cfgs(**over)
    rng = np.random.default_rng(7)
    params = _moe_params(tcfg, rng, 0.0 if case == "tied" else 0.3)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jctx = jp.ctx_for(jcfg, jax.random.PRNGKey(3))
    ref_y, ref_aux = jmoe.moe_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jx, jcfg, quant=jctx)
    tparams = store_params(jax.tree_util.tree_map(torch.from_numpy, params))
    tctx = tp.ctx_for(tcfg, prng.PRNGKey(3))
    y, aux = tmoe.moe_apply(tparams, torch.from_numpy(x).to(torch.bfloat16),
                            tcfg, quant=tctx)

    # routing: the reference's router logits, softmax and top_k
    from repro.models import layers as JL
    m = tcfg.moe
    xt = jx.reshape(-1, tcfg.d_model)
    logits = JL.qdense(xt, jnp.asarray(params["router"]), jctx,
                       jp.TAG_ROUTER).astype(jnp.float32)
    _, ref_topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    tlogits = tp.qdot(torch.from_numpy(x).to(torch.bfloat16).reshape(
        -1, tcfg.d_model), tparams["router"], tctx, tp.TAG_ROUTER).float()
    _, topi = tmoe.top_k(torch.softmax(tlogits, -1), m.top_k)
    np.testing.assert_array_equal(np.asarray(ref_topi), topi.numpy())
    T = x.shape[0] * x.shape[1]
    C = max(1, int(T * m.top_k * m.capacity_factor
                   / max(m.n_experts, m.top_k)))
    _, _, keep = tmoe.dispatch(topi, m.n_experts, C)
    ref_keep = _reference_keep(ref_topi, m.n_experts, C)
    np.testing.assert_array_equal(ref_keep, keep.numpy())
    if case == "tied":                 # every token picks experts 0 and 1
        assert np.all(np.asarray(ref_topi) == [0, 1]) and not ref_keep.all()

    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-6)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ref_y.astype(jnp.float32)),
                               rtol=2 ** -7, atol=0)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                          [0.5, 0.0, 0.5, 0.0]])
    vals, idx = tmoe.top_k(probs, 2)
    _, ref = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(np.asarray(ref), idx.numpy())
    assert idx.tolist() == [[0, 1], [1, 3], [0, 2]]


# ---------------------------------------------------------------------------
# The reduced decoder end to end
# ---------------------------------------------------------------------------
B, PROMPT, GEN = 2, 6, 3


def _numpy_tree(jcfg):
    """The reference's parameter tree (its shapes) with numpy values:
    weights N(0, 1/fan_in), the router N(0, 0.3^2), norms zero."""
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in paths:
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            v = np.zeros(leaf.shape)
        elif "router" in name:
            v = rng.standard_normal(leaf.shape) * 0.3
        else:
            v = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        out.append(v.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def _reference_serve(jcfg, jparams, prompts):
    """Greedy decode through one compiled step (prompt absorption also
    computes the lm head, whose stream no other site shares, so the caches
    are those of ``compute_logits=False``)."""
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


@pytest.mark.parametrize("head_dim", [None, 32], ids=["hd16", "hd32"])
def test_moe_serve_matches_reference(interpret_params, head_dim):
    over = {} if head_dim is None else {"head_dim": head_dim}
    jcfg, tcfg = _cfgs(**over)
    if head_dim is not None:       # n_heads * head_dim != d_model
        assert tcfg.n_heads * tcfg.resolved_head_dim != tcfg.d_model
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


def test_params_from_jax_moe_tree():
    jcfg, tcfg = _cfgs()
    jparams = _numpy_tree(jcfg)
    params = convert.params_from_jax(jparams)
    b, jb = params["blocks"]["attn"], jparams["blocks"]["attn"]
    assert set(b) == {"norm1", "norm2", "attn", "moe"}
    m = b["moe"]
    assert m["router"].shape == (2, 64, 4) and m["router"].dtype \
        == torch.bfloat16
    for k in ("w_gate", "w_up", "w_down"):
        assert isinstance(m[k], list) and len(m[k]) == tcfg.n_layers
        for i, w in enumerate(m[k]):
            assert w.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                w.float().numpy(),
                torch.from_numpy(jb["moe"][k][i]).to(torch.bfloat16)
                .float().numpy())
    assert b["norm1"].dtype == torch.float32
    # the port's own init makes the same tree, bf16 weights; the master
    # tree is the same draws unrounded
    model = build_model(tcfg)
    own = model.init(torch.Generator().manual_seed(0))
    master = model.init_master(torch.Generator().manual_seed(0))
    om = own["blocks"]["attn"]["moe"]
    assert [w.shape for w in om["w_down"]] == [w.shape for w in m["w_down"]]
    assert torch.equal(om["w_up"][1],
                       master["blocks"]["attn"]["moe"]["w_up"][1]
                       .to(torch.bfloat16))
    with pytest.raises(NotImplementedError):
        convert.master_params_from_jax(jparams)


def test_moe_serve_counts_kernel_work_per_step():
    """Launch arithmetic the chip run asserts (counted here through the
    plain twins' call sites): per layer per token 5 rounded 2-D GEMMs (q,
    k, v, o, router), 3 batched expert GEMMs and 1 SR cast; the lm head
    per generated token; no fused dense FFN."""
    names = ("qmatmul_plain", "qmatmul_batched_plain",
             "qmatmul_swiglu_plain")
    calls = {n: 0 for n in names + ("sr_cast_prng_plain",)}
    mp = pytest.MonkeyPatch()

    def counted(mod, name):
        orig = getattr(mod, name)

        def fn(*a, **k):
            calls[name] += 1
            return orig(*a, **k)
        mp.setattr(mod, name, fn)

    for n in names:
        counted(tq, n)
    counted(tsr, "sr_cast_prng_plain")
    try:
        out = tserve.run(ARCH, reduced=True, batch=2, prompt_len=5, gen=3,
                         gemm_policy=POLICY, device="cpu")
    finally:
        mp.undo()
    n_layers, steps = reduced(get_config(ARCH)).n_layers, 5 + 3
    assert calls == {"qmatmul_plain": 5 * n_layers * steps + 3,
                     "qmatmul_batched_plain": 3 * n_layers * steps,
                     "qmatmul_swiglu_plain": 0,
                     "sr_cast_prng_plain": n_layers * steps}
    assert out["tokens"].shape == (2, 3)


def test_moe_serve_cli_needs_a_device_or_cpu(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--arch", ARCH, "--reduced"])
    tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                 "1", "--prompt-len", "3", "--gen", "2", "--gemm-policy",
                 POLICY])
    assert "decode" in capsys.readouterr().out
    assert tserve.MOE_SERVE_RUN == dict(arch=ARCH, batch=4, prompt_len=32,
                                        gen=16)
