"""The port's QAdam against the JAX reference: K5's plain twin against
``fused_qadam_prng_p`` (interpret mode), the bias corrections, ``QAdam``
on its three update paths, and two reduced training steps.

Inputs are made with numpy from fixed seeds.  Tolerances:

* K5's twin: bitwise (float32 as int32 patterns, codes as integers) for
  x⁺, m', v', cm', cv', except x⁺ under the identity chain: there XLA
  contracts ``x - t * d`` into one fused multiply-add and the port keeps
  K2''s two roundings, so they differ by at most the product's rounding
  (one float32 ulp of |x| + |x⁺|; more ulps of x⁺ where x and t·d
  cancel), on under 5 % of the elements.
* ``1 - b ** step``: bitwise for steps 1 ... 10 000.
* ``QAdam.apply`` against the reference's jitted ``apply``: bitwise.
* Two steps of reduced tinyllama with QAdam (bf16-sr moments): the limits
  of the QSGD train test (``tests/test_torch_train.py``): losses within
  5e-7 relative, at most 8 of the 90,432 parameters different, and at
  most 8 moment values (codes) different in m and in v.  The reference is
  compiled with ``xla_allow_excess_precision=False``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.core import gd as jgd, rounding as jr
from repro.kernels import common as jc
from repro.kernels import fused_update as jfu
from repro.optim import qadam as jqadam
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core import gd as tgd, prng, rounding as tr
from repro_torch.kernels import fused_update as tfu
from repro_torch.kernels.tree_update import tree_leaves
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.optim import qadam as tqadam
from repro_torch.optim.adam import bias_correction

SEED = (0x1234ABCD, 0x0BADF00D)
CHAIN = ("binary8-rn", "binary8-sr", "binary8-signed_sr_eps-e0.1")
OTHER_CHAINS = {
    "sr_eps-r16-binary8": ("binary8-rn", "binary8-sr_eps-e0.1-r16",
                           "binary8-sr"),
    "e4m3-mul-identity": ("e4m3-signed_sr_eps-e0.3", "fp32", "e4m3-sr"),
}


@pytest.fixture
def interpret_params(monkeypatch):
    """The reference kernels build ``pltpu.TPUCompilerParams``, which newer
    jax names ``CompilerParams``; alias it only where it is missing."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _diff(ref, got) -> int:
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    if ref.dtype == np.float32:
        ref, got = ref.view(np.int32), got.view(np.int32)
    return int(np.sum(ref != got))


def _k5(m_name, v_name, packed, kahan, n, *, chain=CHAIN, wd=0.0,
        gscale=1.0, step=3, seed=0, again=False):
    """Reference and port outputs of one K5 call on the same inputs:
    mid-trajectory moments (on their grids), x and g N(0, 1) (g scaled by
    ``gscale``), signed zeros and saturating values mixed in.  ``again``:
    also return a function that reruns the port's call."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * gscale).astype(np.float32)
    x[::89] = 0.0
    g[1::97] = -0.0
    g[2::101] = 7e4 * gscale
    ms, vs = jr.parse_spec(m_name), jr.parse_spec(v_name)
    sub_v = "neg_grad" if chain[0].startswith("e4m3") else "grad"
    jcfg = jgd.GDRounding(*(jr.parse_spec(s) for s in chain), sub_v=sub_v)
    tcfg = tgd.GDRounding(*(tr.parse_spec(s) for s in chain), sub_v=sub_v)

    def start(spec, vals):
        vals = jnp.asarray(vals.astype(np.float32))
        return vals if spec.is_identity \
            else jr.parse_spec(f"{spec.fmt}-rn")(vals)
    m0 = start(ms, 0.1 * rng.standard_normal(n) * gscale)
    v0 = start(vs, 0.05 * g.astype(np.float64) ** 2 + 1e-4 * gscale ** 2)
    if packed:
        m0, v0 = jc.pack_block(m0, ms.fmt), jc.pack_block(v0, vs.fmt)
    cm = cv = None
    if kahan:
        # carries at the scale of the moments' own rounding errors
        cm = jnp.asarray((rng.standard_normal(n) * 1e-6 * gscale)
                         .astype(np.float32))
        cv = jnp.asarray((rng.standard_normal(n) * 1e-9 * gscale ** 2)
                         .astype(np.float32))
    scal = np.float32([0.01, 1 - 0.9 ** step, 1 - 0.999 ** step, 1e-8, wd])
    ref = jfu.fused_qadam_prng_p(
        jnp.asarray(x), jnp.asarray(g), m0, v0, jnp.asarray(scal),
        jnp.asarray(np.array(SEED, np.uint32)), jcfg, m_spec=ms, v_spec=vs,
        b1=0.9, b2=0.999, packed=packed, cm=cm, cv=cv, interpret=True)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    def port():
        return tfu.fused_qadam_prng(
            t(x), t(g), t(m0), t(v0), scal.tolist(), SEED, tcfg,
            m_spec=tr.parse_spec(m_name), v_spec=tr.parse_spec(v_name),
            b1=0.9, b2=0.999, packed=packed, cm=t(cm), cv=t(cv))
    got = port()
    assert len(ref) == len(got) == (5 if kahan else 3)
    for r, p in zip(ref, got):
        assert np.asarray(r).dtype == p.numpy().dtype
    return (ref, got, port) if again else (ref, got)


# ------------------------------------------------------------------- K5 --
@pytest.mark.parametrize("m_name,v_name", [
    ("bfloat16-sr", "bfloat16-sr"),
    ("bfloat16-sr", "e4m3-sr"),
    ("bf16-sr-bittrick", "bfloat16-sr"),
])
def test_k5_twin_matches_reference_packed(m_name, v_name):
    ref, got = _k5(m_name, v_name, True, False, 5000)
    assert [_diff(r, g) for r, g in zip(ref, got)] == [0, 0, 0]


@pytest.mark.parametrize("m_name,v_name,packed,kahan,wd", [
    ("bfloat16-sr", "bfloat16-sr", True, True, 0.01),     # packed + Kahan
    ("bfloat16-rn", "bfloat16-rn", False, True, 0.01),    # float32 + Kahan
    ("fp32", "fp32", False, False, 0.01),                 # fp32 carries
    ("binary8-sr-r8", "e4m3-sr-r16", True, False, 0.0),   # 8/16-bit draws
])
def test_k5_twin_matches_reference_carries(m_name, v_name, packed, kahan,
                                           wd):
    ref, got = _k5(m_name, v_name, packed, kahan, 128 * 37 + 37, wd=wd)
    assert [_diff(r, g) for r, g in zip(ref, got)] == [0] * len(ref)


@pytest.mark.parametrize("chain", sorted(OTHER_CHAINS))
def test_k5_twin_matches_reference_chains(chain):
    ref, got = _k5("bfloat16-sr", "bfloat16-sr", True, False, 3000,
                   chain=OTHER_CHAINS[chain], wd=0.01)
    assert [_diff(r, g) for r, g in zip(ref, got)] == [0, 0, 0]


def test_k5_twin_identity_chain_within_one_ulp():
    """x⁺ = x - t * d rounded once (XLA's FMA) or twice (the port): they
    differ by at most the product's rounding, one ulp of |x| + |x⁺|."""
    ref, got = _k5("bfloat16-sr", "bfloat16-sr", True, False, 3000,
                   chain=("fp32",) * 3, wd=0.01)
    assert _diff(ref[1], got[1]) == _diff(ref[2], got[2]) == 0
    x = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    x[::89] = 0.0           # as _k5 draws it
    r, p = np.asarray(ref[0]), got[0].numpy()
    assert np.all(np.abs(r - p) <= np.spacing(np.abs(x) + np.abs(r)))
    assert _diff(r, p) < 0.05 * r.size


@pytest.mark.parametrize("kahan", [False, True])
def test_k5_twin_subnormal_squares(kahan):
    """Gradients near 1e-20: g * g and the moment terms fall below
    2**-126, where XLA's CPU code flushes to zero."""
    ref, got = _k5("bfloat16-sr", "bfloat16-sr", True, kahan, 2000,
                   gscale=1e-20)
    assert [_diff(r, g) for r, g in zip(ref, got)] == [0] * len(ref)


def test_k5_twin_chunks_change_nothing(monkeypatch):
    """The twin works ``CHUNK`` elements at a time; the bits are keyed by
    position, so a chunk of 256 gives the same result, on a ragged n."""
    ref, got, port = _k5("bfloat16-sr", "e4m3-sr", True, True,
                         128 * 11 + 37, again=True)
    monkeypatch.setattr(tfu, "CHUNK", 256)
    small = port()
    for r, g, s in zip(ref, got, small):
        assert _diff(r, g) == 0 and _diff(g.numpy(), s) == 0


def test_k5_rejects_what_it_does_not_support():
    x = torch.zeros(8)
    codes = torch.zeros(8, dtype=torch.uint16)
    bf = tr.parse_spec("bf16-sr")
    cfg = tgd.GDRounding(*(tr.parse_spec(s) for s in CHAIN), sub_v="grad")
    kw = dict(b1=0.9, b2=0.999)
    with pytest.raises(NotImplementedError, match="bit-trick"):
        tfu.fused_qadam_prng(x, x, torch.zeros(8, dtype=torch.uint8), codes,
                             [0.1, 1, 1, 1e-8, 0], SEED, cfg,
                             m_spec=tr.parse_spec("e4m3-sr-bittrick"),
                             v_spec=bf, packed=True, **kw)
    with pytest.raises(ValueError, match="non-identity"):
        tfu.fused_qadam_prng(x, x, x, x, [0.1, 1, 1, 1e-8, 0], SEED, cfg,
                             m_spec=tr.IDENTITY, v_spec=bf, packed=True, **kw)
    with pytest.raises(ValueError, match="both cm and cv"):
        tfu.fused_qadam_prng(x, x, codes, codes, [0.1, 1, 1, 1e-8, 0], SEED,
                             cfg, m_spec=bf, v_spec=bf, packed=True, cm=x,
                             **kw)
    with pytest.raises(ValueError, match="must be torch.uint16"):
        tfu.fused_qadam_prng(x, x, x, codes, [0.1, 1, 1, 1e-8, 0], SEED,
                             cfg, m_spec=bf, v_spec=bf, packed=True, **kw)
    before = tfu.LAUNCHES["fused_qadam_prng"]
    tfu.fused_qadam_prng(x, x, codes, codes, [0.1, 1, 1, 1e-8, 0], SEED, cfg,
                         m_spec=bf, v_spec=bf, packed=True, **kw)
    assert tfu.LAUNCHES["fused_qadam_prng"] == before    # the CPU twin ran


# -------------------------------------------------------- bias correction --
# (chain, m spec, v spec, packed, kahan, the K5 instance it runs)
K5_INSTANCE_CASES = [
    (CHAIN, "bf16-sr", "bf16-sr", True, False, "trainer"),
    (("e4m3-rn", "e4m3-sr", "e4m3-signed_sr_eps-e0.2"), "bf16-sr",
     "bf16-sr", True, False, "trainer"),
    (CHAIN, "bf16-sr-bittrick", "bf16-sr", True, False, "generic"),
    (CHAIN, "bf16-sr", "e4m3-sr", True, False, "generic"),
    (CHAIN, "bf16-sr", "bf16-sr", True, True, "generic"),
    (CHAIN, "bf16-sr", "bf16-sr", False, False, "generic"),
    (CHAIN, "fp32", "fp32", False, False, "generic"),
    (CHAIN, "bf16-sr-r16", "bf16-sr-r16", True, False, "generic"),
    (CHAIN, "bf16-rn", "bf16-rn", True, False, "generic"),
    (CHAIN, "binary8-sr", "binary8-sr", True, False, "generic"),
    (OTHER_CHAINS["sr_eps-r16-binary8"], "bf16-sr", "bf16-sr", True, False,
     "generic"),
    (OTHER_CHAINS["e4m3-mul-identity"], "bf16-sr", "bf16-sr", True, False,
     "generic"),
    (("binary8-rn", "binary8-sr-r16", "binary8-signed_sr_eps-e0.1"),
     "bf16-sr", "bf16-sr", True, False, "generic"),
    # bf16 sites scale past float32's range (not `narrow`)
    (("bf16-rn", "bf16-sr", "bf16-signed_sr_eps-e0.1"), "bf16-sr", "bf16-sr",
     True, False, "generic"),
]


@pytest.mark.parametrize("chain,m_name,v_name,packed,kahan,want",
                         K5_INSTANCE_CASES)
def test_k5_instance_choice(chain, m_name, v_name, packed, kahan, want):
    cfg = tgd.GDRounding(*(tr.parse_spec(s) for s in chain), sub_v="grad")
    got = tfu.k5_instance(cfg, tr.parse_spec(m_name), tr.parse_spec(v_name),
                          packed, kahan)
    assert got == want and got in tfu.K5_INSTANCES


def test_k5_instance_of_adam_run():
    """``train.ADAM_RUN``'s optimizer runs K5's trainer instance on the
    fused path (packed codes) and the generic one on no other."""
    run = ttrain.ADAM_RUN
    cfg = ttrain.rounding_config(run["rounding_kind"], run["fmt"], run["eps"])
    spec, kahan = ttrain.parse_moments_spec(run["moments_spec"])
    opt = ttrain.build_optimizer("adam", lr=run["lr"], momentum=0.0, cfg=cfg,
                                 update_path=run["update_path"],
                                 moments_spec=run["moments_spec"])
    assert opt.moments_packed and not kahan
    assert tfu.k5_instance(cfg, spec, spec, True, kahan) == "trainer"


def test_k5_narrow_grids():
    """rounding.cuh's ``narrow``: every scaled value of the site stays in
    float32's exponent range."""
    assert tfu._narrow(tr.parse_spec("binary8-sr"))
    assert tfu._narrow(tr.parse_spec("e4m3-sr"))
    assert not tfu._narrow(tr.parse_spec("bf16-sr"))


def test_bias_corrections_match_reference():
    """``[t, c1, c2, eps, wd]`` as ``QAdam._apply_fused`` builds it, steps
    1 ... 10 000: the powers come from XLA's float32 pow."""
    steps = np.arange(1, 10001, dtype=np.int32)

    @jax.jit
    def scal(s, b1, b2):
        sf = s.astype(jnp.float32)
        return jnp.stack([jnp.full_like(sf, 0.05), 1.0 - b1 ** sf,
                          1.0 - b2 ** sf, jnp.full_like(sf, 1e-8),
                          jnp.full_like(sf, 0.01)])
    for b1, b2 in ((0.9, 0.999), (0.95, 0.99)):
        ref = np.asarray(scal(jnp.asarray(steps), b1, b2)).T
        opt = tqadam(lr=0.05, b1=b1, b2=b2, weight_decay=0.01)
        got = np.array([opt.scalars(0.05, int(s)) for s in steps],
                       np.float32)
        assert _diff(ref, got) == 0
    assert bias_correction(0.9, 1) == np.float32(1.0) - np.float32(0.9)


# ----------------------------------------------------------------- QAdam --
def _tree(rng, scale=1.0):
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"w": a(37, 5), "layers": [a(130), a(3, 4, 7)], "b": a(9)}


@pytest.mark.parametrize("path", ["fused", "fused_bits", "jnp"])
@pytest.mark.parametrize("moments,kahan,wd", [("bf16-sr", False, 0.01),
                                              ("e4m3-sr", True, 0.0)])
def test_qadam_apply_matches_reference(interpret_params, path, moments,
                                       kahan, wd):
    """One reference step, its state converted (``qadam_state_from_jax``),
    then two more steps in both packages."""
    rng = np.random.default_rng(4)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.3) for _ in range(3)]
    packed = path == "fused" and moments != "fp32"
    kw = dict(lr=0.01, weight_decay=wd, update_path=path,
              moments_packed=packed, kahan=kahan)
    jopt = jqadam(cfg=jgd.GDRounding(*(jr.parse_spec(s) for s in CHAIN),
                                     sub_v="grad"),
                  m_spec=jr.parse_spec(moments), v_spec=jr.parse_spec(moments),
                  **kw)
    topt = tqadam(cfg=tgd.GDRounding(*(tr.parse_spec(s) for s in CHAIN),
                                     sub_v="grad"),
                  m_spec=tr.parse_spec(moments), v_spec=tr.parse_spec(moments),
                  **kw)
    japply = jax.jit(jopt.apply)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp, jax.random.PRNGKey(1))
    jp, js = japply(jp, jax.tree.map(jnp.asarray, grads[0]), js)
    tp = convert._carry(jax.device_get(jp), "cpu")
    ts = convert.qadam_state_from_jax(jax.device_get(js))
    assert ts.step == 1 and ts.key == (0, 1)
    for g in grads[1:]:
        jp, js = japply(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = topt.apply(tp, convert._keep_dtype(g, "cpu"), ts)
    assert ts.step == int(js.step) == 3
    assert _diff(np.concatenate([np.asarray(a).reshape(-1) for a in
                                 jax.tree_util.tree_leaves(jp)]),
                 torch.cat([a.reshape(-1) for a in tree_leaves(tp)])) == 0
    for name in ("m", "v") + (("cm", "cv") if kahan else ()):
        ref = jax.tree_util.tree_leaves(getattr(js, name))
        got = tree_leaves(getattr(ts, name))
        assert len(ref) == len(got)
        assert sum(_diff(r, g) for r, g in zip(ref, got)) == 0, name


# ----------------------------------------------------------- train step --
def _numpy_params(jparams):
    """The reference's tree with values drawn by numpy (its own init folds
    ``hash()`` of a block name, salted per process)."""
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


@pytest.mark.parametrize("path", ["fused", "fused_bits"])
def test_train_step_qadam_matches_reference(interpret_params, path):
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.launch import steps as jsteps
    from repro.launch import train as jtrain
    from repro.models import build_model as jbuild
    jcfg = dataclasses.replace(jreduced(jget("tinyllama-1.1b")),
                               gemm_policy="binary8-paper")
    jparams = _numpy_params(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, 128, (2, 2, 9))
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    kw = dict(lr=0.05, momentum=0.9, update_path=path,
              moments_spec="bf16-sr")
    jopt = jtrain.build_optimizer(
        "adam", cfg=jtrain.rounding_config("signed_sr_eps", "binary8", 0.1),
        **kw)
    state = jopt.init(jparams, jax.random.PRNGKey(1))
    step = jax.jit(jsteps.make_train_step(jbuild(jcfg), jopt))
    jbs = [{k: jnp.asarray(v, jnp.int32) for k, v in b.items()}
           for b in batches]
    compiled = step.lower(jparams, state, jbs[0]).compile(
        compiler_options={"xla_allow_excess_precision": False})
    params, ref_losses = jparams, []
    for jb in jbs:
        params, state, metrics = compiled(params, state, jb)
        ref_losses.append(float(metrics["loss"]))

    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              gemm_policy="binary8-paper")
    opt = ttrain.build_optimizer(
        "adam", cfg=ttrain.rounding_config("signed_sr_eps", "binary8", 0.1),
        **kw)
    assert opt.moments_packed == (path == "fused")
    tparams = convert.master_params_from_jax(jax.device_get(jparams))
    tstate = opt.init(tparams, prng.PRNGKey(1))
    tstep = tsteps.make_train_step(build_model(cfg), opt)
    losses = []
    for batch in batches:
        tparams, tstate, metrics = tstep(
            tparams, tstate,
            {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-7)
    n_diff = sum(_diff(r, g) for r, g in zip(
        jax.tree_util.tree_leaves(params), tree_leaves(tparams)))
    assert n_diff <= 8, n_diff
    for name in ("m", "v"):
        ref = jax.tree_util.tree_leaves(getattr(state, name))
        got = tree_leaves(getattr(tstate, name))
        assert sum(_diff(r, g) for r, g in zip(ref, got)) <= 8, name
    assert tstate.step == 2
