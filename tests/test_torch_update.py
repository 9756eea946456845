"""The port's eq.-8 update (K2'/K2 twins, whole-tree update, QSGD paths,
run_gd) and its random draws, held against the JAX reference.

Inputs are made with numpy from fixed seeds; the reference's Pallas
kernels run in interpret mode on the CPU, the port's wrappers take their
plain twins on CPU tensors.

Tolerance: bitwise (float32 values compared as int32 bit patterns), except
where every step of the update is the identity: then XLA may contract
``x - t * g`` into one fused multiply-add, so those values are compared
within one float32 ulp.  XLA evaluates ``a * b + c`` (the momentum, the
uniform draw's scaling) as one fused multiply-add; the port does the same
(``core.fma``), so those compare bitwise too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gd as jgd, rounding as jr
from repro.kernels import common as jc
from repro.kernels import fused_update as jfu
from repro.kernels import tree_update as jtu
from repro.optim import base as jbase
from repro_torch.core import gd as tgd, prng, rounding as tr
from repro_torch.kernels import common as tc
from repro_torch.kernels import fused_update as tfu
from repro_torch.kernels import tree_update as ttu
from repro_torch.optim import base as tbase

T = 0.05
SEED = (0x1234ABCD, 0x0BADF00D)

# (grad, mul, sub) spec names and the signed-SRe direction of step 8c
CONFIGS = {
    "signed_sr_eps-binary8": ("binary8-rn", "binary8-sr",
                              "binary8-signed_sr_eps-e0.1"),
    "sr_eps-binary8": ("binary8-rn", "binary8-sr_eps-e0.1", "binary8-sr"),
    "sr-r16-binary8": ("binary8-sr-r16", "binary8-sr-r16", "binary8-sr-r16"),
    "sr-all-binary8": ("binary8-sr", "binary8-sr", "binary8-sr"),
    "rn-binary8": ("binary8-rn", "binary8-rn", "binary8-rn"),
    "signed_sr_eps-bf16": ("bf16-rn", "bf16-sr", "bf16-signed_sr_eps-e0.1"),
    "e4m3-sr-neg": ("e4m3-signed_sr_eps-e0.3", "fp32", "e4m3-sr"),
}
IDENTITY_CONFIGS = {
    "fp32": ("fp32", "fp32", "fp32"),
    "sub-only": ("fp32", "fp32", "binary8-sr"),
}


def _cfgs(names, grad_v="self"):
    j = jgd.GDRounding(*(jr.parse_spec(s) for s in names), grad_v=grad_v)
    t = tgd.GDRounding(*(tr.parse_spec(s) for s in names), grad_v=grad_v)
    return j, t


def _cfgs_for(name):
    return _cfgs(CONFIGS[name], "neg_grad" if name.endswith("-neg")
                 else "self")


def _xg(n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 0.05).astype(np.float32)
    g = (rng.standard_normal(n) * 0.3).astype(np.float32)
    g[::13] = 0.0
    g[1::17] = -0.0
    x[::19] = 0.0
    x[2::23] = 1e-40          # float32 subnormals: flushed by the rounding
    g[3::29] = 3e-39
    g[4::31] = 7e4            # beyond binary8's xmax: saturates
    return x, g


def _bits_equal(ref, got):
    ref = np.asarray(ref, np.float32).view(np.int32)
    got = np.asarray(got, np.float32).view(np.int32)
    return int(np.sum(ref != got))


def _within_one_ulp(ref, got):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return bool(np.all(np.abs(ref - got) <= np.spacing(np.abs(ref))))


def _key(k):
    return tuple(int(w) for w in np.asarray(k))


# ---------------------------------------------------------- fused mul-add --
def test_fma_matches_xla_contraction(monkeypatch):
    """``a * b + c`` as XLA compiles it: one rounding (including a sum
    whose float64 value lands exactly on a float32 midpoint), float32
    subnormals flushed."""
    from repro_torch.core import fma as tfma
    a = np.array([97 / 64, 1.0, 0.9, 0.9, 1.0, 1.0], np.float32)
    b = np.array([172961 / 262144, 1e-40, 1e-39, 2e-38, 3e-39, -1.0],
                 np.float32)
    c = np.array([2.0 ** -70, 0.0, 0.0, -1.7e-38, 0.0, 1.0], np.float32)
    rng = np.random.default_rng(1)
    for scale in (1.0, 1e-3, 1e30, 1e-37):
        a = np.concatenate([a, rng.standard_normal(3000).astype(np.float32)])
        b = np.concatenate([b, (rng.standard_normal(3000) * scale)
                            .astype(np.float32)])
        c = np.concatenate([c, (rng.standard_normal(3000) * scale)
                            .astype(np.float32)])
    ref = np.asarray(jax.jit(lambda a_, b_, c_: a_ * b_ + c_)(a, b, c))
    monkeypatch.setattr(tfma, "CHUNK", 1000)
    got = tfma.fma(*(torch.from_numpy(v) for v in (a, b, c)))
    assert _bits_equal(ref, got.numpy()) == 0
    ref = np.asarray(jax.jit(lambda b_, c_: 0.9 * b_ + c_)(b, c))
    got = tfma.fma(0.9, torch.from_numpy(b), torch.from_numpy(c))
    assert _bits_equal(ref, got.numpy()) == 0


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30])
@pytest.mark.parametrize("shape", [(1,), (5, 131)])
def test_momentum_fma_matches_reference_momentum(shape, scale):
    """The momentum wrapper (plain twin on a CPU tensor) against the
    reference's compiled ``momentum * m + g``, subnormals included."""
    rng = np.random.default_rng(len(shape))
    m = (rng.standard_normal(shape) * scale).astype(np.float32)
    g = (rng.standard_normal(shape) * scale).astype(np.float32)
    m.reshape(-1)[::7] = 1e-40
    g.reshape(-1)[1::5] = -3e-39
    ref = np.asarray(jax.jit(lambda m_, g_: 0.9 * m_ + g_)(m, g))
    got = tfu.momentum_fma(0.9, torch.from_numpy(m), torch.from_numpy(g))
    assert got.shape == shape
    assert _bits_equal(ref, got.numpy()) == 0


# ------------------------------------------------------------ random draws --
@pytest.mark.parametrize("shape", [(7,), (3, 129), (2, 5, 11)])
def test_random_bits_and_uniform_match_jax(shape):
    jkey = jax.random.fold_in(jax.random.PRNGKey(11), 3)
    key = _key(jkey)
    ref = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
    assert np.array_equal(ref.astype(np.int64), prng.random_bits(key, shape)
                          .numpy())
    words = prng.random_words(key, shape, chunk=5)
    assert np.array_equal(ref.view(np.int32), words.numpy())
    for lo, hi in ((0.0, 1.0), (1e-6, 1.0), (-2.0, 3.0)):
        ref = np.asarray(jax.random.uniform(jkey, shape, minval=lo,
                                            maxval=hi))
        got = prng.uniform(key, shape, lo, hi).numpy()
        assert _bits_equal(ref, got) == 0, (lo, hi)


def test_counter_bits_pair_and_kernel_bits3_match():
    k0, k1 = 0xDEADBEEF, 0x01234567
    for stream in (0, 1, 2):
        r0, r1 = jc.counter_bits_pair(jnp.uint32(k0), jnp.uint32(k1), (5, 9),
                                      row0=3, col0=2, stream=stream)
        t0, t1 = tc.counter_bits_pair(k0, k1, (5, 9), row0=3, col0=2,
                                      stream=stream)
        assert np.array_equal(np.asarray(r0, np.int64), t0.numpy())
        assert np.array_equal(np.asarray(r1, np.int64), t1.numpy())
    seed = jnp.asarray(np.array([k0, k1], np.uint32))
    for need in [(True, True, True), (False, True, True), (True, False, True),
                 (False, False, True), (False, False, False)]:
        ref = jc.kernel_bits3(seed, (4, 128), 8, need, interpret=True)
        got = tc.kernel_bits3((k0, k1), (4, 128), 8, need)
        for r, g in zip(ref, got):
            assert (r is None) == (g is None)
            if r is not None:
                assert np.array_equal(np.asarray(r, np.int64), g.numpy())


# ------------------------------------------------------- K2' / K2 twins --
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("n", [1, 128 * 3, 128 * 40 + 37])
def test_fused_qupdate_prng_twin_bitwise(name, n):
    jcfg, tcfg = _cfgs_for(name)
    x, g = _xg(n, seed=n)
    ref = jfu.fused_qupdate_prng_p(jnp.asarray(x), jnp.asarray(g), T,
                                   jnp.asarray(np.array(SEED, np.uint32)),
                                   jcfg)
    got = tfu.fused_qupdate_prng(torch.from_numpy(x), torch.from_numpy(g), T,
                                 SEED, tcfg)
    assert _bits_equal(ref, got.numpy()) == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_qupdate_bits_twin_bitwise(name):
    jcfg, tcfg = _cfgs_for(name)
    n = 128 * 20 + 5
    x, g = _xg(n, seed=3)
    bits3 = np.random.default_rng(4).integers(0, 2 ** 32, (3, n),
                                              dtype=np.uint64)
    bits3 = bits3.astype(np.uint32)
    ref = jfu.fused_qupdate_p(jnp.asarray(x), jnp.asarray(g), T,
                              jnp.asarray(bits3), jcfg)
    for words in (torch.from_numpy(bits3.astype(np.int64)),
                  torch.from_numpy(bits3.view(np.int32))):
        got = tfu.fused_qupdate(torch.from_numpy(x), torch.from_numpy(g), T,
                                words, tcfg)
        assert _bits_equal(ref, got.numpy()) == 0


@pytest.mark.parametrize("name", sorted(IDENTITY_CONFIGS))
def test_identity_steps_within_one_ulp(name):
    jcfg, tcfg = _cfgs(IDENTITY_CONFIGS[name])
    x, g = _xg(128 * 7 + 3, seed=8)
    x = x + np.float32(0.5)             # away from the flushed range
    seed = jnp.asarray(np.array(SEED, np.uint32))
    for ref, got in (
            (jfu.fused_qupdate_prng_p(jnp.asarray(x), jnp.asarray(g), T,
                                      seed, jcfg),
             tfu.fused_qupdate_prng(torch.from_numpy(x), torch.from_numpy(g),
                                    T, SEED, tcfg)),
            (jgd.gd_step(jnp.asarray(x), jnp.asarray(g), T, jcfg,
                         jax.random.PRNGKey(2)).x_new,
             tgd.gd_step(torch.from_numpy(x), torch.from_numpy(g), T, tcfg,
                         prng.PRNGKey(2)).x_new)):
        assert _within_one_ulp(ref, got.numpy())


def test_fused_update_twins_chunking_changes_nothing(monkeypatch):
    """The twins work in chunks; the bits are keyed by position, so the
    chunk size changes no value."""
    _, tcfg = _cfgs_for("signed_sr_eps-binary8")
    x, g = (torch.from_numpy(a) for a in _xg(128 * 9 + 7, seed=5))
    bits3 = prng.random_words((1, 2), (3, x.numel()))
    whole = (tfu.fused_qupdate_prng(x, g, T, SEED, tcfg),
             tfu.fused_qupdate(x, g, T, bits3, tcfg))
    monkeypatch.setattr(tfu, "CHUNK", 256)
    chunked = (tfu.fused_qupdate_prng(x, g, T, SEED, tcfg),
               tfu.fused_qupdate(x, g, T, bits3, tcfg))
    for a, b in zip(whole, chunked):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("names", [("binary8-sr2", "fp32", "fp32"),
                                   ("fp32", "fxp16.8-sr", "fp32"),
                                   ("fp32", "fp32", "binary8-rn-inf"),
                                   ("fp32", "bf16-sr-bittrick", "fp32")])
def test_update_raises_on_unported_schemes(names):
    """Chains K2' and K2 once refused: now their wide instance's, the twin
    the reference's interpret kernel; K5 (whose wide chain is not ported)
    still raises on them.  Each chain has identity steps, so x is kept away
    from the flushed range and the values compared within one float32 ulp
    (XLA contracts ``x - t * g`` where both steps are the identity, as in
    ``test_identity_steps_within_one_ulp``); the two chains whose 8c
    subtraction has a rounded operand agree bitwise."""
    jcfg, tcfg = _cfgs(names)
    x, g = _xg(16 * 128 + 5, seed=16)
    x = x + np.float32(0.5)
    ref = jfu.fused_qupdate_prng_p(jnp.asarray(x), jnp.asarray(g), T,
                                   jnp.asarray(np.array(SEED, np.uint32)),
                                   jcfg)
    got = tfu.fused_qupdate_prng(torch.from_numpy(x), torch.from_numpy(g), T,
                                 SEED, tcfg)
    assert tfu.k2_instance(tcfg) == "wide"
    if names[1] == "fp32":
        assert _within_one_ulp(ref, got.numpy())
    else:
        assert _bits_equal(ref, got.numpy()) == 0
    bf16 = tr.parse_spec("bf16-sr")
    with pytest.raises(NotImplementedError):
        tfu.fused_qadam_prng(torch.from_numpy(x), torch.from_numpy(g),
                             torch.zeros(x.size), torch.zeros(x.size),
                             [T, 1.0, 1.0, 1e-8, 0.0], SEED, tcfg,
                             m_spec=bf16, v_spec=bf16, b1=0.9, b2=0.999,
                             packed=False)


# the wide instance's spec families (chip_smoke.py's phase 4), each with its
# input scale: fixed point, sr2 at r = 8, 16 and 32, the bit trick
# (bfloat16's integer path at r = 16, the complemented draw elsewhere), the
# directed roundings, overflow to +-inf on overflowing inputs, a shifted
# grid, a format without subnormals, signed-SRe under overflow to +-inf
WIDE_CHAINS = {
    "fxp": (("fxp16.8-sr2", "fxp16.8-sr", "fxp8.4-rn"), "self", 1.0),
    "sr2": (("binary8-rn", "binary8-sr2", "binary8-sr2-r16"), "self", 1.0),
    "bittrick": (("bf16-rn", "bf16-sr-bittrick", "binary8-sr-bittrick-r8"),
                 "self", 1.0),
    "rz-ra-rd": (("binary8-rz", "binary8-ra", "binary8-rd"), "self", 1.0),
    "ru": (("binary8-ru", "fp32", "binary8-ru"), "self", 1.0),
    "rn-inf": (("binary8-rn-inf", "binary8-sr-inf", "binary8-rn-inf"),
               "self", 3e5),
    "shifted": (("shift8-rn", "shift8-sr", "shift8-signed_sr_eps-e0.2"),
                "grad", 1.0),
    "no-subnormals": (("b8nosub-sr", "b8nosub-rn", "b8nosub-sr_eps-e0.1"),
                      "self", 1e-3),
    "e4m3-ssr-inf": (("e4m3-rn", "e4m3-sr", "e4m3-signed_sr_eps-e0.3-inf"),
                     "grad", 3e3),
}


def _register_wide_grids():
    """The shifted grid and the format without subnormals, in both
    packages (idempotent)."""
    from repro.core import formats as jf, grids as jg
    from repro_torch.core import formats as tf_, grids as tg
    for fm, gr in ((jf, jg), (tf_, tg)):
        gr.register_grid(gr.shifted_grid("binary8", 0.5, 0.25, name="shift8"))
        fm.register_format(fm.FPFormat("b8nosub", 3, -14, 15,
                                       subnormals=False))


@pytest.mark.parametrize("family", sorted(WIDE_CHAINS))
def test_fused_qupdate_wide_twins_bitwise(family):
    """K2' and K2 twins under the wide instance's chains bitwise the
    reference's interpret kernels (``fused_qupdate_prng_p``,
    ``fused_qupdate_p``) at n = 1000 + 37, -0 inputs among them."""
    _register_wide_grids()
    names, sub_v, scale = WIDE_CHAINS[family]
    jcfg, tcfg = (dataclasses.replace(c, sub_v=sub_v) for c in _cfgs(names))
    assert tfu.k2_instance(tcfg) == "wide"
    n = 1000 + 37
    x, g = _xg(n, seed=n)
    x[5::19] = -0.0
    g = (g * np.float32(scale)).astype(np.float32)
    ref = jfu.fused_qupdate_prng_p(jnp.asarray(x), jnp.asarray(g), T,
                                   jnp.asarray(np.array(SEED, np.uint32)),
                                   jcfg)
    got = tfu.fused_qupdate_prng(torch.from_numpy(x), torch.from_numpy(g), T,
                                 SEED, tcfg)
    assert _bits_equal(ref, got.numpy()) == 0
    if family == "rn-inf":
        assert np.isinf(np.asarray(ref)).sum() > 0
    bits3 = np.random.default_rng(5).integers(0, 2 ** 32, (3, n),
                                              dtype=np.uint64)
    bits3 = bits3.astype(np.uint32)
    ref = jfu.fused_qupdate_p(jnp.asarray(x), jnp.asarray(g), T,
                              jnp.asarray(bits3), jcfg)
    got = tfu.fused_qupdate(torch.from_numpy(x), torch.from_numpy(g), T,
                            torch.from_numpy(bits3.view(np.int32)), tcfg)
    assert _bits_equal(ref, got.numpy()) == 0


def test_sr2_at_32_bits_is_sr():
    """sr2 with 32-bit draws is bit for bit sr (the reference's
    test_new_schemes check), on the wide instance's twin against the
    generic instance's."""
    x, g = (torch.from_numpy(a) for a in _xg(128 * 5 + 3, seed=9))
    _, sr2 = _cfgs(("binary8-rn", "binary8-sr2-r32", "binary8-sr2-r32"))
    _, sr = _cfgs(("binary8-rn", "binary8-sr", "binary8-sr"))
    assert (tfu.k2_instance(sr2), tfu.k2_instance(sr)) == ("wide", "generic")
    assert torch.equal(tfu.fused_qupdate_prng(x, g, T, SEED, sr2),
                       tfu.fused_qupdate_prng(x, g, T, SEED, sr))


# the extra update configs of chip_smoke.py's phase 4, and others of the
# kind: each a chain the trainer instance does not compile in
GENERIC_CHAINS = [
    ("binary8-rn", "binary8-sr_eps-e0.1", "binary8-sr"),
    ("binary8-sr-r16",) * 3,
    ("binary8-rn",) * 3,
    ("bf16-rn", "bf16-sr", "bf16-signed_sr_eps-e0.1"),
    ("binary8-sr",) * 3,
    ("binary8-rn", "binary8-sr-r16", "binary8-signed_sr_eps-e0.1"),
    ("binary8-rn", "binary8-sr", "binary8-signed_sr_eps-e0.1-r16"),
    ("fp32", "binary8-sr", "binary8-signed_sr_eps-e0.1"),
    ("e4m3-signed_sr_eps-e0.3", "fp32", "e4m3-sr"),
    ("fp32", "fp32", "fp32"),
]


TRAINER_CHAINS = [   # (grad, mul, sub), sub_v, K2's instance, K5's chain
    (("binary8-rn", "binary8-sr", "binary8-signed_sr_eps-e0.1"), "grad",
     "trainer", "trainer"),
    (("e4m3-rn", "e4m3-sr", "e4m3-signed_sr_eps-e0.2"), "grad", "trainer",
     "trainer"),
    (("binary8-rn", "binary8-sr", "binary8-signed_sr_eps-e0.1"), "neg_grad",
     "generic", "trainer"),
]


# chains only the wide instance takes: each a site the generic one does not
WIDE_INSTANCE_CHAINS = [
    ("binary8-rn", "binary8-sr", "binary8-signed_sr_eps-e0.1-inf"),
    ("fxp16.8-rn", "fxp16.8-sr", "fxp16.8-signed_sr_eps-e0.1"),
    ("binary8-rn", "binary8-sr2-r32", "binary8-sr"),
    ("fp32", "bf16-sr-bittrick", "fp32"),
    ("binary8-rz", "fp32", "fp32"),
    ("shift8-rn", "shift8-sr", "shift8-sr"),
    ("fp32", "fp32", "b8nosub-sr"),
]


@pytest.mark.parametrize(
    "names,sub_v,want,want_k5",
    [(None, "grad", "trainer", "trainer")] + TRAINER_CHAINS
    + [(c, "grad", "generic", "generic") for c in GENERIC_CHAINS]
    + [(c, "grad", "wide", "generic") for c in WIDE_INSTANCE_CHAINS],
    ids=["paper_run"] + ["-".join(c[0]) + f"-{c[1]}" for c in TRAINER_CHAINS]
    + ["-".join(c) for c in GENERIC_CHAINS + WIDE_INSTANCE_CHAINS])
def test_k2_instance_choice(names, sub_v, want, want_k5):
    """K2' and K2 run their trainer instance on ``train.PAPER_RUN``'s
    chain (rn / sr / signed-SRe on a narrow grid, 32-bit draws, the
    direction sign(g_hat)), the wide one on every chain with a site beyond
    rn / sr / sr_eps / signed-SRe on a plain FP grid with subnormals,
    saturating, and the generic one on the rest; K5's trainer instance
    takes the trainer's chain with any direction."""
    from repro_torch.launch.train import rounding_config
    _register_wide_grids()
    if names is None:
        cfg = rounding_config("signed_sr_eps", "binary8", 0.1)
    else:
        cfg = dataclasses.replace(_cfgs(names)[1], sub_v=sub_v)
    assert tfu.k2_instance(cfg) == want
    assert tfu.K2_INSTANCES.index(want) == {"generic": 0, "trainer": 1,
                                            "wide": 2}[want]
    bf16 = tr.parse_spec("bf16-sr")
    assert tfu.k5_instance(cfg, bf16, bf16, True, False) == want_k5


# ------------------------------------------------------- whole-tree update --
def _tree(seed):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return {"blocks": {"attn": {"wq": a(2, 4, 6), "norm": a(2, 4)},
                       "mlp": {"w": a(2, 6, 3)}},
            "embed": a(11, 4), "final_norm": a(4), "z": a(129)}


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _ttree(t):
    return ttu.tree_map(torch.from_numpy, t)


def _assert_trees_equal(jt, tt):
    jl = jax.tree_util.tree_leaves(jt)
    tl = ttu.tree_leaves(tt)
    assert len(jl) == len(tl)
    for r, g in zip(jl, tl):
        assert tuple(r.shape) == tuple(g.shape)
        assert _bits_equal(r, g.numpy()) == 0


def test_tree_flatten_order_matches_jax():
    t = _tree(0)
    assert [x.shape for x in jax.tree_util.tree_leaves(t)] == \
        [x.shape for x in ttu.tree_leaves(t)]
    flat, spec = ttu.tree_ravel(_ttree(t))
    jflat, _ = jtu.tree_ravel(_jtree(t))
    assert _bits_equal(jflat, flat.numpy()) == 0
    back = ttu.tree_unravel(flat, spec)
    # a flat-backed tree ravels to its buffer without a copy
    again, _ = ttu.tree_ravel(back)
    assert again.data_ptr() == flat.data_ptr()


@pytest.mark.parametrize("mode", ["prng", "bits"])
def test_fused_tree_update_matches(mode):
    jcfg, tcfg = _cfgs_for("signed_sr_eps-binary8")
    p, g = _tree(1), _tree(2)
    jkey = jax.random.PRNGKey(7)
    ref = jtu.fused_tree_update(_jtree(p), _jtree(g), T, jcfg, jkey, 3,
                                mode=mode)
    got = ttu.fused_tree_update(_ttree(p), _ttree(g), T, tcfg, _key(jkey), 3,
                                mode=mode)
    _assert_trees_equal(ref, got)


@pytest.mark.parametrize("path", ["jnp", "fused", "fused_bits"])
def test_tree_rounded_update_matches(path):
    jcfg, tcfg = _cfgs_for("sr_eps-binary8")
    p, g = _tree(3), _tree(4)
    jkey = jax.random.PRNGKey(9)
    # one compiled call (eager dispatch compiles every op per leaf shape)
    ref = jax.jit(lambda p_, g_: jbase.tree_rounded_update(
        p_, g_, T, jcfg, jkey, 5, update_path=path))(_jtree(p), _jtree(g))
    got = tbase.tree_rounded_update(_ttree(p), _ttree(g), T, tcfg,
                                    _key(jkey), 5, update_path=path)
    _assert_trees_equal(ref, got)


@pytest.mark.parametrize("mspec", ["fp32", "bf16-sr"])
@pytest.mark.parametrize("path", ["jnp", "fused"])
def test_qsgd_apply_matches(mspec, path):
    """Three QSGD steps (momentum 0.9 on ``mspec``'s grid) against the
    reference's compiled ``apply``: parameters and momentum bitwise."""
    from repro.optim import qsgd as jqsgd
    from repro_torch.optim import qsgd as tqsgd
    jcfg, tcfg = _cfgs_for("signed_sr_eps-binary8")
    jopt = jqsgd(T, momentum=0.9, cfg=jcfg,
                 momentum_spec=jr.parse_spec(mspec), update_path=path)
    topt = tqsgd(T, momentum=0.9, cfg=tcfg,
                 momentum_spec=tr.parse_spec(mspec), update_path=path)
    jkey = jax.random.PRNGKey(3)
    jp, tp = _jtree(_tree(5)), ttu.flat_backed(_ttree(_tree(5)))
    js, ts = jopt.init(jp, jkey), topt.init(tp, _key(jkey))
    apply = jax.jit(jopt.apply)
    for i in range(3):
        g = _tree(10 + i)
        jp, js = apply(jp, _jtree(g), js)
        tp, ts = topt.apply(tp, _ttree(g), ts)
    _assert_trees_equal(jp, tp)
    _assert_trees_equal(js.momentum, ts.momentum)
    assert ts.step == 3


# ------------------------------------------------------------------ run_gd --
@pytest.mark.parametrize("engine", ["jnp", "kernel"])
@pytest.mark.parametrize("name", ["signed_sr_eps-binary8", "sr-all-binary8",
                                  "rn-binary8"])
def test_run_gd_matches(engine, name):
    """The paper's experiment loop on a small quadratic f(x) = ½ Σ a x²: the
    iterates bitwise; f within float32 summation order."""
    jcfg, tcfg = _cfgs_for(name)
    rng = np.random.default_rng(12)
    a = rng.uniform(0.5, 2.0, 300).astype(np.float32)
    x0 = rng.standard_normal(300).astype(np.float32)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    jkey = jax.random.PRNGKey(4)
    fs_ref, x_ref = jgd.run_gd(lambda x: 0.5 * jnp.sum(ja * x * x),
                               lambda x: ja * x, jnp.asarray(x0), 0.1, jcfg,
                               12, jkey, param_fmt="binary8", engine=engine)
    fs, x = tgd.run_gd(lambda x: 0.5 * torch.sum(ta * x * x),
                       lambda x: ta * x, torch.from_numpy(x0), 0.1, tcfg, 12,
                       _key(jkey), param_fmt="binary8", engine=engine)
    assert _bits_equal(x_ref, x.numpy()) == 0
    np.testing.assert_allclose(fs.numpy(), np.asarray(fs_ref), rtol=1e-6)


def test_gd_step_matches():
    jcfg, tcfg = _cfgs_for("signed_sr_eps-binary8")
    x, g = _xg(300, seed=6)
    jkey = jax.random.PRNGKey(3)
    ref = jgd.gd_step(jnp.asarray(x), jnp.asarray(g), T, jcfg, jkey)
    got = tgd.gd_step(torch.from_numpy(x), torch.from_numpy(g), T, tcfg,
                      _key(jkey))
    for r, o in zip(ref[:3], got[:3]):
        assert _bits_equal(r, o.numpy()) == 0
    # the unrounded z = x - update: XLA's CPU backend treats float32
    # subnormal operands as zero, PyTorch does not (the roundings flush
    # explicitly, so x_new above agrees everywhere)
    normal = np.abs(x) >= 2.0 ** -126
    assert _bits_equal(np.asarray(ref.z)[normal], got.z.numpy()[normal]) == 0
    ref = jgd.gd_step_kernel(jnp.asarray(x), jnp.asarray(g), T, jcfg, jkey, 4)
    got = tgd.gd_step_kernel(torch.from_numpy(x), torch.from_numpy(g), T,
                             tcfg, _key(jkey), 4)
    assert _bits_equal(ref, got.numpy()) == 0
