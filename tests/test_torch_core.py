"""Rounding core and key derivation of the PyTorch port, held bit for bit
against the JAX reference in one process.

Inputs are made with numpy from fixed seeds and handed to both packages.
Tolerance: none -- every comparison here is bitwise (float32 values are
compared as their int32 bit patterns, so -0.0 and NaN payloads count).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rounding as jr
from repro.kernels import common as jc
from repro.precision import policy as jp
from repro_torch.core import prng, rounding as tr
from repro_torch.kernels import common as tc
from repro_torch.precision import policy as tp

FORMATS = ("binary8", "e4m3", "bfloat16", "binary16")
GRIDS = FORMATS + ("fxp16.8",)
STOCHASTIC = ("sr", "sr_eps", "signed_sr_eps", "sr2", "sr_bittrick")
DETERMINISTIC = ("rn", "rz", "ra", "rd", "ru")


def _bits_equal(a, b):
    a = np.asarray(a, np.float32).view(np.int32)
    b = np.asarray(b, np.float32).view(np.int32)
    return np.array_equal(a, b), int(np.sum(a != b))


def _inputs(seed=0, n=4096):
    """Values across every binade of the formats, plus the edge cases:
    float32 subnormals (flushed), +-0, +-inf, NaN, beyond-xmax values,
    exact grid points and exact ties."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, n).astype(np.float32)
    expo = rng.integers(-135, 20, n)
    sign = rng.choice([-1.0, 1.0], n)
    x = (sign * mant * np.exp2(expo.astype(np.float64))).astype(np.float32)
    specials = np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 2.0 ** -127,
         -(2.0 ** -126), 2.0 ** -126, 6e4, -6e4, 1e6, -1e6, 3e38, 480.0,
         500.0, 57344.0, 61440.0, 1.0, 1.25, 1.125, -1.375, 0.75, 2.5,
         2.0 ** -14, 2.0 ** -16, 2.0 ** -17, 3.0 * 2.0 ** -17, 65504.0],
        np.float32)
    return np.concatenate([x, specials]).astype(np.float32)


def _words(seed, shape):
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


# ------------------------------------------------------------ threefry --
def test_threefry_matches_reference():
    k = _words(2, (2,))
    c0, c1 = _words(3, (257,)), _words(4, (257,))
    j0, j1 = jc.threefry2x32(k[0], k[1], c0, c1)
    t0, t1 = prng.threefry2x32_tensor(
        int(k[0]), int(k[1]), torch.from_numpy(c0.astype(np.int64)),
        torch.from_numpy(c1.astype(np.int64)))
    assert np.array_equal(np.asarray(j0, np.int64), t0.numpy())
    assert np.array_equal(np.asarray(j1, np.int64), t1.numpy())
    for i in range(5):
        a, b = int(c0[i]), int(c1[i])
        assert prng.threefry2x32(int(k[0]), int(k[1]), a, b) == (
            int(j0[i]), int(j1[i]))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1, -7])
def test_key_derivation_matches_jax_random(seed):
    jkey = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed)
    assert key == tuple(int(w) for w in np.asarray(jkey))
    for d in (0, 3, 2 ** 32 - 1, 0x71D07):
        assert prng.fold_in(key, d) == tuple(
            int(w) for w in np.asarray(jax.random.fold_in(jkey, d)))
    keys = prng.split(key, 5)
    jkeys = np.asarray(jax.random.split(jkey, 5))
    assert keys == [tuple(int(w) for w in row) for row in jkeys]


@pytest.mark.parametrize("step,site", [(None, None), (5, None), (None, 9),
                                       (17, 0x71D07)])
def test_derive_seed_and_fold_words_match(step, site):
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    key = prng.fold_in(prng.PRNGKey(3), 11)
    ref = np.asarray(jc.derive_seed(jkey, step, site))
    words = prng.derive_seed(key, step, site)
    assert words == tuple(int(w) for w in ref)
    for tag in (0, 6, 18, 39):
        jw = np.asarray(jp.fold_words(jnp.asarray(ref, jnp.uint32), tag))
        assert tp.fold_words(words, tag) == tuple(int(w) for w in jw)


@pytest.mark.parametrize("rand_bits", [32, 16, 8])
@pytest.mark.parametrize("row0,col0,shape", [(0, 0, (5, 9)), (3, 7, (6, 13)),
                                             (11, 5, (4, 3))])
def test_counter_bits_reduced_matches(rand_bits, row0, col0, shape):
    k0, k1 = (int(w) for w in _words(7, (2,)))
    for stream in (0, 1):
        ref = jc.counter_bits_reduced(jnp.uint32(k0), jnp.uint32(k1), shape,
                                      rand_bits, row0=row0, col0=col0,
                                      stream=stream)
        got = tc.counter_bits_reduced(k0, k1, shape, rand_bits, row0=row0,
                                      col0=col0, stream=stream)
        assert np.array_equal(np.asarray(ref, np.int64), got.numpy())


# ------------------------------------------------------------ rounding --
def _schemes_bits():
    for mode in DETERMINISTIC:
        yield mode, 32
    for mode in STOCHASTIC:
        for rb in (32, 16, 8):
            yield mode, rb


@pytest.mark.parametrize("grid", GRIDS)
def test_round_to_format_matches_every_scheme(grid):
    x = _inputs(seed=len(grid))
    bits = _words(5, x.shape)
    v = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    v[::7] = 0.0
    xt = torch.from_numpy(x)
    bt = torch.from_numpy(bits.astype(np.int64))
    vt = torch.from_numpy(v)
    for mode, rb in _schemes_bits():
        for overflow in ("saturate", "inf"):
            kw = dict(eps=0.25, overflow=overflow, rand_bits=rb)
            ref = jr.round_to_format(jnp.asarray(x), grid, mode,
                                     bits=jnp.asarray(bits),
                                     v=jnp.asarray(v), **kw)
            got = tr.round_to_format(xt, grid, mode, bits=bt, v=vt, **kw)
            ok, n_bad = _bits_equal(ref, got.numpy())
            assert ok, (grid, mode, rb, overflow, n_bad)


@pytest.mark.parametrize("grid", GRIDS)
def test_round_block_matches_every_scheme(grid):
    x = _inputs(seed=10 + len(grid)).reshape(-1, 2)
    bits = _words(8, x.shape)
    v = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    xt = torch.from_numpy(x)
    bt = torch.from_numpy(bits.astype(np.int64))
    for mode, rb in _schemes_bits():
        ref = jc.round_block(jnp.asarray(x), jnp.asarray(bits), grid, mode,
                             0.3, v=jnp.asarray(v), rand_bits=rb)
        got = tc.round_block(xt, bt, grid, mode, 0.3, v=torch.from_numpy(v),
                             rand_bits=rb)
        ok, n_bad = _bits_equal(ref, got.numpy())
        assert ok, (grid, mode, rb, n_bad)
    # deterministic schemes with bits=None
    for mode in DETERMINISTIC:
        ref = jc.round_block(jnp.asarray(x), None, grid, mode, 0.0)
        got = tc.round_block(xt, None, grid, mode, 0.0)
        assert _bits_equal(ref, got.numpy())[0], (grid, mode)


@pytest.mark.parametrize("grid", GRIDS)
def test_ulp_and_grid_flips_match(grid):
    x = _inputs(seed=20)
    x = x[np.isfinite(x)]
    ref = np.asarray(jr.ulp(jnp.asarray(x), grid))
    assert _bits_equal(ref, tr.ulp(torch.from_numpy(x), grid).numpy())[0]
    g = jr.round_to_format(jnp.asarray(x), grid, "rn")
    up = np.asarray(jr.successor(g, grid))
    g = torch.from_numpy(np.asarray(g))
    n, adjacent = tr.grid_flips(g, torch.from_numpy(up), grid)
    assert adjacent and n > 0
    n, adjacent = tr.grid_flips(g, g + 2 * torch.from_numpy(ref), grid)
    assert not adjacent


def test_shifted_grid_matches():
    from repro.core import grids as jg
    from repro_torch.core import grids as tg
    x = _inputs(seed=3)
    x = x[np.isfinite(x)]
    bits = _words(4, x.shape)
    jgrid = jg.shifted_grid("binary8", scale=0.5, mu=0.25)
    tgrid = tg.shifted_grid("binary8", scale=0.5, mu=0.25)
    for mode in ("rn", "sr"):
        ref = jr.round_to_format(jnp.asarray(x), jgrid, mode,
                                 bits=jnp.asarray(bits))
        got = tr.round_to_format(torch.from_numpy(x), tgrid, mode,
                                 bits=torch.from_numpy(bits.astype(np.int64)))
        assert _bits_equal(ref, got.numpy())[0], mode


@pytest.mark.parametrize("name", ["binary8-sr", "e4m3-sr-r8", "bf16-ssr-e0.4",
                                  "fxp16.8-sr2", "binary8-rn-inf", "fp32",
                                  "bf16-sr-bittrick", "binary16-sr_eps-r16"])
def test_spec_grammar_matches(name):
    ref, got = jr.parse_spec(name), tr.parse_spec(name)
    assert str(ref) == str(got)
    assert (ref.fmt, ref.mode, ref.eps, ref.rand_bits, ref.overflow) == (
        got.fmt, got.mode, got.eps, got.rand_bits, got.overflow)
    assert tr.parse_spec(str(got)) == got


def test_format_registry_matches():
    from repro.core import formats as jf
    from repro_torch.core import formats as tf
    for name in FORMATS + ("binary32", "e5m2", "fp16", "bf16"):
        a, b = jf.get_format(name), tf.get_format(name)
        assert (a.name, a.precision, a.emin, a.emax, a.xmax) == (
            b.name, b.precision, b.emin, b.emax, b.xmax)
    assert tf.get_format("e4m3").xmax == 480.0
    assert tf.get_format("binary8").xmax == 57344.0
