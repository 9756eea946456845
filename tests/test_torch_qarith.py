"""The port's quantized arithmetic, theory bounds, stagnation diagnostics,
rounding extras and normal draw, held against the JAX reference.

Inputs are made with numpy from fixed seeds and handed to both packages;
keys are the same words (``jax.random.PRNGKey(s)`` is the port's ``(0,
s)``).  Tolerances: bitwise for the elementwise ops, ``qmatmul``'s
``accum="fma"`` (every product and sum rounded: nothing is summed in
float32), ``tau`` / ``scenario`` / ``rn_would_stagnate`` and the rounding
extras; the theory bounds exactly equal in float64; ``prng.normal`` within
one float32 ulp of ``jax.random.normal``.  ``accum="result"`` and
``"chunk"`` sum float32 products in another order than XLA's, so at most
1e-3 of their outputs (at least one) may differ, each by one grid step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gd as jgd, qarith as jq, rounding as jr, theory as jt
from repro_torch.core import gd as tgd, prng, qarith as tq, rounding as tr
from repro_torch.core import theory as tt

SPECS = ["binary8-rn", "binary8-sr", "bf16-signed_sr_eps-e0.2",
         "fxp16.8-sr2", "e4m3-sr-r8"]


def _bits_equal(ref, got) -> bool:
    ref = np.asarray(ref, np.float32).view(np.int32)
    got = np.asarray(got, np.float32).view(np.int32)
    return bool(np.array_equal(ref, got))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("op", ["qadd", "qsub", "qmul", "qdiv"])
def test_elementwise_ops_bitwise(op, spec):
    a, b = _normal((7, 33), 1), _normal((7, 33), 2)
    b[0, :3] = 0.0 if op != "qdiv" else 1.0
    v = _normal((7, 33), 3)
    js, ts = jr.parse_spec(spec), tr.parse_spec(spec)
    ref = getattr(jq, op)(jnp.asarray(a), jnp.asarray(b), js,
                          key=jax.random.PRNGKey(5), v=jnp.asarray(v))
    got = getattr(tq, op)(torch.from_numpy(a), torch.from_numpy(b), ts,
                          key=(0, 5), v=torch.from_numpy(v))
    assert _bits_equal(ref, got.numpy())


@pytest.mark.parametrize("shape", [(5, 4, 3), (2, 3, 5, 2)])
@pytest.mark.parametrize("spec", ["binary8-sr", "bf16-rn", "fxp16.8-sr2"])
def test_qmatmul_fma_bitwise(spec, shape):
    """Every product and partial sum rounded: bitwise, batched too."""
    *lead, m, k, n = shape
    a = _normal((*lead, m, k), 4)
    b = _normal((*lead, k, n), 5)
    js, ts = jr.parse_spec(spec), tr.parse_spec(spec)
    ref = jq.qmatmul(jnp.asarray(a), jnp.asarray(b), js,
                     key=jax.random.PRNGKey(7), accum="fma")
    got = tq.qmatmul(torch.from_numpy(a), torch.from_numpy(b), ts,
                     key=(0, 7), accum="fma")
    assert _bits_equal(ref, got.numpy())
    ref = jq.qdot(jnp.asarray(a.reshape(-1)[:k]), jnp.asarray(b[..., 0]
                  .reshape(-1)[:k]), js, key=jax.random.PRNGKey(8),
                  accum="fma")
    got = tq.qdot(torch.from_numpy(a.reshape(-1)[:k].copy()),
                  torch.from_numpy(b[..., 0].reshape(-1)[:k].copy()), ts,
                  key=(0, 8), accum="fma")
    assert _bits_equal(ref, got.numpy())


@pytest.mark.parametrize("accum,chunk", [("result", 32), ("chunk", 16),
                                         ("chunk", 64)])
@pytest.mark.parametrize("spec", ["binary8-sr", "bf16-rn", "binary8-rn"])
def test_qmatmul_result_and_chunk_within_flips(spec, accum, chunk):
    """float32 sums in another order than XLA's: at most 1e-3 of the
    outputs (at least one) differ, each by one grid step."""
    a, b = _normal((64, 200), 6), _normal((200, 30), 7)
    js, ts = jr.parse_spec(spec), tr.parse_spec(spec)
    ref = jq.qmatmul(jnp.asarray(a), jnp.asarray(b), js,
                     key=jax.random.PRNGKey(9), accum=accum, chunk=chunk)
    got = tq.qmatmul(torch.from_numpy(a), torch.from_numpy(b), ts,
                     key=(0, 9), accum=accum, chunk=chunk)
    n, adjacent = tr.grid_flips(torch.from_numpy(np.array(ref)), got,
                                ts.fmt)
    assert n <= max(1, int(1e-3 * got.numel())) and adjacent, n


def test_qmatmul_identity_and_bad_accum():
    a, b = _normal((4, 6), 10), _normal((6, 2), 11)
    got = tq.qmatmul(torch.from_numpy(a), torch.from_numpy(b), tr.IDENTITY)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=1e-6)
    with pytest.raises(ValueError):
        tq.qmatmul(torch.from_numpy(a), torch.from_numpy(b),
                   tr.parse_spec("binary8-rn"), accum="nope")


def test_theory_bounds_exact():
    k = np.arange(0, 50)
    for fmt in ("binary8", "bfloat16", "binary16", "e4m3"):
        pairs = [
            (jt.stepsize_bound(3.0, fmt), tt.stepsize_bound(3.0, fmt)),
            (jt.gradient_floor_general(0.2, 1.5, fmt, 1000),
             tt.gradient_floor_general(0.2, 1.5, fmt, 1000)),
            (jt.b_upper_bound(0.3, fmt), tt.b_upper_bound(0.3, fmt))]
        for cond in (14, 15):
            pairs += [
                (jt.gradient_floor_sr(0.2, 1.5, fmt, 1000, cond),
                 tt.gradient_floor_sr(0.2, 1.5, fmt, 1000, cond)),
                (jt.stagnation_monotonicity_floor_sr(1.5, fmt, 1000, 0.1,
                                                     2.0, cond),
                 tt.stagnation_monotonicity_floor_sr(1.5, fmt, 1000, 0.1,
                                                     2.0, cond)),
                (jt.stagnation_monotonicity_floor_signed(
                    1.5, fmt, 1000, 0.1, 2.0, 0.3, cond),
                 tt.stagnation_monotonicity_floor_signed(
                    1.5, fmt, 1000, 0.1, 2.0, 0.3, cond))]
        for r, g in pairs:
            assert r == g, fmt
    for cond in (14, 15):
        assert np.array_equal(jt.sr_rate_bound(1.0, 0.5, k, 3.0, 0.1, cond),
                              tt.sr_rate_bound(1.0, 0.5, k, 3.0, 0.1, cond))
        assert np.array_equal(
            jt.sr_eps_rate_bound(1.0, 0.5, k, 3.0, 0.1, 0.01, cond),
            tt.sr_eps_rate_bound(1.0, 0.5, k, 3.0, 0.1, 0.01, cond))
    assert np.array_equal(jt.exact_rate_bound(1000.0, 1e-3, k, 17.5),
                          tt.exact_rate_bound(1000.0, 1e-3, k, 17.5))
    assert jt.u_upper_bound(0.2, 1.5) == tt.u_upper_bound(0.2, 1.5)
    with pytest.raises(ValueError):
        tt.gradient_floor_sr(0.2, 1.5, "binary8", 10, condition=13)


def _grid_inputs(grid_name, seed):
    """Grid points, midpoints, values off the grid, zeros of both signs,
    values past xmax, +-inf (no float32 subnormals: XLA flushes them)."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.standard_normal(300) * 3.0,
                        rng.standard_normal(100) * 1e-3,
                        [0.0, -0.0, 1.0, -1.0, 0.75, 1.25, 2.0 ** -14,
                         1e6, -1e6, np.inf, -np.inf]]).astype(np.float32)
    grid = tr.round_to_format(torch.from_numpy(x), grid_name, "rn").numpy()
    return np.concatenate([x, grid[np.isfinite(grid)]]).astype(np.float32)


@pytest.fixture(scope="module")
def shifted():
    from repro.core import grids as jg
    from repro_torch.core import grids as tg
    for gr in (jg, tg):
        gr.register_grid(gr.shifted_grid("binary8", 0.5, 0.25,
                                         name="shift8q"))
    return "shift8q"


@pytest.mark.parametrize("grid", ["binary8", "bfloat16", "e4m3", "fxp16.8",
                                  "shifted"])
def test_rounding_extras_bitwise(grid, shifted):
    grid = shifted if grid == "shifted" else grid
    x = _grid_inputs(grid, 12)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for jf, tf_ in ((jr.successor, tr.successor),
                    (jr.predecessor, tr.predecessor)):
        assert _bits_equal(jf(jx, grid), tf_(tx, grid).numpy()), jf.__name__
    for r, g in zip(jr.floor_ceil(jx, grid), tr.floor_ceil(tx, grid)):
        assert _bits_equal(r, g.numpy())
    assert np.array_equal(np.asarray(jr.is_representable(jx, grid)),
                          tr.is_representable(tx, grid).numpy())


@pytest.mark.parametrize("fmt", ["binary8", "bfloat16", "e4m3"])
def test_stagnation_diagnostics_bitwise(fmt):
    """(The reference's ``tau`` takes format names only, no fxp grid.)"""
    rng = np.random.default_rng(13)
    x = tr.round_to_format(torch.from_numpy(
        (rng.standard_normal(200) * 8).astype(np.float32)), fmt, "rn")
    x[:3] = torch.tensor([0.0, 512.0, -1024.0])
    upd = torch.from_numpy((rng.standard_normal(200) * 0.05)
                           .astype(np.float32))
    jx, ju = jnp.asarray(x.numpy()), jnp.asarray(upd.numpy())
    assert _bits_equal(jgd.tau(jx, jnp.abs(ju), fmt),
                       tgd.tau(x, upd.abs(), fmt).numpy())
    assert np.array_equal(np.asarray(jgd.rn_would_stagnate(jx, ju, fmt)),
                          tgd.rn_would_stagnate(x, upd, fmt).numpy())
    for scale in (1.0, 1e-6):
        assert int(jgd.scenario(jx, ju * scale, fmt)) == \
            int(tgd.scenario(x, upd * scale, fmt))
    # Fig. 2's point: RN stagnates at 512 with t g = 0.03 * 1024
    z = torch.tensor([512.0])
    assert float(tgd.tau(z, torch.tensor([30.72]), "binary8")) <= 2.0 ** -4


@pytest.mark.parametrize("seed", [0, 1])
def test_normal_within_one_ulp(seed):
    """``prng.normal`` against ``jax.random.normal`` (Xavier init of the
    two-layer NN, held at its full shape in test_torch_paper.py): within
    one float32 ulp."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    key = tuple(int(w) for w in np.asarray(jkey))
    ref = np.asarray(jax.random.normal(jkey, (256, 100)))
    got = prng.normal(key, (256, 100)).numpy()
    assert np.all(np.abs(ref - got) <= np.spacing(np.abs(ref)))
