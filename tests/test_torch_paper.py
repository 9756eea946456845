"""The paper's experiments on the port (``repro_torch.paper``) held against
the reference's (``benchmarks/``): data, run_gd on both engines under the
wide update chains, the MLR and NN trainers, the convergence harness and
the figure runners' rows.

Inputs are made with numpy (the synthetic MNIST is numpy in both
packages) and keys are the same words.  Tolerances: the data bitwise; the
GD iterates bitwise on both engines, f within rtol 1e-6 (a float32 sum in
another order); the trainers (float32 products summed in another order
than XLA's, and ``exp`` / ``sigmoid`` ulps) at most 1e-3 of the
parameters after one epoch off by one binary8 step, the test error after
three epochs within 0.02; the convergence harness's rows within rtol 1e-5
(final f: float32 sums) and its ordering verdict equal; the figure
runners' row names equal, Table 2 and Fig. 2 equal.  The reference's
compiled steps are built with ``xla_allow_excess_precision=False``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import convergence as bconv, paper_models as jpm
from repro.core import gd as jgd, rounding as jr
from repro.data import synthetic as jsyn
from repro_torch.core import gd as tgd, prng, rounding as tr
from repro_torch.data import synthetic as tsyn
from repro_torch.paper import convergence as tconv, paper_models as tpm

CPU = torch.device("cpu")


def _bits_equal(ref, got) -> bool:
    return bool(np.array_equal(np.asarray(ref, np.float32).view(np.int32),
                               np.asarray(got, np.float32).view(np.int32)))


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def test_synthetic_mnist_bitwise():
    for ref, got in zip(jsyn.synthetic_mnist(300, 50, seed=3),
                        tsyn.synthetic_mnist(300, 50, seed=3)):
        assert ref.dtype == got.dtype and np.array_equal(ref, got)
    for ref, got in zip(jsyn.synthetic_binary_mnist(60, 20, seed=1),
                        tsyn.synthetic_binary_mnist(60, 20, seed=1)):
        assert ref.dtype == got.dtype and np.array_equal(ref, got)


def test_settings_match():
    for ref, got in ((jpm.setting1(), tpm.setting1(CPU)),
                     (jpm.setting2(), tpm.setting2(device=CPU))):
        for r, g in zip(ref[:3], got[:3]):
            assert _bits_equal(r, g.numpy())
        assert ref[3:] == got[3:]


@pytest.mark.parametrize("engine", ["jnp", "kernel"])
@pytest.mark.parametrize("names", [
    ("fxp16.8-rn", "fxp16.8-sr2", "fxp16.8-sr2"),
    ("binary8-rz", "binary8-rz", "binary8-rz"),
    ("bf16-rn", "bf16-sr-bittrick", "bf16-sr-bittrick")])
def test_run_gd_setting1_wide_chains(names, engine):
    """Setting I's A and x0 cut to n = 300 (the stepsize raised to 0.5 so
    that steps cross grid points), 12 steps: the iterates bitwise on both
    engines (``"kernel"``: K2''s wide instance), f within rtol 1e-6."""
    diag, x0, xstar, _, _ = jpm.setting1()
    diag, x0, xstar = (np.asarray(a)[-300:] for a in (diag, x0, xstar))
    jcfg = jgd.GDRounding(*(jr.parse_spec(s) for s in names))
    tcfg = tgd.GDRounding(*(tr.parse_spec(s) for s in names))
    fmt = names[2].split("-")[0]
    fs_ref, x_ref = jgd.run_gd(
        lambda x: 0.5 * jnp.sum(diag * (x - xstar) ** 2),
        lambda x: diag * (x - xstar), jnp.asarray(x0), 0.5, jcfg, 12,
        jax.random.PRNGKey(4), param_fmt=fmt, engine=engine)
    td, ts = torch.from_numpy(diag.copy()), torch.from_numpy(xstar.copy())
    fs, x = tgd.run_gd(lambda x: 0.5 * torch.sum(td * (x - ts) ** 2),
                       lambda x: td * (x - ts), torch.from_numpy(x0.copy()),
                       0.5, tcfg, 12, (0, 4), param_fmt=fmt, engine=engine)
    assert _bits_equal(x_ref, x.numpy())
    np.testing.assert_allclose(fs.numpy(), np.asarray(fs_ref), rtol=1e-6)


def _step_flips(ref, got, fmt):
    n, adjacent = tr.grid_flips(torch.from_numpy(np.array(ref)), got, fmt)
    return n, adjacent


def test_mlr_trainer_matches():
    """MLR (784 x 10, SR-rounded products and update on binary8) at 200
    samples: W after epoch 1 at most 1e-3 of its elements off by one
    binary8 step; the test error after 3 epochs within 0.02."""
    X, y, Xte, yte = jsyn.synthetic_mnist(200, 100, seed=0)
    sr8 = "binary8"
    jtr = jpm.MLRTrainer(cfg=jgd.make_config(sr8, "sr", "sr", "sr"), t=0.5,
                         grad_spec=jr.spec(sr8, "sr"))
    ttr = tpm.MLRTrainer(cfg=tgd.make_config(sr8, "sr", "sr", "sr"), t=0.5,
                         grad_spec=tr.spec(sr8, "sr"))
    Y1h = np.asarray(jax.nn.one_hot(y, 10))
    jW = jnp.zeros((784, 10), jnp.float32)
    tW = torch.zeros((784, 10))
    jkey, tkey = jax.random.PRNGKey(0), (0, 0)
    tX, tY = torch.from_numpy(X), torch.from_numpy(Y1h.copy())
    step = None
    for e in range(3):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey)
        assert tuple(int(w) for w in np.asarray(jsub)) == tsub
        if step is None:
            step = _compiled(jtr.epoch, jW, X, Y1h, jsub)
        jW = step(jW, X, Y1h, jsub)
        tW = ttr.epoch(tW, tX, tY, tsub)
        if e == 0:
            n, adjacent = _step_flips(jW, tW, sr8)
            assert n <= 1e-3 * tW.numel() and adjacent, n
    err_ref = jtr.test_error(jW, Xte, yte)
    err = ttr.test_error(tW, torch.from_numpy(Xte), torch.from_numpy(yte))
    assert abs(err - err_ref) <= 0.02, (err, err_ref)


def test_nn_trainer_matches():
    """The two-layer NN (784 -> 100 -> 1) from the reference's Xavier init
    carried across, binary8 SR products and update, 200 samples: every
    parameter after epoch 1 within the MLR limits, the test error after 3
    epochs within 0.02."""
    X, y, Xte, yte = jsyn.synthetic_binary_mnist(200, 100, seed=0)
    cfg = ("binary8", "sr", "sr", "sr")
    jtr = jpm.TwoLayerNNTrainer(cfg=jgd.make_config(*cfg), t=0.09375,
                                grad_spec=jr.spec("binary8", "sr"))
    ttr = tpm.TwoLayerNNTrainer(cfg=tgd.make_config(*cfg), t=0.09375,
                                grad_spec=tr.spec("binary8", "sr"))
    jp = jtr.init(jax.random.PRNGKey(1000))
    # one compiled rounding instead of one eager dispatch per op
    jp = _compiled(lambda p: {k: jr.round_to_format(v, "binary8", "rn")
                              for k, v in p.items()}, jp)(jp)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jkey, step = jax.random.PRNGKey(0), None
    tX, ty = torch.from_numpy(X), torch.from_numpy(y)
    for e in range(3):
        jkey, jsub = jax.random.split(jkey)
        tsub = tuple(int(w) for w in np.asarray(jsub))
        if step is None:
            step = _compiled(jtr.epoch, jp, X, y, jsub)
        jp = step(jp, X, y, jsub)
        tp = ttr.epoch(tp, tX, ty, tsub)
        if e == 0:
            for k in jp:
                n, adjacent = _step_flips(jp[k], tp[k], "binary8")
                assert n <= max(1, 1e-3 * tp[k].numel()) and adjacent, (k, n)
    err_ref = jtr.test_error(jp, Xte, yte)
    err = ttr.test_error(tp, torch.from_numpy(Xte), torch.from_numpy(yte))
    assert abs(err - err_ref) <= 0.02, (err, err_ref)


def test_nn_init_matches_reference():
    """The port's own Xavier init (``prng.normal``) against the
    reference's: within one float32 ulp."""
    jtr = jpm.TwoLayerNNTrainer(cfg=jgd.fp32_config(), t=0.1)
    ttr = tpm.TwoLayerNNTrainer(cfg=tgd.fp32_config(), t=0.1)
    ref = jtr.init(jax.random.PRNGKey(1003))
    got = ttr.init((0, 1003), device=CPU)
    for k in ref:
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert r.shape == g.shape
        assert np.all(np.abs(r - g) <= np.spacing(np.abs(r))), k


def test_convergence_smoke_matches_reference(monkeypatch):
    """``convergence.run(smoke=True, grids=("binary8",))`` cut to 20 steps
    and one simulation: the reference's rows (its per-problem functions at
    the same sizes) and ordering verdict; the kernel engine gives the same
    rows' names."""
    steps, sims = 20, 1
    full = tconv.settings(True)
    monkeypatch.setattr(tconv, "settings", lambda smoke: {
        **full, "steps_stag": steps, "steps_pl": steps, "steps_ill": steps,
        "sims": sims})
    rows, failures = tconv.run(smoke=True, grids=("binary8",), device="cpu")
    table, ref_rows = {}, []
    for lab in ("rn", "sr", "sr2"):
        cfg = bconv.scheme_cfgs("binary8")[lab]
        cell = {"stag": bconv.run_stagnation("binary8", cfg, steps, sims)}
        cell["pl"], cell["pl_env"] = bconv.run_quad_pl("binary8", cfg, steps,
                                                       sims)
        cell["ill"] = bconv.run_quad_ill("binary8", cfg, steps, sims)
        table[("binary8", lab)] = cell
        tag = f"conv/binary8-{lab}"
        ref_rows += [(f"{tag}/stagnation_final_f", cell["stag"]),
                     (f"{tag}/quad_pl_final_f", cell["pl"]),
                     (f"{tag}/quad_pl_env_frac", cell["pl_env"]),
                     (f"{tag}/quad_ill_final_f", cell["ill"])]
    assert rows[0][0] == "conv/wall_s"
    assert [r[0] for r in rows[1:]] == [r[0] for r in ref_rows]
    for (name, _, got), (_, ref) in zip(rows[1:], ref_rows):
        np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=name)
    ref_fail = [f[:2] for f in tconv.ordering_failures(
        table, ("binary8",), ("rn", "sr", "sr2"))]
    assert [f[:2] for f in failures] == ref_fail
    krows, _ = tconv.run(smoke=True, grids=("binary8",), device="cpu",
                         engine="kernel")
    assert [r[0] for r in krows] == [r[0] for r in rows]


def test_figure_runners_rows_match_reference(monkeypatch):
    """Each runner's row names equal the reference's at a tiny size; Table
    2 and Fig. 2 (bitwise iterates on a one-element quadratic) equal.  The
    reference's MLR and NN trainers are stubbed for the names (their
    values are held above)."""
    from benchmarks import (fig2_stagnation as b2, fig3_quadratic as b3,
                            fig4_mlr as b4, fig5_mlr_lr as b5, fig6_nn as b6,
                            table_formats as bt)
    from repro_torch.paper import (fig2_stagnation as p2,
                                   fig3_quadratic as p3, fig4_mlr as p4,
                                   fig5_mlr_lr as p5, fig6_nn as p6,
                                   table_formats as pt)
    assert pt.run() == bt.run()
    ref, got = b2.run(steps=30), p2.run(steps=30, device=CPU)
    assert [r[0] for r in ref] == [r[0] for r in got]
    for r, g in zip(ref[1:], got[1:]):
        assert r[2] == g[2], r[0]
    assert ref[0][2] == got[0][2]
    for cls in (jpm.MLRTrainer, jpm.TwoLayerNNTrainer):
        monkeypatch.setattr(cls, "train",
                            lambda self, *a, **k: (None, [(1, 0.5)]))
    # Setting II (its 1000 x 1000 QR held in test_settings_match) as a
    # 40 x 40 problem of the same kind, for the names
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(40, 40)))
    A = (q * np.arange(1, 41)) @ q.T
    small = (((A + A.T) / 2).astype(np.float32),
             np.arange(40, 0, -1, dtype=np.float32),
             np.full(40, 2.0 ** -4, np.float32))
    monkeypatch.setattr(jpm, "setting2", lambda seed=0: (
        *(jnp.asarray(a) for a in small), 1e-3, 40.0))
    monkeypatch.setattr(tpm, "setting2", lambda seed=0, device=None: (
        *(torch.from_numpy(a.copy()).to(device) for a in small), 1e-3, 40.0))
    names = {
        "fig3": ([r[0] for r in p3.run(4, 4, 1, device=CPU)],
                 [r[0] for r in b3.run(4, 4, 1)]),
        "fig4": ([r[0] for r in p4.run(2, 1, 60, 30, device=CPU)],
                 [r[0] for r in b4.run(2, 1, 60, 30)]),
        "fig5": ([r[0] for r in p5.run(1, 1, 60, 30, device=CPU)],
                 [r[0] for r in b5.run(1, 1, 60, 30)]),
        "fig6": ([r[0] for r in p6.run(1, 1, 40, 20, device=CPU)],
                 [r[0] for r in b6.run(1, 1, 40, 20)]),
    }
    for fig, (got_names, ref_names) in names.items():
        assert got_names == ref_names, fig


@pytest.mark.parametrize("entry", ["fig2", "fig3", "fig4", "fig5", "fig6",
                                   "convergence", "setting1", "to_device"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """With no ``device`` every runner and data builder asks for the card,
    so without one it raises instead of running on the CPU."""
    from repro_torch.paper import (fig2_stagnation as p2,
                                   fig3_quadratic as p3, fig4_mlr as p4,
                                   fig5_mlr_lr as p5, fig6_nn as p6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "fig2": lambda: p2.run(steps=2),
        "fig3": lambda: p3.run(2, 2, 1),
        "fig4": lambda: p4.run(1, 1, 20, 10),
        "fig5": lambda: p5.run(1, 1, 20, 10),
        "fig6": lambda: p6.run(1, 1, 20, 10),
        "convergence": lambda: tconv.run(smoke=True, grids=("binary8",)),
        "setting1": tpm.setting1,
        "to_device": lambda: tpm.to_device(
            tsyn.synthetic_mnist(20, 10, seed=0), None),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
