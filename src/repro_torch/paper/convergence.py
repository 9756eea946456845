"""Scheme × grid × problem-class convergence harness, Fig. 2–6 analogues
(counterpart of the reference's ``benchmarks/convergence.py``, its row
names kept).

Every registered scheme family (RN, SR, SR 2.0, SRε, signed-SRε) crossed
with bfloat16, binary8 and the fixed-point fxp16.8 on the paper's problem
classes: the Fig.-2 stagnation quadratic, a strongly convex (PL) diagonal
quadratic, §5.1 Setting I, and (full runs only) MLR and the two-layer NN.
``smoke=True`` runs the reference's nightly subset and returns, beside the
rows, the failures of its headline ordering gate: every SR family must end
below 0.5 × RN on the stagnation quadratic, on every grid.  ``engine``
"kernel" runs the quadratics' updates through the fused kernel K2'
(``core.gd.run_gd``); MLR and the NN update through ``gd_step`` as the
reference does.
"""
from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core import gd, prng, rounding, theory
from repro_torch.core.grids import get_grid
from repro_torch.device import resolve_device
from repro_torch.paper import paper_models as pm

MD_BEGIN = "<!-- convergence:begin -->"
MD_END = "<!-- convergence:end -->"

GRIDS = ("bfloat16", "binary8", "fxp16.8")


def scheme_cfgs(grid, eps_ssr=0.25) -> Dict[str, gd.GDRounding]:
    """label -> GDRounding for one grid.  (8a) is RN everywhere; the scheme
    under test drives (8b) and (8c).  ``parse_spec`` gives each scheme its
    canonical defaults: sr2 at its native 8-bit comparison draw."""
    rn = rounding.spec(grid, "rn")

    def mk(m, **kw):
        return rounding.spec(grid, m, **kw) if kw \
            else rounding.parse_spec(f"{grid}-{m}")
    return {
        "rn": gd.GDRounding(grad=rn, mul=mk("rn"), sub=mk("rn")),
        "sr": gd.GDRounding(grad=rn, mul=mk("sr"), sub=mk("sr")),
        "sr2": gd.GDRounding(grad=rn, mul=mk("sr2"), sub=mk("sr2")),
        "sr_eps": gd.GDRounding(grad=rn, mul=mk("sr_eps", eps=0.1),
                                sub=mk("sr")),
        "ssr": gd.GDRounding(grad=rn, mul=mk("sr"),
                             sub=mk("signed_sr_eps", eps=eps_ssr),
                             sub_v="grad"),
    }


def settings(smoke: bool) -> dict:
    """The run's sizes (the reference's)."""
    return dict(steps_stag=150 if smoke else 400,
                steps_pl=120 if smoke else 300,
                steps_ill=200 if smoke else 1500,
                sims=2 if smoke else 4, epochs_mlr=8 if smoke else 60,
                epochs_nn=6 if smoke else 30,
                labels=("rn", "sr", "sr2") if smoke
                else ("rn", "sr", "sr2", "sr_eps", "ssr"))


# ------------------------------------------------------------ problems ------
def stagnation_problem(grid, device=None):
    """The grid-aware Fig.-2 analogue: the optimum 8 ulps above a
    representable x0, t·|g(x0)| = 0.45 ulp(x0) (below RN's half-ulp
    deadband on every grid)."""
    gobj = get_grid(grid)
    x0v = float(rounding.round_to_format(
        torch.tensor(min(512.0, gobj.xmax / 4.0), dtype=torch.float32),
        grid, "rn"))
    u = float(rounding.ulp(torch.tensor(x0v, dtype=torch.float32), grid))
    center = x0v + 8.0 * u
    x0 = torch.tensor([x0v], dtype=torch.float32,
                      device=resolve_device(device))
    return (lambda x: torch.sum((x - center) ** 2),
            lambda x: 2.0 * (x - center), x0, 0.45 / 16.0)


def run_stagnation(grid, cfg, steps, sims, key0=0, engine="jnp",
                   device=None) -> float:
    """Mean final f on the grid's stagnation quadratic."""
    f, g, x0, t = stagnation_problem(grid, device)
    finals = []
    for s in range(sims):
        fs, _ = gd.run_gd(f, g, x0, t, cfg, steps, param_fmt=grid,
                          key=prng.PRNGKey(key0 + s), engine=engine)
        finals.append(float(fs[-1]))
    return float(np.mean(finals))


def run_quad_pl(grid, cfg, steps, sims, engine="jnp", device=None):
    """Strongly convex (PL, μ = 0.2, L = 1) diagonal quadratic; returns
    (mean final f, fraction of the trace within the Theorem-2 envelope)."""
    n = 64
    rng = np.random.default_rng(0)
    diag = np.linspace(0.2, 1.0, n).astype(np.float32)
    xstar = rng.normal(size=n).astype(np.float32)
    x0 = np.asarray(xstar + rng.normal(size=n).astype(np.float32) * 4,
                    np.float32)
    t = 0.5
    traces = [pm.run_quadratic_diag(*(pm._t(a, device)
                                      for a in (diag, x0, xstar)),
                                    t, cfg, steps, seed=s, param_fmt=grid,
                                    engine=engine)
              for s in range(sims)]
    mean = np.mean(traces, 0)
    bound = theory.exact_rate_bound(1.0, t, np.arange(1, steps + 1),
                                    float(np.linalg.norm(x0 - xstar)))
    in_env = float(np.mean(mean[5:] <= bound[5:] * 1.1 + 1e-2))
    return float(mean[-1]), in_env


def run_quad_ill(grid, cfg, steps, sims, engine="jnp", device=None) -> float:
    """§5.1 Setting I (ill-conditioned convex); mean final f."""
    diag, x0, xstar, t, _ = pm.setting1(device)
    traces = [pm.run_quadratic_diag(diag, x0, xstar, t, cfg, steps, seed=s,
                                    param_fmt=grid, engine=engine)
              for s in range(sims)]
    return float(np.mean([tr[-1] for tr in traces]))


def run_mlr(grid, cfg, epochs, sims, data) -> float:
    """Fig.-4 analogue; mean final test error (the products rounded with
    the update's (8b) spec)."""
    X, y, Xte, yte = data
    errs = []
    for s in range(sims):
        tr = pm.MLRTrainer(cfg=cfg, t=0.5, grad_spec=cfg.mul)
        _, hist = tr.train(X, y, Xte, yte, epochs, seed=s,
                           eval_every=max(epochs // 3, 1), param_fmt=grid)
        errs.append(hist[-1][1])
    return float(np.mean(errs))


def run_nn(grid, cfg, epochs, sims, data) -> float:
    """Fig.-6 analogue (odd vs even classes); mean final test error."""
    X, y, Xte, yte = data
    yb = (y % 2).float()
    ybte = (yte % 2).float()
    errs = []
    for s in range(sims):
        tr = pm.TwoLayerNNTrainer(cfg=cfg, t=0.5, grad_spec=cfg.mul)
        _, hist = tr.train(X, yb, Xte, ybte, epochs, seed=s,
                           eval_every=max(epochs // 3, 1), param_fmt=grid)
        errs.append(hist[-1][1])
    return float(np.mean(errs))


# ------------------------------------------------------------------ run -----
def run(smoke=False, grids=GRIDS, write_md=None, engine="jnp", device=None):
    """Returns (rows, failures): the ``name,us,derived`` rows and the
    ordering gate's failures, (grid, label, final f, RN's final f) for each
    SR family not below 0.5 × RN on the stagnation quadratic.  Writes the
    markdown table only to ``write_md``, a path the caller names."""
    device = resolve_device(device)
    st = settings(smoke)
    labels, sims = st["labels"], st["sims"]
    rows, table = [], {}
    t0 = time.time()
    data = None
    if not smoke:
        from repro_torch.data import synthetic_mnist
        data = pm.to_device(synthetic_mnist(1500, 500, seed=0), device)
    for grid in grids:
        cfgs = scheme_cfgs(grid)
        for lab in labels:
            cfg = cfgs[lab]
            cell = {"stag": run_stagnation(grid, cfg, st["steps_stag"], sims,
                                           engine=engine, device=device)}
            cell["pl"], cell["pl_env"] = run_quad_pl(
                grid, cfg, st["steps_pl"], sims, engine, device)
            cell["ill"] = run_quad_ill(grid, cfg, st["steps_ill"], sims,
                                       engine, device)
            if data is not None:
                cell["mlr"] = run_mlr(grid, cfg, st["epochs_mlr"], sims, data)
                cell["nn"] = run_nn(grid, cfg, st["epochs_nn"], sims, data)
            table[(grid, lab)] = cell
            tag = f"conv/{grid}-{lab}"
            rows.append((f"{tag}/stagnation_final_f", 0.0, cell["stag"]))
            rows.append((f"{tag}/quad_pl_final_f", 0.0, cell["pl"]))
            rows.append((f"{tag}/quad_pl_env_frac", 0.0, cell["pl_env"]))
            rows.append((f"{tag}/quad_ill_final_f", 0.0, cell["ill"]))
            if data is not None:
                rows.append((f"{tag}/mlr_final_err", 0.0, cell["mlr"]))
                rows.append((f"{tag}/nn_final_err", 0.0, cell["nn"]))
    rows.insert(0, ("conv/wall_s", (time.time() - t0) * 1e6, 0.0))
    failures = ordering_failures(table, grids, labels)
    if write_md:
        _write_markdown(write_md, table, grids, labels,
                        with_models=data is not None)
    return rows, failures


def ordering_failures(table, grids, labels):
    """The paper's headline ordering: every stochastic family escapes the
    RN stagnation plateau (final f below 0.5 × RN's)."""
    failures = []
    for grid in grids:
        rn_f = table[(grid, "rn")]["stag"]
        for lab in labels:
            if lab != "rn" and table[(grid, lab)]["stag"] >= 0.5 * rn_f:
                failures.append((grid, lab, table[(grid, lab)]["stag"],
                                 rn_f))
    return failures


def _write_markdown(path, table, grids, labels, with_models):
    cols = ["stag", "pl", "pl_env", "ill"] + (
        ["mlr", "nn"] if with_models else [])
    heads = {"stag": "Fig.2 stagnation f_final",
             "pl": "PL quad f_final", "pl_env": "Thm-2 envelope frac",
             "ill": "Setting-I f_final", "mlr": "MLR test err",
             "nn": "NN test err"}
    lines = [MD_BEGIN, "",
             "| grid × scheme | " + " | ".join(heads[c] for c in cols)
             + " |",
             "|---" * (len(cols) + 1) + "|"]
    for grid in grids:
        for lab in labels:
            cell = table[(grid, lab)]
            vals = " | ".join(f"{cell[c]:.3g}" if c in cell else "—"
                              for c in cols)
            lines.append(f"| `{grid}-{lab}` | {vals} |")
    lines += ["", MD_END]
    block = "\n".join(lines)
    try:
        with open(path) as f:
            text = f.read()
    except FileNotFoundError:
        text = ""
    if MD_BEGIN in text and MD_END in text:
        text = text[: text.index(MD_BEGIN)] + block \
            + text[text.index(MD_END) + len(MD_END):]
    else:
        text = text.rstrip("\n") + ("\n\n" if text else "") + block + "\n"
    with open(path, "w") as f:
        f.write(text)
    print(f"# wrote convergence tables to {path}", file=sys.stderr)
