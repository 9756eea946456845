"""Figures 4a/4b: MLR test error on binary8 across rounding schemes
(counterpart of the reference's ``benchmarks/fig4_mlr.py``).

4a: SR for (8c); {RN, SR, SRε(0.2), SRε(0.4)} for (8a)+(8b).
4b: signed-SRε(ε) for (8c), ε ∈ {0.02, 0.1, 0.4}.
Baseline binary32; t = 0.5, full-batch GD on the synthetic MNIST.  Per
scheme: the best test error over the trajectory, the final one, and the
epochs to an error of 0.25.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import gd, rounding
from repro_torch.data import synthetic_mnist
from repro_torch.device import resolve_device
from repro_torch.paper.paper_models import MLRTrainer, to_device

F8 = "binary8"
THRESH = 0.25


def _metrics(cfg, X, y, Xte, yte, epochs, sims, grad_spec, param_fmt,
             t=0.5):
    curves = []
    for s in range(sims):
        tr = MLRTrainer(cfg=cfg, t=t, grad_spec=grad_spec)
        _, hist = tr.train(X, y, Xte, yte, epochs, seed=s, eval_every=10,
                           param_fmt=param_fmt)
        curves.append([v for _, v in hist])
    m = np.mean(curves, axis=0)
    hit = np.nonzero(m <= THRESH)[0]
    t2t = float((hit[0] + 1) * 10) if len(hit) else float(10 * len(m) + 10)
    return float(m.min()), float(m[-1]), t2t


def run(epochs: int = 150, sims: int = 3, n_train: int = 3000,
        n_test: int = 800, device=None):
    X, y, Xte, yte = to_device(synthetic_mnist(n_train, n_test, seed=0),
                               resolve_device(device))
    rows = []
    t0 = time.time()
    sr8 = rounding.spec(F8, "sr")

    def emit(tag, cfg, grad_spec=sr8, pf=F8):
        best, final, t2t = _metrics(cfg, X, y, Xte, yte, epochs, sims,
                                    grad_spec, pf)
        rows.append((f"{tag}_best_err", 0.0, best))
        rows.append((f"{tag}_final_err", 0.0, final))
        rows.append((f"{tag}_epochs_to_{THRESH}", 0.0, t2t))

    emit("fig4/binary32", gd.fp32_config(), grad_spec=None, pf=None)
    emit("fig4a/rn", gd.make_config(F8, "rn", "rn", "rn"),
         grad_spec=rounding.spec(F8, "rn"))
    emit("fig4a/sr", gd.make_config(F8, "sr", "sr", "sr"))
    for eps in (0.2, 0.4):
        emit(f"fig4a/sr_eps{eps}", gd.GDRounding(
            grad=rounding.spec(F8, "sr_eps", eps),
            mul=rounding.spec(F8, "sr_eps", eps),
            sub=rounding.spec(F8, "sr")))
    for eps in (0.02, 0.1, 0.4):
        emit(f"fig4b/signed_sreps{eps}", gd.GDRounding(
            grad=sr8, mul=sr8,
            sub=rounding.spec(F8, "signed_sr_eps", eps), sub_v="grad"))
    wall = time.time() - t0
    rows.insert(0, ("fig4/wall_us_per_epoch",
                    wall * 1e6 / (epochs * sims * 8), 0.0))
    return rows
