"""Figures 5a/5b: the MLR stepsize sweep, SR everywhere (5a) against
SRε(0.1) for (8a) and signed-SRε(0.1) for (8b)/(8c) (5b) (counterpart of
the reference's ``benchmarks/fig5_mlr_lr.py``)."""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import gd, rounding
from repro_torch.data import synthetic_mnist
from repro_torch.device import resolve_device
from repro_torch.paper.paper_models import MLRTrainer, to_device

F8 = "binary8"


def run(epochs: int = 150, sims: int = 2, n_train: int = 4000,
        n_test: int = 1000, device=None):
    X, y, Xte, yte = to_device(synthetic_mnist(n_train, n_test, seed=0),
                               resolve_device(device))
    rows = []
    t0 = time.time()
    cfg_sr = gd.GDRounding(grad=rounding.spec(F8, "sr"),
                           mul=rounding.spec(F8, "sr"),
                           sub=rounding.spec(F8, "sr"))
    cfg_signed = gd.GDRounding(grad=rounding.spec(F8, "sr_eps", 0.1),
                               mul=rounding.spec(F8, "signed_sr_eps", 0.1),
                               sub=rounding.spec(F8, "signed_sr_eps", 0.1),
                               mul_v="neg_grad", sub_v="grad")

    def avg(cfg, t):
        errs = []
        for s in range(sims):
            tr = MLRTrainer(cfg=cfg, t=t, grad_spec=rounding.spec(F8, "sr"))
            _, hist = tr.train(X, y, Xte, yte, epochs, seed=s,
                               eval_every=epochs, param_fmt=F8)
            errs.append(hist[-1][1])
        return float(np.mean(errs))

    for t in (0.1, 0.5, 1.0, 1.25):
        rows.append((f"fig5a/sr_t{t}_err", 0.0, avg(cfg_sr, t)))
        rows.append((f"fig5b/signed_t{t}_err", 0.0, avg(cfg_signed, t)))
    wall = time.time() - t0
    rows.insert(0, ("fig5/wall_us_per_epoch",
                    wall * 1e6 / (epochs * sims * 8), 0.0))
    return rows
