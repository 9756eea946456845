"""Figures 6a/6b: the two-layer NN (binary 3-vs-8 stand-in) on binary8
(counterpart of the reference's ``benchmarks/fig6_nn.py``).

6a: SR for (8c), {SR, SRε(0.2)} for (8a)/(8b), and RN everywhere.
6b: signed-SRε for (8c), ε ∈ {0.02, 0.1, 0.2}.
t = 0.09375 (the paper's), Xavier init, BCE loss.  Per scheme: the best
error over the trajectory, the final one, the epochs to 0.15.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import gd, rounding
from repro_torch.data import synthetic_binary_mnist
from repro_torch.device import resolve_device
from repro_torch.paper.paper_models import TwoLayerNNTrainer, to_device

F8 = "binary8"
T = 0.09375
THRESH = 0.15


def _metrics(cfg, data, epochs, sims, grad_spec, param_fmt, t=T):
    X, y, Xte, yte = data
    curves = []
    for s in range(sims):
        tr = TwoLayerNNTrainer(cfg=cfg, t=t, grad_spec=grad_spec)
        _, hist = tr.train(X, y, Xte, yte, epochs, seed=s, eval_every=5,
                           param_fmt=param_fmt)
        curves.append([v for _, v in hist])
    m = np.mean(curves, axis=0)
    hit = np.nonzero(m <= THRESH)[0]
    t2t = float((hit[0] + 1) * 5) if len(hit) else float(5 * len(m) + 5)
    return float(m.min()), float(m[-1]), t2t


def run(epochs: int = 50, sims: int = 2, n_train: int = 3000,
        n_test: int = 800, device=None):
    data = to_device(synthetic_binary_mnist(n_train, n_test, seed=0),
                     resolve_device(device))
    rows = []
    t0 = time.time()
    sr8 = rounding.spec(F8, "sr")

    def emit(tag, cfg, grad_spec=sr8, pf=F8):
        best, final, t2t = _metrics(cfg, data, epochs, sims, grad_spec, pf)
        rows.append((f"{tag}_best_err", 0.0, best))
        rows.append((f"{tag}_final_err", 0.0, final))
        rows.append((f"{tag}_epochs_to_{THRESH}", 0.0, t2t))

    emit("fig6/binary32", gd.fp32_config(), grad_spec=None, pf=None)
    emit("fig6a/rn", gd.make_config(F8, "rn", "rn", "rn"),
         grad_spec=rounding.spec(F8, "rn"))
    emit("fig6a/sr", gd.make_config(F8, "sr", "sr", "sr"))
    emit("fig6a/sr_eps0.2", gd.GDRounding(
        grad=rounding.spec(F8, "sr_eps", 0.2),
        mul=rounding.spec(F8, "sr_eps", 0.2),
        sub=rounding.spec(F8, "sr")))
    for eps in (0.02, 0.1, 0.2):
        emit(f"fig6b/signed_sreps{eps}", gd.GDRounding(
            grad=sr8, mul=sr8,
            sub=rounding.spec(F8, "signed_sr_eps", eps), sub_v="grad"))
    wall = time.time() - t0
    rows.insert(0, ("fig6/wall_us_per_epoch",
                    wall * 1e6 / (epochs * sims * 7), 0.0))
    return rows
