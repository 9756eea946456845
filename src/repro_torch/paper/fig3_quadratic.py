"""Figure 3: quadratic optimization on bfloat16, E[f] under SR(8b)+SR(8c)
and SR(8b)+signed-SRε(8c, ε = 0.4) against the binary32 baseline and the
Theorem-2 bound (counterpart of the reference's
``benchmarks/fig3_quadratic.py``)."""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core import gd, rounding, theory
from repro_torch.device import resolve_device
from repro_torch.paper import paper_models as pm


def _cfgs():
    cfg_sr = gd.make_config("bfloat16", "rn", "sr", "sr")
    cfg_signed = gd.GDRounding(
        grad=rounding.spec("bfloat16", "rn"),
        mul=rounding.spec("bfloat16", "sr"),
        sub=rounding.spec("bfloat16", "signed_sr_eps", 0.4),
        sub_v="grad")
    return cfg_sr, cfg_signed


def run(steps_s1: int = 2000, steps_s2: int = 3000, sims: int = 5,
        engine: str = "jnp", device=None):
    device = resolve_device(device)
    rows = []
    t0 = time.time()
    cfg_sr, cfg_signed = _cfgs()

    def mean_over_sims(run_fn, args, cfg, steps):
        return np.mean([run_fn(*args, cfg, steps, seed=s,
                               param_fmt="bfloat16", engine=engine)
                        for s in range(sims)], axis=0)

    # ---------------- Setting I
    diag, x0, xstar, t, L = pm.setting1(device)
    args = (diag, x0, xstar, t)
    exact = pm.run_quadratic_diag(*args, gd.fp32_config(), steps_s1,
                                  engine=engine)
    sr = mean_over_sims(pm.run_quadratic_diag, args, cfg_sr, steps_s1)
    sg = mean_over_sims(pm.run_quadratic_diag, args, cfg_signed, steps_s1)
    bound = theory.exact_rate_bound(
        L, t, steps_s1, float(np.linalg.norm((x0 - xstar).cpu().numpy())))
    rows += [
        ("fig3a/binary32_final_f", 0.0, float(exact[-1])),
        ("fig3a/bf16_sr_final_f", 0.0, float(sr[-1])),
        ("fig3a/bf16_signed_sreps_final_f", 0.0, float(sg[-1])),
        ("fig3a/thm2_bound_final", 0.0, float(bound)),
        ("fig3a/sr_within_bound", 0.0, float(sr[-1] <= bound * 1.05)),
        ("fig3a/signed_speedup_vs_sr", 0.0,
         float(sr[-1] / max(sg[-1], 1e-30))),
    ]

    # ---------------- Setting II
    A, x0, xstar, t, L = pm.setting2(device=device)
    args = (A, x0, xstar, t)
    exact2 = pm.run_quadratic_full(*args, gd.fp32_config(), steps_s2,
                                   engine=engine)
    sr2 = mean_over_sims(pm.run_quadratic_full, args, cfg_sr, steps_s2)
    sg2 = mean_over_sims(pm.run_quadratic_full, args, cfg_signed, steps_s2)
    wall = time.time() - t0
    rows += [
        ("fig3b/binary32_final_f", wall * 1e6 / (steps_s1 + steps_s2),
         float(exact2[-1])),
        ("fig3b/bf16_sr_final_f", 0.0, float(sr2[-1])),
        ("fig3b/bf16_signed_sreps_final_f", 0.0, float(sg2[-1])),
        ("fig3b/signed_speedup_vs_sr", 0.0,
         float(sr2[-1] / max(sg2[-1], 1e-30))),
        ("fig3b/signed_beats_binary32", 0.0, float(sg2[-1] < exact2[-1])),
    ]
    return rows
