"""Figure 2: stagnation of GD with RN on binary8 for f(x) = (x − 1024)²,
and its diagnosis by τ_k ≤ u/2, paper §3.2 (counterpart of the
reference's ``benchmarks/fig2_stagnation.py``)."""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import formats, gd, prng
from repro_torch.device import resolve_device

F8 = formats.get_format("binary8")


def run(steps: int = 400, t: float = 0.03, engine: str = "jnp",
        device=None):
    device = resolve_device(device)

    def f(x):
        return torch.sum((x - 1024.0) ** 2)

    def g(x):
        return 2.0 * (x - 1024.0)
    x0 = torch.tensor([512.0], dtype=torch.float32, device=device)
    t0 = time.time()
    cfg_rn = gd.make_config("binary8", "rn", "rn", "rn")
    fs_rn, x_rn = gd.run_gd(f, g, x0, t, cfg_rn, steps, param_fmt="binary8",
                            engine=engine)
    cfg_sr = gd.make_config("binary8", "rn", "sr", "sr")
    # float32 finals, averaged in float32 as the reference's numpy does
    sr_final = [gd.run_gd(f, g, x0, t, cfg_sr, steps, key=prng.PRNGKey(s),
                          param_fmt="binary8", engine=engine)[0][-1]
                .cpu().numpy() for s in range(10)]
    wall = time.time() - t0
    tau = float(gd.tau(x_rn, torch.abs(t * g(x_rn)), F8))
    rn_f = float(fs_rn[-1])
    return [
        ("fig2/rn_final_f", wall * 1e6 / steps, rn_f),
        ("fig2/rn_tau_k", 0.0, tau),
        ("fig2/rn_stagnated", 0.0, float(tau <= F8.u / 2)),
        ("fig2/sr_mean_final_f", 0.0, float(np.mean(sr_final))),
        ("fig2/sr_over_rn_ratio", 0.0, float(np.mean(sr_final) / rn_f)),
    ]
