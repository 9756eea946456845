"""Runner of the paper's experiments on the port (counterpart of the
reference's ``benchmarks/run.py`` for the paper's figures and of
``benchmarks/convergence.py``'s command line).

  python -m repro_torch.paper.run --only convergence --smoke --engine kernel
  python -m repro_torch.paper.run --only table2,fig2,fig3 --quick --device cpu

Prints ``name,us,derived`` rows (the reference's names) after a line naming
the device.  ``--engine kernel`` sends the quadratic problems' updates
(convergence, Fig. 2, Fig. 3) through the fused kernel K2'; ``--quick``
takes the reference's CI sizes for the figures; ``--smoke`` the
convergence harness's nightly subset, whose ordering gate makes the
command exit 1.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

import torch

from repro_torch.device import resolve_device

NAMES = ("table2", "fig2", "fig3", "fig4", "fig5", "fig6", "convergence")


def benches(quick: bool, smoke: bool, engine: str, device, grids=None,
            write_md=None):
    """name -> a function returning (rows, failures)."""
    from repro_torch.paper import (convergence, fig2_stagnation,
                                   fig3_quadratic, fig4_mlr, fig5_mlr_lr,
                                   fig6_nn, table_formats)
    q = quick

    def rows_only(fn):
        return lambda: (fn(), [])
    return {
        "table2": rows_only(table_formats.run),
        "fig2": rows_only(lambda: fig2_stagnation.run(
            steps=200 if q else 400, engine=engine, device=device)),
        "fig3": rows_only(lambda: fig3_quadratic.run(
            steps_s1=400 if q else 2000, steps_s2=600 if q else 3000,
            sims=2 if q else 5, engine=engine, device=device)),
        "fig4": rows_only(lambda: fig4_mlr.run(
            epochs=40 if q else 150, sims=1 if q else 2,
            n_train=1500 if q else 3000, n_test=500 if q else 800,
            device=device)),
        "fig5": rows_only(lambda: fig5_mlr_lr.run(
            epochs=40 if q else 150, sims=1,
            n_train=1500 if q else 3000, n_test=500 if q else 800,
            device=device)),
        "fig6": rows_only(lambda: fig6_nn.run(
            epochs=15 if q else 50, sims=1 if q else 2,
            n_train=1000 if q else 3000, n_test=400 if q else 800,
            device=device)),
        "convergence": lambda: convergence.run(
            smoke=smoke, grids=grids or convergence.GRIDS,
            write_md=write_md, engine=engine, device=device),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset of {','.join(NAMES)}")
    ap.add_argument("--quick", action="store_true",
                    help="the reference's CI sizes for the figures")
    ap.add_argument("--smoke", action="store_true",
                    help="convergence: the nightly subset and its ordering "
                         "gate (exit 1 if an SR family fails to beat RN)")
    ap.add_argument("--engine", choices=("jnp", "kernel"), default="jnp")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain PyTorch path (default: the card)")
    ap.add_argument("--grids", default=None,
                    help="convergence: comma-separated grid names")
    ap.add_argument("--write-md", default=None, metavar="PATH",
                    help="convergence: write its markdown table to PATH")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # the paper's products are float32 (qarith.matmul refuses TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"# device {device} ({name}), engine {args.engine}", flush=True)
    only = set(args.only.split(",")) if args.only else set(NAMES)
    unknown = only - set(NAMES)
    if unknown:
        ap.error(f"unknown benchmarks {sorted(unknown)}")
    grids = tuple(args.grids.split(",")) if args.grids else None
    failed = False
    for bench, fn in benches(args.quick, args.smoke, args.engine, device,
                             grids, args.write_md).items():
        if bench not in only:
            continue
        t0 = time.time()
        try:
            rows, failures = fn()
        except Exception:
            traceback.print_exc()
            print(f"{bench}/FAILED,0,0")
            failed = True
            continue
        for row_name, us, derived in rows:
            print(f"{row_name},{us:.3f},{derived}", flush=True)
        for grid, lab, got, rn_f in failures:
            print(f"# ORDERING FAIL {grid}-{lab}: stagnation f {got:.3g} "
                  f"not < 0.5×RN ({rn_f:.3g})", file=sys.stderr)
        failed = failed or bool(failures)
        print(f"# {bench} done in {time.time() - t0:.1f}s", file=sys.stderr)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
