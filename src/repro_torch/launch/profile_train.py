"""Where a train step's device time goes: ``torch.profiler`` over steps of
one of ``repro_torch.launch.train``'s target runs on the card:
``train.PAPER_RUN`` (tinyllama-1.1b, batch 4 x 256, ``binary8-paper``
GEMMs, QSGD, signed-SRε binary8 update through K2') or, with ``--optimizer
adam``, ``train.ADAM_RUN`` (QAdam over packed bf16-sr moments through K5).

  PYTHONPATH=src python -m repro_torch.launch.profile_train \\
      [--optimizer adam] [--steps 2] \\
      [--out chiprun_out/profile_train.json]

After one warm-up step, ``--steps`` steps run under the profiler; it prints
the host-clock wall time of that window, the device time summed over
kernels (one stream, so kernels do not overlap: their sum over the wall
time is the device busy share), and the kernels by device time, and writes
them as JSON.  It needs a card: without one it raises.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.launch import train


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, name, None)
        if value is not None:
            return float(value)
    return 0.0


def kernel_rows(events) -> list:
    """The profiled kernels by device time (name, calls, device ms)."""
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(({"name": e.key, "calls": e.count,
                    "device_ms": _device_us(e) / 1e3} for e in kernels),
                  key=lambda r: -r["device_ms"])


def profile(steps: int, run: dict) -> dict:
    tr = train.setup(**run)
    tr.step(tr.batch(0))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            tr.step(tr.batch(1 + i))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = kernel_rows(prof.key_averages())
    device_ms = sum(r["device_ms"] for r in rows)
    return {**run, "steps": steps,
            "device": torch.cuda.get_device_name(0), "wall_ms": wall_ms,
            "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else 0.0,
            "kernels": rows}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"],
                    help="sgd: train.PAPER_RUN; adam: train.ADAM_RUN")
    ap.add_argument("--out", default="chiprun_out/profile_train.json")
    args = ap.parse_args(argv)
    run = train.PAPER_RUN if args.optimizer == "sgd" else train.ADAM_RUN
    res = profile(args.steps, run)
    print(f"{res['device']}: {args.optimizer} {args.steps} steps, wall "
          f"{res['wall_ms']:.1f} "
          f"ms, device {res['device_ms']:.1f} ms, busy share "
          f"{res['busy_share']:.3f}")
    for r in res["kernels"][:30]:
        print(f"  {r['device_ms']:10.3f} ms  {r['calls']:6d}x  "
              f"{r['name'][:110]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
