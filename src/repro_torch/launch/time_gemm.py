"""CUDA-event times of the rounded GEMM kernels K3' and K4' at the serving
path's shapes (tinyllama-1.1b decode, M = 4) and one train-step shape, for
comparing two trees of the port on one card.

  python src/repro_torch/launch/time_gemm.py [--src DIR] [--tag NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the tree this file lives in), so one call can time two
checkouts in turns (A, B, B, A).  Prints one JSON line: ms per call at
each shape, and the sums over one decode step's launches.  It needs a
card.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

# (name, M, K, N, launches per tinyllama decode step)
SHAPES = [("k3", 4, 2048, 2048, 44), ("k3", 4, 2048, 256, 44),
          ("k3", 4, 5632, 2048, 22), ("k3", 4, 2048, 32000, 1),
          ("k4", 4, 2048, 5632, 22), ("k3", 1024, 5632, 2048, 0)]
L2_BYTES = 50 * 2 ** 20


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.kernels import build, qmatmul as tq
    if not torch.cuda.is_available():
        raise RuntimeError("time_gemm needs a CUDA device")
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    seeds = ((1, 2), (3, 4), (5, 6))
    res, step = {}, {"k3": 0.0, "k4": 0.0}
    for name, M, K, N, per_step in SHAPES:
        nw = 2 if name == "k4" else 1
        a = torch.randn(M, K, generator=gen, device="cuda")
        n = max(2, math.ceil(2 * L2_BYTES / (nw * K * N * 2)))
        ws = [[torch.randn(K, N, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(nw)] for _ in range(n)]

        def call(i):
            if name == "k4":
                return tq.qmatmul_swiglu_prng(a, *ws[i], seeds, "binary8")
            return tq.qmatmul_prng(a, ws[i][0], seeds[0], "binary8")
        for i in range(3):
            call(i % n)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(20):
            call(i % n)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 20
        res[f"{name} {M}x{K}x{N}"] = ms
        step[name] += ms * per_step
    out = dict(tag=args.tag, src=args.src,
               device=torch.cuda.get_device_name(0), ms=res,
               decode_step_ms=step)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
