"""CUDA-event times of K5, the fused QAdam step, over the 1,100,048,384
tinyllama-1.1b parameters in ``train.ADAM_RUN``'s case (bf16-sr moment
codes, the rn / sr / signed-SRe binary8 chain, step 3 at its learning
rate), and of ``torch.optim.Adam(fused=True)`` over as many float32
parameters (an unrounded yardstick), for comparing two trees of the port
on one card.

  python src/repro_torch/launch/time_adam.py [--src DIR] [--tag NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the tree this file lives in), so one call can time two
checkouts in turns (A, B, B, A).  Prints one JSON line of ms per call.
It needs a card (about 30 GB of its memory).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

N_PARAMS = 1_100_048_384      # tinyllama-1.1b
SEED = (0x1234ABCD, 0x0BADF00D)


def _time(torch, fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.core.rounding import parse_spec
    from repro_torch.kernels import build, common
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.launch.train import ADAM_RUN, rounding_config
    from repro_torch.optim import qadam
    if not torch.cuda.is_available():
        raise RuntimeError("time_adam needs a CUDA device")
    build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = N_PARAMS
    x = torch.randn(n, generator=gen, device=dev) * 0.02
    g = torch.randn(n, generator=gen, device=dev) * 0.3
    spec = parse_spec(ADAM_RUN["moments_spec"])
    rn = parse_spec(f"{spec.fmt}-rn")
    # non-zero moment codes, made 2**26 elements at a time
    m = torch.cat([common.pack_block(rn(0.1 * gi), spec.fmt)
                   for gi in g.split(1 << 26)])
    v = torch.cat([common.pack_block(rn(0.05 * gi * gi + 1e-6), spec.fmt)
                   for gi in g.split(1 << 26)])
    cfg = rounding_config(ADAM_RUN["rounding_kind"], ADAM_RUN["fmt"],
                          ADAM_RUN["eps"])
    lr = ADAM_RUN["lr"]
    scal = qadam(lr=lr).scalars(lr, 3)
    res = {f"k5 n={n} bf16-sr codes": _time(
        torch, lambda: tfu.fused_qadam_prng(
            x, g, m, v, scal, SEED, cfg, m_spec=spec, v_spec=spec, b1=0.9,
            b2=0.999, packed=True))}
    del m, v
    torch.cuda.empty_cache()
    p = torch.nn.Parameter(x)
    p.grad = g
    adam = torch.optim.Adam([p], lr=lr, fused=True)
    res["torch.optim.Adam(fused=True) float32"] = _time(torch, adam.step)
    out = dict(tag=args.tag, src=args.src,
               device=torch.cuda.get_device_name(0), ms=res)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
