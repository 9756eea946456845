"""CUDA-event times of the update kernels over the 1,100,048,384
tinyllama-1.1b parameters, for comparing two trees of the port on one
card.

  python src/repro_torch/launch/time_adam.py [--kernel k5|k2] [--src DIR]
      [--tag NAME]

``--kernel k5`` (the default): K5, the fused QAdam step, in
``train.ADAM_RUN``'s case (bf16-sr moment codes, the rn / sr / signed-SRe
binary8 chain, step 3 at its learning rate), and
``torch.optim.Adam(fused=True)`` over as many float32 parameters (an
unrounded yardstick).  ``--kernel k2``: the eq.-8 update K2' (in-kernel
bits) and K2 (explicit bits, the three rows made on the card from a
seeded generator) under ``train.PAPER_RUN``'s config, the momentum FMA,
and the unrounded ``torch.add(x, g, alpha=-t)`` (the yardstick), each with
a digest of its output; then digests of K2' and K2 at n = 2**24 + 37
under every extra update config of ``chip_smoke.py``'s phase 4, so that
two trees whose kernels compute the same bits print the same digests.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the tree this file lives in), so one call can time two
checkouts in turns (A, B, B, A).  Prints one JSON line of ms per call.
It needs a card (about 30 GB of its memory for K5, 40 GB for K2).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

N_PARAMS = 1_100_048_384      # tinyllama-1.1b
SEED = (0x1234ABCD, 0x0BADF00D)
# K2''s step size and the momentum (train.PAPER_RUN's lr and QSGD's 0.9)
T_K2 = 0.05
MOMENTUM = 0.9
# the extra update configs of chip_smoke.py's phase 4, (grad, mul, sub)
UPDATE_CONFIGS = {
    "sr_eps-binary8": ("binary8-rn", "binary8-sr_eps-e0.1", "binary8-sr"),
    "sr-r16-binary8": ("binary8-sr-r16",) * 3,
    "rn-binary8": ("binary8-rn",) * 3,
    "signed_sr_eps-bf16": ("bf16-rn", "bf16-sr", "bf16-signed_sr_eps-e0.1"),
}
N_DIGEST = (1 << 24) + 37


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


def digest(t) -> str:
    """sha256 of a tensor's bytes, copied to the host 2**26 elements at a
    time."""
    h = hashlib.sha256()
    for part in t.reshape(-1).split(1 << 26):
        h.update(part.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_k5(torch, args):
    from repro_torch.core.rounding import parse_spec
    from repro_torch.kernels import common
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.launch.train import ADAM_RUN, rounding_config
    from repro_torch.optim import qadam
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
    return dict(ms=res)


def time_k2(torch, args):
    from repro_torch.core import gd
    from repro_torch.core.rounding import parse_spec
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.launch.train import PAPER_RUN, rounding_config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = rounding_config(PAPER_RUN["rounding_kind"], PAPER_RUN["fmt"],
                          PAPER_RUN["eps"])
    ms, digests = {}, {}
    for n in (N_PARAMS, N_DIGEST):
        x = torch.randn(n, generator=gen, device=dev) * 0.02
        g = torch.randn(n, generator=gen, device=dev) * 0.3
        bits3 = torch.randint(-2 ** 31, 2 ** 31, (3, n), generator=gen,
                              device=dev, dtype=torch.int32)
        configs = {"trainer": cfg} if n == N_PARAMS else {
            k: gd.GDRounding(*(parse_spec(s) for s in v))
            for k, v in UPDATE_CONFIGS.items()}
        for name, c in configs.items():
            runs = {"k2'": lambda: tfu.fused_qupdate_prng(x, g, T_K2, SEED,
                                                          c),
                    "k2": lambda: tfu.fused_qupdate(x, g, T_K2, bits3, c)}
            if n == N_PARAMS:
                runs["momentum_fma"] = lambda: tfu.momentum_fma(MOMENTUM, x,
                                                                g)
                runs["torch.add(x, g, alpha=-t)"] = lambda: torch.add(
                    x, g, alpha=-T_K2)
            for kernel, fn in runs.items():
                key = f"{kernel} n={n} {name}"
                if n == N_PARAMS:
                    ms[key] = _time(torch, fn)
                digests[key] = digest(fn())
        del x, g, bits3
        torch.cuda.empty_cache()
    return dict(ms=ms, digests=digests)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("k5", "k2"), default="k5")
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise RuntimeError("time_adam needs a CUDA device")
    build.build_all()
    res = (time_k2 if args.kernel == "k2" else time_k5)(torch, args)
    out = dict(tag=args.tag, src=args.src, kernel=args.kernel,
               device=torch.cuda.get_device_name(0), **res)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
