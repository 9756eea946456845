"""CUDA-event times of the rounded attention kernels that share the forward
kernel body: K9 (decode) at the serve cell's shape, K6 (training forward)
at the train step's, and K10 (paged decode) at the engine's decode shape
where the tree has it, for comparing two trees of the port on one card.

  python src/repro_torch/launch/time_attention.py [--src DIR] [--tag NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the tree this file lives in), so one call can time two
checkouts in turns (A, B, B, A).  Prints one JSON line of ms per call.
It needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _time(torch, fn, iters=50, warmup=5):
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
    import numpy as np
    import torch
    from repro_torch.core.rounding import parse_spec
    from repro_torch.kernels import build, common
    from repro_torch.kernels import flash_attention as tfa
    if not torch.cuda.is_available():
        raise RuntimeError("time_attention needs a CUDA device")
    build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = [parse_spec("binary8-sr")] * 3
    d = 64
    res = {}
    # K9: batch 4 x 4 kv heads, G = 8, S_max = length = 48, e4m3 codes
    seeds = np.random.default_rng(0).integers(0, 2 ** 32, (16, 6),
                                              dtype=np.uint64)
    q = torch.randn((16, 8, d), generator=gen, device=dev)
    codes = [common.pack_block(parse_spec("e4m3-rn")(torch.randn(
        (16, 48, d), generator=gen, device=dev)), "e4m3") for _ in range(2)]
    res["k9 B.KV=16 length 48"] = _time(torch, lambda: tfa.flash_decode(
        q, *codes, seeds, 48, specs, scale=d ** -0.5, kv_fmt="e4m3"))
    # K6: batch 4 x 32 heads (4 kv), S = 256, causal, one block
    seeds6 = np.random.default_rng(1).integers(0, 2 ** 32, (128, 6),
                                               dtype=np.uint64)
    q6 = torch.randn((128, 256, d), generator=gen, device=dev)
    k6, v6 = (torch.randn((16, 256, d), generator=gen, device=dev)
              for _ in range(2))
    res["k6 B.H=128 S=256"] = _time(torch, lambda: tfa.flash_fwd(
        q6, k6, v6, seeds6, specs, scale=d ** -0.5, n_heads=32, n_kv=4,
        causal=True, q_block=1024, kv_block=1024), iters=10, warmup=2)
    if hasattr(tfa, "flash_decode_paged"):
        # K10: 4 slots x 4 kv heads, pages of 64, n_max 4, lengths 80
        pages = [common.pack_block(parse_spec("e4m3-rn")(torch.randn(
            (17 * 4, 64, d), generator=gen, device=dev)), "e4m3")
            for _ in range(2)]
        tables = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0],
                               [7, 8, 0, 0]], dtype=torch.int32, device=dev)
        lengths = torch.full((4,), 80, dtype=torch.int32, device=dev)
        res["k10 B.KV=16 page 64 lengths 80"] = _time(
            torch, lambda: tfa.flash_decode_paged(
                q, *pages, seeds, lengths, tables, specs, scale=d ** -0.5,
                n_kv=4, kv_fmt="e4m3"))
    out = dict(tag=args.tag, src=args.src,
               device=torch.cuda.get_device_name(0), ms=res)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
