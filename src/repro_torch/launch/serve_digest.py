"""Digests of full-size serve runs, for holding two trees of the port to
the same tokens on one card: ``serve.SERVE_RUN`` (tinyllama-1.1b, batch 4,
prompt 32, gen 16) under ``binary8-paper-attn`` (K9 once per layer per
token) and ``serve.MOE_SERVE_RUN`` (qwen3-moe-30b-a3b) under the oracle
form of ``binary8-paper`` (K3, K8, K1), each from its seeded weights and
prompts.

  python src/repro_torch/launch/serve_digest.py [--src DIR] [--tag NAME]
      [--repeat N] [--dense-only]

``--src`` names the ``src`` directory whose ``repro_torch`` runs (default:
the tree this file lives in).  Prints one JSON line: per run a digest of
the tokens and one of the logits' bits (two trees whose digests agree
gave the same bits), the first row's tokens and decode tok/s.
``--repeat N`` runs each N times (the digests must agree) and lists every
run's decode tok/s; ``--dense-only`` leaves out the MoE run.  It needs a
card (the MoE run holds ~59 GiB of it).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import sys
from pathlib import Path


def _digest(torch, t) -> str:
    t = t.contiguous()
    if t.dtype == torch.float32:
        t = t.view(torch.int32)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--dense-only", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.launch import serve
    from repro_torch.precision import get_policy
    if not torch.cuda.is_available():
        raise RuntimeError("serve_digest needs a CUDA device")
    oracle = dataclasses.replace(get_policy("binary8-paper"), oracle=True)
    runs = {"tinyllama-1.1b binary8-paper-attn": (serve.SERVE_RUN,
                                                  "binary8-paper-attn"),
            "qwen3-moe-30b-a3b oracle binary8-paper": (serve.MOE_SERVE_RUN,
                                                       oracle)}
    if args.dense_only:
        runs = {k: v for k, v in runs.items() if not k.startswith("qwen")}
    res = {}
    for name, (run, policy) in runs.items():
        rates = []
        for _ in range(args.repeat):
            out = serve.run(**run, gemm_policy=policy, device="cuda")
            row = dict(tokens=_digest(torch, out["tokens"]),
                       logits=_digest(torch, out["logits"].float()),
                       sample=out["tokens"][0].tolist())
            if name in res and row != {k: res[name][k] for k in row}:
                raise RuntimeError(f"{name}: the repeats' bits differ")
            res[name] = row
            rates.append(out["decode_tokps"])
            del out
            gc.collect()
            torch.cuda.empty_cache()
        res[name]["decode_tokps"] = rates[0] if len(rates) == 1 else rates
    line = dict(tag=args.tag, src=args.src,
                device=torch.cuda.get_device_name(0), runs=res)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
