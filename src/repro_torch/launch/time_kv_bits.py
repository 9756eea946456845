"""Host-clock times of the KV-store rounding bits, for comparing two trees
of the port on one card: ``precision.attention.round_kv`` (the fixed-batch
serve path's k/v append, one layer and decode step) and
``serving.paged_cache.PagedKVCache.kv_bits`` (the engine's, every layer's
bits of one decode call drawn at once), each at tinyllama-1.1b's decode
shape (batch 4, 4 kv heads of 64) and gemma-7b's (batch 4, 16 kv heads of
256), under the e4m3-sr cache spec.

  python src/repro_torch/launch/time_kv_bits.py [--src DIR] [--tag NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the tree this file lives in), so one call can time two
checkouts in turns (A, B, B, A).  Each time is milliseconds per call by
the host's clock from the call to the card having finished it (these
draws cost host time: numpy on the host, or the launches of many small
kernels on the card).  Prints one JSON line with the times and a digest of
each call's output (two trees whose digests agree draw the same bits).
It needs a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

# (name, layers, kv heads, head dim) at batch 4, one token
SHAPES = (("tinyllama-1.1b", 22, 4, 64), ("gemma-7b", 28, 16, 256))
BATCH = 4


def _host_ms(torch, fn, iters=30, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def _digest(torch, t) -> str:
    """Of the values: bits as int64 whatever integer dtype holds them."""
    t = t.detach().cpu()
    if not t.is_floating_point():
        t = t.to(torch.int64)
    raw = t.contiguous().view(-1).view(torch.uint8).numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from repro_torch.core.rounding import parse_spec
    from repro_torch.precision import attention as PA
    from repro_torch.serving.paged_cache import PagedKVCache
    if not torch.cuda.is_available():
        raise RuntimeError("time_kv_bits needs a CUDA device")
    dev = torch.device("cuda")
    spec = parse_spec("e4m3-sr")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    ms, digests = {}, {}
    for name, L, KV, d in SHAPES:
        x = torch.randn((2, BATCH, 1, KV, d), generator=gen, device=dev)
        words = (0x6A09E667, 0xBB67AE85)
        key = f"round_kv {name} (2, {BATCH}, 1, {KV}, {d})"
        ms[key] = _host_ms(torch, lambda: PA.round_kv(
            x, spec, words, pos0=40, stream=(0, 1)))
        digests[key] = _digest(torch, PA.round_kv(x, spec, words, pos0=40,
                                                  stream=(0, 1)))
        cache = PagedKVCache(
            k_pages=torch.empty((0,), device=dev),
            v_pages=torch.empty((0,), device=dev),
            tables=torch.zeros((BATCH, 4), dtype=torch.int32, device=dev),
            lengths=np.array([80, 17, 40, 3], dtype=np.int32),
            words=rng.integers(0, 2 ** 32, (L, BATCH, 2), dtype=np.int64),
            append=np.ones(BATCH, dtype=bool))

        def kv_bits():
            cache._index.clear()        # a new model call's first layer
            return cache.kv_bits(0, spec, 1, KV * d)
        key = f"kv_bits {name} {L} layers (2, {BATCH}, 1, {KV * d})"
        ms[key] = _host_ms(torch, kv_bits)
        kv_bits()
        digests[key] = _digest(torch, torch.stack(
            [cache.kv_bits(i, spec, 1, KV * d) for i in range(L)]))
    print(json.dumps(dict(tag=args.tag, src=args.src,
                          device=torch.cuda.get_device_name(0), ms=ms,
                          digest=digests)), flush=True)


if __name__ == "__main__":
    main()
