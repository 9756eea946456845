"""CUDA-event times of the latency-bound kernels, for comparing two trees
of the port on one card: the rounded attention kernels K9 (decode; its
tiled route too where the tree has one) at the serve cell's shape, K6
(training forward), K7 and K7' (backward; their first kernels too where
the tree has them as a second route) at the train step's beside SDPA's
backward alone (one forward kept: the yardstick of K7 + K7') and
K10 (paged decode) at the engine's decode shape where the tree has it,
and K1' and K1 (the SR cast, in-kernel and explicit bits; K1's generic
instance too where the tree has one) at the MoE decode path's (128, 1,
768) hidden under its spec (binary8 sr, 32-bit draws) beside a bf16 cast
of the same tensor (an unrounded yardstick).

  python src/repro_torch/launch/time_attention.py [--src DIR] [--tag NAME]
      [--arch tinyllama-1.1b|gemma-7b] [--head-dim 16|32|64|128]

``--arch gemma-7b`` times the head dim 256 instances instead: K9 at gemma's
decode shape (batch 4 x 16 kv heads, G = 1, S_max = length = 48, e4m3
codes; its tiled route too), K6 over 16 heads of 512 keys in one block,
and K10 at the engine's shape (4 slots x 16 kv heads, pages of 64,
lengths 80); K7 and K7' refuse d = 256, and K1' and K1 do not depend on
it.  ``--head-dim`` times tinyllama-1.1b's shapes at another head dim
(default 64, tinyllama's): the other compiled instances of K6's single
pass, K7, K7', K9 and K10.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the tree this file lives in), so one call can time two
checkouts in turns (A, B, B, A).  Prints one JSON line: ms per call by
CUDA events around a loop of calls (``ms``, the host's cost per call
included), by replay of the same calls captured in one CUDA graph
(``device_ms``, device time only), and a digest of each kernel's output
on the seeded inputs (``digest``: two trees whose digests agree give the
same bits).  It needs a card.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
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


def _graph(torch, fn, iters=50, warmup=5, stream=None):
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed between two CUDA events.  ``stream``: the stream to warm up
    and capture on (an autograd backward must run on its forward's)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _digest(torch, t) -> str:
    return hashlib.sha256(t.contiguous().view(torch.int32).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--arch", choices=("tinyllama-1.1b", "gemma-7b"),
                    default="tinyllama-1.1b")
    ap.add_argument("--head-dim", type=int, choices=(16, 32, 64, 128),
                    default=64)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import numpy as np
    import torch
    from repro_torch.core.prng import int32_words
    from repro_torch.core.rounding import parse_spec
    from repro_torch.kernels import build, common
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import sr_cast as tsr
    if not torch.cuda.is_available():
        raise RuntimeError("time_attention needs a CUDA device")
    build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = [parse_spec("binary8-sr")] * 3
    d = args.head_dim
    res, dev_res, digests = {}, {}, {}

    def timed(name, fn, stream=None, out=None, **kw):
        """``out``: the output to digest from ``fn``'s result (default
        the result itself)."""
        res[name] = _time(torch, fn, **kw)
        dev_res[name] = _graph(torch, fn, stream=stream, **kw)
        digests[name] = _digest(torch, (out or (lambda r: r))(fn()))

    def on_card(seed_words):    # int32 bit patterns, as the engine passes
        return torch.from_numpy(seed_words.astype(np.uint32)
                                .view(np.int32)).to(dev)
    if args.arch == "gemma-7b":
        _time_d256(torch, gen, specs, timed, on_card)
        return _emit(args, torch, res, dev_res, digests)
    # K9: batch 4 x 4 kv heads, G = 8, S_max = length = 48, e4m3 codes
    seeds = on_card(np.random.default_rng(0).integers(0, 2 ** 32, (16, 6),
                                                      dtype=np.uint64))
    q = torch.randn((16, 8, d), generator=gen, device=dev)
    codes = [common.pack_block(parse_spec("e4m3-rn")(torch.randn(
        (16, 48, d), generator=gen, device=dev)), "e4m3") for _ in range(2)]
    timed("k9 B.KV=16 length 48", lambda: tfa.flash_decode(
        q, *codes, seeds, 48, specs, scale=d ** -0.5, kv_fmt="e4m3"))
    if "kernel" in inspect.signature(tfa.flash_decode).parameters:
        timed("k9 B.KV=16 length 48, tiled route", lambda: tfa.flash_decode(
            q, *codes, seeds, 48, specs, scale=d ** -0.5, kv_fmt="e4m3",
            kernel="flash_decode_tiled"))
    # K6: batch 4 x 32 heads (4 kv), S = 256, causal, one block
    seeds6 = on_card(np.random.default_rng(1).integers(0, 2 ** 32, (128, 6),
                                                       dtype=np.uint64))
    q6 = torch.randn((128, 256, d), generator=gen, device=dev)
    k6, v6 = (torch.randn((16, 256, d), generator=gen, device=dev)
              for _ in range(2))
    kw6 = dict(scale=d ** -0.5, n_heads=32, n_kv=4, causal=True,
               q_block=1024, kv_block=1024)
    timed("k6 B.H=128 S=256", lambda: tfa.flash_fwd(
        q6, k6, v6, seeds6, specs, **kw6)[0], iters=10, warmup=2)
    # K7, K7' on the forward's residuals, beside SDPA's backward alone
    do6 = torch.randn((128, 256, d), generator=gen, device=dev)
    o6, m6, l6 = tfa.flash_fwd(q6, k6, v6, seeds6, specs, **kw6)
    dd6 = (do6 * o6).sum(-1)
    seeds7 = torch.cat([seeds6[:, :2], seeds6[:, 4:]], 1).contiguous()
    routes = {"": {}}
    if "kernel" in inspect.signature(tfa.flash_bwd_dq).parameters:
        routes[", first kernel"] = {"dq": {"kernel": "flash_bwd_dq_simple"},
                                    "dkv": {"kernel": "flash_bwd_dkv_simple"}}
    for label, kern in routes.items():
        timed(f"k7 B.H=128 S=256{label}", lambda kern=kern: tfa.flash_bwd_dq(
            q6, k6, v6, do6, m6, l6, dd6, seeds7, specs[0], specs[0], **kw6,
            **kern.get("dq", {})), iters=10, warmup=2)
        timed(f"k7' B.H=128 S=256{label}", lambda kern=kern: tfa.flash_bwd_dkv(
            q6, k6, v6, do6, m6, l6, dd6, seeds6, *specs, **kw6,
            **kern.get("dkv", {})), out=lambda r: torch.cat(r, -1), iters=10,
            warmup=2)
    qg, kg, vg = (x.view(4, -1, 256, d).detach().requires_grad_()
                  for x in (q6, k6, v6))
    do4 = do6.view(4, 32, 256, d)
    # the kept forward on a stream of its own, which its backward runs on:
    # timed and captured there
    s_bwd = torch.cuda.Stream()
    s_bwd.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s_bwd):
        o_kept = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, is_causal=True, enable_gqa=True)
        timed("sdpa backward B.H=128 S=256 (one forward kept)",
              lambda: torch.autograd.grad(o_kept, (qg, kg, vg), do4,
                                          retain_graph=True)[0],
              stream=s_bwd, iters=10, warmup=2)
    torch.cuda.current_stream().wait_stream(s_bwd)
    if hasattr(tfa, "flash_decode_paged"):
        # K10: 4 slots x 4 kv heads, pages of 64, n_max 4, lengths 80
        pages = [common.pack_block(parse_spec("e4m3-rn")(torch.randn(
            (17 * 4, 64, d), generator=gen, device=dev)), "e4m3")
            for _ in range(2)]
        tables = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0],
                               [7, 8, 0, 0]], dtype=torch.int32, device=dev)
        lengths = torch.full((4,), 80, dtype=torch.int32, device=dev)
        timed("k10 B.KV=16 page 64 lengths 80",
              lambda: tfa.flash_decode_paged(
                  q, *pages, seeds, lengths, tables, specs, scale=d ** -0.5,
                  n_kv=4, kv_fmt="e4m3"))
    # K1': the MoE decode's act-site hidden, binary8 sr, 32-bit draws
    words = (0x6A09E667, 0xBB67AE85)
    x = torch.randn((128, 1, 768), generator=gen, device=dev) * 4
    timed("k1' (128, 1, 768) binary8 sr r32",
          lambda: tsr.sr_cast_prng(x, words, "binary8"), iters=200,
          warmup=20)
    if "instance" in inspect.signature(tsr.sr_cast_prng).parameters:
        timed("k1' (128, 1, 768) binary8 sr r32, generic instance",
              lambda: tsr.sr_cast_prng(x, words, "binary8",
                                       instance="generic"), iters=200,
              warmup=20)
    # K1: the oracle act site's words, one per element by flat index
    bits = int32_words(common.counter_bits_reduced(
        *words, (x.numel(), 1), 32, device=dev).reshape(x.shape))
    timed("k1 (128, 1, 768) binary8 sr r32", lambda: tsr.sr_cast(
        x, bits, "binary8"), iters=200, warmup=20)
    if "instance" in inspect.signature(tsr.sr_cast).parameters:
        timed("k1 (128, 1, 768) binary8 sr r32, generic instance",
              lambda: tsr.sr_cast(x, bits, "binary8", instance="generic"),
              iters=200, warmup=20)
    timed("bf16 cast (128, 1, 768)", lambda: x.to(torch.bfloat16),
          iters=200, warmup=20)
    return _emit(args, torch, res, dev_res, digests)


def _emit(args, torch, res, dev_res, digests):
    out = dict(tag=args.tag, src=args.src, arch=args.arch,
               head_dim=256 if args.arch == "gemma-7b" else args.head_dim,
               device=torch.cuda.get_device_name(0), ms=res,
               device_ms=dev_res, digest=digests)
    print(json.dumps(out), flush=True)
    return out


def _time_d256(torch, gen, specs, timed, on_card):
    """gemma-7b's attention shapes at head dim 256 (``--arch gemma-7b``)."""
    import numpy as np
    from repro_torch.core.rounding import parse_spec
    from repro_torch.kernels import common
    from repro_torch.kernels import flash_attention as tfa
    dev, d = torch.device("cuda"), 256
    rng = np.random.default_rng(256)
    seeds = on_card(rng.integers(0, 2 ** 32, (64, 6), dtype=np.uint64))
    q = torch.randn((64, 1, d), generator=gen, device=dev)
    codes = [common.pack_block(parse_spec("e4m3-rn")(torch.randn(
        (64, 48, d), generator=gen, device=dev)), "e4m3") for _ in range(2)]
    for label, kern in (("", None), (", tiled route", "flash_decode_tiled")):
        timed(f"k9 d 256 B.KV=64 G=1 length 48{label}",
              lambda kern=kern: tfa.flash_decode(
                  q, *codes, seeds, 48, specs, scale=d ** -0.5,
                  kv_fmt="e4m3", kv_block=1024, kernel=kern))
    seeds6 = on_card(rng.integers(0, 2 ** 32, (16, 6), dtype=np.uint64))
    q6, k6, v6 = (torch.randn((16, 512, d), generator=gen, device=dev)
                  for _ in range(3))
    kw6 = dict(scale=d ** -0.5, n_heads=16, n_kv=16, causal=True,
               kv_block=512)
    for label, kern in (("", None), (", two-pass", "flash_fwd_two_pass")):
        timed(f"k6 d 256 B.H=16 S=512{label}",
              lambda kern=kern: tfa.flash_fwd(q6, k6, v6, seeds6, specs,
                                              kernel=kern, **kw6)[0],
              iters=10, warmup=2)
    pages = [common.pack_block(parse_spec("e4m3-rn")(torch.randn(
        (17 * 16, 64, d), generator=gen, device=dev)), "e4m3")
        for _ in range(2)]
    tables = torch.tensor([[1, 2, 0, 0], [3, 4, 0, 0], [5, 6, 0, 0],
                           [7, 8, 0, 0]], dtype=torch.int32, device=dev)
    lengths = torch.full((4,), 80, dtype=torch.int32, device=dev)
    timed("k10 d 256 B.KV=64 page 64 lengths 80",
          lambda: tfa.flash_decode_paged(
              q, *pages, seeds, lengths, tables, specs, scale=d ** -0.5,
              n_kv=16, kv_fmt="e4m3"))


if __name__ == "__main__":
    main()
