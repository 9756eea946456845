"""Times and output digests of the rounded GEMM kernels K3', K4' and K4 at
the serving and train-step shapes, for comparing two trees of the port on
one card.

  python src/repro_torch/launch/time_gemm.py [--src DIR] [--tag NAME]
      [--routes] [--out FILE]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: the tree this file lives in), so one call can time two
checkouts in turns (A, B, B, A).  For every shape it prints ``ms`` (CUDA
events around 20 wrapper calls: device time plus the wrapper's host
cost), ``device_ms`` (the same calls replayed from a CUDA graph: device
time alone), the same two for fp32 ``torch.matmul`` on the same operands
(the unrounded yardstick: one product for K3', two for K4') and a digest
of the kernel's output on seeded N(0, 1) inputs, so two trees whose
kernels sum in the same order print the same digests.  The shapes:
tinyllama-1.1b's decode GEMMs at M = 4, 8 and 16 and its prompt's at M =
128, the train step's forward, dgrad and wgrad GEMMs (chip_smoke.py
phases 3 and 5) and a ragged one; K4' (``k4``, with the binary8 act site
of ``binary8-paper``) at M = 4, 8, 16 and 128 and at the train step's
1024 rows with residuals, and K4 fed K4''s words beside it (``bits_*``:
its times and digest, which equals K4''s).  ``--routes`` (a tree with
``qmatmul.DECODE_MAX_M``) also times both routes forced at M = 4, 8, 16
and 128, K3' on its decode shapes and K4' on its own, the measurement
behind the route threshold.  Prints one JSON line (and writes it to
``--out``).  It needs a card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

DECODE_KN = [(2048, 2048, 44), (2048, 256, 44), (5632, 2048, 22),
             (2048, 32000, 1)]
# K4''s shape (K, N, launches per decode step)
GLU_KN = (2048, 5632, 22)
# (name, M, K, N, B dtype, launches per tinyllama decode step); "k4r":
# K4' with residuals
SHAPES = ([("k3", m, k, n, "bf16", c if m == 4 else 0)
           for m in (4, 8, 16, 128) for (k, n, c) in DECODE_KN]
          + [("k4", m, GLU_KN[0], GLU_KN[1], "bf16",
              GLU_KN[2] if m == 4 else 0) for m in (4, 8, 16, 128)]
          + [("k4r", 1024, GLU_KN[0], GLU_KN[1], "bf16", 0),
             ("k3", 37, 45, 70, "bf16", 0), ("k4", 37, 45, 70, "bf16", 0)]
          + [("k3", 1024, k, n, "bf16", 0) for (k, n) in (
              (2048, 2048), (2048, 256), (256, 2048), (5632, 2048),
              (2048, 5632), (2048, 32000), (32000, 2048))]
          + [("k3", m, 1024, n, "f32", 0) for (m, n) in (
              (2048, 2048), (2048, 256), (5632, 2048), (2048, 5632),
              (2048, 32000))])
L2_BYTES = 50 * 2 ** 20
SEEDS = ((1, 2), (3, 4), (5, 6))


def time_ms(torch, fn, n, iters=20, warmup=3):
    for i in range(warmup):
        fn(i % n)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, n, iters=20, warmup=3):
    """Device ms per call: the calls captured in one CUDA graph and
    replayed between two events (chip_smoke.py's graph_ms)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i % n)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def digest(t) -> str:
    """A digest of an output, or of a tuple of outputs (h and the
    residuals)."""
    h = hashlib.sha256()
    for x in (t if isinstance(t, tuple) else (t,)):
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.kernels import build, qmatmul as tq
    if not torch.cuda.is_available():
        raise RuntimeError("time_gemm needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(M, K, N, bdt, nw):
        dt = torch.bfloat16 if bdt == "bf16" else torch.float32
        a = torch.randn(M, K, generator=gen, device="cuda")
        n = max(2, math.ceil(2 * L2_BYTES / (nw * K * N * dt.itemsize)))
        ws = [[(torch.randn(K, N, generator=gen, device="cuda")
                / math.sqrt(K)).to(dt) for _ in range(nw)] for _ in range(n)]
        return a, ws, n

    from repro_torch.core.prng import int32_words
    from repro_torch.core.rounding import spec
    from repro_torch.kernels import common as tc
    act = spec("binary8", "sr")

    def measure(name, M, K, N, bdt, yardstick=True):
        glu = name in ("k4", "k4r")
        kw = dict(act_spec=act, residuals=name == "k4r")
        nw = 2 if glu else 1
        a, ws, n = operands(M, K, N, bdt, nw)

        def call(i):
            if glu:
                return tq.qmatmul_swiglu_prng(a, *ws[i], SEEDS, "binary8",
                                              **kw)
            return tq.qmatmul_prng(a, ws[i][0], SEEDS[0], "binary8")
        row = dict(digest=digest(call(0)), ms=time_ms(torch, call, n),
                   device_ms=graph_ms(torch, call, n))
        if glu:
            # K4 fed the words K4' draws, as int32 bit patterns
            bits = [int32_words(tc.counter_bits_reduced(
                w[0], w[1], (M, N), 32, stream=st, device="cuda"))
                for w, st in zip(SEEDS, (0, 0, 1))]

            def call_bits(i):
                return tq.qmatmul_swiglu(a, *ws[i], bits[0], bits[1],
                                         "binary8", act_bits=bits[2], **kw)
            row.update(bits_digest=digest(call_bits(0)),
                       bits_ms=time_ms(torch, call_bits, n),
                       bits_device_ms=graph_ms(torch, call_bits, n))
        if yardstick:
            w32 = [[w.float() for w in ws_] for ws_ in ws]

            def lib(i):
                return [a @ w for w in w32[i]]
            row.update(library_ms=time_ms(torch, lib, n),
                       library_device_ms=graph_ms(torch, lib, n))
            del w32
        del a, ws
        return row

    keys = ("ms", "device_ms", "library_ms", "library_device_ms",
            "bits_ms", "bits_device_ms")
    res, step = {}, {"k3": dict.fromkeys(keys, 0.0),
                     "k4": dict.fromkeys(keys, 0.0)}
    for name, M, K, N, bdt, per_step in SHAPES:
        row = measure(name, M, K, N, bdt)
        res[f"{name} {M}x{K}x{N} {bdt}"] = row
        if per_step:
            for key in keys:
                if key in row:
                    step[name][key] += row[key] * per_step
        print(f"  {name} {M}x{K}x{N} {bdt}: {json.dumps(row)}", flush=True)
    routes = {}
    if args.routes and hasattr(tq, "DECODE_MAX_M"):
        keep = tq.DECODE_MAX_M
        for M in (4, 8, 16, 128):
            for name, (K, N) in ([("k3", kn[:2]) for kn in DECODE_KN]
                                 + [("k4", GLU_KN[:2])]):
                for route, limit in (("decode", 1 << 30), ("large", 0)):
                    tq.DECODE_MAX_M = limit
                    row = measure(name, M, K, N, "bf16", yardstick=False)
                    routes[f"{name} {route} {M}x{K}x{N}"] = row
                    print(f"  route {name} {route} {M}x{K}x{N}: "
                          f"{json.dumps(row)}", flush=True)
        tq.DECODE_MAX_M = keep
    out = dict(tag=args.tag, src=args.src,
               device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               shapes=res, decode_step=step, routes=routes)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
