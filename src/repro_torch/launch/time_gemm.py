"""Times and output digests of the rounded GEMM kernels K3', K4' and K4 at
the serving and train-step shapes (or, with ``--kernel k8``, of the batched
expert GEMMs K8' and K8 at the MoE path's shapes), for comparing two trees
of the port on one card.

  python src/repro_torch/launch/time_gemm.py [--src DIR] [--tag NAME]
      [--kernel gemm|k8] [--arch tinyllama-1.1b|gemma-7b] [--routes]
      [--spec NAME] [--out FILE]

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
behind the route threshold.

``--arch gemma-7b``: gemma-7b's decode GEMMs instead (M = 4 and a prompt's
128: q, k, v 3072 -> 4096, o 4096 -> 3072, down 24576 -> 3072, the tied lm
head 3072 -> 256000) and K4' (and K4) at 3072 -> 24576 under each
activation of ``qmatmul.ACT_FNS`` (``k4[gelu]``: gemma's; a tree without
the activations runs silu alone), ``decode_step`` summing a gemma decode
step's launches under gelu.

``--kernel k8``: K8' (``qmatmul_batched_prng``) at qwen3-moe-30b-a3b's
expert GEMMs, 128 experts x M rows, 2048 -> 768 (gate, up) and 768 -> 2048
(down), at M = 1 (a decode step's capacity) and M = 10 (a whole-prompt
forward's: batch 4 x prompt 32 at once, top-8, factor 1.25), at M = 16, 17
and 64, and a ragged 5 x
3 x 70 x 50; K8 fed K8''s words beside it (``bits_*``; its digest equals
K8''s) and bf16 ``torch.bmm`` on the same operands (the unrounded
yardstick); ``decode_step`` and ``prefill`` sum a decode step's 144 calls
(96 at 2048 -> 768, 48 at 768 -> 2048) and a whole-prompt forward's 144
at M = 10.
With ``--routes`` (a tree with ``qmatmul.BATCHED_STREAM_MAX_M``) it also
times both routes forced at M = 1, 10, 16, 17, 24, 32, 48, 64, 96 and
128 (2048 -> 768), the measurement behind that threshold.

``--spec NAME`` (a tree with the wide instances, ``qmatmul.
gemm_instance``): at every shape K3', K4' (its GEMM and act sites under
the spec) and K8' are also timed under that canonical spec name on the
instance it takes (``spec_ms``, ``spec_device_ms``, ``spec_digest``;
e.g. 'e4m3-sr2-r16': the wide instances), and the wide instance forced
on the binary8 sr sites of the run (``wide_ms``, ``wide_device_ms``,
``wide_digest``, which equals ``digest``): the wide instance's cost
beside the first one's on the same work.

Prints one JSON line (and writes it to ``--out``).  It needs a card.
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
# gemma-7b's (--arch gemma-7b): 28 layers of q, k, v, o and down through
# K3', the fused GeGLU through K4', the tied lm head
GEMMA_DECODE_KN = [(3072, 4096, 3 * 28), (4096, 3072, 28),
                   (24576, 3072, 28), (3072, 256000, 1)]
GEMMA_GLU_KN = (3072, 24576, 28)
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
# K8' shapes (E, M, K, N, launches per decode step, per prompt)
MOE_LAYERS = 48
K8_SHAPES = ([(128, m, 2048, 768, 2 * MOE_LAYERS if m == 1 else 0,
               2 * MOE_LAYERS if m == 10 else 0) for m in (1, 10, 16, 17, 64)]
             + [(128, m, 768, 2048, MOE_LAYERS if m == 1 else 0,
                 MOE_LAYERS if m == 10 else 0) for m in (1, 10)]
             + [(5, 3, 70, 50, 0, 0)])
K8_ROUTE_M = (1, 10, 16, 17, 24, 32, 48, 64, 96, 128)
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
    ap.add_argument("--kernel", choices=("gemm", "k8"), default="gemm")
    ap.add_argument("--arch", choices=("tinyllama-1.1b", "gemma-7b"),
                    default="tinyllama-1.1b")
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--spec", default=None)
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
    if args.kernel == "k8":
        out = dict(tag=args.tag, src=args.src,
                   device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                   **time_k8(torch, tq, args.routes, args.spec))
        return _emit(out, args.out)
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
    wide = _wide_spec(tq, args.spec)

    def measure(name, M, K, N, bdt, yardstick=True):
        glu = name.startswith("k4")
        kw = dict(act_spec=act, residuals=name == "k4r")
        if "[" in name:             # k4[act]: K4' under that activation
            kw["act"] = name[3:-1]
        nw = 2 if glu else 1
        a, ws, n = operands(M, K, N, bdt, nw)

        def call(i):
            if glu:
                return tq.qmatmul_swiglu_prng(a, *ws[i], SEEDS, "binary8",
                                              **kw)
            return tq.qmatmul_prng(a, ws[i][0], SEEDS[0], "binary8")
        row = dict(digest=digest(call(0)), ms=time_ms(torch, call, n),
                   device_ms=graph_ms(torch, call, n))
        if wide is not None:
            def call_spec(i, forced=False):
                s = act if forced else wide
                if glu:
                    return tq.qmatmul_swiglu_prng(
                        a, *ws[i], SEEDS, s.fmt, s.mode,
                        **dict(kw, act_spec=s), rand_bits=s.rand_bits,
                        eps=s.eps)
                return tq.qmatmul_prng(a, ws[i][0], SEEDS[0], s.fmt, s.mode,
                                       s.rand_bits, eps=s.eps)
            row.update(_spec_rows(torch, tq, call_spec, n))
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
            "bits_ms", "bits_device_ms") + _SPEC_KEYS
    shapes = SHAPES
    if args.arch == "gemma-7b":
        acts = sorted(getattr(tq, "ACT_FNS", {"silu": None}))
        K4, N4, c4 = GEMMA_GLU_KN
        shapes = ([("k3", m, k, n, "bf16", c if m == 4 else 0)
                   for m in (4, 128) for (k, n, c) in GEMMA_DECODE_KN]
                  + [(f"k4[{a}]", m, K4, N4, "bf16",
                      c4 if m == 4 and a == "gelu" else 0)
                     for a in acts for m in (4, 128)])
    res, step = {}, {}
    for name, M, K, N, bdt, per_step in shapes:
        row = measure(name, M, K, N, bdt)
        res[f"{name} {M}x{K}x{N} {bdt}"] = row
        if per_step:
            acc = step.setdefault(name[:2], dict.fromkeys(keys, 0.0))
            for key in keys:
                if key in row:
                    acc[key] += row[key] * per_step
        print(f"  {name} {M}x{K}x{N} {bdt}: {json.dumps(row)}", flush=True)
    routes = {}
    if args.routes and hasattr(tq, "DECODE_MAX_M") \
            and args.arch == "tinyllama-1.1b":
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
    out = dict(tag=args.tag, src=args.src, arch=args.arch,
               device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               shapes=res, decode_step=step, routes=routes)
    return _emit(out, args.out)


# the --spec timings: under the spec, and the wide instance forced on the
# binary8 sr sites
_SPEC_KEYS = ("spec_ms", "spec_device_ms", "wide_ms", "wide_device_ms")


def _wide_spec(tq, name):
    """--spec's RoundingSpec (None without it); a tree without the wide
    instances cannot take it."""
    if name is None:
        return None
    if not hasattr(tq, "gemm_instance"):
        raise SystemExit("--spec: this tree has no wide GEMM instances")
    from repro_torch.core.rounding import parse_spec
    return parse_spec(name)


def _spec_rows(torch, tq, call, n):
    """The --spec columns of one shape: ``call(i)`` under the spec,
    ``call(i, True)`` on binary8 sr with ``tq.FORCE_WIDE`` set (the wide
    instance on the first instance's site)."""
    row = dict(spec_digest=digest(call(0)),
               spec_ms=time_ms(torch, call, n),
               spec_device_ms=graph_ms(torch, call, n))
    tq.FORCE_WIDE = True
    try:
        row.update(wide_digest=digest(call(0, True)),
                   wide_ms=time_ms(torch, lambda i: call(i, True), n),
                   wide_device_ms=graph_ms(torch, lambda i: call(i, True), n))
    finally:
        tq.FORCE_WIDE = False
    return row


def _emit(out, path):
    line = json.dumps(out)
    print(line, flush=True)
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(line + "\n")
    return out


def time_k8(torch, tq, routes, spec_name=None):
    """K8', K8 and bf16 torch.bmm at K8_SHAPES (and both K8' routes forced
    at K8_ROUTE_M): times, device times and digests; with ``spec_name``
    the --spec columns too."""
    import numpy as np
    from repro_torch.core.prng import int32_words
    from repro_torch.kernels import common as tc
    gen = torch.Generator(device="cuda").manual_seed(0)
    wide = _wide_spec(tq, spec_name)

    def measure(E, M, K, N, yardstick=True):
        seeds = np.random.default_rng(E * K + N).integers(
            0, 2 ** 32, (E, 2), dtype=np.int64)
        a = torch.randn(E, M, K, generator=gen, device="cuda")
        n = max(2, math.ceil(2 * L2_BYTES / (E * K * N * 2)))
        ws = [(torch.randn(E, K, N, generator=gen, device="cuda")
               / math.sqrt(K)).to(torch.bfloat16) for _ in range(n)]

        def call(i):
            return tq.qmatmul_batched_prng(a, ws[i], seeds, "binary8")
        bits = int32_words(tc.counter_bits_batch(seeds, (E, M, N), 32,
                                                 device="cuda"))

        def call_bits(i):
            return tq.qmatmul_batched(a, ws[i], bits, "binary8")
        row = dict(digest=digest(call(0)), ms=time_ms(torch, call, n),
                   device_ms=graph_ms(torch, call, n))
        if wide is not None:
            def call_spec(i, forced=False):
                if forced:
                    return tq.qmatmul_batched_prng(a, ws[i], seeds,
                                                   "binary8")
                return tq.qmatmul_batched_prng(a, ws[i], seeds, wide.fmt,
                                               wide.mode, wide.rand_bits,
                                               eps=wide.eps)
            row.update(_spec_rows(torch, tq, call_spec, n))
        if yardstick:
            a16 = a.to(torch.bfloat16)

            def lib(i):
                return torch.bmm(a16, ws[i])
            row.update(bits_digest=digest(call_bits(0)),
                       bits_ms=time_ms(torch, call_bits, n),
                       bits_device_ms=graph_ms(torch, call_bits, n),
                       library_ms=time_ms(torch, lib, n),
                       library_device_ms=graph_ms(torch, lib, n))
        del a, ws, bits
        return row

    keys = ("ms", "device_ms", "bits_ms", "bits_device_ms", "library_ms",
            "library_device_ms") + (_SPEC_KEYS if wide is not None else ())
    res = {}
    totals = {"decode_step": dict.fromkeys(keys, 0.0),
              "prefill": dict.fromkeys(keys, 0.0)}
    for E, M, K, N, per_step, per_prompt in K8_SHAPES:
        row = measure(E, M, K, N)
        res[f"k8 {E}x{M}x{K}x{N}"] = row
        for total, count in (("decode_step", per_step),
                             ("prefill", per_prompt)):
            for key in keys:
                totals[total][key] += row[key] * count
        print(f"  k8 {E}x{M}x{K}x{N}: {json.dumps(row)}", flush=True)
    forced = {}
    if routes and hasattr(tq, "BATCHED_STREAM_MAX_M"):
        keep = tq.BATCHED_STREAM_MAX_M
        for M in K8_ROUTE_M:
            for route, limit in (("stream", 1 << 30), ("large", 0)):
                tq.BATCHED_STREAM_MAX_M = limit
                row = measure(128, M, 2048, 768, yardstick=False)
                forced[f"k8 {route} 128x{M}x2048x768"] = row
                print(f"  route k8 {route} 128x{M}x2048x768: "
                      f"{json.dumps(row)}", flush=True)
        tq.BATCHED_STREAM_MAX_M = keep
    return dict(shapes=res, routes=forced, **totals)


if __name__ == "__main__":
    main()
