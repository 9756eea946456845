"""Device times of variants of K3', K4' or K8' on one card, for choosing
the routes' shapes by measurement: each variant is built by ``nvcc`` from a
copy of the kernel's source (``csrc/qmatmul_sr.cu`` for K3',
``csrc/qmatmul_swiglu_sr.cu`` and its ``qmatmul_swiglu.cuh`` for K4' (the
silu instance), ``csrc/qmatmul_batched_sr.cu`` for
K8') and of the routes' shared header ``csrc/gemm_routes.cuh`` with named
constants changed, held bitwise to the sources as they stand (every
variant keeps the summation order) and to the GEMM contract against the
plain twin, and timed in turns (forward, then reverse order) by
CUDA-graph replay at the decode shapes (M = 4 and 8; for K8' the MoE
path's 128 experts at M = 1 and a whole prompt's M = 10) and at the large-M
shapes.

  python src/repro_torch/launch/k3_variants.py [--kernel k3|k4|k8]
      [--only NAME ...]

Prints each variant's registers and spills (ptxas) and one JSON line of
device ms per call (also written to ``chiprun_out/k3_variants.json``, or
``k4_variants.json``, ``k8_variants.json``).  It needs a card and the
CUDA toolkit; builds go to ``build/k3_variants/`` at the repository root.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[3]
HEADER = "gemm_routes.cuh"
GLU_HEADER = "qmatmul_swiglu.cuh"     # K4''s routes and constants
# per kernel: its source and (M, K, N, B dtype) decode-route and large-M
# shapes (K4' with residuals at the train step's 1024 rows)
KERNELS = {
    "k3": ("qmatmul_sr.cu", [
        (4, 2048, 2048, "bf16"), (4, 2048, 256, "bf16"),
        (4, 5632, 2048, "bf16"), (4, 2048, 32000, "bf16"),
        (8, 2048, 2048, "bf16"), (128, 2048, 2048, "bf16"),
        (1024, 2048, 256, "bf16"), (1024, 2048, 2048, "bf16"),
        (1024, 5632, 2048, "bf16"), (2048, 1024, 256, "f32"),
        (2048, 1024, 5632, "f32")]),
    "k4": ("qmatmul_swiglu_sr.cu", [
        (4, 2048, 5632, "bf16"), (8, 2048, 5632, "bf16"),
        (16, 2048, 5632, "bf16"), (128, 2048, 5632, "bf16"),
        (1024, 2048, 5632, "bf16")]),
    # (E, M, K, N) with bf16 experts
    "k8": ("qmatmul_batched_sr.cu", [
        (128, 1, 2048, 768), (128, 1, 768, 2048), (128, 10, 2048, 768),
        (128, 10, 768, 2048), (128, 16, 2048, 768)]),
}
L2_BYTES = 50 * 2 ** 20
# constant lines the variants change: knob -> (file, line)
KNOBS = {"dwarps": (HEADER, "constexpr int kDWarps = 4;"),
         "dstage": (HEADER, "constexpr int kDStage = 64;"),
         "dbatch": (HEADER, "constexpr int kDBatch = 32;"),
         "bk": (HEADER, "constexpr int kBK = 32;   // a multiple of 16"),
         "wave": (HEADER, "constexpr long kWaveTiles = 120;"),
         "dstages": ("qmatmul_sr.cu", "constexpr int kDecStages = 8;"),
         "big": ("qmatmul_sr.cu", "constexpr int kBigRG = 2, kBigCG = 1;"),
         "glu_dstages": (GLU_HEADER, "constexpr int kDecStages = 4;"),
         "glu_big": (GLU_HEADER,
                     "constexpr int kBigRG = 1, kBigMinBlocks = 3;"),
         "glu_stages": (GLU_HEADER,
                        "constexpr int kBigStages = 3, kSmallStages = 6;"),
         "swarps": ("qmatmul_batched_sr.cu",
                    "constexpr int kSWarps = 4;                    // warps "
                    "per block"),
         "sk": ("qmatmul_batched_sr.cu",
                "constexpr int kSK = 32;                       // k rows per "
                "stage"),
         "sstages": ("qmatmul_batched_sr.cu",
                     "constexpr int kSStages = 3;                   // "
                     "stages in the ring")}


def variants(kernel: str, srcs):
    """name -> {file: text} for ``kernel``'s variants."""
    for f, text in KNOBS.values():
        if f in srcs and text not in srcs[f]:
            raise RuntimeError(f"{f} no longer holds {text!r}")

    def edit(*changes):
        out = dict(srcs)
        for knob, line in changes:
            f, text = KNOBS[knob]
            out[f] = out[f].replace(text, line)
        return out
    if kernel == "k8":
        def knob(name, value):
            text = KNOBS[name][1]
            head, tail = text.split(" = ", 1)
            return (name, f"{head} = {value};{tail.split(';', 1)[1]}")
        return {
            "as built": srcs,
            "2 warps": edit(knob("swarps", 2)),
            "k 16": edit(knob("sk", 16)),
            "k 64": edit(knob("sk", 64)),
            "4 stages": edit(knob("sstages", 4)),
            "2 warps 4 stages": edit(knob("swarps", 2), knob("sstages", 4)),
        }
    if kernel == "k3":
        return {
            "as built": srcs,
            "decode batch 16": edit(("dbatch", "constexpr int kDBatch = 16;")),
            "decode batch 64": edit(("dbatch", "constexpr int kDBatch = 64;")),
            "decode 12 stages": edit(("dstages",
                                      "constexpr int kDecStages = 12;")),
            "decode 6 stages": edit(("dstages",
                                     "constexpr int kDecStages = 6;")),
            "decode 2 warps": edit(("dwarps", "constexpr int kDWarps = 2;")),
            "decode 8 warps": edit(("dwarps", "constexpr int kDWarps = 8;")),
            "big 128x128": edit(("big",
                                 "constexpr int kBigRG = 2, kBigCG = 2;")),
            "kBK 16": edit(("bk", "constexpr int kBK = 16;   // a multiple "
                            "of 16"))}

    def dec(n):
        return ("glu_dstages", f"constexpr int kDecStages = {n};")

    def big(stages, minb=3, rg=1):
        return [("glu_stages", f"constexpr int kBigStages = {stages}, "
                 "kSmallStages = 6;"),
                ("glu_big", f"constexpr int kBigRG = {rg}, kBigMinBlocks = "
                 f"{minb};")]
    return {
        "as built": srcs,
        "decode 8 stages": edit(dec(8)),
        "decode 6 stages": edit(dec(6)),
        "decode 2 warps": edit(("dwarps", "constexpr int kDWarps = 2;")),
        "decode batch 16": edit(("dbatch", "constexpr int kDBatch = 16;")),
        "big 4 stages 2 blocks": edit(*big(4, 2)),
        "big 3 stages 2 blocks": edit(*big(3, 2)),
        "big 4 stages": edit(*big(4)),
        "big 128 rows": edit(*big(3, 1, 2)),
    }


def _build(build, name: str, kernel: str, srcs, out: Path):
    d = out / kernel / "".join(ch if ch.isalnum() else "_" for ch in name)
    d.mkdir(parents=True, exist_ok=True)
    for f, text in srcs.items():
        (d / f).write_text(text)
    main = KERNELS[kernel][0]
    # the copy's own header is found first (the including file's
    # directory); rounding.cuh from the source tree
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
           str(d / "lib.so"), str(d / main)]
    return d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)


def graph_ms(torch, fn, n, iters=20, warmup=3):
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k3")
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core.rounding import grid_flips, spec
    from repro_torch.kernels import build, qmatmul as tq
    if not torch.cuda.is_available():
        raise RuntimeError("k3_variants needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    main_src, shapes = KERNELS[args.kernel]
    lib_name = main_src[:-len(".cu")]
    files = (main_src, HEADER) + ((GLU_HEADER,) if args.kernel == "k4"
                                  else ())
    srcs = {f: (build.CSRC / f).read_text() for f in files}
    todo = {k: v for k, v in variants(args.kernel, srcs).items()
            if args.only is None or k in args.only or k == "as built"}
    out = ROOT / "build" / "k3_variants"
    t0 = time.time()
    procs = {name: _build(build, name, args.kernel, v, out)
             for name, v in todo.items()}
    libs, regs = {}, {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(d / "lib.so"))
        regs[name] = [ln.split("info    :")[-1].strip()
                      for ln in log.splitlines() if "Used" in ln]
        print(f"  {name}: {regs[name]}", flush=True)
    print(f"  built {len(libs)} variants in {time.time() - t0:.1f} s",
          flush=True)

    glu = args.kernel == "k4"
    k8 = args.kernel == "k8"
    act = spec("binary8", "sr")
    gen = torch.Generator(device="cuda").manual_seed(0)
    words = (0x9E3779B9, 0x7F4A7C15)
    seeds = (words, (0x3C6EF372, 0xA54FF53A), (0x510E527F, 0x9B05688C))
    res = {name: {} for name in libs}
    digests = {name: {} for name in libs}
    for shape in shapes:
        if k8:
            E, M, K, N = shape
            bdt, lead = "bf16", (E,)
        else:
            (M, K, N, bdt), E, lead = shape, 1, ()
        dt = torch.bfloat16 if bdt == "bf16" else torch.float32
        nw = 2 if glu else 1
        kw = dict(act_spec=act, residuals=M >= 1024)
        a = torch.randn(*lead, M, K, generator=gen, device="cuda")
        n = max(2, math.ceil(2 * L2_BYTES / (E * nw * K * N * dt.itemsize)))
        ws = [[(torch.randn(*lead, K, N, generator=gen, device="cuda")
                / math.sqrt(K)).to(dt) for _ in range(nw)] for _ in range(n)]
        e_seeds = np.random.default_rng(E).integers(0, 2 ** 32, (E, 2),
                                                    dtype=np.int64)

        def call(i):
            if k8:
                return tq.qmatmul_batched_prng(a, ws[i][0], e_seeds,
                                               "binary8")
            if glu:
                return tq.qmatmul_swiglu_prng(a, *ws[i], seeds, "binary8",
                                              residuals=True, act_spec=act)
            return tq.qmatmul_prng(a, ws[i][0], words, "binary8")

        def timed(i):
            if k8:
                return call(i)
            if glu:
                return tq.qmatmul_swiglu_prng(a, *ws[i], seeds, "binary8",
                                              **kw)
            return tq.qmatmul_prng(a, ws[i][0], words, "binary8")
        if glu:       # the rounded branches hold the GEMM contract
            ref = tq.qmatmul_swiglu_plain(a, *ws[0], seeds, "binary8",
                                          act_spec=act, residuals=True)[1]
        elif k8:
            ref = tq.qmatmul_batched_plain(a, ws[0][0], e_seeds, "binary8")
        else:
            ref = tq.qmatmul_plain(a, ws[0][0], words, "binary8")
        key = f"{E}x{M}x{K}x{N} {bdt}" if k8 else f"{M}x{K}x{N} {bdt}"
        for name, lib in libs.items():
            build._LIBS[lib_name] = lib
            got = call(0)
            outs = got if isinstance(got, tuple) else (got,)
            flips, adjacent = grid_flips(ref, outs[1] if glu else outs[0],
                                         "binary8")
            if flips > 1e-4 * ref.numel() or not adjacent:
                raise RuntimeError(f"{name} {key}: {flips} flips")
            h = hashlib.sha256()
            for o in outs:
                h.update(o.cpu().numpy().tobytes())
            digests[name][key] = h.hexdigest()[:16]
            if digests[name][key] != digests["as built"][key]:
                raise RuntimeError(f"{name} {key}: not bitwise the source "
                                   "as built")
        order = list(libs)
        for rnd, names in enumerate((order, order[::-1])):
            for name in names:
                build._LIBS[lib_name] = libs[name]
                ms = graph_ms(torch, timed, n)
                res[name].setdefault(key, []).append(ms)
        print(f"  {key}: " + ", ".join(
            f"{name} {min(res[name][key]) * 1e3:.2f} us" for name in order),
            flush=True)
        del a, ws, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                  kernel=args.kernel, registers=regs, device_ms=res,
                  digests=digests)
    line = json.dumps(report)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"{args.kernel}_variants.json").write_text(
        line + "\n")
    print(line, flush=True)
    return report


if __name__ == "__main__":
    main()
