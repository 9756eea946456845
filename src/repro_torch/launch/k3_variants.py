"""Device times of variants of K3' on one card, for choosing the decode
route's and the large-M route's shapes by measurement: each variant is
built by ``nvcc`` from a copy of ``csrc/qmatmul_sr.cu`` with named
constants changed, held bitwise to the source as it stands (every variant
keeps the summation order) and to the GEMM contract against the plain
twin, and timed in turns (forward, then reverse order) by CUDA-graph
replay at the decode shapes (M = 4 and 8) and at six large-M shapes.

  python src/repro_torch/launch/k3_variants.py [--only NAME ...]

Prints each variant's registers and spills (ptxas) and one JSON line of
device ms per call (also written to ``chiprun_out/k3_variants.json``).  It
needs a card and the CUDA toolkit; builds go to ``build/k3_variants/`` at
the repository root.
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

ROOT = Path(__file__).resolve().parents[3]
# (M, K, N, B dtype): decode-route and large-M shapes
SHAPES = [(4, 2048, 2048, "bf16"), (4, 2048, 256, "bf16"),
          (4, 5632, 2048, "bf16"), (4, 2048, 32000, "bf16"),
          (8, 2048, 2048, "bf16"), (128, 2048, 2048, "bf16"),
          (1024, 2048, 256, "bf16"), (1024, 2048, 2048, "bf16"),
          (1024, 5632, 2048, "bf16"), (2048, 1024, 256, "f32"),
          (2048, 1024, 5632, "f32")]
L2_BYTES = 50 * 2 ** 20
# constant lines of the source the variants change
KNOBS = {"dstages": "constexpr int kDStages = 8;",
         "dwarps": "constexpr int kDWarps = 4;",
         "dstage": "constexpr int kDStage = 64;",
         "dbatch": "constexpr int kDBatch = 32;",
         "big": "constexpr int kBigRG = 2, kBigCG = 1;",
         "bk": "constexpr int kBK = 32;   // a multiple of 16"}


def variants(src: str):
    """name -> source."""
    for text in KNOBS.values():
        if text not in src:
            raise RuntimeError(f"qmatmul_sr.cu no longer holds {text!r}")

    def edit(knob, line):
        return src.replace(KNOBS[knob], line)
    return {
        "as built": src,
        "decode batch 16": edit("dbatch", "constexpr int kDBatch = 16;"),
        "decode batch 64": edit("dbatch", "constexpr int kDBatch = 64;"),
        "decode 12 stages": edit("dstages", "constexpr int kDStages = 12;"),
        "decode 2 warps": edit("dwarps", "constexpr int kDWarps = 2;"),
        "decode 8 warps": edit("dwarps", "constexpr int kDWarps = 8;"),
        "big 128x128": edit("big", "constexpr int kBigRG = 2, kBigCG = 2;"),
        "kBK 16": edit("bk", "constexpr int kBK = 16;   // a multiple of 16"),
    }


def _build(build, name: str, src: str, out: Path):
    d = out / "".join(ch if ch.isalnum() else "_" for ch in name)
    d.mkdir(parents=True, exist_ok=True)
    (d / "qmatmul_sr.cu").write_text(src)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
           str(d / "lib.so"), str(d / "qmatmul_sr.cu")]
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
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core.rounding import grid_flips
    from repro_torch.kernels import build, qmatmul as tq
    if not torch.cuda.is_available():
        raise RuntimeError("k3_variants needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    src = (build.CSRC / "qmatmul_sr.cu").read_text()
    todo = {k: v for k, v in variants(src).items()
            if args.only is None or k in args.only or k == "as built"}
    out = ROOT / "build" / "k3_variants"
    t0 = time.time()
    procs = {name: _build(build, name, s, out)
             for name, s in todo.items()}
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

    gen = torch.Generator(device="cuda").manual_seed(0)
    words = (0x9E3779B9, 0x7F4A7C15)
    res = {name: {} for name in libs}
    digests = {name: {} for name in libs}
    for M, K, N, bdt in SHAPES:
        dt = torch.bfloat16 if bdt == "bf16" else torch.float32
        a = torch.randn(M, K, generator=gen, device="cuda")
        n = max(2, math.ceil(2 * L2_BYTES / (K * N * dt.itemsize)))
        ws = [(torch.randn(K, N, generator=gen, device="cuda")
               / math.sqrt(K)).to(dt) for _ in range(n)]
        ref = tq.qmatmul_plain(a, ws[0], words, "binary8")
        key = f"{M}x{K}x{N} {bdt}"
        for name, lib in libs.items():
            build._LIBS["qmatmul_sr"] = lib
            got = tq.qmatmul_prng(a, ws[0], words, "binary8")
            flips, adjacent = grid_flips(ref, got, "binary8")
            if flips > 1e-4 * ref.numel() or not adjacent:
                raise RuntimeError(f"{name} {key}: {flips} flips")
            digests[name][key] = hashlib.sha256(
                got.cpu().numpy().tobytes()).hexdigest()[:16]
            if digests[name][key] != digests["as built"][key]:
                raise RuntimeError(f"{name} {key}: not bitwise the source "
                                   "as built")
        order = list(libs)
        for rnd, names in enumerate((order, order[::-1])):
            for name in names:
                build._LIBS["qmatmul_sr"] = libs[name]
                ms = graph_ms(torch, lambda i: tq.qmatmul_prng(
                    a, ws[i], words, "binary8"), n)
                res[name].setdefault(key, []).append(ms)
        print(f"  {key}: " + ", ".join(
            f"{name} {min(res[name][key]) * 1e3:.2f} us" for name in order),
            flush=True)
        del a, ws, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                  registers=regs, device_ms=res, digests=digests)
    line = json.dumps(report)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k3_variants.json").write_text(line + "\n")
    print(line, flush=True)
    return report


if __name__ == "__main__":
    main()
