"""Times of variants of the update kernels' trainer instances on one
card, for choosing their launch shape by measurement: each variant is
built by ``nvcc`` from a copy of ``csrc/fused_qupdate.cu`` with one edit
(all builds at once), checked bitwise against the source as it stands,
and timed in turns (each variant twice, in forward then reverse order)
with CUDA events over the 1,100,048,384 tinyllama-1.1b parameters:
``--kernel k5`` (the default) K5 in ``train.ADAM_RUN``'s case, ``--kernel
k2`` K2' and K2 under ``train.PAPER_RUN``'s config.

  python src/repro_torch/launch/k5_variants.py [--kernel k5|k2]

Prints each variant's registers and spills (ptxas) and one JSON line of
ms per call.  It needs a card and the CUDA toolkit; builds go to
``build/k5_variants/`` at the repository root.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
KERNEL_HEAD = ("__global__ void __launch_bounds__(kThreads)\n"
               "fused_qadam_prng_kernel(")
IN_FLIGHT = "constexpr int kInFlight = 1;"


K2_HEAD = ("__global__ void __launch_bounds__(kK2Threads)\n"
           "fused_qupdate_kernel(")
K2_THREADS = "constexpr int kK2Threads = 512;"
K2_PRNG_BLOCKS = "constexpr int64_t kK2PrngBlocks = 132 * 64;"
K2_BITS_BLOCKS = "constexpr int64_t kK2BitsBlocks = 0x7FFFFFFF;"


def _check_holds(src: str, texts) -> None:
    for text in texts:
        if text not in src:
            raise RuntimeError(f"fused_qupdate.cu no longer holds {text!r}")


def variants(src: str):
    """K5's: name -> source: the kernel as it stands, two groups in flight
    per thread, and at least 6 resident blocks per SM (fewer registers)."""
    _check_holds(src, (KERNEL_HEAD, IN_FLIGHT))
    return {
        "as built (one group in flight)": src,
        "two groups in flight": src.replace(
            IN_FLIGHT, "constexpr int kInFlight = 2;"),
        "__launch_bounds__(256, 6)": src.replace(
            KERNEL_HEAD, KERNEL_HEAD.replace("(kThreads)", "(kThreads, 6)")),
    }


def k2_variants(src: str):
    """K2''s and K2's: the block's threads and each kernel's cap on the
    grid-stride loop's blocks (none: one group per thread)."""
    _check_holds(src, (K2_HEAD, K2_THREADS, K2_PRNG_BLOCKS, K2_BITS_BLOCKS))

    def edit(text, old, value):
        return text.replace(old, old.replace(old.split(" = ")[1],
                                             f"{value};"))
    return {
        "as built (512 threads; K2' 132 x 64 blocks, K2 one group per "
        "thread)": src,
        "256 threads": edit(src, K2_THREADS, 256),
        "K2' 132 x 256 blocks": edit(src, K2_PRNG_BLOCKS, "132 * 256"),
        "K2' one group per thread": edit(src, K2_PRNG_BLOCKS, "0x7FFFFFFF"),
        "K2 132 x 64 blocks": edit(src, K2_BITS_BLOCKS, "132 * 64"),
    }


class _Lib:
    """Stands in for ``kernels.build`` so the wrapper loads a variant."""

    def __init__(self, lib):
        self.lib = lib

    def load(self, name):
        return self.lib


def _dir(out: Path, name: str) -> Path:
    return out / "".join(ch if ch.isalnum() else "_" for ch in name)


def _build_all(torch_build, sources, out: Path):
    """name -> (library, ptxas lines), one nvcc per variant, all at once."""
    procs = {}
    for name, src in sources.items():
        d = _dir(out, name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "fused_qupdate.cu").write_text(src)
        cmd = [torch_build._nvcc(), *torch_build.NVCC_FLAGS, "-I",
               str(torch_build.CSRC), "-o", str(d / "lib.so"),
               str(d / "fused_qupdate.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        built[name] = (ctypes.CDLL(str(_dir(out, name) / "lib.so")), regs)
    return built


def _k5_calls(torch, tfu):
    """K5's case: name -> a call of the wrapper."""
    from repro_torch.core.rounding import parse_spec
    from repro_torch.kernels import common
    from repro_torch.launch.time_adam import N_PARAMS, SEED
    from repro_torch.launch.train import ADAM_RUN, rounding_config
    from repro_torch.optim import qadam
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = N_PARAMS
    x = torch.randn(n, generator=gen, device=dev) * 0.02
    g = torch.randn(n, generator=gen, device=dev) * 0.3
    spec = parse_spec(ADAM_RUN["moments_spec"])
    rn = parse_spec(f"{spec.fmt}-rn")
    m = torch.cat([common.pack_block(rn(0.1 * gi), spec.fmt)
                   for gi in g.split(1 << 26)])
    v = torch.cat([common.pack_block(rn(0.05 * gi * gi + 1e-6), spec.fmt)
                   for gi in g.split(1 << 26)])
    cfg = rounding_config(ADAM_RUN["rounding_kind"], ADAM_RUN["fmt"],
                          ADAM_RUN["eps"])
    lr = ADAM_RUN["lr"]
    scal = qadam(lr=lr).scalars(lr, 3)
    kw = dict(m_spec=spec, v_spec=spec, b1=0.9, b2=0.999, packed=True)
    return {"k5": lambda: tfu.fused_qadam_prng(x, g, m, v, scal, SEED, cfg,
                                               **kw)}


def _k2_calls(torch, tfu):
    """K2' and K2 under train.PAPER_RUN's config: name -> a call."""
    from repro_torch.launch.time_adam import N_PARAMS, SEED, T_K2
    from repro_torch.launch.train import PAPER_RUN, rounding_config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = N_PARAMS
    x = torch.randn(n, generator=gen, device=dev) * 0.02
    g = torch.randn(n, generator=gen, device=dev) * 0.3
    bits3 = torch.randint(-2 ** 31, 2 ** 31, (3, n), generator=gen,
                          device=dev, dtype=torch.int32)
    cfg = rounding_config(PAPER_RUN["rounding_kind"], PAPER_RUN["fmt"],
                          PAPER_RUN["eps"])
    return {"k2'": lambda: (tfu.fused_qupdate_prng(x, g, T_K2, SEED, cfg),),
            "k2": lambda: (tfu.fused_qupdate(x, g, T_K2, bits3, cfg),)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("k5", "k2"), default="k5")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as tfu
    if not torch.cuda.is_available():
        raise RuntimeError("k5_variants needs a CUDA device")
    src = (build.CSRC / "fused_qupdate.cu").read_text()
    out = ROOT / "build" / "k5_variants"
    make = k2_variants if args.kernel == "k2" else variants
    built = _build_all(build, make(src), out)
    for name, (_, regs) in built.items():
        print(name, regs, flush=True)
    calls = (_k2_calls if args.kernel == "k2" else _k5_calls)(torch, tfu)
    real = tfu.build

    def call(name, kernel):
        tfu.build = _Lib(built[name][0])
        try:
            return calls[kernel]()
        finally:
            tfu.build = real

    names = list(built)
    for kernel in calls:
        ref = call(names[0], kernel)
        for name in names[1:]:
            got = call(name, kernel)
            torch.cuda.synchronize()
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       if a.dtype == torch.float32 else torch.equal(a, b)
                       for a, b in zip(ref, got)):
                raise RuntimeError(f"{name}: {kernel} not bitwise equal to "
                                   "the source")
            del got
        del ref
    res = {f"{kernel} {name}": [] for kernel in calls for name in names}
    for name in names + names[::-1]:
        for kernel in calls:
            for _ in range(2):
                call(name, kernel)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call(name, kernel)
            end.record()
            torch.cuda.synchronize()
            res[f"{kernel} {name}"].append(start.elapsed_time(end) / 10)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          kernel=args.kernel, ms=res)), flush=True)
    return res


if __name__ == "__main__":
    main()
