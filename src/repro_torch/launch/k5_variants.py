"""Times of variants of K5's trainer instance on one card, for choosing
its launch shape by measurement: each variant is built by ``nvcc`` from a
copy of ``csrc/fused_qupdate.cu`` with one edit, checked bitwise against
the source as it stands, and timed in turns (each variant twice, in
forward then reverse order) with CUDA events over the 1,100,048,384
tinyllama-1.1b parameters in ``train.ADAM_RUN``'s case.

  python src/repro_torch/launch/k5_variants.py

Prints each variant's registers and spills (ptxas) and one JSON line of
ms per call.  It needs a card and the CUDA toolkit; builds go to
``build/k5_variants/`` at the repository root.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
KERNEL_HEAD = ("__global__ void __launch_bounds__(kThreads)\n"
               "fused_qadam_prng_kernel(")
IN_FLIGHT = "constexpr int kInFlight = 1;"


def variants(src: str):
    """name -> source: the kernel as it stands, two groups in flight per
    thread, and at least 6 resident blocks per SM (fewer registers)."""
    for text in (KERNEL_HEAD, IN_FLIGHT):
        if text not in src:
            raise RuntimeError(f"fused_qupdate.cu no longer holds {text!r}")
    return {
        "as built (one group in flight)": src,
        "two groups in flight": src.replace(
            IN_FLIGHT, "constexpr int kInFlight = 2;"),
        "__launch_bounds__(256, 6)": src.replace(
            KERNEL_HEAD, KERNEL_HEAD.replace("(kThreads)", "(kThreads, 6)")),
    }


class _Lib:
    """Stands in for ``kernels.build`` so the wrapper loads a variant."""

    def __init__(self, lib):
        self.lib = lib

    def load(self, name):
        return self.lib


def _build(torch_build, name: str, src: str, out: Path):
    d = out / name.replace(" ", "_").replace("(", "").replace(")", "") \
        .replace(",", "")
    d.mkdir(parents=True, exist_ok=True)
    (d / "fused_qupdate.cu").write_text(src)
    cmd = [torch_build._nvcc(), *torch_build.NVCC_FLAGS, "-I",
           str(torch_build.CSRC), "-o", str(d / "lib.so"),
           str(d / "fused_qupdate.cu")]
    log = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if log.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log.stdout}")
    regs = [ln.strip() for ln in log.stdout.splitlines()
            if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(d / "lib.so")), regs


def main(argv=None):
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.core.rounding import parse_spec
    from repro_torch.kernels import build, common
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.launch.time_adam import N_PARAMS, SEED
    from repro_torch.launch.train import ADAM_RUN, rounding_config
    from repro_torch.optim import qadam
    if not torch.cuda.is_available():
        raise RuntimeError("k5_variants needs a CUDA device")
    src = (build.CSRC / "fused_qupdate.cu").read_text()
    out = ROOT / "build" / "k5_variants"
    libs = {}
    for name, text in variants(src).items():
        libs[name], regs = _build(build, name, text, out)
        print(name, regs, flush=True)
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
    real = tfu.build

    def call(name):
        tfu.build = _Lib(libs[name])
        try:
            return tfu.fused_qadam_prng(x, g, m, v, scal, SEED, cfg, **kw)
        finally:
            tfu.build = real

    names = list(libs)
    ref = call(names[0])
    for name in names[1:]:
        got = call(name)
        torch.cuda.synchronize()
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   if a.dtype == torch.float32 else torch.equal(a, b)
                   for a, b in zip(ref, got)):
            raise RuntimeError(f"{name}: not bitwise equal to the source")
        del got
    del ref
    res = {name: [] for name in names}
    for name in names + names[::-1]:
        for _ in range(2):
            call(name)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            call(name)
        end.record()
        torch.cuda.synchronize()
        res[name].append(start.elapsed_time(end) / 10)
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), n=n,
                          ms=res)), flush=True)
    return res


if __name__ == "__main__":
    main()
