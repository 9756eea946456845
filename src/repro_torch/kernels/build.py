"""Build and load the port's CUDA C++ kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  The libraries go
to ``build/repro_torch/`` at the repository root (listed in .gitignore),
named by a hash of every source and header plus the flags, so an edit
rebuilds and an unchanged tree reuses what is there.  All sources compile
in parallel, one ``nvcc`` each.

No ``--use_fast_math`` / ``-ftz=true``: the rounding epilogues are exact
only with IEEE float32 and subnormals kept (the flush below 2**-126 is
explicit in the code).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing; returns name -> path.

    Writes each library under a temporary name and renames it into place,
    so concurrent builders never load a half-written file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {p.stem: lib_path(p.stem) for p in sources()}
    todo = [(p, out[p.stem]) for p in sources() if not out[p.stem].exists()]
    procs = []
    for src, dst in todo:
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        log = dst.with_suffix(".log").open("w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs.append((subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT),
                      log, tmp, dst))
    failed = []
    for proc, log, tmp, dst in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{dst.name}: nvcc exit {rc}\n"
                          + dst.with_suffix(".log").read_text())
        else:
            os.replace(tmp, dst)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/shared-memory report)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built at first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        paths = build_all()
        if name not in paths:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        lib = ctypes.CDLL(str(paths[name]))
        _LIBS[name] = lib
    return lib
