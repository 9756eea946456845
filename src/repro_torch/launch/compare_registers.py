"""Registers and spills of every compiled kernel instance in two trees of
the port, side by side: which instances of the first tree changed in the
second, and which the second adds.

  python src/repro_torch/launch/compare_registers.py --src A/src \
      --src B/src [--out FILE]

Each tree's ``kernels.build.build_all`` compiles its ``csrc`` (in a
subprocess, so the two trees' modules never mix) into its own build
directory, and ptxas' report (``-Xptxas=-v``) is read with
``chip_smoke.ptxas_usage`` of the checkout this file lives in.  Kernel
names are compared after dropping a template argument that names the
first instances' rounding site (``rt::RoundParams``): the epilogues of
K3', K4', K8' and K1' take their site as a template parameter since
their wide instances (``rt::WideParams``) were added, which renames the
first instances without changing their code (and K8''s weight-stream
kernel gained the epilogue as a template argument).  Prints one JSON line (and
writes it to ``--out``); it needs nvcc, so it runs on the card's machine.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def _normal(name: str) -> str:
    """A kernel name without the first instances' site argument (K8''s
    weight-stream kernel took no epilogue argument before)."""
    name = re.sub(r"\s+>", ">", name)    # c++filt's "> >"
    name = re.sub(r"<rt::RoundParams>", "", name)
    name = re.sub(r", rt::RoundParams>", ">", name)
    return re.sub(r"^(stream_kernel<.*), Epilogue>$", r"\1>", name)


def build_logs(src: str) -> dict:
    """{library: ptxas report} of the tree whose ``src`` directory is
    given, built in a subprocess."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.kernels import build; "
            "print(json.dumps({n: build.build_log(n) "
            "for n in sorted(build.build_all())}))")
    out = subprocess.run([sys.executable, "-c", code, src],
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if len(args.src) != 2:
        raise SystemExit("give --src twice: the first tree, then the second")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ptxas_usage
    usage = []
    for src in args.src:
        usage.append({lib: {_normal(fn): use
                            for fn, use in ptxas_usage(log).items()}
                      for lib, log in build_logs(src).items()})
    first, second = usage
    changed, same, added = {}, 0, {}
    for lib, kernels in second.items():
        for fn, use in kernels.items():
            old = first.get(lib, {}).get(fn)
            if old is None:
                added[f"{lib}: {fn}"] = use
            elif old != use:
                changed[f"{lib}: {fn}"] = dict(first=old, second=use)
            else:
                same += 1
    gone = [f"{lib}: {fn}" for lib, kernels in first.items()
            for fn in kernels if fn not in second.get(lib, {})]
    out = dict(src=args.src, unchanged=same, changed=changed, added=added,
               gone=gone)
    for key, val in changed.items():
        print(f"  changed {key}: {val}", flush=True)
    print(f"  {same} instances unchanged, {len(changed)} changed, "
          f"{len(added)} added, {len(gone)} gone", flush=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
