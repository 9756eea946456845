"""Compare runs of the test suite name by name, from their JUnit XML files
(``pytest --junitxml=FILE``): the counts of each run, and every test whose
outcome (pass, fail, skip, or missing) differs between the runs.

  python src/repro_torch/launch/compare_failed_sets.py A.xml B.xml [C.xml ...]

The first half of the files are the parent's runs, the rest the change's
(parent, parent, change, change): a test that passed in every parent run
and fails in a run of the change is flagged ``broken``.  Exits 1 when one
is.
"""
from __future__ import annotations

import sys
import xml.etree.ElementTree as ET
from typing import Dict, List


def outcomes(path: str) -> Dict[str, str]:
    """test id (``tests/file.py::name``) -> pass | fail | skip."""
    out = {}
    for case in ET.parse(path).iter("testcase"):
        name = case.get("classname").replace(".", "/") + ".py::" \
            + case.get("name")
        state = "pass"
        for child in case:
            if child.tag in ("failure", "error"):
                state = "fail"
            elif child.tag == "skipped":
                state = "skip"
        out[name] = state
    return out


def main(argv: List[str] = None) -> int:
    paths = list(sys.argv[1:] if argv is None else argv)
    if len(paths) < 2:
        raise SystemExit(__doc__)
    runs = [outcomes(p) for p in paths]
    for p, r in zip(paths, runs):
        counts = {s: sum(v == s for v in r.values())
                  for s in ("pass", "fail", "skip")}
        print(f"{p}: {counts}")
    n_parent = len(runs) // 2
    names = sorted(set().union(*runs))
    broken = 0
    for name in names:
        states = [r.get(name, "-") for r in runs]
        if len(set(states)) == 1:
            continue
        flag = ""
        if all(s == "pass" for s in states[:n_parent]) \
                and "fail" in states[n_parent:]:
            flag, broken = " broken", broken + 1
        print(f"  {name}: {' '.join(states)}{flag}")
    print(f"{broken} test(s) passed in every parent run and fail later "
          f"(parent runs: the first {n_parent})")
    return 1 if broken else 0


if __name__ == "__main__":
    sys.exit(main())
