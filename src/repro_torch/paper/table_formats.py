"""Table 2: number-format parameters (u, xmin, xmax), emitted from the
port's format registry (counterpart of the reference's
``benchmarks/table_formats.py``)."""
from __future__ import annotations

from repro_torch.core import formats


def run():
    rows = []
    for name in ("binary8", "bfloat16", "binary16", "binary32"):
        f = formats.get_format(name)
        rows.append((f"table2/{name}_u", 0.0, f.u))
        rows.append((f"table2/{name}_xmin", 0.0, f.xmin))
        rows.append((f"table2/{name}_xmax", 0.0, f.xmax))
    return rows
