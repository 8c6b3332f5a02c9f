"""Study log → CSV pivot (reference 2_study2csv.py:12-39): the port of
``gnnadvisor_osdi21_tpu/bench/study2csv.py``, with the same output byte
for byte.

Reads the study banner lines (``++ <param>: <value>``), per-run dataset
markers (``<dataset>---<param>: <value>``) and ``Time (ms)`` lines, and
writes a param x dataset table.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.study2csv study.log
"""

from __future__ import annotations

import re
import sys
from collections import OrderedDict


def parse(lines):
    table: "OrderedDict[str, OrderedDict[str, str]]" = OrderedDict()
    current_param = None
    current_ds = None
    for line in lines:
        m = re.match(r"\+\+ .*: (.+)", line)
        if m:
            current_param = m.group(1).strip()
            table.setdefault(current_param, OrderedDict())
            continue
        m = re.match(r"(\S+)---.*: ", line)
        if m:
            current_ds = m.group(1)
            continue
        if "Time (ms):" in line and current_param is not None and current_ds:
            table[current_param][current_ds] = line.split("Time (ms):")[1].strip()
    return table


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0]
    with open(path) as f:
        table = parse(f)
    datasets: list[str] = []
    for row in table.values():
        for ds in row:
            if ds not in datasets:
                datasets.append(ds)
    out = path.removesuffix(".log") + ".csv"
    with open(out, "w") as f:
        f.write("param," + ",".join(datasets) + "\n")
        for param, row in table.items():
            f.write(param + "," + ",".join(row.get(d, "") for d in datasets) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
