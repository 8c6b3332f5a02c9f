"""Log → CSV scraper, contract-compatible with the reference 1_log2csv.py:
the port of ``gnnadvisor_osdi21_tpu/bench/log2csv.py``, with the same
output byte for byte.

Scrapes ``dataset=...`` from the argparse namespace echo and
``Time (ms): ...`` from the timing line (GNNA_main.py:42, :202), writing
``dataset,Avg.Epoch (ms)`` rows.  The port CLI's ``--platform cpu`` note
("# --platform cpu: Time (ms) below is ...") has no colon after
``Time (ms)`` and is not scraped.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.log2csv result.log
"""

from __future__ import annotations

import re
import sys


def parse_log(lines) -> list[tuple[str, str]]:
    datasets, times = [], []
    for line in lines:
        if "dataset=" in line:
            m = re.findall(r"dataset=.*?,", line)
            if m:
                datasets.append(
                    m[0].split("=")[1].replace(",", "").replace("'", "")
                )
        if "Time (ms):" in line:
            times.append(line.split("Time (ms):")[1].strip())
    return list(zip(datasets, times))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        raise ValueError("Usage: python -m ...log2csv result.log")
    path = argv[0]
    with open(path) as fp:
        rows = parse_log(fp)
    out = path.removesuffix(".log") + ".csv"
    with open(out, "w") as f:
        f.write("dataset,Avg.Epoch (ms)\n")
        for d, t in rows:
            f.write(f"{d},{t}\n")
    print(f"wrote {out} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
