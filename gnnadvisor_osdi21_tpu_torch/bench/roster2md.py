"""Render the assembled campaign roster (``gcn.csv`` + ``gin.csv`` of a
campaign's log directory) as the RESULTS.md markdown table: the port of
``gnnadvisor_osdi21_tpu/bench/roster2md.py``, with the same table.  The
default directory is the port campaign's (``chiprun_out/campaign``).

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.roster2md [log_dir]
"""

from __future__ import annotations

import csv
import os
import sys

from gnnadvisor_osdi21_tpu_torch.bench.campaign import LOG_DIR
from gnnadvisor_osdi21_tpu_torch.bench.datasets import DATASETS


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    log_dir = argv[0] if argv else LOG_DIR
    # agg_dtype is scraped from each run's Namespace echo in the assembled
    # protocol log (the CLI prints its arguments, cli.py's main) so the
    # column records the dtype the run actually used, not an assumption
    import re

    print("| model | dataset | type | nodes | edges | agg_dtype | ms/epoch |")
    print("|---|---|---|---:|---:|---|---:|")
    for model, hidden in (("gcn", "h16"), ("gin", "h64")):
        path = os.path.join(log_dir, f"{model}.csv")
        if not os.path.exists(path):
            continue
        # key on the dataset name scraped from the SAME Namespace line:
        # a resumed campaign appends extra echoes, so positional zip
        # against CSV rows would misalign every subsequent row (last echo
        # per dataset wins — that is the run the CSV row came from)
        dtypes = {}
        log_path = os.path.join(log_dir, f"{model}.log")
        if os.path.exists(log_path):
            with open(log_path) as fp:
                for ds, dt in re.findall(
                    r"dataset='([^']+)'.*?agg_dtype='(\w+)'", fp.read()
                ):
                    dtypes[ds] = dt
        with open(path) as fp:
            for row in csv.DictReader(fp):
                name = row["dataset"]
                n, e, _, _, typ, _ = DATASETS[name]
                ms = float(row["Avg.Epoch (ms)"])
                dt = dtypes.get(name, "?")
                print(
                    f"| {model.upper()} ({hidden}) | {name} | {typ} "
                    f"| {n:,} | {e:,} | {dt} | {ms:.3f} |"
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
