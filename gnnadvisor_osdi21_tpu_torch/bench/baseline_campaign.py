"""Baseline roster campaign: the three-way comparison table; the port of
``gnnadvisor_osdi21_tpu/bench/baseline_campaign.py``.

The reference's evaluation headline is a GNNAdvisor-vs-DGL-vs-PyG
epoch-time table over 15 datasets x {GCN, GIN} (dgl_baseline/dgl_main.py:
66-88, pyg_baseline/pyg_main.py, assembled by 1_log2csv.py).  For each of
the 30 roster configs this driver measures, on the card by default:

- ``naive`` (the DGL role, ``baselines/naive.py``): per-edge COO gather +
  ``segment_reduce``, autograd;
- ``torch`` (the PyG role, ``baselines/torch_baseline.py``):
  ``index_select``/``index_add_`` message passing, autograd.

Both run on the same card as the tuned stack (the JAX campaign ran the
torch column on the host CPU); ``--device cpu`` runs both on the host.

Protocol, the JAX campaign's: 10 warm-up + 50 timed epochs per config,
resumable like ``bench/campaign.py``: one log per config under
``<log_dir>/baseline_runs/``, skipped when it already holds a ``Time
(ms):`` line.  Output: ``<log_dir>/baselines.csv`` (long form) and
``<log_dir>/speedups.csv``, joined against the campaign's
``<log_dir>/roster.csv``, with the JAX file's row and column order and
the card in place of the JAX file's hardware names: ``model,dataset,
tuned_ms,naive_ms,torch_ms,speedup_vs_naive,speedup_vs_torch,device``,
``device`` being the baselines' card as their logs record it (its name
and power limit from ``nvidia-smi``, or ``cpu``).  ``<log_dir>`` is the
git-ignored ``chiprun_out/campaign`` by default; the pidfile is the
campaign's.  The exit code is 1 when a config did not finish, naming
each.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.baseline_campaign
           [--only torch|naive] [--assemble-only] [--quick] [--device cpu]
           [--log_dir DIR]
"""

from __future__ import annotations

import csv
import os
import re
import sys

from gnnadvisor_osdi21_tpu_torch.bench.campaign import (
    LOG_DIR, recorded_pid, run_one,
)
from gnnadvisor_osdi21_tpu_torch.bench.datasets import DATASETS, QUICK

EPOCHS = 50
USAGE = ("usage: baseline_campaign [--quick] [--only torch|naive]"
         " [--assemble-only] [--device cpu] [--log_dir DIR]")


def configs(quick: bool, only: str | None, tail=()):
    """(tag, baseline, model, dataset, command) of each config; ``tail`` is
    appended to each command."""
    names = QUICK if quick else list(DATASETS)
    for baseline, module in (
        ("torch", "gnnadvisor_osdi21_tpu_torch.baselines.torch_baseline"),
        ("naive", "gnnadvisor_osdi21_tpu_torch.baselines.naive"),
    ):
        if only and baseline != only:
            continue
        for model in ("gcn", "gin"):
            for name in names:
                tag = f"{baseline}_{model}_{name}"
                yield tag, baseline, model, name, [
                    sys.executable, "-m", module, model,
                    "--dataset", name, "--epochs", str(EPOCHS),
                ] + list(tail)


def _scrape(path: str, pattern: str) -> str | None:
    """The last match of ``pattern``'s group in the log, or None."""
    if not os.path.exists(path):
        return None
    with open(path) as fp:
        m = re.findall(pattern, fp.read())
    return m[-1] if m else None


def _scrape_ms(path: str) -> float | None:
    ms = _scrape(path, r"Time \(ms\):\s*([0-9.]+)")
    return None if ms is None else float(ms)


def assemble(quick: bool, log_dir: str = LOG_DIR) -> None:
    run_dir = os.path.join(log_dir, "baseline_runs")
    rows, devices = {}, {}
    for tag, baseline, model, name, _cmd in configs(quick, None):
        path = os.path.join(run_dir, f"{tag}.log")
        rows[(model, name, baseline)] = _scrape_ms(path)
        devices[(model, name, baseline)] = _scrape(path, r"# device: (.*)")
    with open(os.path.join(log_dir, "baselines.csv"), "w") as fp:
        fp.write("baseline,model,dataset,Avg.Epoch (ms)\n")
        for (model, name, baseline), ms in sorted(rows.items()):
            if ms is not None:
                fp.write(f"{baseline},{model},{name},{ms:.3f}\n")

    tuned = {}
    roster = os.path.join(log_dir, "roster.csv")
    if os.path.exists(roster):
        with open(roster) as fp:
            next(fp)
            for line in fp:
                model, name, ms = line.strip().split(",")
                tuned[(model, name)] = float(ms)
    with open(os.path.join(log_dir, "speedups.csv"), "w") as fp:
        fp.write(
            "model,dataset,tuned_ms,naive_ms,torch_ms,"
            "speedup_vs_naive,speedup_vs_torch,device\n"
        )
        out = csv.writer(fp, lineterminator="\n")
        for model in ("gcn", "gin"):
            for name in DATASETS:
                t = tuned.get((model, name))
                nv = rows.get((model, name, "naive"))
                th = rows.get((model, name, "torch"))
                if t is None:
                    continue
                device = (devices.get((model, name, "naive"))
                          or devices.get((model, name, "torch")) or "")
                out.writerow([
                    model, name, f"{t:.3f}",
                    "" if nv is None else nv, "" if th is None else th,
                    f"{nv / t:.2f}" if nv else "",
                    f"{th / t:.2f}" if th else "", device,
                ])
    print(f"assembled {log_dir}/baselines.csv + {log_dir}/speedups.csv",
          flush=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    quick = "--quick" in argv
    only = None
    if "--only" in argv:
        idx = argv.index("--only") + 1
        if idx >= len(argv) or argv[idx] not in ("torch", "naive"):
            print(USAGE)
            return 2
        only = argv[idx]
    log_dir = LOG_DIR
    if "--log_dir" in argv:
        idx = argv.index("--log_dir") + 1
        if idx >= len(argv):
            print(USAGE)
            return 2
        log_dir = argv[idx]
    tail = (["--device", argv[argv.index("--device") + 1]]
            if "--device" in argv else [])
    run_dir = os.path.join(log_dir, "baseline_runs")
    os.makedirs(run_dir, exist_ok=True)
    failed = []
    if "--assemble-only" not in argv:
        # the campaign's quiesce handshake (the naive and torch arms run
        # on the card)
        with recorded_pid():
            for tag, _b, _m, _n, cmd in configs(quick, only, tail):
                if not run_one(run_dir, tag, cmd):
                    failed.append(tag)
    assemble(quick, log_dir)
    if failed:
        print(f"baseline campaign FAILED: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
