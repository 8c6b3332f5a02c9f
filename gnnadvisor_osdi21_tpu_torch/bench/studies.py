"""Parameter studies (reference s7-4_*.py / s7-5_1.py): the port of
``gnnadvisor_osdi21_tpu/bench/studies.py``, with its four studies and
grids, one CLI process per run (``python -m gnnadvisor_osdi21_tpu_torch``,
on the card; ``--platform cpu`` is passed on to the runs).

- ``partsize``: neighbor-group size 2..512 on Type III graphs
  (s7-4_1_neighbor_partitioning.py:5-13)
- ``dimtile``:  the dimWorker study (s7-4_2_dimension_partitiong.py).  The
  port's CLI accepts ``--dimWorker`` and does not use it (the CUDA kernels
  size their own launches), so every arm of a graph runs one program: the
  spread across the grid is the run-to-run noise.
- ``reorder``:  rabbit on/off (s7-4_3_node_renumbering.py)
- ``hidden``:   hidden dim 16..1024 (s7-5_1_hidden_dimension.py)

Each run prints the reference's ``Time (ms)`` contract so
bench/study2csv.py can pivot param x dataset.  Unlike the JAX driver,
which ignores its runs' exit codes, this one exits 1 when any run failed,
naming each.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.studies <study> [--quick]
           [--platform cpu]
"""

from __future__ import annotations

import subprocess
import sys

from gnnadvisor_osdi21_tpu_torch.bench.datasets import DATASETS, TYPE_III

PARTSIZES = [2, 4, 8, 16, 32, 64, 128, 256, 512]
DIM_TILES = [8, 16, 32, 64, 128]  # dimWorker grid (s7-4_2:5)
HIDDEN = [16, 32, 64, 128, 256, 512, 1024]  # s7-5_1:5


def _run(dataset, extra, quick, platform) -> bool:
    """One CLI run; True when it exited 0."""
    _, _, dim, classes, _, _ = DATASETS[dataset]
    cmd = [
        sys.executable, "-m", "gnnadvisor_osdi21_tpu_torch",
        "--dataset", dataset, "--dim", str(dim), "--classes", str(classes),
        "--num_epoches", "50" if quick else "200",
        # the step-by-step loop, as the JAX studies run (each config is a
        # fresh program there)
        "--use_scan", "False",
    ] + extra + platform
    sys.stdout.flush()  # the banners before the run's own lines
    return subprocess.run(cmd).returncode == 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    study = argv[0] if argv else "partsize"
    quick = "--quick" in argv
    platform = (
        ["--platform", argv[argv.index("--platform") + 1]]
        if "--platform" in argv else []
    )
    graphs = TYPE_III[:1] if quick else TYPE_III
    failed = []

    def run(ds, label, extra):
        if not _run(ds, extra, quick, platform):
            failed.append(f"{ds}[{label}]")

    if study == "partsize":
        for ps in PARTSIZES[:3] if quick else PARTSIZES:
            print("******************************")
            print(f"++ Part-size: {ps}")
            print("******************************")
            for ds in graphs:
                print(f"{ds}---partsize: {ps}")
                run(ds, f"partsize {ps}",
                    ["--manual_mode", "True", "--method", "ell",
                     "--partSize", str(ps), "--hidden", "16"])
    elif study == "dimtile":
        for dw in DIM_TILES[:3] if quick else DIM_TILES:
            print("******************************")
            print(f"++ dimWorker: {dw}")
            print("******************************")
            for ds in graphs:
                print(f"{ds}---dimWorker: {dw}")
                run(ds, f"dimWorker {dw}",
                    ["--manual_mode", "True", "--method", "hybrid",
                     "--dimWorker", str(dw), "--hidden", "16"])
    elif study == "reorder":
        # Reference protocol (s7-4_3_node_renumbering.py:10-17): GIN
        # hidden=64, manual mode (so enable_rabbit on/off is forced rather
        # than left to the heuristic), first three Type III graphs.
        for flag in ("False", "True"):
            print("******************************")
            print(f"++ rabbit: {flag}")
            print("******************************")
            for ds in TYPE_III[:1] if quick else TYPE_III[:3]:
                print(f"{ds}---rabbit: {flag}")
                run(ds, f"rabbit {flag}",
                    ["--manual_mode", "True", "--method", "hybrid",
                     "--model", "gin",
                     "--enable_rabbit", flag, "--hidden", "64"])
    elif study == "hidden":
        for h in HIDDEN[:3] if quick else HIDDEN:
            print("******************************")
            print(f"++ hidden: {h}")
            print("******************************")
            for ds in graphs:
                print(f"{ds}---hidden: {h}")
                run(ds, f"hidden {h}",
                    ["--manual_mode", "False", "--hidden", str(h)])
    else:
        raise ValueError(f"unknown study: {study}")
    if failed:
        print(f"FAILED: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
