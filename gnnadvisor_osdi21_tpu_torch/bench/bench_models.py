"""Model benchmark grids (reference 0_bench_GNNA_GCN.py / 0_bench_GNNA_GIN.py):
the port of ``gnnadvisor_osdi21_tpu/bench/bench_models.py``.

Sweeps the dataset roster with the reference's protocol constants — GCN:
2 layers hidden=16; GIN: 5 layers hidden=64; auto decider + rabbit enabled;
200 epochs — spawning one CLI process per config (``python -m
gnnadvisor_osdi21_tpu_torch``), like the reference's ``os.system`` fan-out
(0_bench_GNNA_GCN.py:44-53).  The children run on the card;
``--platform cpu`` is passed on to them.

Unlike the JAX driver, which ignores its children's exit codes, this one
exits 1 when any child failed, naming each, so that a failed run on the
card is not hidden.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.bench_models [gcn|gin]
           [--quick] [--platform cpu]
Pipe stdout to a log and feed it to bench/log2csv.py.
"""

from __future__ import annotations

import subprocess
import sys

from gnnadvisor_osdi21_tpu_torch.bench.datasets import DATASETS, QUICK


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    model = argv[0] if argv and not argv[0].startswith("-") else "gcn"
    quick = "--quick" in argv
    extra = (
        ["--platform", argv[argv.index("--platform") + 1]]
        if "--platform" in argv else []
    )
    epochs = "50" if quick else "200"
    hidden = "16" if model == "gcn" else "64"
    roster = QUICK if quick else list(DATASETS)
    failed = []
    for name in roster:
        _, _, dim, classes, _, _ = DATASETS[name]
        cmd = [
            sys.executable, "-m", "gnnadvisor_osdi21_tpu_torch",
            "--dataset", name, "--dim", str(dim), "--hidden", hidden,
            "--classes", str(classes), "--model", model,
            "--num_epoches", epochs,
            "--manual_mode", "False", "--enable_rabbit", "True",
        ] + extra
        print(f"=> {name}", flush=True)
        if subprocess.run(cmd).returncode != 0:
            failed.append(name)
    if failed:
        print(f"FAILED: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
