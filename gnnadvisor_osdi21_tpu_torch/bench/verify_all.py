"""Kernel verification across the dataset roster (reference 4_verifying.py):
the port of ``gnnadvisor_osdi21_tpu/bench/verify_all.py``.

Runs the unitest-style SAG verification (``--verify_spmm True``) of the
port's CLI for every dataset in BOTH tier compute dtypes (the tuned
bfloat16 default and float32, each checked against its own tolerance,
``verification.Verification.compare``), one CLI process per run, on the
card (``--platform cpu`` runs them on the host); any failed run fails the
sweep, and the exit code is 1, naming each ``name[dtype]``.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.verify_all
           [--quick] [--platform cpu] [--agg_dtype bfloat16|float32|both]
"""

from __future__ import annotations

import subprocess
import sys

from gnnadvisor_osdi21_tpu_torch.bench.datasets import DATASETS, QUICK


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    quick = "--quick" in argv
    extra = (
        ["--platform", argv[argv.index("--platform") + 1]]
        if "--platform" in argv else []
    )
    dtype_arg = (
        argv[argv.index("--agg_dtype") + 1] if "--agg_dtype" in argv
        else "both"
    )
    dtypes = (
        ["bfloat16", "float32"] if dtype_arg == "both" else [dtype_arg]
    )
    roster = QUICK if quick else list(DATASETS)
    failed = []
    for dtype in dtypes:
        for name in roster:
            _, _, dim, classes, _, _ = DATASETS[name]
            cmd = [
                sys.executable, "-m", "gnnadvisor_osdi21_tpu_torch",
                "--dataset", name, "--dim", str(dim),
                "--classes", str(classes),
                "--hidden", "16", "--manual_mode", "False",
                "--verify_spmm", "True", "--agg_dtype", dtype,
            ] + extra
            print(f"=> verifying {name} [{dtype}]", flush=True)
            if subprocess.run(cmd).returncode != 0:
                failed.append(f"{name}[{dtype}]")
    if failed:
        print(f"FAILED: {failed}")
        return 1
    print("All kernel verifications passed "
          f"({len(roster)} datasets x {dtypes}).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
