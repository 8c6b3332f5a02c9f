"""The readings a cell's limits are set from (``limits/<cell>.json``).

    python3 -m gnnbench.calibrate --workload gcn.amazon0505 --seeds 12 \\
        --control 3 --faults 3 --first-seed 1000 --out chiprun_out/calib.jsonl

One build of the program, then for each seed: the program's first steps
(``Program.reseed``, the captured step the window replays) against the
reference's; on the first ``--control`` seeds each control in the
program's place, the reference one precision below one that the
configuration states (``reference.CONTROLS``: ``control_int8``, int8
aggregation operands; ``control_tf32``, TF32 GEMM operands); on the
first ``--faults`` seeds a planted fault, the reference with half of the
nodes left out of the loss, in the program's place.  One JSON line a
reading, then a summary line: the lower reading (the largest of the
program's), and each control's and the fault's least.  The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from gnnbench import check, data, graphgen, reference, spec
from gnnbench.program import FIRST_STEPS, Program


def readings(cell, seeds: list[int], control: int, faults: int, device,
             emit=print) -> tuple[dict, dict]:
    dev = torch.device(device)
    cache_dir = os.path.join(cell.here, "_cache")
    prog = Program.build(cell, seeds[0], dev, cache_dir, seconds=1.0,
                         log=lambda s: emit(json.dumps({"log": s})))
    src, dst, n = graphgen.read_edges(graphgen.edge_file(cell.traffic,
                                                         cache_dir))
    g = reference.Graph(src, dst, n, dev)
    half = torch.arange(0, n, 2, device=dev)
    controls = [f"control_{c}" for c in reference.CONTROLS]
    kinds: dict[str, list[dict]] = {k: [] for k in
                                    ["program", *controls, "half_batch"]}

    def record(kind: str, seed: int, got: dict, ref: dict) -> None:
        nums = check.compare(got, ref)
        kinds[kind].append(nums)
        diff = [float((a.double() - b.double()).norm() / b.double().norm())
                for a, b in zip(got["grad1"], ref["grad1"])]
        leaf = {name: [float(a.double().norm() / b.double().norm() - 1)
                       for a, b in zip(got[name], ref[name])]
                for name in ("grad1", "delta")}
        emit(json.dumps({"kind": kind, "seed": seed, **nums,
                         "losses": got["losses"],
                         "ref_losses": ref["losses"],
                         "top_share": ref["top_share"],
                         "grad1_diff_per_leaf": diff,
                         "grad1_norm_ratio_minus_1": leaf["grad1"],
                         "delta_norm_ratio_minus_1": leaf["delta"],
                         "ref_grad1_norms": [float(r.double().norm())
                                             for r in ref["grad1"]]}))

    for i, seed in enumerate(seeds):
        if i:
            prog.reseed(seed, cell)
        x, labels, params0 = data.make_inputs(seed, cell.model,
                                              cell.traffic, dev)
        ref = reference.follow(cell.model, g, x, labels, params0,
                               FIRST_STEPS)
        record("program", seed, prog.readings, ref)
        if i < control:
            for name, lower in reference.CONTROLS.items():
                record(f"control_{name}", seed, reference.follow(
                    cell.model, g, x, labels, params0, FIRST_STEPS,
                    **lower), ref)
        if i < faults:
            record("half_batch", seed, reference.follow(
                cell.model, g, x, labels, params0, FIRST_STEPS,
                loss_rows=half), ref)
    summary = {"workload": cell.name}
    for k in spec.NUMBERS:
        summary[k] = {
            "lower": max(r[k] for r in kinds["program"]),
            **{f"{kind}_least": min(r[k] for r in kinds[kind])
               for kind in (*controls, "half_batch") if kinds[kind]},
        }
    emit(json.dumps({"summary": summary}))
    return summary, kinds


def main(argv=None, device=None, root=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=1000)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if device is None and not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload, root or spec.ROOT)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    out = open(args.out, "a") if args.out else None

    def emit(line: str) -> None:
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    try:
        readings(cell, seeds, args.control, args.faults, device or "cuda:0",
                 emit)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
