#!/usr/bin/env python3
"""Paired timing of ``chip_smoke.py``'s phase 3 on one NVIDIA card.

    for t in parent change; do cp chip_pair.py "$t"/; done
    for t in parent change change parent parent change change parent; do
        (cd "$t" && python3 chip_pair.py)
    done

Run from the root of a tree (a checkout or a ``git archive`` of one
commit; the script imports that tree's ``chip_smoke`` and package, so it
must sit in the tree's root), it builds that tree's kernels, the amazon0505-scale graph and its
auto layout (probe off), and runs phase 3 (GCN 96 -> 16 -> 22,
transposed: first step against the plain path, ``epoch_ms`` by the
reference's protocol, the device's idle share) twice, then times the
same model step by step (``train_and_time(use_scan=False)``, 5 dry-run
epochs and the protocol's windows of 8 and 1) twice.  Each reading
prints as a ``PAIR epoch_ms ...`` or ``PAIR eager_epoch_ms ...`` line,
with the 8-epoch windows' spread, the card's name and power limit.  Alternating two trees in one call compares them on one card,
which single runs on different cards cannot.  Exits 1 without a card.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as cs
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty

READINGS = 2


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_pair: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    smi = cs.phase0()
    cs.exact_f32_matmul()
    cs.phase1()
    g = synthesize_graph(410236, 4878874, num_features=96, num_classes=22,
                         kind="web", seed=0)
    head = InputProperty(g, hidden_dim=16, probe=False).decider()
    hts = head.build_tensors()
    recs = {n: cs.Record(n) for n in cs.spmm_cuda.KERNELS}
    for _ in range(READINGS):
        epoch_ms = cs.phase3([(g, head, hts)], recs)
        print(f"PAIR epoch_ms {epoch_ms:.4f} on {smi}", flush=True)
    for _ in range(READINGS):
        res, _ = cs.train(g, head, hts, epochs=cs.TIMED_EPOCHS, dry=5,
                          use_scan=False)
        per = [w / res["chunk"] for w in res["window_ms"]]
        print(f"PAIR eager_epoch_ms {res['epoch_ms']:.4f} (windows "
              f"{min(per):.4f}-{max(per):.4f}) on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
