"""Single-SpMM kernel bench on the Type III graphs at dim=16: the port of
``gnnadvisor_osdi21_tpu/bench/bench_spmm.py`` (reference
3_single_spmm_bench.py + 0_bench_Gunrock.py protocol: 200 rounds,
feature-len 16).

Times the tuned hybrid aggregation (rabbit order, the auto layout with
the tier probe on the card, transposed, bf16 tier operands) and the naive
COO segment sum (``build_graph_tensors(g, method="coo")``, the
Gunrock-SpMM baseline's role), both through ``sag`` and the two-point
``chained_marginal_time``, and prints the speedup beside the Gunrock
numbers the reference's artifact committed.  Those were taken on an
RTX 3090, not on this card, and the column says so.

Before timing, one ``sag`` of each arm on all-ones x is held against the
other: both are exact integer counts (bf16 0/1 times 1.0, f32 sums), so
they must be equal; a mismatch exits 1.  A ``#`` line before each row
gives the reordered graph's fingerprint and its tiers (above 200,000
nodes the native reorder does not repeat).

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.bench_spmm [--quick]
           [--device cpu]
(``--device cpu`` runs the plain versions: host times.)
"""

from __future__ import annotations

import sys

GUNROCK_MS = {  # committed artifact numbers (bench_gunrock.csv:2-6, RTX3090)
    "amazon0505": 4.065,
    "artist": 0.638,
    "com-amazon": 4.020,
    "soc-BlogCatalog": 1.051,
    "amazon0601": 3.028,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    quick = "--quick" in argv
    dim = 16

    import torch

    from gnnadvisor_osdi21_tpu_torch.bench.datasets import TYPE_III, get_dataset
    from gnnadvisor_osdi21_tpu_torch.device import resolve_device
    from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import (
        build_hybrid, graph_fingerprint,
    )
    from gnnadvisor_osdi21_tpu_torch.graphs.reorder import rabbit_reorder_graph
    from gnnadvisor_osdi21_tpu_torch.ops.aggregate import sag
    from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import build_graph_tensors
    from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import build_hybrid_tensors
    from gnnadvisor_osdi21_tpu_torch.utils.timing import chained_marginal_time

    dev = resolve_device(
        argv[argv.index("--device") + 1] if "--device" in argv else None)
    roster = TYPE_III[:1] if quick else TYPE_III
    # reference protocol: 200 rounds (unitest.py:65-80); marginal cost per
    # round via the two-point fit (removes what every run pays once)
    iters = 20 if quick else 200
    print("dataset,hybrid_ms,naive_coo_ms,speedup,gunrock_rtx3090_ms")
    for name in roster:
        g = rabbit_reorder_graph(get_dataset(name, dim=dim))
        hg = build_hybrid(g, device=dev)
        print(f"# {name}: fingerprint {graph_fingerprint(g)}, diag_b "
              f"{hg.diag_b} hot_k {hg.hot_k} res_ob {hg.res_ob} res_tile "
              f"{hg.res_tile}, tier probe {hg.tier_probe}", flush=True)
        # the tuned defaults: transposed layout + bf16 tier operands
        ht = build_hybrid_tensors(hg, device=dev, transposed=True,
                                  agg_dtype="bfloat16")
        x = torch.ones((dim, hg.num_rows), dtype=torch.float32, device=dev)
        gt_coo = build_graph_tensors(g, method="coo", device=dev)
        xn = torch.ones((g.num_nodes, dim), dtype=torch.float32, device=dev)
        with torch.no_grad():
            hy = sag(x, ht)[:, : g.num_nodes].t()
            co = sag(xn, gt_coo)
            if not torch.equal(hy, co):
                print(f"# {name}: hybrid arm against the COO arm: MISMATCH, "
                      f"max |diff| {float((hy - co).abs().max())}")
                return 1
            t_h = chained_marginal_time(
                lambda a, h: sag(a, h), x, ht, iters=iters
            )[0] * 1e3
            # the naive-COO arm is slower per round: fewer rounds, same fit
            t_n = chained_marginal_time(
                lambda a, h: sag(a, h), xn, gt_coo, iters=max(iters // 40, 5)
            )[0] * 1e3

        gr = GUNROCK_MS.get(name, float("nan"))
        print(f"{name},{t_h:.3f},{t_n:.3f},{t_n / t_h:.2f},{gr}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
