"""Component-level breakdown of the hybrid SpMM on the card: the port of
``gnnadvisor_osdi21_tpu/bench/breakdown.py``.

Times each tier of the tuned aggregation apart (diagonal slab, hot slab,
residual combine, the whole pipeline) with roofline context, and prints
the host-side censuses (hot coverage, diagonal locality) beside them: the
data the cost model in ``graphs/hybrid.py`` is fitted to.  Sections
(``--only``, a comma list; all by default):

- ``census``: hot-column coverage and diagonal-block coverage;
- ``hybrid``: ``sag`` on the layout (transposed unless ``--rowmajor``);
- ``diag``, ``hot``, ``res``: each tier alone through the row-major
  helpers (``ops/hybrid_agg.diag_tier``, ``hot_tier``, ``residual_tier``),
  x in the tier dtype, as the pipeline hands it to them;
- ``rest``: the transposed residual alone (the table pass and
  ``residual_tier_t``);
- ``slabt``: the diagonal and hot tiers (``ops/hybrid_agg.slab_tiers_t``:
  the table pass, then one ``fused_slab_matmul_t`` launch after the hot
  rows' gather, or the diagonal slab and the hot list, as the pipeline
  runs them);
- ``tiers``: ``sag`` over the ``--tiers`` list of (diag_b, hot_k);
- ``geom``: one line.  The JAX script sweeps the TPU kernels' block rows;
  the CUDA kernels size their own launches, so there is nothing to sweep.

x is all ones, so every tier's output is an exact integer count (0/1
products of 1.0, sums below 2^24).  When ``hybrid`` and every tier the
layout has run, their outputs are added up and held against the whole
aggregation, exactly; a mismatch exits 1.  The reordered graph's
fingerprint is printed: above 200,000 nodes the native reorder does not
repeat, so each run may get another permutation and other tiers.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.breakdown [--only X]
           [--tiers ...] [--rowmajor] [--device cpu]
(``--device cpu`` runs the plain versions on the host: its times are the
host's, not the card's.)
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--graph", default="",
                   help="graph .npz path (default: the shared bench graph)")
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--only", default="",
                   help="comma list: census,hybrid,diag,hot,res,rest,slabt,"
                        "tiers,geom")
    p.add_argument("--hotk", type=int, default=-1, help="force hot_k (-1=auto)")
    p.add_argument("--diagb", type=int, default=-1, help="force diag_b (-1=auto)")
    p.add_argument("--agg_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="tier compute dtype (the tuned default is bfloat16)")
    p.add_argument("--rowmajor", action="store_true",
                   help="use the row-major layout (default: the transposed "
                        "pipeline; per-tier --only diag/hot/res isolation "
                        "always runs row-major)")
    p.add_argument("--tiers", default="0:0,512:0,0:4096,2048:2048,4096:4096",
                   help="diag_b:hot_k sweep list for --only tiers")
    p.add_argument("--device", default=None,
                   help="default: the card; 'cpu' runs the plain versions")
    args = p.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None

    import numpy as np
    import torch

    from gnnadvisor_osdi21_tpu_torch.device import resolve_device
    from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import (
        build_hybrid, graph_fingerprint,
    )
    from gnnadvisor_osdi21_tpu_torch.graphs.loader import load_graph
    from gnnadvisor_osdi21_tpu_torch.graphs.reorder import rabbit_reorder_graph
    from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda
    from gnnadvisor_osdi21_tpu_torch.ops.aggregate import sag
    from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
        AGG_DTYPES, build_hybrid_tensors, diag_tier, hot_tier,
        residual_tier, residual_tier_t, slab_tiers_t,
    )
    from gnnadvisor_osdi21_tpu_torch.utils.profiling import spmm_roofline
    from gnnadvisor_osdi21_tpu_torch.utils.timing import chained_device_time

    def want(name):
        return only is None or name in only

    dev = resolve_device(args.device)
    agg = AGG_DTYPES[args.agg_dtype]
    dim = args.dim
    if args.graph:
        graph = load_graph(args.graph, num_features=dim)
    else:
        from gnnadvisor_osdi21_tpu_torch.bench.datasets import bench_graph

        graph = bench_graph(dim)
    graph = rabbit_reorder_graph(graph)
    n, e = graph.num_nodes, graph.nnz
    print(f"graph: N={n} nnz={e} dim={dim} (after rabbit)")
    print(f"fingerprint: {graph_fingerprint(graph)}")

    # ---------------- host-side censuses --------------------------------
    if want("census"):
        counts = np.bincount(graph.column_index, minlength=n)
        csum = np.cumsum(np.sort(counts)[::-1])
        for k in (512, 1024, 2048, 4096, 8192, 16384):
            if k <= n:
                print(f"  hot coverage K={k:6d}: {csum[k-1]/e:.3f}")
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(graph.row_pointers))
        cd = graph.column_index.astype(np.int64)
        for B in (512, 1024, 2048, 4096):
            cov = np.mean(src // B == cd // B)
            print(f"  diag cov B={B:5d} (rabbit order): {cov:.3f}")

    hot_k = None if args.hotk < 0 else args.hotk
    diag_b = None if args.diagb < 0 else args.diagb
    transposed = not args.rowmajor
    # auto tiers probe on the card, as the JAX build probes on its TPU
    hg = build_hybrid(graph, hot_k=hot_k, diag_b=diag_b, device=dev)
    ht = build_hybrid_tensors(hg, device=dev, agg_dtype=args.agg_dtype,
                              transposed=transposed)
    # the per-tier helpers are row-major; only pay the second device copy
    # of the layout when one of them is requested
    ht_rm = ht
    if transposed and (want("diag") or want("hot") or want("res")):
        ht_rm = build_hybrid_tensors(hg, device=dev, agg_dtype=args.agg_dtype,
                                     transposed=False)
    r = hg.num_rows
    print(f"layout: rows={r} diag_b={hg.diag_b} hot_k={hg.hot_k} | "
          f"edges diag={hg.num_diag_edges} hot={hg.num_hot_edges} "
          f"res={hg.num_res_edges} (pairs={hg.num_res_pairs} "
          f"slots={hg.num_res_slots})")
    print(f"  res_ob={hg.res_ob} res_tile={hg.res_tile}; tier probe: "
          f"{hg.tier_probe}")

    x = torch.ones((dim, r) if transposed else (r, dim), dtype=torch.float32,
                   device=dev)
    x_rm = torch.ones((r, dim), dtype=agg, device=dev)

    def report(name, sec):
        rl = spmm_roofline(sec, e, dim, n)
        print(f"{name:34s} {sec*1e3:8.3f} ms | {rl.achieved_gbs:6.0f} GB/s-eff "
              f"| {rl.hbm_fraction*100:5.1f}% of HBM floor | "
              f"{e/sec/1e9:.2f} Gedge/s")

    def run(name, op, a, h):
        """Time ``op(a, h)``, report it, and return one output."""
        report(name, chained_device_time(op, a, h, iters=args.iters))
        return op(a, h)

    def table_of(a, h):
        return spmm_cuda.row_table_t(a, AGG_DTYPES[h.agg_dtype])

    whole, parts = None, {}
    with torch.no_grad():
        if want("hybrid"):
            whole = run("hybrid total (sag)", lambda a, h: sag(a, h), x, ht)
        if want("diag") and hg.diag_b:
            parts["diag"] = run("diag slab only (rowmajor)", diag_tier,
                                x_rm, ht_rm)
        if want("hot") and hg.hot_k:
            parts["hot"] = run("hot slab only (rowmajor)", hot_tier,
                               x_rm, ht_rm)
        if want("res") and hg.num_res_slots:
            parts["res"] = run("residual only (rowmajor)", residual_tier,
                               x_rm, ht_rm)
        if want("rest") and hg.num_res_slots and transposed:
            # the transposed residual tier alone: the table pass, the
            # kernel's own slot gather and its combine
            def res_only(a, h):
                return residual_tier_t(table_of(a, h).t()[: a.shape[0]], h)

            run("residual only (transposed)", res_only, x, ht)
        if want("slabt") and hg.diag_b and hg.hot_k and transposed:
            def slab_only(a, h):
                return slab_tiers_t(table_of(a, h), a.shape[0], h)

            run("slab tiers only (transposed)", slab_only, x, ht)

    present = {name for name, on in (("diag", hg.diag_b), ("hot", hg.hot_k),
                                     ("res", hg.num_res_slots)) if on}
    if whole is not None and present and set(parts) == present:
        total = sum(parts.values())
        got = whole.t() if transposed else whole
        if not torch.equal(total, got):
            diff = float((total - got).abs().max())
            print(f"tiers {'+'.join(sorted(present))} against the whole: "
                  f"MISMATCH, max |diff| {diff}")
            return 1
        print(f"tiers {'+'.join(sorted(present))} against the whole: exact")

    # ---------------- (diag_b, hot_k) sweep on the full pipeline --------
    if want("tiers"):
        for spec in args.tiers.split(","):
            b, k = (int(v) for v in spec.split(":"))
            hgc = build_hybrid(graph, hot_k=k, diag_b=b)
            htc = build_hybrid_tensors(hgc, device=dev,
                                       agg_dtype=args.agg_dtype,
                                       transposed=transposed)
            xc = torch.ones(
                (dim, hgc.num_rows) if transposed else (hgc.num_rows, dim),
                dtype=torch.float32, device=dev)
            with torch.no_grad():
                sec = chained_device_time(lambda a, h: sag(a, h), xc, htc,
                                          iters=args.iters)
            print(f"diag_b={b:5d} hot_k={k:5d} res={hgc.num_res_edges:8d} "
                  f"-> {sec*1e3:8.3f} ms")

    # ---------------- kernel geometry -----------------------------------
    if want("geom"):
        print("block_rows: not swept; the CUDA kernels size their own "
              "launches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
