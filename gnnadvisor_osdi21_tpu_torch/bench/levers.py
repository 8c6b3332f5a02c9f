"""Headline-kernel lever sweep on the amazon0505-scale bench graph: the
port of ``gnnadvisor_osdi21_tpu/bench/levers.py``, on the row-major
layout (``transposed=False``, the default of the JAX package's
``build_hybrid_tensors``), so that the cost model's constants stay tied to
measurements.

Levers swept, with the JAX script's grids and tags:

- tier geometry: the (diag_b, hot_k) grid around the cost model's choice;
  ``--quick`` keeps its grid, hot_k 8192 included;
- the kernels' block rows: not swept.  The CUDA kernels size their own
  launches, so one line says so where the JAX script sweeps
  ``block_rows``;
- the tier compute dtype: float32 against bfloat16;
- residual tiling: res_tile x res_ob (not with ``--quick``), less the
  JAX grid's 512-slot tile, which the residual kernels do not take
  (``spmm_cuda.MAX_RES_TILE``): a line names it.

A config that fails fails the run: there is no catch-all around a config
(the JAX script's caught the TPU compiler's memory overflows, which have
no counterpart here, and on the card it would hide a failed kernel).

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.levers [--quick]
           [--dtype float32|bfloat16] [--device cpu]
Prints one line per config: config, ms, Gedge/s; then the best config.
``--device cpu`` runs the plain versions on the host (host times).
"""

from __future__ import annotations

import itertools
import sys


def _bench_graph(dim: int = 16):
    from gnnadvisor_osdi21_tpu_torch.bench.datasets import bench_graph
    from gnnadvisor_osdi21_tpu_torch.graphs.reorder import rabbit_reorder_graph

    return rabbit_reorder_graph(bench_graph(dim))


def main(argv=None) -> int:
    import numpy as np
    import torch

    from gnnadvisor_osdi21_tpu_torch.device import resolve_device
    from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import (
        build_hybrid, choose_tiers, graph_fingerprint,
    )
    from gnnadvisor_osdi21_tpu_torch.ops.aggregate import sag
    from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import build_hybrid_tensors
    from gnnadvisor_osdi21_tpu_torch.ops.spmm_cuda import MAX_RES_TILE
    from gnnadvisor_osdi21_tpu_torch.utils.timing import chained_device_time

    argv = list(sys.argv[1:] if argv is None else argv)
    quick = "--quick" in argv
    base_dtype = (
        argv[argv.index("--dtype") + 1] if "--dtype" in argv else "float32"
    )
    dev = resolve_device(
        argv[argv.index("--device") + 1] if "--device" in argv else None)
    dim = 16
    graph = _bench_graph(dim)
    print(f"# graph: N={graph.num_nodes} nnz={graph.nnz} (after rabbit), "
          f"fingerprint {graph_fingerprint(graph)}", flush=True)

    src = np.repeat(
        np.arange(graph.num_nodes, dtype=np.int64),
        np.diff(np.asarray(graph.row_pointers, dtype=np.int64)),
    )
    auto_b, auto_k = choose_tiers(
        src, np.asarray(graph.column_index, dtype=np.int64), graph.num_nodes
    )
    print(f"# cost-model choice: diag_b={auto_b} hot_k={auto_k}", flush=True)

    def run(tag, hg, agg_dtype=None):
        agg_dtype = agg_dtype or base_dtype
        ht = build_hybrid_tensors(hg, device=dev, agg_dtype=agg_dtype,
                                  transposed=False)
        xx = torch.ones((hg.num_rows, dim), dtype=torch.float32, device=dev)
        with torch.no_grad():
            sec = chained_device_time(
                lambda a, h: sag(a, h), xx, ht, iters=20 if quick else 50,
                reps=3)
        ms = sec * 1e3
        print(
            f"{tag:58s} {ms:8.3f} ms  {graph.nnz / sec / 1e9:6.2f} Gedge/s",
            flush=True,
        )
        return ms, tag

    results = []

    # 1) tier grid around the auto choice
    b_grid = sorted({auto_b, 512, 1024, 2048, 4096} - {0})
    k_grid = sorted({auto_k, 512, 1024, 2048, 4096} - {0})
    if quick:
        b_grid, k_grid = [auto_b or 2048], sorted({auto_k or 4096, 8192})
    layouts = {}
    for b, k in itertools.product(b_grid, k_grid):
        hg = layouts.setdefault((b, k), build_hybrid(graph, hot_k=k, diag_b=b))
        results.append(run(f"tiers diag_b={b} hot_k={k}", hg))

    # best tier layout feeds the remaining sweeps
    hg = layouts[
        min(
            (m, bk) for (m, t), bk in zip(results, itertools.product(b_grid, k_grid))
        )[1]
    ]

    # 2) block_rows: the TPU kernels' geometry knob has no counterpart
    print("# block_rows: not swept; the CUDA kernels size their own launches",
          flush=True)

    # 3) compute dtype
    other = "float32" if base_dtype == "bfloat16" else "bfloat16"
    results.append(run(f"agg_dtype={other}", hg, agg_dtype=other))

    # 4) residual tiling (the JAX grid; its 512-slot tile is past what the
    # residual kernels stage, so that config is named and not run)
    if not quick:
        for rt, ob in ((128, 256), (256, 256), (512, 256), (256, 512)):
            if rt > MAX_RES_TILE:
                print(f"# res_tile={rt} res_ob={ob}: not run; the residual "
                      f"kernels take tiles of up to {MAX_RES_TILE} slots",
                      flush=True)
                continue
            hg2 = build_hybrid(
                graph, hot_k=hg.hot_k, diag_b=hg.diag_b,
                res_tile=rt, res_ob=ob,
            )
            results.append(run(f"res_tile={rt} res_ob={ob}", hg2))

    best = min(results)
    print(f"# BEST: {best[1]} @ {best[0]:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
