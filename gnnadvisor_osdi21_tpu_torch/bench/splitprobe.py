"""Probe: do H residual launches, each on a stream of its own, beat one?
The port of ``gnnadvisor_osdi21_tpu/bench/splitprobe.py``.

The JAX probe split the residual tier's two-stage gather chain H ways, so
that the chains could overlap each other's fixed costs.  Here the residual
kernel gathers its own slot rows, so there is no gather chain to split.
What can be split is the launch: the residual stream is cut at output-block
boundaries (``res_block_ptr``) into H parts of about equal tile counts,
and each part is one ``residual_combine_t`` launch over its blocks, on a
side stream, joined back by events; the slab tiers and the tier sum run as
in ``sag``.  Every output block's sum stays inside one launch and in its
order, so the split result must equal the stock ``sag`` bitwise; each
split is checked once before it is timed, and a mismatch exits 1.

Measures the full hybrid ``sag`` with the residual split H ways, H in {2,
4}, against the stock pipeline, on the headline graph (rabbit order, the
auto layout, transposed, bf16 tiers).  Each split line also gives the
rows of x each part reads (the distinct ``res_src`` ids of its slots)
against the stock launch's.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.splitprobe  (on the card)
           [--device cpu]  (the plain versions, one after another: host times)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
    AGG_DTYPES, HybridTensors, slab_tiers_t,
)


def split_parts(ht: HybridTensors, n_split: int) -> list[dict]:
    """The residual stream of ``ht`` cut at output-block boundaries into
    up to ``n_split`` parts of about equal tile counts, each with no empty
    range: per part, the keyword operands of its ``residual_combine_t``
    launch over its blocks (``res_src``, ``mask_s``, ``t2b``, ``block_ptr``
    rebased, ``num_rows``, ``res_ob``), its first output column and the
    number of distinct rows of x it reads."""
    t2b = ht.res_t2b.cpu().numpy()
    ptr = ht.res_block_ptr.cpu().numpy()
    n_tiles, n_blocks = len(t2b), len(ptr) - 1
    s, ob = ht.res_tile, ht.res_ob
    cuts = sorted({0, n_blocks}
                  | {int(t2b[n_tiles * i // n_split]) for i in range(1, n_split)})
    src = ht.res_src.cpu().numpy()
    parts = []
    for b_lo, b_hi in zip(cuts[:-1], cuts[1:]):
        t_lo, t_hi = int(ptr[b_lo]), int(ptr[b_hi])
        if t_hi == t_lo:  # blocks no tile visits: the whole is zero there
            parts.append({"col": b_lo * ob, "rows": (b_hi - b_lo) * ob,
                          "launch": None, "reads": 0})
            continue
        launch = dict(
            res_src=ht.res_src[t_lo * s: t_hi * s],
            mask_s=ht.res_mask_s[:, t_lo * ob: t_hi * ob].contiguous(),
            t2b=ht.res_t2b[t_lo:t_hi] - b_lo,
            block_ptr=ht.res_block_ptr[b_lo: b_hi + 1] - t_lo,
            num_rows=(b_hi - b_lo) * ob, res_ob=ob,
        )
        parts.append({"col": b_lo * ob, "rows": (b_hi - b_lo) * ob,
                      "launch": launch,
                      "reads": len(np.unique(src[t_lo * s: t_hi * s]))})
    return parts


def split_sag(x: torch.Tensor, ht: HybridTensors, parts: list[dict],
              streams: list | None) -> torch.Tensor:
    """``sag(x, ht)`` (x transposed ``[D, R]``) with the residual tier run
    as one launch per part of ``split_parts``, part i on ``streams[i]``
    (None: one after another on the current stream, as on the CPU)."""
    d = x.shape[0]
    table = spmm_cuda.row_table_t(x, AGG_DTYPES[ht.agg_dtype])
    x_t = table.t()[:d]
    slab = slab_tiers_t(table, d, ht)
    main = torch.cuda.current_stream(x.device) if streams else None
    res = []
    for i, part in enumerate(parts):
        if part["launch"] is None:
            res.append(torch.zeros((d, part["rows"]), dtype=torch.float32,
                                   device=x.device))
            continue
        if streams is None:
            res.append(spmm_cuda.residual_combine_t(x_t, **part["launch"]))
            continue
        side = streams[i]
        side.wait_stream(main)
        with torch.cuda.stream(side):
            r = spmm_cuda.residual_combine_t(x_t, **part["launch"])
        # the table is read on the side stream, the part read back on main
        table.record_stream(side)
        r.record_stream(main)
        res.append(r)
    if streams:
        for side in streams[: len(parts)]:
            main.wait_stream(side)
    r = torch.cat(res, dim=1)
    # the stock kernel adds the slab sum to its own: addend + r, the same
    # sum in IEEE f32 as slab + r
    out = r if slab is None else slab + r
    return out.to(x.dtype)


def main(argv=None) -> int:
    from gnnadvisor_osdi21_tpu_torch.bench.datasets import bench_graph
    from gnnadvisor_osdi21_tpu_torch.device import resolve_device
    from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import (
        build_hybrid, graph_fingerprint,
    )
    from gnnadvisor_osdi21_tpu_torch.graphs.reorder import rabbit_reorder_graph
    from gnnadvisor_osdi21_tpu_torch.ops.aggregate import sag
    from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import build_hybrid_tensors
    from gnnadvisor_osdi21_tpu_torch.utils.timing import chained_device_time

    argv = list(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(
        argv[argv.index("--device") + 1] if "--device" in argv else None)
    g = rabbit_reorder_graph(bench_graph(16))
    hg = build_hybrid(g, device=dev)
    print(f"# graph: N={g.num_nodes} nnz={g.nnz}, fingerprint "
          f"{graph_fingerprint(g)}; tiers diag_b {hg.diag_b} hot_k "
          f"{hg.hot_k} res_ob {hg.res_ob} res_tile {hg.res_tile} "
          f"({len(hg.res_t2b)} tiles), tier probe {hg.tier_probe}",
          flush=True)
    if not hg.num_res_slots:
        print("# the layout has no residual tier: nothing to split")
        return 0
    ht = build_hybrid_tensors(hg, device=dev, transposed=True,
                              agg_dtype="bfloat16")
    x = torch.ones((16, hg.num_rows), dtype=torch.float32, device=dev)
    stock_reads = len(np.unique(ht.res_src.cpu().numpy()))
    with torch.no_grad():
        stock = sag(x, ht)
        sec = chained_device_time(lambda a, h: sag(a, h), x, ht, iters=50)
        print(f"stock pipeline: {sec*1e3:7.3f} ms", flush=True)

        for n_split in (2, 4):
            parts = split_parts(ht, n_split)
            streams = ([torch.cuda.Stream(dev) for _ in parts]
                       if dev.type == "cuda" else None)

            def run(a, h):
                return split_sag(a, h, parts, streams)

            if not torch.equal(run(x, ht), stock):
                print(f"{n_split}-way split residual: MISMATCH against the "
                      "stock sag")
                return 1
            sec = chained_device_time(run, x, ht, iters=50)
            reads = [p["reads"] for p in parts]
            print(
                f"{n_split}-way split residual: {sec*1e3:7.3f} ms "
                f"(bitwise equal to the stock sag; {len(parts)} launches, "
                f"rows read per part {reads}, {sum(reads)} in all against "
                f"{stock_reads} in one launch)",
                flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
