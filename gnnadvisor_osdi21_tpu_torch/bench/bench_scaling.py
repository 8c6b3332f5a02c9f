"""Multi-device scaling benchmark, aggregated edges/s against the number of
ranks: the port of ``gnnadvisor_osdi21_tpu/bench/bench_scaling.py``.

The north-star scaling metric (BASELINE.md): at least 2x edges/s at 2
hosts over a single chip on large graphs.  For each rank count the same
GCN step runs on the ELL shards (``parallel/partition.shard_graph``,
``dist_ops``), ranks spawned by ``parallel.mesh.run_ranks``: NCCL, one
card each, the timed steps replaying the step captured as one CUDA graph
(``epoch_ms`` by CUDA events, the slowest rank's); or, with ``--device
cpu``, gloo ranks step by step (``epoch_ms`` the host's wall time, which
a ``#`` line says).  The CSV adds the plan statistics that decide real
scaling: ``halo_rows`` (the plan's padded rows per rank pair) and
``interior_frac`` (the share of neighbor slots the interior parts reduce
while the exchange is in flight).

Each count also gets a model line: per-card compute (the smallest count's
time, divided) against the exchange's bytes (4 exchanges a GCN step, of
the rows the ragged plan ships to its busiest receiver) over the link
rate.  With 2 or more NCCL ranks the rate is measured, from a timed
``all_to_all_single`` of the plan's rows; otherwise it is the H100 SXM's
NVLink data-sheet rate, and the line says so.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.bench_scaling
       [--devices 1,2,4,8] [--nodes N] [--edges E] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile

import numpy as np

WARMUP = 5
EXCHANGE_REPS = 5  # CUDA-event-timed exchanges per rank, median
# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s per card both ways
NVLINK_BYTES_PER_S = 450e9  # one way: a rank ships and receives at once
NVLINK_ORIGIN = ("the H100 SXM's NVLink data-sheet rate (900 GB/s both "
                 "ways), not measured")


def plan_stats(sg) -> tuple[int, float]:
    """(halo_rows, interior_frac) of an ELL sharding: the padded rows per
    rank pair, and the interior parts' share of the neighbor slots."""
    n_int = float(sg.int_lens.sum())
    return int(sg.halo), n_int / max(n_int + float(sg.bnd_lens.sum()), 1.0)


def _rank_scaling(group, sg, dim, x, y, epochs, out_dir):
    """One rank: the GCN step's ms (captured on NCCL), and with several
    NCCL ranks the plan's exchange alone at ``dim`` f32 columns, into
    ``rank<r>.npz``."""
    import torch

    from gnnadvisor_osdi21_tpu_torch.ops.aggregate import exact_f32_matmul
    from gnnadvisor_osdi21_tpu_torch.parallel import dist_ops

    nccl = group.backend == "nccl"
    if nccl:
        exact_f32_matmul()
    step, init = dist_ops.make_dist_train_step(group, sg, "gcn")
    net, opt, xb, yb = init(torch.Generator().manual_seed(0), dim, 16, 16,
                            x, y)
    ms, losses = dist_ops.timed_dist_steps(step, net, opt, xb, yb, group,
                                           WARMUP, epochs, capture=nccl)
    res = {"ms": np.asarray(ms), "loss": np.asarray(losses[-1])}
    if nccl and group.world > 1:
        plan = dist_ops.halo_plan(sg, group.rank, group.device)
        table = torch.randn((plan.block + plan.recv_max, dim),
                            device=group.device)
        dist_ops.halo_exchange(table, plan, group).wait()
        times = []
        for _ in range(EXCHANGE_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dist_ops.halo_exchange(table, plan, group).wait()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        res["exchange_ms"] = np.asarray(statistics.median(times))
        res["exchange_bytes"] = np.asarray(plan.recv_total * dim * 4)
    np.savez(os.path.join(out_dir, f"rank{group.rank}.npz"), **res)


def run(dev_list, nodes: int = 100_000, edges: int = 1_000_000,
        dim: int = 64, epochs: int = 20, device=None, log=print) -> list:
    """The CSV and model lines for each rank count in ``dev_list`` (run in
    increasing order: the smallest count's time is the per-card baseline);
    returns a dict per count (``devices``, ``epoch_ms``, ``edges_per_s``,
    ``halo_rows``, ``interior_frac``, ``link_bytes_per_s``, ``loss``)."""
    from gnnadvisor_osdi21_tpu_torch.device import card_description
    from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
    from gnnadvisor_osdi21_tpu_torch.graphs.reorder import (
        rabbit_reorder_graph,
    )
    from gnnadvisor_osdi21_tpu_torch.parallel.mesh import (
        check_cards, run_ranks,
    )
    from gnnadvisor_osdi21_tpu_torch.parallel.partition import shard_graph

    dev_list = sorted(dev_list)
    check_cards(dev_list[-1], device)  # before the graph is made
    card = card_description(device)
    g = synthesize_graph(nodes, edges, num_features=dim, num_classes=16,
                         kind="web", seed=0)
    g = rabbit_reorder_graph(g)  # locality shrinks the halo
    if card == "cpu":
        log("# --device cpu: gloo ranks step by step; epoch_ms is the "
            "host's wall milliseconds per step (plain versions), not a card "
            "time")
    else:
        log(f"# {card}: NCCL ranks, one card each; epoch_ms is CUDA-event "
            "milliseconds per replay of the step captured as one CUDA graph "
            "(the slowest rank's)")
    log("devices,epoch_ms,edges_per_s,halo_rows,interior_frac")
    x, y = g.init_embedding(dim), g.init_labels(16)
    rows, t1_ms = [], None
    for nd in dev_list:
        sg = shard_graph(g, num_devices=nd)
        with tempfile.TemporaryDirectory() as out:
            run_ranks(_rank_scaling, nd, device,
                      args=(sg, dim, x, y, epochs, out), timeout=3600)
            per = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                   for r in range(nd)]
        ms = max(float(p["ms"]) for p in per)
        halo, interior = plan_stats(sg)
        log(f"{nd},{ms:.2f},{g.nnz / ms * 1e3:.3g},{halo},{interior:.3f}")

        rates = [float(p["exchange_bytes"]) / float(p["exchange_ms"]) * 1e3
                 for p in per if float(p.get("exchange_bytes", 0)) > 0]
        if rates:
            rate = min(rates)
            origin = (f"measured: one all_to_all_single of the plan's rows "
                      f"at {dim} f32 columns, median of {EXCHANGE_REPS}, "
                      "the slowest rank's")
        else:
            rate, origin = NVLINK_BYTES_PER_S, NVLINK_ORIGIN
        # per GCN step each layer exchanges the halo once forward and once
        # backward: 4 exchanges of the busiest receiver's rows
        shipped = int(sg.halo_sizes.sum(axis=1).max()) if nd > 1 else 0
        comm_ms = 4 * shipped * dim * 4 / rate * 1e3
        if t1_ms is None:
            t1_ms = ms * nd  # per-card-equivalent single baseline
        compute_ms = t1_ms / nd
        overlapped = max(compute_ms, comm_ms)
        serial = compute_ms + comm_ms
        log(f"  model nd={nd}: compute/card {compute_ms:.2f} ms, link comm "
            f"{comm_ms:.3f} ms at {rate / 1e9:.1f} GB/s ({origin}) -> epoch "
            f"{overlapped:.2f}-{serial:.2f} ms, speedup x{t1_ms / serial:.2f}"
            f"-x{t1_ms / overlapped:.2f} (interior {interior:.0%} overlaps "
            "the exchange)")
        rows.append({"devices": nd, "epoch_ms": ms,
                     "edges_per_s": g.nnz / ms * 1e3, "halo_rows": halo,
                     "interior_frac": interior, "link_bytes_per_s": rate,
                     "loss": [float(p["loss"]) for p in per]})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=str, default="1,2,4,8")
    p.add_argument("--nodes", type=int, default=100_000)
    p.add_argument("--edges", type=int, default=1_000_000)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--device", default=None,
                   help="cpu: gloo ranks and the plain versions (default: "
                        "the card, NCCL)")
    args = p.parse_args(argv)
    try:
        run([int(d) for d in args.devices.split(",")], args.nodes,
            args.edges, args.dim, args.epochs, args.device)
    except ValueError as e:
        print(f"error: --devices {args.devices}: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
