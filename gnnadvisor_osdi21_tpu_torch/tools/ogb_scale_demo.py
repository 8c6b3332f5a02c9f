"""One-card scale demonstration at ogbn-products size: the port of
``gnnadvisor_osdi21_tpu/tools/ogb_scale_demo.py``.

BASELINE.md's scaling target names ogbn-products-scale graphs (2.45M
nodes, about 124M directed edges).  This tool synthesizes a web-structured
graph at that scale (no download), reorders it (rabbit order, unless
``--skip_reorder``), builds the tuned hybrid layout (the tier choice, with
the tier probe on the card as the JAX build probes on its TPU; the
residual geometry), and runs one transposed SpMM at D = 16 and a few full
GCN training steps at the real width on the card: evidence that the
one-card layout and kernels hold far beyond the 15-dataset roster.

``--shard_devices 16,64`` also builds the sharded layout at those device
counts and prints its exchange: the rows a uniform exchange would ship
against the ragged one the port ships (``dense_exchange_rows`` /
``ragged_exchange_rows``), and the port's plan bytes per device (its
``send_rows`` and the two split lists, ``parallel/dist_ops.HaloPlan``).

``--device cpu`` runs the plain versions on the host: its times are the
host's, which the ``#`` line says.  The tool checks itself: on all-ones
features each row's SpMM sum must equal its degree exactly, and the
loss must be finite (exit 1 otherwise).

Usage: python -m gnnadvisor_osdi21_tpu_torch.tools.ogb_scale_demo
           [--nodes N] [--edges E] [--dim D] [--skip_reorder]
           [--shard_devices 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np


def plan_bytes(sg) -> int:
    """The largest per-device exchange plan of a sharded layout, in bytes:
    its ``send_rows`` (int64) and its two split lists (an int64 per
    peer)."""
    return int(sg.halo_send_sizes.sum(axis=1).max()) * 8 \
        + 2 * sg.num_devices * 8


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nodes", type=int, default=2_449_029)
    p.add_argument("--edges", type=int, default=61_859_140,
                   help="default: ogbn-products' undirected edge count "
                        "(the loader dedups; 2x when counting directions)")
    p.add_argument("--dim", type=int, default=100)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--classes", type=int, default=47)
    p.add_argument("--skip_reorder", action="store_true")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--shard_devices", default="",
                   help="comma list (e.g. 16,64): also build the sharded "
                        "layout at these device counts and report the "
                        "plan-build time + ragged-vs-dense exchange rows")
    p.add_argument("--device", default=None,
                   help="cpu: the plain versions on the host (default: the "
                        "card)")
    args = p.parse_args(argv)

    import torch

    from gnnadvisor_osdi21_tpu_torch.device import (
        card_description, resolve_device,
    )
    from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import build_hybrid
    from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
    from gnnadvisor_osdi21_tpu_torch.graphs.reorder import (
        rabbit_reorder_graph,
    )
    from gnnadvisor_osdi21_tpu_torch.ops.aggregate import sag
    from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import build_layer_tensors
    from gnnadvisor_osdi21_tpu_torch.train import train_and_time
    from gnnadvisor_osdi21_tpu_torch.utils.timing import chained_device_time

    dev = resolve_device(args.device)
    on_host = dev.type == "cpu"
    print(f"# device: {card_description(dev)}"
          + ("; times below are the host's wall times (plain versions), "
             "not card times" if on_host else ""), flush=True)

    t0 = time.perf_counter()
    g = synthesize_graph(args.nodes, args.edges, num_features=args.dim,
                         num_classes=args.classes, kind="web", seed=0)
    print(f"synthesize: {time.perf_counter()-t0:.1f}s "
          f"(N={g.num_nodes:,} nnz={g.nnz:,})", flush=True)

    if not args.skip_reorder:
        t0 = time.perf_counter()
        g = rabbit_reorder_graph(g)
        print(f"rabbit reorder: {time.perf_counter()-t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    hg = build_hybrid(g, device=dev)
    print(
        f"hybrid build: {time.perf_counter()-t0:.1f}s | "
        f"diag_b={hg.diag_b} hot_k={hg.hot_k} res_ob={hg.res_ob} "
        f"res_tile={hg.res_tile} | edges diag={hg.num_diag_edges:,} "
        f"hot={hg.num_hot_edges:,} res={hg.num_res_edges:,} "
        f"(pairs={hg.num_res_pairs:,} slots={hg.num_res_slots:,})",
        flush=True,
    )
    # the exchange at several device counts: the ragged plan ships
    # Σ halo_sizes rows where a uniform one would ship ndev·Hmax
    for nd in [int(v) for v in args.shard_devices.split(",") if v]:
        from gnnadvisor_osdi21_tpu_torch.parallel.hybrid_partition import (
            shard_graph_hybrid,
        )

        t0 = time.perf_counter()
        sg = shard_graph_hybrid(g, num_devices=nd)
        dense = sg.dense_exchange_rows
        ragged = sg.ragged_exchange_rows
        print(
            f"shard plan nd={nd}: build {time.perf_counter()-t0:.1f}s | "
            f"Hmax={sg.halo} dense all_to_all rows/dev={dense:,} "
            f"ragged rows/dev={ragged:,} "
            f"({dense / max(ragged, 1):.1f}x fewer bytes on the wire) | "
            f"plan bytes/dev {plan_bytes(sg):,} (send_rows and the split "
            "lists)",
            flush=True,
        )

    ht = build_layer_tensors(hg, device=dev, agg_dtype="bfloat16")

    # one SpMM at dim 16 (the kernel-bench protocol shape)
    x16 = torch.ones((16, hg.num_rows), dtype=torch.float32, device=dev)
    sec = chained_device_time(lambda a, h: sag(a, h), x16, ht[0], iters=20)
    print(f"SpMM dim=16: {sec*1e3:.3f} ms ({g.nnz/sec/1e9:.2f} Gedge/s)",
          flush=True)
    # on all-ones x each row's sum is its degree, exactly (integers in f32)
    degrees = torch.zeros(hg.num_rows)
    degrees[: g.num_nodes] = torch.from_numpy(
        np.diff(g.row_pointers).astype(np.float32))
    sums_ok = torch.equal(sag(x16, ht[0]).cpu(),
                          degrees.expand(16, -1).contiguous())
    print("SpMM dim=16 on all-ones x: each row's sum equals its degree: "
          + ("exact" if sums_ok else "MISMATCH"), flush=True)
    del x16

    # a few full GCN train epochs at the real feature dim (train_and_time
    # transposes x itself for the transposed layout)
    x = hg.pad_array(g.init_embedding(args.dim, seed=0))
    y = hg.pad_array(g.init_labels(args.classes))
    t0 = time.perf_counter()
    r = train_and_time(
        "gcn", ht, x, y, hidden=args.hidden, num_classes=args.classes,
        num_epochs=args.epochs, dry_run=2, mask=hg.row_mask, device=dev,
    )
    epoch_ms = r["epoch_ms"]
    if epoch_ms is None:  # the host: its wall time per step
        epoch_ms = (time.perf_counter() - t0) * 1e3 / len(r["losses"])
    print(
        f"GCN dim={args.dim} h={args.hidden}: {epoch_ms:.1f} ms/epoch "
        f"({g.nnz * 2 / epoch_ms * 1e3 / 1e9:.2f} Gedge/s fwd+bwd), "
        f"loss={r['final_loss']:.4f}",
        flush=True,
    )
    return 0 if sums_ok and math.isfinite(r["final_loss"]) else 1


if __name__ == "__main__":
    sys.exit(main())
