"""Communication-overlap ablation for the distributed hybrid path: the port
of ``gnnadvisor_osdi21_tpu/tools/overlap_ablation.py``.

The diagonal tier reads only the rank's own rows, so its slab kernel can
run while the halo exchange is in flight.  This tool times the SAME
sharded training step in two builds (``dist_hybrid``):

- ``overlap=True``: the diagonal tier is issued before the exchange's
  ``wait()`` (the shipped configuration), and
- ``overlap=False``: it is issued after the ``wait()`` (identical math and
  identical bytes moved, the kernel ordered after the exchange),

and optionally writes a ``torch.profiler`` trace of each.  Any step-time
gap between the two is time the exchange spends hidden behind the
diagonal tier.

The ranks are processes (``parallel.mesh.run_ranks``): ``--devices N``
is N NCCL ranks, one card each, whose timed steps replay the step
captured as one CUDA graph (CUDA events); with ``--device cpu`` N gloo
ranks, step by step, timed by the host's clock.  A layout without a
diagonal tier runs one program in both arms: then the ablation measures
nothing, and a ``#`` line says so (``run(diag_b=...)`` forces a tier).

Usage: python -m gnnadvisor_osdi21_tpu_torch.tools.overlap_ablation
           [--devices 1] [--nodes 200000] [--epochs 30] [--trace DIR]
           [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

WARMUP = 5  # untimed steps of each arm (capture follows them on NCCL)
DIM, HIDDEN = 32, 16


def _rank_ablation(group, sg, model, x, y, classes, epochs, trace, out_dir):
    """One rank: both arms' steps from the same weights, each timed; their
    ms, every step's loss and the hybrid kernels' launches into
    ``rank<r>.npz``."""
    import torch

    from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda
    from gnnadvisor_osdi21_tpu_torch.ops.aggregate import exact_f32_matmul
    from gnnadvisor_osdi21_tpu_torch.parallel import dist_hybrid, dist_ops

    if group.device.type == "cuda":
        exact_f32_matmul()
    spmm_cuda.reset_launches()
    res = {}
    for overlap in (True, False):
        step, init = dist_hybrid.make_dist_train_step(group, sg, model,
                                                      overlap=overlap)
        net, opt, xb, yb = init(torch.Generator().manual_seed(0), DIM, HIDDEN,
                                classes, x, y)
        trace_dir = (os.path.join(trace, f"overlap_{overlap}",
                                  f"rank{group.rank}") if trace else None)
        ms, losses = dist_ops.timed_dist_steps(
            step, net, opt, xb, yb, group, WARMUP, epochs,
            capture=group.backend == "nccl", trace_dir=trace_dir)
        res[f"ms_{overlap}"] = np.asarray(ms)
        res[f"losses_{overlap}"] = np.asarray(losses)
    for name, n in spmm_cuda.launches.items():
        res[f"launches_{name}"] = np.asarray(n)
    np.savez(os.path.join(out_dir, f"rank{group.rank}.npz"), **res)


def run(nodes: int = 200_000, edges: int = 2_400_000, devices: int = 1,
        epochs: int = 30, model: str = "gcn", trace: str = "", device=None,
        diag_b: int | None = None, log=print) -> dict:
    """The ablation on ``devices`` ranks (NCCL on the card, or gloo with
    ``device="cpu"``): the rabbit-reordered community graph, sharded by
    ``shard_graph_hybrid`` (``diag_b`` None: the cost model's tiers), each
    arm ``WARMUP`` steps and then ``epochs`` timed ones.  Returns the ms
    per step of each arm (the slowest rank's), every rank's losses of each
    arm, the hybrid kernels' launches summed over the ranks, and the
    layout's tiers."""
    from gnnadvisor_osdi21_tpu_torch.device import card_description
    from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
    from gnnadvisor_osdi21_tpu_torch.graphs.reorder import (
        rabbit_reorder_graph,
    )
    from gnnadvisor_osdi21_tpu_torch.parallel.hybrid_partition import (
        shard_graph_hybrid,
    )
    from gnnadvisor_osdi21_tpu_torch.parallel.mesh import run_ranks

    card = card_description(device)  # raises without a card, unless cpu
    g = rabbit_reorder_graph(
        synthesize_graph(nodes, edges, num_features=DIM, num_classes=8,
                         kind="community", seed=5)
    )
    sg = shard_graph_hybrid(g, num_devices=devices, diag_b=diag_b)
    log(f"# {nodes} nodes, {g.nnz} edges, {devices} devices, "
        f"diag_b={sg.diag_b} hot_k={sg.hot_k} halo={sg.halo}")
    if not sg.diag_b:
        log("# the layout has no diagonal tier: both arms run one program, "
            "so the ablation measures nothing")
    if card == "cpu":
        log(f"# --device cpu: {devices} gloo ranks, step by step; ms below "
            "are the host's wall milliseconds per step (plain versions), "
            "not card times")
    else:
        log(f"# {devices} NCCL ranks on {card}: ms below are CUDA-event "
            "milliseconds per replay of the step captured as one CUDA graph")
    with tempfile.TemporaryDirectory() as out:
        run_ranks(_rank_ablation, devices, device, args=(
            sg, model, g.init_embedding(DIM, seed=0),
            g.init_labels(g.num_classes), g.num_classes, epochs, trace, out),
            timeout=3600)
        per = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
               for r in range(devices)]
    ms = {ov: max(float(p[f"ms_{ov}"]) for p in per) for ov in (True, False)}
    losses = {ov: [p[f"losses_{ov}"].tolist() for p in per]
              for ov in (True, False)}
    for overlap in (True, False):
        if trace:
            log(f"# trace written to {os.path.join(trace, f'overlap_{overlap}')}")
        log(f"overlap={overlap}: {ms[overlap]:.3f} ms/epoch  "
            f"(loss={losses[overlap][0][-1]:.4f})")
    hidden = ms[False] - ms[True]
    log(f"exchange time hidden behind the diagonal tier: {hidden:.3f} "
        f"ms/epoch ({hidden / max(ms[False], 1e-9):.1%} of the "
        "serialized step)")
    launches = {k[len("launches_"):]: sum(int(p[k]) for p in per)
                for k in per[0] if k.startswith("launches_")}
    return {"ms": ms, "losses": losses, "launches": launches,
            "diag_b": sg.diag_b, "hot_k": sg.hot_k, "hidden_ms": hidden}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=1,
                   help="ranks: NCCL, one card each (gloo with --device cpu)")
    p.add_argument("--nodes", type=int, default=200_000)
    p.add_argument("--edges", type=int, default=2_400_000)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--model", type=str, default="gcn")
    p.add_argument("--trace", type=str, default="",
                   help="write torch.profiler traces under this directory")
    p.add_argument("--device", default=None,
                   help="cpu: gloo ranks and the plain versions (default: "
                        "the card)")
    args = p.parse_args(argv)
    run(args.nodes, args.edges, args.devices, args.epochs, args.model,
        args.trace, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
