"""Command-line entry point, flag-compatible with the reference's
``GNNA_main.py``: the port of ``gnnadvisor_osdi21_tpu/cli.py``.

The parser takes every option of the JAX package's, with its defaults and
choices (GNNA_main.py:15-41 plus the JAX package's additions).  What the
port does with them:

- dataset selection (``--dataDir --dataset --dim --hidden --classes
  --loadFromTxt``, ``--synthetic N:E:kind``; a roster name without its
  ``.npz`` synthesizes, ``bench/datasets.py``), the model and epochs
  (``--model --num_epoches``), ``--method``, ``--diagB``/``--hotK``,
  ``--agg_dtype``, ``--gemm_dtype``, ``--seed``, the mode flags
  (``--manual_mode --verbose_mode --enable_rabbit``) and ``--partSize``:
  as the JAX package does;
- ``--dimWorker``, ``--warpPerBlock`` and ``--sharedMem`` are accepted
  and unused: the CUDA kernels size their own launches
  (``tuner/decider.py``);
- ``--use_scan True`` (the default) trains through the captured step
  (a CUDA graph replayed, ``train.make_captured_step``), ``False`` step
  by step;
- ``--save_ckpt``/``--resume``: checkpoints in the JAX package's schema;
- ``--verify_spmm`` (unitest.py:9-63) and ``--single_spmm``
  (unitest.py:65-80): ``verification.py``;
- ``--platform default`` runs on the card and fails without one;
  ``cpu`` runs the plain versions on the host;
- ``--num_devices N > 1`` trains on N ranks (``parallel/``), spawned
  here: NCCL with one card per rank (fewer cards than ranks exits
  non-zero, naming both counts), or gloo on the host with ``--platform
  cpu``.  ``--method auto|hybrid`` shards the hybrid layout
  (``dist_hybrid``, honouring ``--diagB``, ``--hotK``, ``--agg_dtype``),
  any other method the ELL one (``dist_ops``); 10 warm-up steps, then
  ``--num_epoches`` timed steps, and rank 0 prints ``Time (ms):``.  On
  NCCL with ``--use_scan True`` the timed steps replay the step captured
  as one CUDA graph, CUDA-event milliseconds per step; otherwise (gloo,
  or ``--use_scan False``) they run step by step, the host's wall
  milliseconds per step (the step ends on the loss's fetch), and on gloo
  the ``#`` line before says so.

Booleans are the strings 'True'/'False', as in the reference (:34-39).
The last line is ``Time (ms): <epoch ms>`` (GNNA_main.py:202, which the
JAX package's log-to-CSV tools scrape).  With ``--platform cpu`` it holds
the host's wall milliseconds per step, and the line before says so.
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GNNAdvisor on PyTorch/CUDA")
    p.add_argument("--dataDir", type=str, default="./data", help="the path to graphs")
    p.add_argument("--dataset", type=str, default="synthetic", help="dataset name")
    p.add_argument("--dim", type=int, default=96, help="input embedding dimension")
    p.add_argument("--hidden", type=int, default=16, help="hidden dimension")
    p.add_argument("--classes", type=int, default=22, help="output classes")
    p.add_argument("--model", type=str, default="gcn", choices=["gcn", "gin"])
    p.add_argument("--num_epoches", type=int, default=200)
    # the reference's manual performance parameters
    p.add_argument("--partSize", type=int, default=32, help="neighbor-group size")
    p.add_argument("--dimWorker", type=int, default=32,
                   help="accepted, unused: the kernels size their launches")
    p.add_argument("--warpPerBlock", type=int, default=8,
                   help="accepted, unused: the kernels size their launches")
    p.add_argument("--sharedMem", type=int, default=16384,
                   help="accepted, unused: the kernels size their launches")
    # string booleans, reference-style
    for name, default, hlp in (
        ("manual_mode", "True", "manual vs auto parameter selection"),
        ("verbose_mode", "False", "verbose prints"),
        ("enable_rabbit", "False", "community reordering"),
        ("loadFromTxt", "False", "load TXT edge list instead of .npz"),
        ("single_spmm", "False", "profile the single SpMM kernel"),
        ("verify_spmm", "False", "verify SpMM against the CPU reference"),
        ("use_scan", "True", "train through the step captured as a CUDA graph"),
    ):
        p.add_argument(
            f"--{name}", type=str, choices=["True", "False"], default=default, help=hlp
        )
    p.add_argument(
        "--method",
        type=str,
        default="auto",
        choices=["auto", "dense", "ell", "coo", "hybrid"],
        help="aggregation path (auto = the decider chooses)",
    )
    p.add_argument(
        "--synthetic",
        type=str,
        default="",
        help="generate a graph: 'N:E:kind' (e.g. 410236:4878874:web)",
    )
    p.add_argument("--num_devices", type=int, default=1,
                   help="ranks to train on: one card each (NCCL), or host "
                        "processes with --platform cpu (gloo)")
    p.add_argument("--diagB", type=int, default=-1,
                   help="hybrid diagonal-tier block rows (-1 = cost model, 0 = off)")
    p.add_argument("--hotK", type=int, default=-1,
                   help="hybrid hot-tier slab columns (-1 = cost model, 0 = off)")
    p.add_argument("--gemm_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="model GEMM operand dtype (f32 = the reference's "
                        "contract; bf16 operands with f32 accumulation)")
    p.add_argument("--agg_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="hybrid-tier operand dtype (f32 accumulation either "
                        "way)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_ckpt", type=str, default="",
                   help="save (params, opt_state, step) to this path after training")
    p.add_argument("--resume", type=str, default="",
                   help="restore (params, opt_state, step) from this path first")
    p.add_argument("--platform", type=str, default="default",
                   choices=["default", "cpu"],
                   help="default = the CUDA card (fails without one); cpu = "
                        "the plain versions on the host")
    return p


def load_dataset(args):
    from gnnadvisor_osdi21_tpu_torch.graphs.loader import (
        load_graph, synthesize_graph,
    )

    verbose = args.verbose_mode == "True"
    if args.synthetic:
        n, e, kind = args.synthetic.split(":")
        return synthesize_graph(
            int(n), int(e), num_features=args.dim, num_classes=args.classes,
            kind=kind, seed=args.seed,
        )
    if args.loadFromTxt == "True":
        path = osp.join(args.dataDir, args.dataset)
        return load_graph(
            path, num_features=args.dim, num_classes=args.classes,
            load_from_txt=True, verbose=verbose,
        )
    path = osp.join(args.dataDir, args.dataset + ".npz")
    if not osp.exists(path):
        # roster datasets synthesize (and cache) a matching topology when
        # the real .npz is not present
        from gnnadvisor_osdi21_tpu_torch.bench.datasets import (
            DATASETS, get_dataset,
        )

        if args.dataset in DATASETS:
            return get_dataset(
                args.dataset, data_dir=args.dataDir,
                dim=args.dim, classes=args.classes,
            )
    return load_graph(
        path, num_features=args.dim, num_classes=args.classes, verbose=verbose
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print(args)
    import torch

    from gnnadvisor_osdi21_tpu_torch.device import resolve_device
    from gnnadvisor_osdi21_tpu_torch.train import train_and_time
    from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty

    device = "cpu" if args.platform == "cpu" else None
    if args.num_devices > 1:
        from gnnadvisor_osdi21_tpu_torch.parallel.mesh import check_cards

        try:
            check_cards(args.num_devices, device)
        except ValueError as e:
            print(f"error: --num_devices {args.num_devices}: {e}",
                  file=sys.stderr)
            return 2
    dev = resolve_device(device)
    on_host = dev.type == "cpu"
    host_note = ("# --platform cpu: Time (ms) below is the host's wall "
                 "milliseconds per {} (plain versions), not a card time")
    graph = load_dataset(args)
    verbose = args.verbose_mode == "True"
    manual = args.manual_mode == "True"

    prop = InputProperty(
        graph,
        hidden_dim=args.hidden,
        part_size=args.partSize if manual else None,
        method=None if args.method == "auto" else args.method,
        diag_b=None if args.diagB < 0 else args.diagB,
        hot_k=None if args.hotK < 0 else args.hotK,
        model=args.model,
        enable_reorder=args.enable_rabbit == "True",
        manual_mode=manual,
        verbose=verbose,
        agg_dtype=args.agg_dtype,
        gemm_dtype=args.gemm_dtype,
        # verification checks correctness, not tier quality: no probe
        probe=False if args.verify_spmm == "True" else None,
    ).decider()
    if args.num_devices > 1:
        return run_multi_device(args, prop.graph, device)
    hts = prop.build_tensors(device=device)
    graph = prop.graph

    # -- kernel verification / profiling modes ----------------------------
    if args.verify_spmm == "True" or args.single_spmm == "True":
        from gnnadvisor_osdi21_tpu_torch.verification import Verification

        valid = Verification(args.hidden, prop, hts[0])
        if args.verify_spmm == "True":
            valid.compute()
            valid.reference()
            return 0 if valid.compare() else 1
        ms = valid.profile_spmm(rounds=args.num_epoches)
        if on_host:
            print(host_note.format("aggregation"))
        print(f"Time (ms): {ms:.3f}")
        return 0

    # -- training ---------------------------------------------------------
    # features randn (dataset.py:129) and labels all-ones (dataset.py:136),
    # made on the device, in the tensors' row space
    n_rows = (
        prop.hybrid_graph.num_rows if prop.hybrid_graph is not None
        else graph.num_nodes
    )
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((n_rows, args.dim), generator=gen, device=dev)
    y = torch.ones((n_rows,), dtype=torch.int64, device=dev)
    mask = None
    if prop.hybrid_graph is not None:
        mask = prop.hybrid_graph.row_mask
    start = time.perf_counter()
    res = train_and_time(
        args.model, hts, x, y,
        hidden=args.hidden, num_classes=graph.num_classes,
        num_epochs=args.num_epoches, mask=mask, seed=args.seed,
        device=device, use_scan=args.use_scan == "True",
        save_ckpt=args.save_ckpt or None, resume=args.resume or None,
    )
    ms = res["epoch_ms"]
    if on_host:
        ms = (time.perf_counter() - start) * 1e3 / max(len(res["losses"]), 1)
        print(host_note.format("training step"))
    if verbose:
        print(f"# warmup (s): {res['warmup_s']:.2f}  final loss: "
              f"{res['final_loss']:.4f}  step: {res['step']}")
    print(f"Time (ms): {ms:.3f}")
    return 0



def run_multi_device(args, graph, device) -> int:
    """The multi-device path (JAX cli.py:171-225): shard ``graph`` on the
    host, spawn ``--num_devices`` ranks and train on them."""
    from gnnadvisor_osdi21_tpu_torch.parallel.mesh import run_ranks

    if args.method in ("auto", "hybrid"):
        from gnnadvisor_osdi21_tpu_torch.parallel.hybrid_partition import (
            shard_graph_hybrid,
        )

        # the widest aggregate the model's layers run (the sharded
        # layout's residual gather form is fixed for all of them)
        agg_dim = (max(args.dim, args.hidden) if args.model == "gin"
                   else max(args.hidden, args.classes))
        path = "hybrid"
        sg = shard_graph_hybrid(
            graph, num_devices=args.num_devices,
            diag_b=None if args.diagB < 0 else args.diagB,
            hot_k=None if args.hotK < 0 else args.hotK,
            agg_feature_dim=agg_dim,
        )
    else:
        from gnnadvisor_osdi21_tpu_torch.parallel.partition import (
            shard_graph,
        )

        path = "ell"
        sg = shard_graph(graph, num_devices=args.num_devices)
    run_ranks(_train_rank, args.num_devices, device, args=(
        path, sg, args.model, args.dim, args.hidden, graph.num_classes,
        graph.init_embedding(args.dim, seed=args.seed),
        graph.init_labels(graph.num_classes), args.seed, args.agg_dtype,
        args.num_epoches, args.use_scan == "True",
    ))
    return 0


def _train_rank(group, path, sg, model, dim, hidden, classes, x, y, seed,
                agg_dtype, epochs, use_scan) -> None:
    """One rank of ``run_multi_device``: 10 warm-up steps, then ``epochs``
    timed ones; rank 0 prints the milliseconds per step.  On NCCL with
    ``use_scan`` the timed steps replay the step captured as one CUDA graph
    (``dist_ops.make_captured_dist_step``), timed by CUDA events; otherwise
    they run step by step, timed by the host's clock up to the loss's
    fetch."""
    import torch

    from gnnadvisor_osdi21_tpu_torch.ops.aggregate import exact_f32_matmul
    from gnnadvisor_osdi21_tpu_torch.parallel import dist_hybrid, dist_ops

    if group.device.type == "cuda":
        exact_f32_matmul()
    if path == "hybrid":
        step, init = dist_hybrid.make_dist_train_step(
            group, sg, model, agg_dtype=agg_dtype)
    else:
        step, init = dist_ops.make_dist_train_step(group, sg, model)
    net, opt, xb, yb = init(torch.Generator().manual_seed(seed), dim, hidden,
                            classes, x, y)
    capture = use_scan and group.backend == "nccl"
    ms, _ = dist_ops.timed_dist_steps(step, net, opt, xb, yb, group, 10,
                                      epochs, capture)
    if group.rank == 0:
        if capture:
            print(f"# {group.world} NCCL ranks: Time (ms) below is the step "
                  "captured as one CUDA graph, CUDA-event milliseconds per "
                  "replay", flush=True)
        elif group.device.type == "cpu":
            print("# --platform cpu: Time (ms) below is the host's wall "
                  f"milliseconds per training step on {group.world} gloo "
                  "ranks (plain versions), not a card time; the ranks ran "
                  "step by step (gloo collectives cannot be captured)",
                  flush=True)
        print(f"Time (ms): {ms:.3f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
