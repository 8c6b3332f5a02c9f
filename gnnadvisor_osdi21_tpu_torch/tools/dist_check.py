"""The distributed paths on one rank of a real process group, against the
single-card paths on the same device: the port of
``gnnadvisor_osdi21_tpu/tools/tpu_dist_check.py``.

    python -m gnnadvisor_osdi21_tpu_torch.tools.dist_check
    python -m gnnadvisor_osdi21_tpu_torch.tools.dist_check --device cpu --nodes 3000 --edges 40000
    python -m gnnadvisor_osdi21_tpu_torch.tools.dist_check --ranks 4   # 4 cards

A group of one rank (NCCL on the card, gloo with ``--device cpu``) runs
the whole distributed program: the exchange (a collective that ships no
rows at one rank), ``slab_matmul_t`` and ``residual_combine_t`` inside the
distributed aggregation, the loss summed over the ranks, the backward
through the same aggregation, the gradients summed over the ranks and
Adam.  On the layout ``shard_graph_hybrid(g, 1)`` chooses and the
single-card layout of the same tiers and geometry, it checks:

- the aggregate, norm on and off, overlap on and off, f32 and bf16
  tiers, against ``hybrid_aggregate``;
- GCN's loss and gradients (f32 and bf16 tiers) against the single-card
  model with the same weights (``params_from_jax``);
- ``steps`` Adam steps (bf16 tiers): the losses against the single-card
  step's, each step's time by CUDA events (on the card), and the hybrid
  kernels' launches per step;
- the ELL twin (``dist_ops``) against the single-card ELL aggregation;
- on NCCL, each path's step captured as one CUDA graph
  (``dist_ops.make_captured_dist_step``) against the same step run step
  by step from the same weights: ``steps`` Adam steps' losses and the
  final weights within CAPTURE_RTOL; the captured step's ms (CUDA
  events) and device busy time (``torch.profiler``) beside the
  step-by-step one's.  A gloo group cannot capture: on the host the
  check is that asking it to raises.

``--ranks N`` (``run_ranks_check``) runs the same program on N ranks,
one card each (or N gloo processes with ``--device cpu``), and holds the
ranks' results put together against the single-card paths on the first
card; it also times each rank's step (step by step and, on NCCL,
captured, held against each other) and its exchange alone.  Exit code
0 when every check holds.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import HybridGraph, build_hybrid
from gnnadvisor_osdi21_tpu_torch.graphs.loader import GraphCSR, synthesize_graph
from gnnadvisor_osdi21_tpu_torch.models.gcn import GCN
from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import (
    aggregate, exact_f32_matmul,
)
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import build_graph_tensors
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
    build_hybrid_tensors, hybrid_aggregate,
)
from gnnadvisor_osdi21_tpu_torch.parallel import dist_hybrid, dist_ops, mesh
from gnnadvisor_osdi21_tpu_torch.parallel.hybrid_partition import (
    shard_graph_hybrid,
)
from gnnadvisor_osdi21_tpu_torch.parallel.partition import shard_graph
from gnnadvisor_osdi21_tpu_torch.train import (
    make_optimizer, make_train_step, nll_loss, warm_up,
)

# distributed against single-card: the same kernels on the same table rows
# (one rank ships nothing), so at most f32 summation order in the loss
AGG_RTOL = 1e-5  # elementwise, and of the largest value
LOSS_RTOL = 1e-4  # losses over the steps and gradients, relative
# the captured step against the step-by-step loop: the same kernels and
# collectives in the same order, so equal up to the last bits
CAPTURE_RTOL = 1e-6
TIMED_REPLAYS = 20  # CUDA-event-timed replays of a captured step


class Checks:
    """The checks' results: each a label, an error, its bound and a
    verdict, printed as they come."""

    def __init__(self, log=print):
        self.log = log
        self.rows: list[tuple[str, float, float, bool]] = []

    def add(self, label: str, err: float, bound: float, ok: bool) -> None:
        self.rows.append((label, err, bound, ok))
        self.log(f"  {label}: error {err:.3e} (bound {bound:.1e}) "
                 f"{'ok' if ok else 'FAIL'}")

    def close(self, label: str, got: torch.Tensor, want: torch.Tensor,
              rtol: float = AGG_RTOL) -> None:
        """``got`` within rtol·|want| + rtol·max|want| of ``want``."""
        scale = float(want.abs().max())
        err = (got - want).abs()
        ok = (got.shape == want.shape
              and bool((err <= rtol * want.abs() + rtol * scale).all()))
        self.add(label, float(err.max()) / max(scale, 1e-30), rtol, ok)

    @property
    def ok(self) -> bool:
        return all(r[3] for r in self.rows)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_steps(step, n: int, dev: torch.device):
    """Run ``step()`` n times; returns (losses, ms per step: CUDA events
    on the card, None on the host)."""
    losses, times = [], []
    for _ in range(n):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step())
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            losses.append(step())
    return torch.stack(losses).tolist(), times or None


def _device_profile(step, dev: torch.device, steps: int = 3):
    """Device time of ``steps`` steps by ``torch.profiler`` (after one
    warm-up step inside it, each step finished before the next): the busy
    ms per step and the largest entries as (name, ms per step, launches
    per step).  Device-side entries only, without the user annotations'
    ranges, which repeat their kernels' time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps)) as prof:
        for i in range(steps + 1):
            step()
            torch.cuda.synchronize(dev)
            if i < steps:
                prof.step()
    events = [(e.key, e.self_device_time_total / steps / 1e3,
               e.count // steps)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e[1])
    return sum(e[1] for e in events), events[:10]


def captured_against_eager(label: str, step, init, group, steps: int,
                           checks: Checks, log=print) -> dict:
    """``step(net, opt, x, y)`` (a distributed path's) captured as one CUDA
    graph against the same step run ``steps`` times step by step, each
    from ``init()``'s weights: the losses and the final weights within
    CAPTURE_RTOL (the captured run: one warm-up step, then ``steps - 1``
    replays).  Returns the captured and the step-by-step ms per step
    (medians, CUDA events) and the captured step's device busy ms per step
    and largest entries (``_device_profile``).  A gloo group raises on
    capture, and that is what is checked there."""
    dev = group.device
    if group.backend != "nccl":
        try:
            dist_ops.make_captured_dist_step(step, *init(), group)
        except ValueError as e:
            checks.add(f"{label}: a {group.backend} group refuses to "
                       f"capture ({e})", 0.0, 0.0, True)
        else:
            checks.add(f"{label}: a {group.backend} group captured", 1.0,
                       0.0, False)
        return {}
    net, opt, xb, yb = init()
    eager = torch.stack([step(net, opt, xb, yb) for _ in range(steps)])
    cnet, copt, cxb, cyb = init()
    warm = warm_up(lambda: step(cnet, copt, cxb, cyb), 1, dev)
    cap = dist_ops.make_captured_dist_step(
        step, cnet, copt, cxb, cyb, group,
        capacity=steps - 1 + TIMED_REPLAYS + 4)
    for _ in range(steps - 1):
        cap.replay()
    got = torch.cat([torch.stack(warm), cap.history[: steps - 1]])
    checks.close(f"{label}: captured step's {steps} losses against step by "
                 "step", got, eager, CAPTURE_RTOL)
    for (name, p), q in zip(cnet.named_parameters(), net.parameters()):
        checks.close(f"{label}: captured step's final {name} against step "
                     "by step", p.detach(), q.detach(), CAPTURE_RTOL)

    def replay() -> torch.Tensor:
        cap.replay()
        return cap.history[cap.replays - 1]

    _, cap_ms = _timed_steps(replay, TIMED_REPLAYS, dev)
    _, eager_ms = _timed_steps(lambda: step(net, opt, xb, yb),
                               TIMED_REPLAYS, dev)
    info = {"captured_ms": statistics.median(cap_ms),
            "eager_ms": statistics.median(eager_ms)}
    info["captured_busy_ms"], info["captured_profile"] = _device_profile(
        replay, dev)
    log(f"  {label}: captured {info['captured_ms']:.4f} ms per step "
        f"(device busy {info['captured_busy_ms']:.4f}), step by step "
        f"{info['eager_ms']:.4f} (medians of {TIMED_REPLAYS}, CUDA events)")
    return info


def run(g: GraphCSR, dim: int = 96, hidden: int = 16, classes: int = 22,
        device=None, steps: int = 10, single: HybridGraph | None = None,
        log=print) -> tuple[Checks, dict]:
    """Every check on ``g`` with GCN ``dim -> hidden -> classes``, on one
    rank on ``device`` (None: the card).  ``single``: the single-card
    layout to hold the distributed one against, when its tiers and
    geometry are the ones ``shard_graph_hybrid(g, 1)`` chooses (else one
    is built).  Returns the checks and the measurements: per-step ms (dist
    and single-card, None off the card), the hybrid kernels' launches per
    distributed step, the layouts' tiers, the build seconds, and each
    path's captured step against its step-by-step one (``capture``,
    ``capture_ell``: ``captured_against_eager``'s, empty off NCCL)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        exact_f32_matmul()
    checks = Checks(log)
    info: dict = {}
    start = time.perf_counter()
    sg = shard_graph_hybrid(g, 1)
    info["shard_s"] = time.perf_counter() - start
    tiers = (sg.diag_b, sg.hot_k, sg.res_ob, sg.res_tile)
    info["tiers"] = tiers
    log(f"  shard_graph_hybrid(g, 1): diag_b={sg.diag_b} hot_k={sg.hot_k} "
        f"res_ob={sg.res_ob} res_tile={sg.res_tile} res_single="
        f"{sg.res_single} block={sg.block} recv_max={sg.recv_max} "
        f"({info['shard_s']:.1f} s)")
    if single is None or (single.diag_b, single.hot_k, single.res_ob,
                          single.res_tile) != tiers:
        start = time.perf_counter()
        single = build_hybrid(g, diag_b=sg.diag_b, hot_k=sg.hot_k,
                              res_tile=sg.res_tile, res_ob=sg.res_ob,
                              probe=False)
        log(f"  single-card layout of the same tiers built "
            f"({time.perf_counter() - start:.1f} s)")
    if single.num_rows != sg.block:
        raise ValueError(f"single-card rows {single.num_rows} != block "
                         f"{sg.block}")
    rows = sg.block
    rng = np.random.default_rng(0)
    x_np = np.zeros((rows, dim), np.float32)
    x_np[: g.num_nodes] = rng.standard_normal((g.num_nodes, dim),
                                              dtype=np.float32)
    y_np = np.zeros(rows, np.int64)
    y_np[: g.num_nodes] = rng.integers(0, classes, g.num_nodes)
    x = torch.from_numpy(x_np).to(dev)
    y = torch.from_numpy(y_np).to(dev)
    mask = torch.from_numpy(single.row_mask).to(dev)
    h_t = torch.from_numpy(
        rng.standard_normal((hidden, rows), dtype=np.float32)).to(dev)
    weights = GCN(dim, hidden, classes, torch.Generator().manual_seed(0),
                  device="cpu").params_to_jax()

    group = mesh.make_group(1, device)
    try:
        for dt in ("float32", "bfloat16"):
            sh = dist_hybrid.HybridShard(sg, group, dt)
            ht = build_hybrid_tensors(single, device=dev, agg_dtype=dt)
            for norm in (False, True):
                want = hybrid_aggregate(h_t, ht, norm)
                for overlap in (True, False):
                    got = dist_hybrid.dist_hybrid_aggregate_t(h_t, sh, norm,
                                                              overlap)
                    checks.close(f"dist aggregate D={hidden} {dt} norm="
                                 f"{norm} overlap={overlap} against "
                                 "hybrid_aggregate", got, want)
            # loss and gradients on the same weights
            loss_fn = dist_hybrid.make_dist_loss_fn(group, sg, "gcn",
                                                    agg_dtype=dt, shard=sh)
            _, init = dist_ops.make_train_step_on(
                loss_fn, group, 0.01, "gcn", True, sg.block)
            net, _, xb, yb = init(torch.Generator(), dim, hidden, classes,
                                  x_np, y_np, init_params=weights)
            loss = loss_fn(net, xb, yb)
            loss.backward()
            dist_ops.all_reduce_grads(net, group)
            ref = GCN(dim, hidden, classes, device=dev).params_from_jax(
                weights)
            want = nll_loss(ref(x.t().contiguous(), (ht, ht)), y, mask)
            want.backward()
            checks.close(f"GCN loss {dt}", loss.detach(), want.detach(),
                         LOSS_RTOL)
            for (name, p), q in zip(net.named_parameters(),
                                    ref.parameters()):
                checks.close(f"GCN grad {name} {dt}", p.grad, q.grad,
                             LOSS_RTOL)

        # Adam steps at the default bf16 tiers
        step, init = dist_hybrid.make_dist_train_step(group, sg, "gcn",
                                                      agg_dtype="bfloat16")
        net, opt, xb, yb = init(torch.Generator(), dim, hidden, classes,
                                x_np, y_np, init_params=weights)
        _sync(dev)
        spmm_cuda.reset_launches()
        dist_losses, dist_ms = _timed_steps(
            lambda: step(net, opt, xb, yb), steps, dev)
        info["launches_per_step"] = {
            k: v / steps for k, v in spmm_cuda.launches.items() if v}
        if dev.type == "cuda":
            info["busy_ms"], info["profile"] = _device_profile(
                lambda: step(net, opt, xb, yb), dev)
        ht = build_hybrid_tensors(single, device=dev, agg_dtype="bfloat16")
        ref = GCN(dim, hidden, classes, device=dev).params_from_jax(weights)
        ref_step = make_train_step(ref, (ht, ht), make_optimizer(ref), mask)
        x_t = x.t().contiguous()
        single_losses, single_ms = _timed_steps(
            lambda: ref_step(x_t, y), steps, dev)
        want = torch.tensor(single_losses)
        checks.close(f"{steps} Adam steps' losses (bf16 tiers)",
                     torch.tensor(dist_losses), want, LOSS_RTOL)
        info["dist_losses"], info["single_losses"] = dist_losses, single_losses
        info["capture"] = captured_against_eager(
            "hybrid (bf16 tiers)", step,
            lambda: init(torch.Generator(), dim, hidden, classes, x_np,
                         y_np, init_params=weights),
            group, steps, checks, log)
        for key, ms in (("dist_ms", dist_ms), ("single_ms", single_ms)):
            info[key] = None if ms is None else statistics.median(ms)
        per_tier = bool(sg.diag_b) + bool(sg.hot_k)
        want_launches = {"slab_matmul_t": 4.0 * per_tier,
                         "residual_combine_t": 4.0}
        got_launches = info["launches_per_step"]
        if dev.type == "cuda":
            checks.add(f"launches per step {got_launches} (want "
                       f"{want_launches})", 0.0, 0.0, got_launches == {
                           k: v for k, v in want_launches.items() if v})
        else:
            log("  launches: not counted (the plain versions on the host "
                "launch nothing)")

        # the ELL twin
        start = time.perf_counter()
        sge = shard_graph(g, 1)
        she = dist_ops.ell_shard(sge, group)
        gt = build_graph_tensors(g, method="ell", part_size=sge.part_size,
                                 device=dev)
        log(f"  ELL layouts at part size {sge.part_size} "
            f"({time.perf_counter() - start:.1f} s)")
        h = h_t.t()[: g.num_nodes].contiguous()
        h_pad = torch.zeros((sge.block, hidden), device=dev)
        h_pad[: g.num_nodes] = h
        for norm in (False, True):
            got = dist_ops.dist_aggregate(h_pad, she, norm)[: g.num_nodes]
            checks.close(f"ELL dist aggregate D={hidden} norm={norm}", got,
                         aggregate(h, gt, norm))
        estep, einit = dist_ops.make_dist_train_step(group, sge, "gcn")
        info["capture_ell"] = captured_against_eager(
            "ELL", estep,
            lambda: einit(torch.Generator(), dim, hidden, classes,
                          x_np[: g.num_nodes], y_np[: g.num_nodes],
                          init_params=weights),
            group, steps, checks, log)
        _sync(dev)
    finally:
        mesh.destroy_group(group)
    return checks, info


def _inputs(g: GraphCSR, rows: int, dim: int, hidden: int, classes: int):
    """Features [rows, dim], labels, hidden-width features [hidden, rows]
    (the aggregates' input) from one seed; rows past the graph's zero."""
    rng = np.random.default_rng(0)
    x = np.zeros((rows, dim), np.float32)
    x[: g.num_nodes] = rng.standard_normal((g.num_nodes, dim),
                                           dtype=np.float32)
    y = np.zeros(rows, np.int64)
    y[: g.num_nodes] = rng.integers(0, classes, g.num_nodes)
    h_t = rng.standard_normal((hidden, rows), dtype=np.float32)
    h_t[:, g.num_nodes:] = 0
    return x, y, h_t


def _rank_check(group, sg, sge, x, y, h_t, weights, steps, out_dir):
    """One rank of ``run_ranks_check``: its shard's aggregates, the loss
    and gradients, ``steps`` Adam steps (f32 tiers, compared; then bf16,
    timed), the bf16 step captured against itself step by step
    (``captured_against_eager``; on gloo, that capture raises) and the
    exchange alone, into ``rank<r>.npz``."""
    import os

    dev, r, block = group.device, group.rank, sg.block
    if dev.type == "cuda":
        exact_f32_matmul()
    res = {}
    rows = slice(r * block, (r + 1) * block)
    h_blk = torch.from_numpy(h_t[:, rows].copy()).to(dev)
    shards = {dt: dist_hybrid.HybridShard(sg, group, dt)
              for dt in ("float32", "bfloat16")}
    for dt, sh in shards.items():
        for norm in (False, True):
            for overlap in (True, False):
                res[f"agg_{dt}_{norm}_{overlap}"] = (
                    dist_hybrid.dist_hybrid_aggregate_t(h_blk, sh, norm,
                                                        overlap).cpu().numpy())
    she = dist_ops.ell_shard(sge, group)
    rows_e = slice(r * sge.block, (r + 1) * sge.block)
    h_e = np.zeros((group.world * sge.block, h_t.shape[0]), np.float32)
    m = min(h_t.shape[1], len(h_e))  # both hold every real row
    h_e[:m] = h_t.T[:m]
    for norm in (False, True):
        res[f"ell_{norm}"] = dist_ops.dist_aggregate(
            torch.from_numpy(h_e[rows_e]).to(dev), she, norm).cpu().numpy()
    dim, hidden, classes = x.shape[1], h_t.shape[0], weights["conv2"].shape[1]
    for dt in ("float32", "bfloat16"):
        loss_fn = dist_hybrid.make_dist_loss_fn(group, sg, "gcn",
                                                agg_dtype=dt, shard=shards[dt])
        step, init = dist_ops.make_train_step_on(loss_fn, group, 0.01, "gcn",
                                                 True, block)
        net, opt, xb, yb = init(torch.Generator(), dim, hidden, classes, x, y,
                                init_params=weights)
        if dt == "float32":
            loss = loss_fn(net, xb, yb)
            loss.backward()
            dist_ops.all_reduce_grads(net, group)
            res["loss"] = loss.detach().cpu().numpy()
            for name, p in net.named_parameters():
                res[f"grad_{name}"] = p.grad.cpu().numpy()
        losses, ms = _timed_steps(lambda: step(net, opt, xb, yb), steps, dev)
        res[f"losses_{dt}"] = np.asarray(losses)
        if ms is not None:
            res[f"ms_{dt}"] = np.asarray(ms)
    # the bf16 step captured, against itself step by step
    checks = Checks(log=lambda m: None)
    cap = captured_against_eager(
        f"rank {r}", step,
        lambda: init(torch.Generator(), dim, hidden, classes, x, y,
                     init_params=weights), group, steps, checks)
    res["capture_ok"] = np.asarray(checks.ok)
    res["capture_err"] = np.asarray(max(row[1] for row in checks.rows))
    for key in ("captured_ms", "eager_ms", "captured_busy_ms"):
        if key in cap:
            res[key] = np.asarray(cap[key])
    # the exchange alone: a bf16 table of the hidden width
    plan = shards["bfloat16"].plan
    table = spmm_cuda.row_table_t(h_blk, torch.bfloat16,
                                  rows=block + plan.recv_max)

    def exchange() -> torch.Tensor:
        dist_ops.halo_exchange(table, plan, group).wait()
        return torch.zeros(())

    _, ms = _timed_steps(exchange, 20, dev)
    if ms is not None:
        res["exchange_ms"] = np.asarray(ms)
        res["exchange_bytes"] = np.asarray(
            [sum(plan.send_sizes), sum(plan.recv_sizes), table.shape[1] * 2])
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)


def run_ranks_check(g: GraphCSR, ranks: int, dim: int = 96,
                    hidden: int = 16, classes: int = 22, device=None,
                    steps: int = 10, log=print) -> tuple[Checks, dict]:
    """The distributed program on ``ranks`` ranks (NCCL, one card each,
    or gloo with ``device="cpu"``) on ``shard_graph_hybrid(g, ranks)`` and
    ``shard_graph(g, ranks)``, the ranks' results put together against
    the single-card paths on the first card: the aggregates (norm,
    overlap, f32 and bf16 tiers) and the ELL twin within AGG_RTOL, GCN's
    loss and gradients and ``steps`` Adam steps' losses (f32 tiers)
    within LOSS_RTOL; on each rank, the bf16 step captured against itself
    step by step within CAPTURE_RTOL (on gloo: that capture raises).  The
    measurements: each rank's ms per step (f32 and bf16 tiers; on NCCL
    also captured, with its device busy ms) and ms per exchange, with the
    rows it ships."""
    import tempfile

    dev = resolve_device(device)
    checks, info = Checks(log), {}
    start = time.perf_counter()
    sg = shard_graph_hybrid(g, ranks)
    sge = shard_graph(g, ranks)
    log(f"  {ranks} shards: diag_b={sg.diag_b} hot_k={sg.hot_k} res_ob="
        f"{sg.res_ob} res_tile={sg.res_tile} block={sg.block} halo rows by "
        f"receiver {sg.halo_sizes.sum(axis=1).tolist()}; ELL part size "
        f"{sge.part_size} ({time.perf_counter() - start:.1f} s)")
    n = g.num_nodes
    x, y, h_t = _inputs(g, ranks * sg.block, dim, hidden, classes)
    weights = GCN(dim, hidden, classes, torch.Generator().manual_seed(0),
                  device="cpu").params_to_jax()
    with tempfile.TemporaryDirectory() as out:
        start = time.perf_counter()
        mesh.run_ranks(_rank_check, ranks, device, args=(
            sg, sge, x, y, h_t, weights, steps, out), timeout=1200)
        log(f"  {ranks} ranks ran ({time.perf_counter() - start:.1f} s)")
        per = [dict(np.load(f"{out}/rank{r}.npz")) for r in range(ranks)]
    if dev.type == "cuda":
        exact_f32_matmul()
    single = build_hybrid(g, diag_b=sg.diag_b, hot_k=sg.hot_k,
                          res_tile=sg.res_tile, res_ob=sg.res_ob, probe=False)
    rows = single.num_rows
    h = torch.from_numpy(h_t[:, :rows].copy()).to(dev)
    for dt in ("float32", "bfloat16"):
        ht = build_hybrid_tensors(single, device=dev, agg_dtype=dt)
        for norm in (False, True):
            want = hybrid_aggregate(h, ht, norm)[:, :n].cpu()
            for overlap in (True, False):
                got = np.concatenate(
                    [p[f"agg_{dt}_{norm}_{overlap}"] for p in per], axis=1)
                checks.close(f"{ranks} ranks: aggregate {dt} norm={norm} "
                             f"overlap={overlap}",
                             torch.from_numpy(got[:, :n]), want)
    gt = build_graph_tensors(g, method="ell", part_size=sge.part_size,
                             device=dev)
    for norm in (False, True):
        got = np.concatenate([p[f"ell_{norm}"] for p in per])[:n]
        checks.close(f"{ranks} ranks: ELL aggregate norm={norm}",
                      torch.from_numpy(got),
                      aggregate(h[:, :n].t().contiguous(), gt, norm).cpu())
    # the single-card model on the same weights, f32 tiers
    ht = build_hybrid_tensors(single, device=dev)
    mask = torch.from_numpy(single.row_mask).to(dev)
    ref = GCN(dim, hidden, classes, device=dev).params_from_jax(weights)
    x_t = torch.from_numpy(x[:rows].T.copy()).to(dev)
    y_d = torch.from_numpy(y[:rows]).to(dev)
    want = nll_loss(ref(x_t, (ht, ht)), y_d, mask)
    want.backward()
    for r, p in enumerate(per):
        for key in [k for k in p if k.startswith(("loss", "grad_"))]:
            if not np.array_equal(p[key], per[0][key]):
                checks.add(f"rank {r}'s {key} equals rank 0's", 1.0, 0.0,
                           False)
    checks.close(f"{ranks} ranks: GCN loss", torch.from_numpy(per[0]["loss"]),
                 want.detach().cpu(), LOSS_RTOL)
    for name, q in ref.named_parameters():
        checks.close(f"{ranks} ranks: GCN grad {name}",
                     torch.from_numpy(per[0][f"grad_{name}"]),
                     q.grad.cpu(), LOSS_RTOL)
    ref = GCN(dim, hidden, classes, device=dev).params_from_jax(weights)
    ref_step = make_train_step(ref, (ht, ht), make_optimizer(ref), mask)
    single_losses, single_ms = _timed_steps(lambda: ref_step(x_t, y_d),
                                            steps, dev)
    checks.close(f"{ranks} ranks: {steps} Adam steps' losses (f32 tiers)",
                 torch.from_numpy(per[0]["losses_float32"]),
                 torch.tensor(single_losses, dtype=torch.float64)
                 .to(torch.float32), LOSS_RTOL)
    for r, p in enumerate(per):
        checks.add(f"rank {r}: the captured bf16 step against step by step "
                   "(or, on gloo, the refusal to capture)",
                   float(p["capture_err"]), CAPTURE_RTOL,
                   bool(p["capture_ok"]))
    if "captured_ms" in per[0]:
        for key in ("captured_ms", "eager_ms", "captured_busy_ms"):
            info[f"step_{key}"] = [float(p[key]) for p in per]
    if "ms_float32" in per[0]:
        for dt in ("float32", "bfloat16"):
            info[f"step_ms_{dt}"] = [float(np.median(p[f"ms_{dt}"]))
                                     for p in per]
        info["single_ms_float32"] = statistics.median(single_ms)
        info["exchange_ms"] = [float(np.median(p["exchange_ms"]))
                               for p in per]
        info["exchange_rows"] = [p["exchange_bytes"][:2].tolist()
                                 for p in per]
        info["row_bytes"] = int(per[0]["exchange_bytes"][2])
    return checks, info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nodes", type=int, default=20_000)
    p.add_argument("--edges", type=int, default=400_000)
    p.add_argument("--kind", default="community")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--ranks", type=int, default=1,
                   help="ranks (one card each): above 1, the ranks' "
                        "results are held against the single-card paths")
    p.add_argument("--device", default=None,
                   help="cpu: gloo and the plain versions (default: the card)")
    args = p.parse_args(argv)
    g = synthesize_graph(args.nodes, args.edges, num_features=args.dim,
                         num_classes=args.classes, kind=args.kind,
                         seed=args.seed)
    print(f"graph: {g.num_nodes} nodes, {g.nnz} edges", flush=True)
    if args.ranks > 1:
        checks, info = run_ranks_check(g, args.ranks, dim=args.dim,
                                       classes=args.classes,
                                       device=args.device)
        print(f"measurements: {info}", flush=True)
    else:
        checks, info = run(g, dim=args.dim, hidden=16, classes=args.classes,
                           device=args.device)
        print(f"dist step ms {info['dist_ms']}, single-card "
              f"{info['single_ms']}; launches per step "
              f"{info['launches_per_step']}")
    print("ALL PASS" if checks.ok else "FAILURES PRESENT", flush=True)
    return 0 if checks.ok else 1


if __name__ == "__main__":
    sys.exit(main())
