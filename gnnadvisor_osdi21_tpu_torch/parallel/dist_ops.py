"""Distributed aggregation and training over a group of ranks: the port of
``gnnadvisor_osdi21_tpu/parallel/dist_ops.py`` (the ELL twin) and the
pieces both distributed paths share.

Destination rows are sharded in contiguous blocks, one per rank
(``parallel/partition.py``).  Every aggregation fetches the remote source
rows its edges read with one exchange (``halo_exchange``: a ragged
``all_to_all_single`` that ships exactly the plan's rows, in place of the
JAX package's ``ragged_all_to_all`` and its dense CPU emulation), then
reduces the padded neighbor groups as the single-card ELL path does
(``ops/aggregate.ell_sums``).  Interior parts, whose neighbors are all
local, reduce while the exchange is in flight.

GCN's ``deg[s]·deg[d]`` weighting factors into a pre-scale of the rows
before the exchange and a post-scale of the output, so the exchange ships
no degrees.

Autograd: ``dist_aggregate``'s backward is the same distributed
aggregation of the incoming gradient, exchange included (the global
operator is symmetric on undirected graphs, the reference's assumption).
So the ranks run their backward exchanges together, as their forward
ones.  The JAX ``shard_map`` sums the replicated weights' gradients over
the mesh by itself; here each rank's backward gives its own share, and
``all_reduce_grads`` sums the shares before the optimizer's step.

The JAX package compiles each path's step into one program (``jax.jit``
over ``shard_map``); here ``make_captured_dist_step`` captures either
path's step as one CUDA graph on NCCL, its exchanges and reductions
inside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from gnnadvisor_osdi21_tpu_torch.ops.aggregate import _matmul_f32, ell_sums
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import _offsets
from gnnadvisor_osdi21_tpu_torch.parallel.mesh import Group
from gnnadvisor_osdi21_tpu_torch.parallel.partition import ShardedGraph
from gnnadvisor_osdi21_tpu_torch.train import (
    CapturedStep, build_model, capture_step, make_optimizer, nll_per_row,
    warm_up,
)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """One rank's side of the exchange, built once per layout: the local
    rows it ships (to each receiver in turn, ``send_sizes`` rows each) and
    the rows it receives (from each sender in turn, ``recv_sizes``), all
    host-side split lists but ``send_rows``."""

    block: int  # the rank's rows; the received rows follow them
    recv_max: int  # halo rows of every rank's table (padded to 8)
    send_rows: torch.Tensor  # [sum(send_sizes)] int64 local row ids
    send_sizes: list[int]  # [world] rows shipped to each receiver
    recv_sizes: list[int]  # [world] rows received from each sender

    @property
    def recv_total(self) -> int:
        return sum(self.recv_sizes)


def halo_plan(sg, rank: int, device) -> HaloPlan:
    """Rank ``rank``'s exchange plan from a sharded layout (``ShardedGraph``
    or ``HybridShardedGraph``): its ragged sender list, sizes by peer.  A
    sender's segments lie back to back in ``send_flat``, in receiver
    order, and a receiver's in its table in sender order
    (``halo_in_off``/``halo_out_off`` are their exclusive sums)."""
    send_sizes = [int(v) for v in sg.halo_send_sizes[rank]]
    rows = sg.send_flat[rank, : sum(send_sizes)].astype(np.int64)
    return HaloPlan(
        block=sg.block, recv_max=sg.recv_max,
        send_rows=torch.from_numpy(rows).to(device),
        send_sizes=send_sizes,
        recv_sizes=[int(v) for v in sg.halo_sizes[rank]],
    )


def halo_exchange(table: torch.Tensor, plan: HaloPlan, group: Group):
    """Fill the halo rows of ``table`` [block + recv_max, ld] (row-major,
    contiguous; rows ``[0, block)`` the rank's own) from the other ranks:
    one ``all_to_all_single`` ships ``table[:block][send_rows]`` and
    writes what arrives straight into ``table[block : block +
    recv_total]``, segments in sender order; rows past ``recv_total`` are
    zeroed.  Returns the collective's ``Work``, in flight: ``wait()`` on
    it before reading the halo rows (on the card it orders the current
    stream after the exchange).  A rank that ships and gets nothing (one
    rank, or an empty plan) still joins the collective."""
    block = plan.block
    if not table.is_contiguous() or table.shape[0] != block + plan.recv_max:
        raise ValueError(
            f"halo table must be a contiguous [{block + plan.recv_max}, ld] "
            f"tensor, got {tuple(table.shape)}"
        )
    end = block + plan.recv_total
    table[end:].zero_()
    send = table[:block].index_select(0, plan.send_rows)
    return dist.all_to_all_single(
        table[block:end], send, output_split_sizes=plan.recv_sizes,
        input_split_sizes=plan.send_sizes, group=group.pg, async_op=True,
    )


@dataclasses.dataclass(frozen=True)
class EllShard:
    """One rank's ELL tensors (entry ``rank`` of a ``ShardedGraph``) and
    its exchange plan; ``*_ptr`` are the owner offsets of the sorted
    parts, [block + 1]."""

    group: Group
    plan: HaloPlan
    int_cols: torch.Tensor  # [PI, S] int32, local rows
    int_lens: torch.Tensor  # [PI] int32
    int_ptr: torch.Tensor  # [block + 1] int64
    bnd_cols: torch.Tensor  # [PB, S] int32, table rows
    bnd_lens: torch.Tensor  # [PB] int32
    bnd_ptr: torch.Tensor  # [block + 1] int64
    degrees: torch.Tensor  # [block] f32
    node_mask: torch.Tensor  # [block] f32
    num_nodes: int


def ell_shard(sg: ShardedGraph, group: Group) -> EllShard:
    r, dev, block = group.rank, group.device, sg.block

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return EllShard(
        group=group, plan=halo_plan(sg, r, dev),
        int_cols=put(sg.int_cols[r]), int_lens=put(sg.int_lens[r]),
        int_ptr=put(_offsets(sg.int2local[r], block)),
        bnd_cols=put(sg.bnd_cols[r]), bnd_lens=put(sg.bnd_lens[r]),
        bnd_ptr=put(_offsets(sg.bnd2local[r], block)),
        degrees=put(sg.degrees[r]), node_mask=put(sg.node_mask[r]),
        num_nodes=sg.num_nodes,
    )


def _dist_ell(x: torch.Tensor, sh: EllShard, norm: bool) -> torch.Tensor:
    """out [block, D] = Σ_d w_sd · x[d] over the rank's rows."""
    plan = sh.plan
    if norm:
        x = x * sh.degrees[:, None].to(x.dtype)
    table = x.new_empty((plan.block + plan.recv_max, x.shape[1]))
    table[: plan.block] = x
    work = halo_exchange(table, plan, sh.group)
    # interior parts read local rows only: they reduce during the exchange
    out = ell_sums(table, sh.int_cols, sh.int_lens, sh.int_ptr)
    work.wait()
    out = out + ell_sums(table, sh.bnd_cols, sh.bnd_lens, sh.bnd_ptr)
    if norm:
        out = out * sh.degrees[:, None].to(out.dtype)
    return out


class _DistAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, run, norm: bool):
        ctx.run, ctx.norm = run, norm
        return run(x, norm)

    @staticmethod
    def backward(ctx, g):
        # undirected graphs: the adjoint is the same aggregation, exchange
        # included, on the gradient
        return ctx.run(g.contiguous(), ctx.norm), None, None


def aggregate_with_adjoint(x: torch.Tensor, run: Callable, norm: bool):
    """``run(x, norm)`` (a distributed aggregation) with ``run`` of the
    incoming gradient as its backward."""
    return _DistAggregate.apply(x, run, norm)


def dist_aggregate(x_local: torch.Tensor, sh: EllShard,
                   norm: bool) -> torch.Tensor:
    """out[s] = Σ_d w_sd · x[d] for the rank's rows ``x_local [block, D]``
    (``norm``: w = deg[s]·deg[d], else 1), with the halo exchange."""
    return aggregate_with_adjoint(
        x_local, lambda x, n: _dist_ell(x, sh, n), norm)


def model_apply_with_agg(model: str, net: torch.nn.Module, x: torch.Tensor,
                         agg: Callable, transposed: bool = False):
    """GCN-2 / GIN-5 forward over an injected per-layer aggregation
    ``agg(h, norm)``: the one definition both distributed paths share
    (dist_ops.py:201-231 in the JAX package), with ``net``'s weights (the
    port's ``GCN``/``GIN``).  ``transposed``: the whole forward runs on
    ``[D, rows]`` features (GEMMs ``W^T @ h``, classes on axis 0), the
    hybrid path's layout."""
    if transposed:
        def mm(h, w):
            return _matmul_f32(w.t(), h)
        axis = 0
    else:
        mm = _matmul_f32
        axis = 1
    if model == "gcn":
        h = torch.relu(agg(mm(x, net.conv1), True))
        h = agg(mm(h, net.conv2), True)
        return torch.log_softmax(h, dim=axis)
    if model == "gin":
        weights = list(net.parameters())
        h = x
        for i, w in enumerate(weights):
            h = mm(net.epsilon * agg(h, False), w)
            if i < len(weights) - 1:
                h = torch.relu(h)
        return torch.log_softmax(h, dim=axis)
    raise ValueError(f"unknown model: {model}")


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over the group's ranks; its gradient is the
    incoming one, as each rank's share of a replicated loss (the JAX
    ``psum``'s transpose inside ``shard_map``)."""

    @staticmethod
    def forward(ctx, t, group: Group):
        out = t.clone()
        dist.all_reduce(out, group=group.pg)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def masked_loss(log_probs: torch.Tensor, y: torch.Tensor,
                node_mask: torch.Tensor, num_nodes: int, group: Group,
                transposed: bool) -> torch.Tensor:
    """Masked NLL over every rank's real rows divided by the global node
    count: the same value on every rank; each rank's backward gives its
    own rows' share of the gradient."""
    local = (nll_per_row(log_probs, y, transposed) * node_mask).sum()
    return _SumOverRanks.apply(local, group) / num_nodes


def all_reduce_grads(net: torch.nn.Module, group: Group) -> None:
    """Sum every weight's gradient over the ranks (the replicated weights'
    full gradient), in place."""
    for p in net.parameters():
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group.pg)


def _pad_rows(a, rows: int, dtype) -> np.ndarray:
    out = np.zeros((rows,) + np.shape(a)[1:], dtype=dtype)
    out[: len(a)] = np.asarray(a)
    return out


def make_train_step_on(loss_fn: Callable, group: Group, lr: float,
                       model: str, transposed: bool, block: int):
    """``(step, init)`` over a rank's ``loss_fn(net, x, y)``: the shared
    part of both paths' ``make_dist_train_step``."""

    def step(net, opt, x, y) -> torch.Tensor:
        """One forward, backward (gradients summed over the ranks) and
        Adam update of the replicated weights; returns the global loss,
        detached, with no wait for it."""
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(net, x, y)
        loss.backward()
        all_reduce_grads(net, group)
        opt.step()
        return loss.detach()

    def init(generator: torch.Generator, in_dim: int, hidden: int,
             num_classes: int, x=None, y=None, init_params=None):
        """The replicated model and its Adam (the same weights on every
        rank: one ``generator`` seed, or ``init_params`` by JAX name), and
        the rank's rows of ``x`` and ``y`` once padded to ``world·block``
        rows (``x`` as the path's loss takes it)."""
        net = build_model(model, generator, in_dim, hidden, num_classes,
                          device=group.device)
        if init_params is not None:
            net.params_from_jax(init_params)
        out = [net, make_optimizer(net, lr)]
        rows = slice(group.rank * block, (group.rank + 1) * block)
        n_pad = group.world * block
        if x is not None:
            xb = torch.from_numpy(_pad_rows(x, n_pad, np.float32)[rows])
            out.append((xb.t() if transposed else xb).contiguous()
                       .to(group.device))
        if y is not None:
            out.append(torch.from_numpy(_pad_rows(y, n_pad, np.int64)[rows])
                       .to(group.device))
        return tuple(out)

    return step, init


def make_captured_dist_step(step: Callable, net: torch.nn.Module,
                            opt: torch.optim.Optimizer, x: torch.Tensor,
                            y: torch.Tensor, group: Group,
                            capacity: int = 1) -> CapturedStep:
    """``step(net, opt, x, y)`` (either path's ``make_dist_train_step``)
    captured as one CUDA graph: the halo exchanges (``all_to_all_single``,
    forward and backward), the loss's ``all_reduce`` and the gradients'
    ``all_reduce`` run inside it, on NCCL's stream, ordered against the
    kernels by the stream waits that ``Work.wait()`` records; with
    ``overlap`` the diagonal tier, issued before the wait, stays a branch
    of the graph beside the exchange.  Every rank captures and replays the
    same step.  Warm the step up first (``train.warm_up``, at least one
    step): that creates Adam's state and runs each collective once, so
    that NCCL's communicator exists before capture.

    What capture on NCCL needs (PyTorch 2.11, NCCL 2.28 on an H100): the
    warm-up's collectives finished before capture (the synchronisation
    below); ``Work.wait()`` only making the stream wait, so
    ``TORCH_NCCL_BLOCKING_WAIT`` (a host wait) is refused; and the capture
    in ``thread_local`` mode, so that the process group's watchdog thread,
    which queries its collectives' events at any time, is not bound by
    the capture's rules (``global`` mode would bind every thread).  The
    send buffers come from the graph's private pool, with
    ``TORCH_NCCL_AVOID_RECORD_STREAMS`` left at its default.  A gloo group
    raises: its collectives run on the host, outside any graph."""
    if group.backend != "nccl":
        raise ValueError(
            f"a {group.backend} group cannot be captured in a CUDA graph (its "
            "collectives run on the host): run its step step by step")
    if os.environ.get("TORCH_NCCL_BLOCKING_WAIT", "0") not in ("", "0"):
        raise ValueError("TORCH_NCCL_BLOCKING_WAIT makes Work.wait() block "
                         "the host, which a CUDA-graph capture forbids")
    torch.cuda.synchronize(group.device)
    return capture_step(lambda: step(net, opt, x, y), group.device, capacity,
                        capture_error_mode="thread_local")


def timed_dist_steps(step: Callable, net: torch.nn.Module,
                     opt: torch.optim.Optimizer, x: torch.Tensor,
                     y: torch.Tensor, group: Group, warmup: int, epochs: int,
                     capture: bool, trace_dir: str | None = None,
                     ) -> tuple[float, list[float]]:
    """``warmup`` steps of ``step(net, opt, x, y)``, then ``epochs`` timed
    ones: (ms per timed step, every step's loss).  ``capture`` (NCCL
    only): the timed steps replay the step captured as one CUDA graph
    (``make_captured_dist_step``), timed by CUDA events; otherwise they
    run step by step, timed by the host's clock up to the last loss's
    fetch.  ``trace_dir``: a ``torch.profiler`` trace of the timed steps
    goes there (``utils/profiling.trace``)."""
    from gnnadvisor_osdi21_tpu_torch.utils.profiling import trace

    traced = trace(trace_dir) if trace_dir else contextlib.nullcontext()
    n = max(epochs, 1)
    if capture:
        losses = warm_up(lambda: step(net, opt, x, y), max(warmup, 1),
                         group.device)
        captured = make_captured_dist_step(step, net, opt, x, y, group,
                                           capacity=n)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with traced:
            start.record()
            for _ in range(epochs):
                captured.replay()
            end.record()
            end.synchronize()
        return (start.elapsed_time(end) / n,
                torch.stack(losses).tolist() + captured.losses())
    losses = [step(net, opt, x, y) for _ in range(warmup)]
    if losses:
        float(losses[-1])  # the host's fetch waits for the step
    with traced:
        t0 = time.perf_counter()
        for _ in range(epochs):
            losses.append(step(net, opt, x, y))
        if losses:
            float(losses[-1])
        ms = (time.perf_counter() - t0) * 1e3 / n
    return ms, torch.stack(losses).tolist() if losses else []


def make_dist_loss_fn(group: Group, sg: ShardedGraph, model: str,
                      shard: EllShard | None = None) -> Callable:
    """``loss(net, x_blk, y_blk)``: the masked NLL over every rank's real
    rows of the model on the ELL shards (``x_blk [block, D]``)."""
    sh = shard or ell_shard(sg, group)

    def loss_fn(net, x_blk, y_blk):
        log_probs = model_apply_with_agg(
            model, net, x_blk, lambda h, norm: dist_aggregate(h, sh, norm))
        return masked_loss(log_probs, y_blk, sh.node_mask, sh.num_nodes,
                           group, transposed=False)

    return loss_fn


def make_dist_train_step(group: Group, sg: ShardedGraph, model: str,
                         lr: float = 0.01):
    """``(step, init)``: ``init(generator, in_dim, hidden, num_classes, x,
    y, init_params=None) -> (net, opt, x_blk, y_blk)`` and ``step(net,
    opt, x_blk, y_blk) -> loss``, one forward, backward and Adam update on
    the ELL shards."""
    return make_train_step_on(make_dist_loss_fn(group, sg, model), group, lr,
                              model, False, sg.block)
