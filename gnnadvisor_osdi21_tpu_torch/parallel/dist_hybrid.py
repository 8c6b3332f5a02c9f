"""Distributed aggregation and training on the hybrid layout: the port of
``gnnadvisor_osdi21_tpu/parallel/dist_hybrid.py``, the multi-device twin
of ``ops/hybrid_agg.py`` (layout: ``parallel/hybrid_partition.py``).

Each rank aggregates its row block, features transposed ``[D, block]``
end to end, on the single card's kernels:

1. its rows go, pre-scaled and cast to ``agg_dtype``, into one row-major
   table ``[block + recv_max, ld]`` in one pass (``spmm_cuda.row_table_t``);
   the cast comes first, so a bf16 exchange ships half the bytes,
2. one exchange fills the table's halo rows (``dist_ops.halo_exchange``),
3. the **diagonal tier** (``slab_matmul_t``) reads only the rank's own
   rows, so with ``overlap`` it runs while the exchange is in flight,
4. after the wait, the **hot tier** (``slab_matmul_t`` over the table's
   ``hot_ids`` rows) and the **residual tier** (``residual_combine_t``
   over the whole table, the slab tiers' sum as its addend).

The JAX dist path keeps the diagonal tier apart, for the overlap, so the
fused slab kernel is not on this path.  GCN's weighting is the pre- and
post-scale of ``dist_ops``.  ``dist_hybrid_aggregate_t``'s backward is the
same aggregation of the incoming gradient, exchange included.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
    AGG_DTYPES, HybridTensors, residual_tier_t,
)
from gnnadvisor_osdi21_tpu_torch.parallel.dist_ops import (
    HaloPlan, aggregate_with_adjoint, halo_exchange, halo_plan,
    make_train_step_on, masked_loss, model_apply_with_agg,
)
from gnnadvisor_osdi21_tpu_torch.parallel.hybrid_partition import (
    HybridShardedGraph,
)
from gnnadvisor_osdi21_tpu_torch.parallel.mesh import Group


def local_tensors(sg: HybridShardedGraph, rank: int, device,
                  agg_dtype: str = "bfloat16") -> HybridTensors:
    """Rank ``rank``'s shard as the port's ``HybridTensors`` (the JAX
    ``_local_tensors``): its block's rows (``num_rows = block``),
    transposed, the slot-major residual mask only.  The residual kernel
    reads one table row per slot: ``res_dst`` itself when the layout
    precomposed it (``res_single``), else ``res_gather[res_dst]``."""
    if agg_dtype not in AGG_DTYPES:
        raise ValueError(f"agg_dtype must be one of {sorted(AGG_DTYPES)}")

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    block, ob = sg.block, sg.res_ob
    t2b = sg.res_t2b[rank]
    res_src = (sg.res_dst[rank] if sg.res_single
               else sg.res_gather[rank][sg.res_dst[rank]])
    if len(res_src) != len(t2b) * sg.res_tile:
        raise ValueError(f"{len(res_src)} residual slots for {len(t2b)} "
                         f"tiles of {sg.res_tile}")
    block_ptr = np.searchsorted(t2b, np.arange(block // ob + 1))
    return HybridTensors(
        degrees=put(sg.degrees[rank]),
        row_mask=put(sg.node_mask[rank]),
        diag_bits=put(sg.diag_bits[rank]) if sg.diag_b else None,
        hot_bits=put(sg.hot_bits[rank]) if sg.hot_k else None,
        hot_ids=put(sg.hot_ids[rank], torch.int64) if sg.hot_k else None,
        res_mask=None,
        res_mask_s=put(sg.res_mask_s[rank]),
        res_t2b=put(t2b),
        res_block_ptr=put(block_ptr.astype(np.int32)),
        res_src=put(res_src.astype(np.int32)),
        num_rows=block,
        real_nodes=block,
        diag_b=sg.diag_b,
        hot_k=sg.hot_k,
        res_tile=sg.res_tile,
        res_ob=ob,
        agg_dtype=agg_dtype,
        transposed=True,
    )


def diag_tier_t(table: torch.Tensor, d: int, ht: HybridTensors):
    """The diagonal tier over the table's first ``num_rows`` rows (the
    rank's own), or None without one."""
    if not ht.diag_b:
        return None
    return spmm_cuda.slab_matmul_t(
        ht.diag_bits, table.t()[:d, : ht.num_rows], table_block_cols=ht.diag_b
    )


def table_tiers_t(table: torch.Tensor, d: int, ht: HybridTensors,
                  out: torch.Tensor | None) -> torch.Tensor:
    """The hot and residual tiers over the whole table (the halo rows
    landed), added to ``out`` (the diagonal tier's, or None): [D,
    num_rows] f32."""
    if ht.hot_k:
        h = spmm_cuda.slab_matmul_t(
            ht.hot_bits, table.index_select(0, ht.hot_ids).t()[:d])
        out = h if out is None else out + h
    return residual_tier_t(table.t()[:d], ht, addend=out)


def shard_tiers_t(table: torch.Tensor, d: int,
                  ht: HybridTensors) -> torch.Tensor:
    """The three tiers over a table whose halo rows are already in place
    (no exchange): what each rank computes, for checks that build its
    table themselves."""
    return table_tiers_t(table, d, ht, diag_tier_t(table, d, ht))


def _dist_tiers_t(x_t: torch.Tensor, ht: HybridTensors, plan: HaloPlan,
                  group: Group, norm: bool, overlap: bool) -> torch.Tensor:
    d = x_t.shape[0]
    table = spmm_cuda.row_table_t(
        x_t, AGG_DTYPES[ht.agg_dtype], ht.degrees.to(x_t.dtype) if norm
        else None, rows=plan.block + plan.recv_max)
    work = halo_exchange(table, plan, group)
    out = diag_tier_t(table, d, ht) if overlap else None
    work.wait()
    if not overlap:
        out = diag_tier_t(table, d, ht)
    out = table_tiers_t(table, d, ht, out)
    if norm:
        out = out * ht.degrees[None, :]
    return out.to(x_t.dtype)


class HybridShard:
    """One rank's hybrid tensors, exchange plan and group."""

    def __init__(self, sg: HybridShardedGraph, group: Group,
                 agg_dtype: str = "bfloat16"):
        self.group = group
        self.ht = local_tensors(sg, group.rank, group.device, agg_dtype)
        self.plan = halo_plan(sg, group.rank, group.device)
        self.num_nodes = sg.num_nodes


def dist_hybrid_aggregate_t(x_t: torch.Tensor, sh: HybridShard, norm: bool,
                            overlap: bool = True) -> torch.Tensor:
    """``out[D, block] = Σ_d w_sd · x_t[:, d]`` for the rank's rows,
    transposed, over the three tiers with the halo exchange.
    ``overlap=False`` runs the diagonal tier after the exchange has
    landed (the JAX package's ablation arm)."""
    return aggregate_with_adjoint(
        x_t, lambda x, n: _dist_tiers_t(x, sh.ht, sh.plan, sh.group, n,
                                        overlap), norm)


def dist_hybrid_aggregate(x_local: torch.Tensor, sh: HybridShard,
                          norm: bool, overlap: bool = True) -> torch.Tensor:
    """Row-major ``[block, D]`` wrapper over ``dist_hybrid_aggregate_t``."""
    return dist_hybrid_aggregate_t(x_local.t(), sh, norm, overlap).t()


def make_dist_loss_fn(group: Group, sg: HybridShardedGraph, model: str,
                      overlap: bool = True, agg_dtype: str = "bfloat16",
                      shard: HybridShard | None = None) -> Callable:
    """``loss(net, x_t, y_blk)``: the masked NLL over every rank's real
    rows, the whole forward transposed (``x_t [D, block]``)."""
    sh = shard or HybridShard(sg, group, agg_dtype)

    def loss_fn(net, x_t, y_blk):
        log_probs_t = model_apply_with_agg(
            model, net, x_t,
            lambda h, norm: dist_hybrid_aggregate_t(h, sh, norm, overlap),
            transposed=True)
        return masked_loss(log_probs_t, y_blk, sh.ht.row_mask, sh.num_nodes,
                           group, transposed=True)

    return loss_fn


def make_dist_train_step(group: Group, sg: HybridShardedGraph, model: str,
                         lr: float = 0.01, overlap: bool = True,
                         agg_dtype: str = "bfloat16"):
    """``(step, init)`` as ``dist_ops.make_dist_train_step``, on the hybrid
    shards; ``init`` hands back the rank's ``x`` transposed."""
    loss_fn = make_dist_loss_fn(group, sg, model, overlap, agg_dtype)
    return make_train_step_on(loss_fn, group, lr, model, True, sg.block)
