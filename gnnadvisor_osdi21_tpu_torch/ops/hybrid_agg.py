"""Hybrid diagonal/hot/residual aggregation on torch tensors, in either
feature layout: transposed ``[D, R]`` (graph rows on the minor axis) or
row-major ``[R, D]``, as ``HybridTensors.transposed`` says.

The port of ``gnnadvisor_osdi21_tpu/ops/hybrid_agg.py``, per layout
(``*_t`` kernels when transposed, their row-major twins otherwise):

- diagonal tier: ``spmm_cuda.slab_matmul[_t]`` with the block-local wiring,
- hot tier: ``spmm_cuda.slab_matmul[_t]`` against the gathered hot-node
  table,
- both at once: ``spmm_cuda.fused_slab_matmul[_t]``,
- residual tier: ``spmm_cuda.residual_combine[_t]`` alone, which gathers
  the slot rows from x by ``res_src`` itself (one or two XLA gathers
  outside the kernel in the JAX package) and adds the slab tiers' sum.

The transposed path first writes x, scaled and cast, into one row-major
table (``spmm_cuda.row_table_t``) and hands every tier a view of it: the
diagonal tier and the residual gather read it in place, and the hot tier
reads its rows gathered by ``hot_ids``, so no kernel call transposes x.

Every reduction is deterministic; there are no atomics.  All arrays live
in the padded row space [num_rows]; the loss masks padding rows out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import HybridGraph
from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda

AGG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class HybridTensors:
    """The layout's tensors on one device, with the JAX ``HybridTensors``
    fields.  Only the residual mask that the layout's kernels read is on
    the device: ``res_mask`` when row-major, ``res_mask_s`` when
    ``transposed``.  Differences: ``res_block_ptr`` holds each output
    block's tile range for the residual kernels; each slot's row of x is
    ``res_src`` (``res_gather[res_dst]``, whatever the JAX gather's
    stages), which the residual kernels gather by themselves, in place of
    ``res_gather``/``res_dst``; and the TPU kernel geometry
    (``block_rows``, ``feature_tile``) is gone: the kernels choose their
    own geometry."""

    degrees: torch.Tensor  # [R] f32
    row_mask: torch.Tensor  # [R] f32
    diag_bits: Optional[torch.Tensor]  # [B/16, R] uint16 or None
    hot_bits: Optional[torch.Tensor]  # [K/16, R] uint16 or None
    hot_ids: Optional[torch.Tensor]  # [K] int64 or None
    res_mask: Optional[torch.Tensor]  # [res_ob/32, M_pad] uint32 (row-major)
    res_mask_s: Optional[torch.Tensor]  # [res_tile/16, T*res_ob] uint16
    res_t2b: Optional[torch.Tensor]  # [T] int32 tile -> out block, sorted
    res_block_ptr: Optional[torch.Tensor]  # [num_rows/res_ob + 1] int32
    res_src: Optional[torch.Tensor]  # [M_pad] int32 slot -> x row
    num_rows: int = 0
    real_nodes: int = 0
    diag_b: int = 0
    hot_k: int = 0
    res_tile: int = 128
    res_ob: int = 256
    agg_dtype: str = "float32"
    transposed: bool = True
    res_covers_all: bool = False
    # the model's GEMM dtype (ops.aggregate._gemm), as on GraphTensors
    gemm_dtype: str = "float32"

    @property
    def method(self) -> str:
        return "hybrid"


def build_hybrid_tensors(
    hg: HybridGraph,
    device=None,
    agg_dtype: str = "float32",
    transposed: bool = True,
    gemm_dtype: str = "float32",
) -> HybridTensors:
    """Move a layout onto ``device`` (None: the card), for the transposed
    kernels or, with ``transposed=False``, the row-major ones.

    The residual kernels of both orientations gather each slot's row of x
    once, by ``res_src``, at any width: the JAX package's per-width choice
    between a one- and a two-stage gather (hybrid_agg.py:106-125 there)
    has no counterpart."""
    if agg_dtype not in AGG_DTYPES:
        raise ValueError(f"agg_dtype must be one of {sorted(AGG_DTYPES)}")
    dev = resolve_device(device)

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=dev, dtype=dtype or t.dtype)

    has_res = hg.res_dst.size > 0
    if has_res:
        n_blocks = hg.num_rows // hg.res_ob
        block_ptr = np.searchsorted(
            hg.res_t2b, np.arange(n_blocks + 1)
        ).astype(np.int32)
    res_src = None
    if has_res:
        # one id per slot for the kernels' gather; pad slots read row
        # res_gather[0], which their empty masks never add
        res_src = hg.res_gather[hg.res_dst].astype(np.int32)
        if not (res_src.min() >= 0 and res_src.max() < hg.num_rows):
            raise ValueError("residual slot ids fall outside the layout's "
                             f"{hg.num_rows} rows")
    return HybridTensors(
        degrees=put(hg.degrees),
        row_mask=put(hg.row_mask),
        diag_bits=put(hg.diag_bits) if hg.diag_b else None,
        hot_bits=put(hg.hot_bits) if hg.hot_k else None,
        hot_ids=put(hg.hot_ids, torch.int64) if hg.hot_k else None,
        # only the mask the chosen kernels read (the other is 77 MB at
        # amazon0505 scale): hybrid_agg.py:110-114 in the JAX package
        res_mask=put(hg.res_mask) if has_res and not transposed else None,
        res_mask_s=put(hg.res_mask_s) if has_res and transposed else None,
        res_t2b=put(hg.res_t2b) if has_res else None,
        res_block_ptr=put(block_ptr) if has_res else None,
        res_src=None if res_src is None else put(res_src),
        num_rows=hg.num_rows,
        real_nodes=hg.real_nodes,
        diag_b=hg.diag_b,
        hot_k=hg.hot_k,
        res_tile=hg.res_tile,
        res_ob=hg.res_ob,
        agg_dtype=agg_dtype,
        transposed=transposed,
        res_covers_all=hg.res_covers_all,
        gemm_dtype=gemm_dtype,
    )


def build_layer_tensors(
    hg: HybridGraph,
    device=None,
    agg_dtype: str = "float32",
    transposed: bool = True,
    gemm_dtype: str = "float32",
) -> tuple[HybridTensors, HybridTensors]:
    """The (input-layer, hidden-layer) tensors of one layout: one tensor set
    for both layers, since ``res_src`` serves every width (the JAX decider
    may give two layers different residual gathers,
    tuner/decider.py:349-382 there)."""
    ht = build_hybrid_tensors(
        hg, device=device, agg_dtype=agg_dtype, transposed=transposed,
        gemm_dtype=gemm_dtype,
    )
    return ht, ht


def slab_tiers_t(table: torch.Tensor, d: int,
                 ht: HybridTensors) -> torch.Tensor | None:
    """The slab tiers' sum ([D, R] f32, no degree scaling; None when the
    layout has no slab tier) over x given as its row-major table [R, Dp]
    (``spmm_cuda.row_table_t``): every tier reads ``table.t()[:d]``, x_t
    itself, in place, and both slab tiers run as one fused launch where
    both exist."""
    x_t = table.t()[:d]
    x_hot_t = table.index_select(0, ht.hot_ids).t()[:d] if ht.hot_k else None
    if ht.diag_b and ht.hot_k:
        return spmm_cuda.fused_slab_matmul_t(
            ht.diag_bits, ht.hot_bits, x_t, x_hot_t, ht.diag_b
        )
    out = None
    if ht.diag_b:
        out = spmm_cuda.slab_matmul_t(
            ht.diag_bits, x_t, table_block_cols=ht.diag_b
        )
    if ht.hot_k:
        h = spmm_cuda.slab_matmul_t(ht.hot_bits, x_hot_t)
        out = h if out is None else out + h
    return out


def _tiers_transposed(table: torch.Tensor, d: int,
                      ht: HybridTensors) -> torch.Tensor:
    """Sum of the tiers ([D, R] out, no degree scaling) over x given as its
    row-major table (``slab_tiers_t``); the residual kernel adds the slab
    tiers' sum to its own (no separate ``out + r``)."""
    out = slab_tiers_t(table, d, ht)
    if ht.res_t2b is not None:
        out = residual_tier_t(table.t()[:d], ht, addend=out)
    if out is None:
        out = torch.zeros((d, table.shape[0]), dtype=torch.float32,
                          device=table.device)
    return out


def residual_tier_t(
    src_t: torch.Tensor, ht: HybridTensors, addend: torch.Tensor | None = None
) -> torch.Tensor:
    """Transposed residual tier over the gather source ``src_t [D, table]``
    (the JAX package's ``residual_tier_t``, hybrid_agg.py:355-385), plus
    ``addend`` when given.  The kernel gathers the slot rows by ``res_src``
    itself, and writes zeros into output blocks that no tile visits, so
    the JAX package's visited-block select has no pass of its own here,
    whether or not ``res_covers_all`` holds."""
    return spmm_cuda.residual_combine_t(
        src_t, ht.res_src, ht.res_mask_s, ht.res_t2b, ht.res_block_ptr,
        ht.num_rows, ht.res_ob, addend=addend,
    )


def diag_tier(x: torch.Tensor, ht: HybridTensors) -> torch.Tensor:
    """Row-major diagonal tier alone ([R, D] in, [R, D] f32 out): one slab
    pass with the block-local table (the JAX package's
    ``_diag_aggregate``, hybrid_agg.py:180-207)."""
    return spmm_cuda.slab_matmul(ht.diag_bits, x, table_block_rows=ht.diag_b)


def hot_tier(x: torch.Tensor, ht: HybridTensors) -> torch.Tensor:
    """Row-major hot tier alone: the slab times the gathered hot-node
    rows (the JAX package's ``_hot_aggregate``, hybrid_agg.py:210-228)."""
    return spmm_cuda.slab_matmul(ht.hot_bits, x.index_select(0, ht.hot_ids))


def _tiers_rowmajor(x: torch.Tensor, ht: HybridTensors) -> torch.Tensor:
    """Sum of the tiers ([R, D] in and out, no degree scaling); both slab
    tiers run as one fused launch, and the residual kernel adds their sum
    to its own (no separate ``h + r``)."""
    out = None
    if ht.diag_b and ht.hot_k:
        x_hot = x.index_select(0, ht.hot_ids)
        out = spmm_cuda.fused_slab_matmul(
            ht.diag_bits, ht.hot_bits, x, x_hot, ht.diag_b
        )
    else:
        if ht.diag_b:
            out = diag_tier(x, ht)
        if ht.hot_k:
            h = hot_tier(x, ht)
            out = h if out is None else out + h
    if ht.res_t2b is not None:
        out = residual_tier(x, ht, addend=out)
    if out is None:
        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return out


def residual_tier(
    src: torch.Tensor, ht: HybridTensors, addend: torch.Tensor | None = None
) -> torch.Tensor:
    """Row-major residual tier over the gather source ``src [table, D]``
    (the JAX package's ``_residual_aggregate``, hybrid_agg.py:231-285),
    plus ``addend`` when given.  The kernel gathers the slot rows by
    ``res_src`` itself, and zeroes the blocks no tile visits, as
    ``residual_tier_t``'s does."""
    return spmm_cuda.residual_combine(
        src, ht.res_src, ht.res_mask, ht.res_t2b, ht.res_block_ptr,
        ht.num_rows, ht.res_ob, addend=addend,
    )


def hybrid_aggregate(
    x: torch.Tensor, ht: HybridTensors, norm: bool
) -> torch.Tensor:
    """out[s] = Σ_{d∈N(s)} w_sd · x[d] over the three-tier layout, x and
    out transposed ``[D, R]`` when ``ht.transposed``, else row-major
    ``[R, D]``.

    GCN weighting (``norm``): pre-scale x by sqrt-degree and post-scale
    the output, both dense, so no tier touches per-edge weights
    (deg[s]·deg[d]·x[d] = deg[s]·(deg·x)[d])."""
    out_dtype = x.dtype
    agg_dtype = AGG_DTYPES[ht.agg_dtype]
    if ht.transposed:
        deg = ht.degrees[None, :]
        # the scale, the cast and the transpose in one pass
        table = spmm_cuda.row_table_t(
            x, agg_dtype, ht.degrees.to(x.dtype) if norm else None)
        out = _tiers_transposed(table, x.shape[0], ht)
    else:
        deg = ht.degrees[:, None]
        if norm:
            x = x * deg.to(x.dtype)
        out = _tiers_rowmajor(x.to(agg_dtype).contiguous(), ht)
    if norm:
        out = out * deg
    return out.to(out_dtype)
