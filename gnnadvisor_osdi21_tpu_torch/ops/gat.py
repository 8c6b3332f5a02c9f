"""GAT's attention layer: the tensors of the attention layout and the op
whose backward is the true adjoint.

A layer with K heads of F features (Veličković et al., arXiv:1710.10903,
eq. 1-4), per head h, over the edges (s, d) of each row s with its
self-loop: ``v = x W``; ``e_sd = LeakyReLU(a_src . v_s + a_dst . v_d)``;
``alpha_sd`` = the softmax of ``e_sd`` over the row; ``out_s = sum of
alpha_sd v_d``.  The node scores ``a . v`` are one plain PyTorch product
(``score_matrix``; autograd takes its backward); ``attention`` is a
``torch.autograd.Function`` over the kernels of ``ops/gat_cuda.py``:

- forward: the edge softmax (``gat::``), the operand's cast, the
  alpha-weighted aggregation in row-owner order (``gnna::``);
- backward, from dout: the SDDMM with the softmax's and the LeakyReLU's
  backward in row-owner order, giving the logits' gradient per edge and
  its row sums, d(a_src . v); their column sums, d(a_dst . v), in
  transposed order (``gat::``); then dout's cast and the adjoint
  aggregation ``dv_d = sum over s of alpha_sd dout_s`` in transposed
  order, alpha read through the permutation (``gnna::``).

The graph is directed in general and alpha is not symmetric, so the
backward is not the forward aggregation again (``ops/aggregate.py``'s
rule for GCN and GIN).  Precision: the gathered rows (v forward and in
the SDDMM, dout in the adjoint) are the layout's ``agg_dtype``; the
scores, alpha, the softmax statistics and every sum are float32.  No
atomics: two runs give the same bits.

Spans: ``forward.layer<i>.gemm`` and ``.attention`` (the scores, the
softmax, and inside it ``aggregate.passes`` around the operand's cast and
``aggregate.tiers`` around the aggregation); in the backward
``attention.backward`` (the SDDMM and the column sums),
``aggregate.passes`` and ``aggregate.tiers``.  Counter ``attn.edges``:
the edges of each layout built.
"""

from __future__ import annotations

import dataclasses

import torch

from gnnadvisor_osdi21_tpu_torch.graphs.gat import GatLayout
from gnnadvisor_osdi21_tpu_torch.ops import gat_cuda
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import _gemm, _matmul_f32
from gnnadvisor_osdi21_tpu_torch.utils import profiling

AGG_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class GatTensors:
    """The attention layout on a device: the edges with self-loops in
    row-owner order (``rows``) and transposed order (``cols``), the
    gathered operands' dtype and the model's GEMM dtype.  Row-major
    features, one row a node: no padding rows."""

    num_nodes: int
    num_edges: int
    rows: gat_cuda.Walk
    cols: gat_cuda.Walk
    agg_dtype: torch.dtype = torch.bfloat16
    gemm_dtype: str = "float32"
    method: str = "gat"
    transposed: bool = False


def build_gat_tensors(layout: GatLayout, device, agg_dtype: str = "bfloat16",
                      gemm_dtype: str = "float32") -> GatTensors:
    """``layout`` (``graphs/gat.build_gat_layout``) on ``device``."""
    if agg_dtype not in AGG_DTYPES:
        raise ValueError(f"unknown agg_dtype: {agg_dtype}")
    profiling.count("attn.edges", layout.num_edges)
    return GatTensors(layout.num_nodes, layout.num_edges,
                      gat_cuda.Walk.of(layout.rows, device),
                      gat_cuda.Walk.of(layout.cols, device),
                      AGG_DTYPES[agg_dtype], gemm_dtype)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, s_src, s_dst, gt: GatTensors, heads: int,
                slope: float):
        k, f = heads, v.shape[1] // heads
        rows = gt.rows
        alpha = gat_cuda.edge_softmax(rows.ptr, rows.idx, s_src, s_dst, slope)
        with profiling.span("aggregate.passes"):
            table = gat_cuda.operand_table(v, k, f, gt.agg_dtype)
        with profiling.span("aggregate.tiers"):
            out = gat_cuda.aggregate(table, k, f, rows, alpha)
        ctx.save_for_backward(table, alpha, out, s_src, s_dst)
        ctx.gt, ctx.k, ctx.f, ctx.slope = gt, k, f, slope
        return out

    @staticmethod
    def backward(ctx, dout):
        table, alpha, out, s_src, s_dst = ctx.saved_tensors
        gt, k, f = ctx.gt, ctx.k, ctx.f
        dout = dout.contiguous()
        with profiling.span("attention.backward"):
            de, ds_src = gat_cuda.sddmm(
                gt.rows.ptr, gt.rows.idx, table, k, f, dout, out, alpha,
                s_src, s_dst, ctx.slope)
            ds_dst = gat_cuda.col_reduce(de, gt.cols)
        with profiling.span("aggregate.passes"):
            dtable = gat_cuda.operand_table(dout, k, f, gt.agg_dtype)
        with profiling.span("aggregate.tiers"):
            dv = gat_cuda.aggregate(dtable, k, f, gt.cols, alpha)
        return dv, ds_src, ds_dst, None, None, None


def attention(v: torch.Tensor, s_src: torch.Tensor, s_dst: torch.Tensor,
              gt: GatTensors, heads: int, slope: float) -> torch.Tensor:
    """out [n, heads*F] f32: per head, the softmax over each row's edges of
    leaky_relu(s_src[s] + s_dst[d], slope) weighting v's rows [n,
    heads*F] (head h at columns h*F..)."""
    return _Attention.apply(v, s_src, s_dst, gt, heads, slope)


def score_matrix(att_src: torch.Tensor, att_dst: torch.Tensor) -> torch.Tensor:
    """[K*F, 2K]: column h holds ``att_src[h]`` in head h's rows and column
    K + h ``att_dst[h]``, zeros elsewhere, so that ``v @ score_matrix``
    gives every node's scores of both kinds in one product."""
    return torch.cat([torch.block_diag(*att_src[:, None]).t(),
                      torch.block_diag(*att_dst[:, None]).t()], dim=1)


def gat_conv(x: torch.Tensor, weight: torch.Tensor, att_src: torch.Tensor,
             att_dst: torch.Tensor, gt: GatTensors, slope: float,
             layer: int = 0) -> torch.Tensor:
    """One attention layer: x [n, in] -> [n, K*F], the heads side by side;
    ``weight`` [in, K*F], ``att_src`` and ``att_dst`` [K, F].  The node
    scores ``a . v`` of every head are one float32 product with
    ``score_matrix`` (whose zeros add nothing), which reads v once where
    a product and a sum per kind would pass over [n, K, F] several times,
    backward too.  Spans: ``forward.layer<layer>.gemm`` and
    ``.attention``."""
    k = att_src.shape[0]
    with profiling.span(f"forward.layer{layer}.gemm"):
        v = _gemm(x, weight, gt)
    with profiling.span(f"forward.layer{layer}.attention"):
        scores = _matmul_f32(v, score_matrix(att_src, att_dst))
        return attention(v, scores[:, :k].contiguous(),
                         scores[:, k:].contiguous(), gt, k, slope)
