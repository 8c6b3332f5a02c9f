"""Aggregation ops with the reference's backward, on every layout.

The port of ``gnnadvisor_osdi21_tpu/ops/aggregate.py``.  The forward
aggregation dispatches over the tensors' ``method``: the hybrid layout
(``ops/hybrid_agg.py``, the CUDA kernels), or the ELL, dense and COO
paths of ``GraphTensors`` (PyTorch ops: the JAX package has no Pallas
kernel on them).  ``aggregate`` is a ``torch.autograd.Function`` whose
backward applies the same forward aggregation to the incoming gradient:
exact for undirected graphs, the reference's backward structure
(gnn_conv.py:23-27).  Hybrid features are transposed ``[D, R]`` or
row-major ``[R, D]``, as the layout's ``transposed`` says
(``is_transposed``); the other paths are row-major.  The layers orient
their GEMMs to match.

Every reduction is deterministic, on the card too: the ELL and COO paths
sum sorted segments with ``torch.segment_reduce`` over ``seg_ptr`` (one
thread a segment and column, in order), where ``index_add_`` would add
with atomics.
"""

from __future__ import annotations

import torch

from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import GraphTensors
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
    HybridTensors, hybrid_aggregate,
)

# Max bytes of materialized [parts, part_size, D] gather scratch per ELL
# pass (the JAX package's budget); above it the pass runs over blocks of
# parts, one after the other.
_ELL_SCRATCH_BUDGET = 1 << 30


def _ell_part_sums(x, cols, lens, degrees, norm: bool) -> torch.Tensor:
    """Per-part masked (weighted) sum over the partSize axis: the analog of
    a warp accumulating its part into shared memory
    (GNNAdvisor_kernel.cu:383-406)."""
    num_parts, part_size = cols.shape
    gathered = x.index_select(0, cols.reshape(-1)).view(num_parts, part_size,
                                                        -1)
    lane = torch.arange(part_size, device=cols.device)
    mask = lane[None, :] < lens[:, None]
    if norm:
        w = torch.where(mask, degrees[cols.long()], 0.0)
    else:
        w = mask.to(x.dtype)
    return (gathered * w.to(x.dtype)[:, :, None]).sum(dim=1)


def _segment_sum(vals: torch.Tensor, seg_ptr: torch.Tensor) -> torch.Tensor:
    """Row sums of each sorted segment ``seg_ptr[i]:seg_ptr[i+1]`` (empty
    segments give 0), with no atomics."""
    return torch.segment_reduce(vals, "sum", offsets=seg_ptr, axis=0,
                                unsafe=True)


def _ell_aggregate(x: torch.Tensor, gt: GraphTensors, norm: bool):
    """Padded neighbor-group aggregation (the warp-per-part analog).

    Stage 1: per-part masked (weighted) sums, over blocks of parts when the
    padded gather would exceed ``_ELL_SCRATCH_BUDGET``.  Stage 2: the
    sorted segment sum of the part sums into their owner nodes, the
    deterministic analog of the atomic flush (:409-413).  The ``deg[src]``
    factor is applied once per node at the end."""
    out = ell_sums(x, gt.part_cols, gt.part_lens, gt.seg_ptr, gt.degrees,
                   norm)
    if norm:
        out = out * gt.degrees[:, None].to(out.dtype)
    return out


def ell_sums(x, cols, lens, seg_ptr, degrees=None, norm: bool = False):
    """Both ELL stages over parts ``cols``/``lens`` with owner offsets
    ``seg_ptr``: the per-part masked (``norm``: degree-weighted) sums, over
    blocks of parts within ``_ELL_SCRATCH_BUDGET``, then their sorted
    segment sums, one row per owner."""
    num_parts, part_size = cols.shape
    chunk = max(_ELL_SCRATCH_BUDGET // (part_size * x.shape[1] * 4), 1)
    part_sums = torch.cat([
        _ell_part_sums(x, cols[s:s + chunk], lens[s:s + chunk], degrees,
                       norm)
        for s in range(0, num_parts, chunk)
    ])
    return _segment_sum(part_sums, seg_ptr)


def _dense_aggregate(x: torch.Tensor, gt: GraphTensors, norm: bool):
    """Whole-adjacency matrix product: out = D_s · A · D_s · x (or A · x),
    in f32."""
    a = gt.dense_adj
    if norm:
        xw = x * gt.degrees[:, None].to(x.dtype)
        out = _matmul_f32(a, xw.to(a.dtype))
        return (out * gt.degrees[:, None]).to(x.dtype)
    return _matmul_f32(a, x.to(a.dtype)).to(x.dtype)


def _coo_aggregate(x: torch.Tensor, gt: GraphTensors, norm: bool):
    """Naive per-edge path, the Gunrock-SpMM-shaped baseline
    (Gunrock/app/spmm/spmm_enactor.cuh:92-105), atomics replaced by a
    sorted segment sum."""
    vals = x.index_select(0, gt.coo_dst)
    if norm:
        w = gt.degrees[gt.coo_src.long()] * gt.degrees[gt.coo_dst.long()]
        vals = vals * w[:, None].to(vals.dtype)
    return _segment_sum(vals, gt.seg_ptr)


_PATHS = {"ell": _ell_aggregate, "dense": _dense_aggregate,
          "coo": _coo_aggregate}


def _dispatch_aggregate(x: torch.Tensor, gt, norm: bool) -> torch.Tensor:
    if gt.method == "hybrid":
        return hybrid_aggregate(x, gt, norm)
    if gt.method not in _PATHS:
        raise ValueError(f"unknown aggregation method: {gt.method}")
    return _PATHS[gt.method](x, gt, norm)


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gt, norm: bool):
        ctx.gt, ctx.norm = gt, norm
        return _dispatch_aggregate(x, gt, norm)

    @staticmethod
    def backward(ctx, g):
        # undirected-graph assumption, as in the reference: the adjoint of
        # the aggregation is the same aggregation
        return _dispatch_aggregate(g.contiguous(), ctx.gt, ctx.norm), None, None


def aggregate(x: torch.Tensor, gt: HybridTensors | GraphTensors,
              norm: bool = False):
    """out[s] = Σ_{d∈N(s)} w_sd · x[d]; w = deg[s]·deg[d] if ``norm`` else
    1."""
    return _Aggregate.apply(x, gt, norm)


def sag(x: torch.Tensor, gt: HybridTensors | GraphTensors) -> torch.Tensor:
    """Scatter-And-Gather: plain neighbour sum (gnn_conv.py:7-28)."""
    return aggregate(x, gt, False)


def is_transposed(gt) -> bool:
    """True when the layout keeps features transposed ``[D, R]`` (only a
    hybrid layout can)."""
    return bool(getattr(gt, "transposed", False))


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result.  f32 operands contract in full f32 (the
    reference's cuBLAS contract): TF32 would keep about three decimal
    digits, so a CUDA product refuses to run with it on
    (``exact_f32_matmul`` turns it off).  bf16 operands multiply exactly
    and accumulate in f32, as the JAX package's
    ``preferred_element_type=f32``: on the card one bf16 GEMM with an f32
    output; on the CPU, which has no such kernel, the operands widened to
    f32 (the same products)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "TF32 matmul is on: call exact_f32_matmul() before running "
                "the model on the card"
            )
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


class _Bf16Gemm(torch.autograd.Function):
    """a @ b on bf16 operands, f32 out; the backward's two products take
    bf16 operands too (the JAX package's ``_gemm`` inside its custom
    VJPs)."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        return _matmul_f32(a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        return _matmul_f32(g16, b16.t()), _matmul_f32(a16.t(), g16)


def _gemm(a: torch.Tensor, b: torch.Tensor, gt) -> torch.Tensor:
    """The model's GEMM at the tensors' ``gemm_dtype``: f32 (the default,
    the reference's contract) or bf16 operands with f32 accumulation."""
    dt = getattr(gt, "gemm_dtype", "float32")
    if dt == "float32":
        return _matmul_f32(a, b)
    if dt == "bfloat16":
        return _Bf16Gemm.apply(a, b)
    raise ValueError(f"unknown gemm_dtype: {dt}")


def exact_f32_matmul() -> None:
    """Turn TF32 off for CUDA matmuls (process-wide) and check it is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("could not turn TF32 off for CUDA matmuls")


def gcn_conv(x: torch.Tensor, weight: torch.Tensor,
             gt: HybridTensors | GraphTensors):
    """GCN layer Agg(X @ W) with deg[s]·deg[d] weighting (gnn_conv.py:31-78),
    Agg(W^T @ X_t) when transposed.  Autograd through the GEMM and
    ``aggregate`` gives the reference's backward: dX = Agg(g) @ W^T,
    dW = X^T @ Agg(g)."""
    h = _gemm(weight.t(), x, gt) if is_transposed(gt) else _gemm(x, weight, gt)
    return aggregate(h, gt, True)


def gin_conv(
    x: torch.Tensor, weight: torch.Tensor, gt: HybridTensors | GraphTensors,
    epsilon: float = 0.5,
):
    """GIN layer (ε · Agg(X)) @ W: no normalization, no self term
    (gnn_conv.py:101-126), W^T @ (ε · Agg(X_t)) when transposed.  Autograd
    through ``aggregate`` and the GEMM gives the reference's backward
    (aggregate.py:262-283): dW = X_agg^T @ g from the saved X_agg, and
    dX = ε · Agg(g @ W^T)."""
    x_agg = epsilon * aggregate(x, gt, False)
    if is_transposed(gt):
        return _gemm(weight.t(), x_agg, gt)
    return _gemm(x_agg, weight, gt)
