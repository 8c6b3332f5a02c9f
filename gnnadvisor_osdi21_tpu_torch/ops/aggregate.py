"""Aggregation ops with the reference's backward, on the hybrid layout.

The port of ``gnnadvisor_osdi21_tpu/ops/aggregate.py:167-244``.
``aggregate`` is a ``torch.autograd.Function`` whose backward applies the
same forward aggregation to the incoming gradient: exact for undirected
graphs, the reference's backward structure (gnn_conv.py:23-27).  Features
are transposed ``[D, R]`` throughout.
"""

from __future__ import annotations

import torch

from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
    HybridTensors, hybrid_aggregate,
)


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ht: HybridTensors, norm: bool):
        ctx.ht, ctx.norm = ht, norm
        return hybrid_aggregate(x, ht, norm)

    @staticmethod
    def backward(ctx, g):
        # undirected-graph assumption, as in the reference: the adjoint of
        # the aggregation is the same aggregation
        return hybrid_aggregate(g.contiguous(), ctx.ht, ctx.norm), None, None


def aggregate(x: torch.Tensor, ht: HybridTensors, norm: bool = False):
    """out[:, s] = Σ_{d∈N(s)} w_sd · x[:, d]; w = deg[s]·deg[d] if ``norm``
    else 1."""
    return _Aggregate.apply(x, ht, norm)


def sag(x: torch.Tensor, ht: HybridTensors) -> torch.Tensor:
    """Scatter-And-Gather: plain neighbour sum (gnn_conv.py:7-28)."""
    return aggregate(x, ht, False)


def _gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Model-stack GEMM in full f32 (the reference's cuBLAS contract).
    TF32 would keep about three decimal digits, so a CUDA GEMM refuses to
    run with it on; ``exact_f32_matmul`` turns it off."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "TF32 matmul is on: call exact_f32_matmul() before running the "
            "model on the card"
        )
    return torch.matmul(a, b)


def exact_f32_matmul() -> None:
    """Turn TF32 off for CUDA matmuls (process-wide) and check it is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("could not turn TF32 off for CUDA matmuls")


def gcn_conv(x: torch.Tensor, weight: torch.Tensor, ht: HybridTensors):
    """GCN layer Agg(W^T @ X_t) with deg[s]·deg[d] weighting
    (gnn_conv.py:31-78).  Autograd through the GEMM and ``aggregate``
    gives the reference's backward: dX = W @ Agg(g), dW = X @ Agg(g)^T."""
    return aggregate(_gemm(weight.t(), x), ht, True)
