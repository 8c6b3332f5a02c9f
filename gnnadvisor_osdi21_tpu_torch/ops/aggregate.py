"""Aggregation ops with the reference's backward, on the hybrid layout.

The port of ``gnnadvisor_osdi21_tpu/ops/aggregate.py:167-283``.
``aggregate`` is a ``torch.autograd.Function`` whose backward applies the
same forward aggregation to the incoming gradient: exact for undirected
graphs, the reference's backward structure (gnn_conv.py:23-27).  Features
are transposed ``[D, R]`` or row-major ``[R, D]``, as the layout's
``transposed`` says (``is_transposed``); the layers orient their GEMMs to
match.
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
    """out[s] = Σ_{d∈N(s)} w_sd · x[d]; w = deg[s]·deg[d] if ``norm`` else
    1."""
    return _Aggregate.apply(x, ht, norm)


def sag(x: torch.Tensor, ht: HybridTensors) -> torch.Tensor:
    """Scatter-And-Gather: plain neighbour sum (gnn_conv.py:7-28)."""
    return aggregate(x, ht, False)


def is_transposed(ht: HybridTensors) -> bool:
    """True when the layout keeps features transposed ``[D, R]``."""
    return bool(ht.transposed)


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
    """GCN layer Agg(X @ W) with deg[s]·deg[d] weighting (gnn_conv.py:31-78),
    Agg(W^T @ X_t) when transposed.  Autograd through the GEMM and
    ``aggregate`` gives the reference's backward: dX = Agg(g) @ W^T,
    dW = X^T @ Agg(g)."""
    h = _gemm(weight.t(), x) if is_transposed(ht) else _gemm(x, weight)
    return aggregate(h, ht, True)


def gin_conv(
    x: torch.Tensor, weight: torch.Tensor, ht: HybridTensors,
    epsilon: float = 0.5,
):
    """GIN layer (ε · Agg(X)) @ W: no normalization, no self term
    (gnn_conv.py:101-126), W^T @ (ε · Agg(X_t)) when transposed.  Autograd
    through ``aggregate`` and the GEMM gives the reference's backward
    (aggregate.py:262-283): dW = X_agg^T @ g from the saved X_agg, and
    dX = ε · Agg(g @ W^T)."""
    x_agg = epsilon * aggregate(x, ht, False)
    if is_transposed(ht):
        return _gemm(weight.t(), x_agg)
    return _gemm(x_agg, weight)
