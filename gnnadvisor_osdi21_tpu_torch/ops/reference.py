"""The plain oracle of the reference's aggregation semantics, in torch.

The port of ``gnnadvisor_osdi21_tpu/ops/reference.py``: slow but plainly
correct versions of the five CUDA entry points
(GNNAdvisor_kernel.cu:110/267/422/559/696).  The CPU tests and
``chip_smoke.py`` hold the ELL, dense and COO paths against them.  The
per-edge sum is ``index_add_`` (atomic on CUDA, so not bitwise
repeatable there), on purpose another formulation than the sorted
segment sums of the paths under test.

Reference semantics, quirks intact:

- **SAG** (``SAG_cuda``): plain neighbor sum,
  ``out[s] = Σ_{d ∈ N(s)} x[d]``.
- **GCN aggregation** (``spmm_forward_cuda_kernel:389``): multiplicative
  sqrt-degree weighting ``out[s] = Σ_d deg[s]·deg[d]·x[d]`` with
  ``deg[i] = sqrt(max(degree_i, 1))`` (dataset.py:121-122).
- **GCN forward** = GEMM then aggregate: ``Agg(X @ W)``
  (GNNAdvisor_kernel.cu:280, :298); **backward**: ``dX = Agg(d_out) @ Wᵀ``,
  ``dW = Xᵀ @ Agg(d_out)`` (:448-473), exact for undirected graphs.
- **GIN forward** = aggregate then GEMM: ``X_agg = ε·Σ_d x[d]`` (no
  normalization, no self term, ε = 0.5; gnn_conv.py:132), ``out = X_agg @
  W`` (:605); **backward**: ``dW = X_aggᵀ @ d_out``,
  ``dX = ε·Σ_d (d_out @ Wᵀ)[d]`` (:710-738).
"""

from __future__ import annotations

import numpy as np
import torch


def csr_to_coo(row_pointers: np.ndarray, column_index: np.ndarray) -> np.ndarray:
    """Expand CSR row pointers to a per-edge source-id array (sorted)."""
    rp = np.asarray(row_pointers, dtype=np.int64)
    deg = rp[1:] - rp[:-1]
    return np.repeat(np.arange(rp.shape[0] - 1, dtype=np.int32), deg)


def coo_aggregate(
    x: torch.Tensor,
    coo_src: torch.Tensor,
    coo_dst: torch.Tensor,
    num_nodes: int,
    edge_weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """out[s] = Σ_{(s,d) ∈ E} w_sd · x[d]."""
    vals = x[coo_dst.long()]
    if edge_weight is not None:
        vals = vals * edge_weight[:, None]
    out = torch.zeros((num_nodes,) + tuple(x.shape[1:]), dtype=vals.dtype,
                      device=x.device)
    return out.index_add_(0, coo_src.long(), vals)


def sag(x, coo_src, coo_dst, num_nodes):
    """Plain scatter-and-gather (SAG_cuda, GNNAdvisor_kernel.cu:110-184)."""
    return coo_aggregate(x, coo_src, coo_dst, num_nodes)


def gcn_aggregate(x, coo_src, coo_dst, degrees, num_nodes):
    """out[s] = Σ_d deg[s]·deg[d]·x[d] (spmm_forward_cuda_kernel:389-403)."""
    w = degrees[coo_src.long()] * degrees[coo_dst.long()]
    return coo_aggregate(x, coo_src, coo_dst, num_nodes, edge_weight=w)


def gcn_forward(x, weight, coo_src, coo_dst, degrees, num_nodes):
    """GEMM-then-aggregate (spmm_forward_cuda, GNNAdvisor_kernel.cu:267-322)."""
    return gcn_aggregate(x @ weight, coo_src, coo_dst, degrees, num_nodes)


def gcn_backward(d_output, x, weight, coo_src, coo_dst, degrees, num_nodes):
    """(dX, dW) exactly as spmm_backward_cuda (GNNAdvisor_kernel.cu:422-476)."""
    d_ip = gcn_aggregate(d_output, coo_src, coo_dst, degrees, num_nodes)
    return d_ip @ weight.T, x.T @ d_ip


def gin_forward(x, weight, coo_src, coo_dst, num_nodes, epsilon=0.5):
    """Aggregate-then-GEMM; returns (out, X_agg)
    (spmm_forward_cuda_gin, GNNAdvisor_kernel.cu:559-617)."""
    x_agg = epsilon * coo_aggregate(x, coo_src, coo_dst, num_nodes)
    return x_agg @ weight, x_agg


def gin_backward(d_output, x_agg, weight, coo_src, coo_dst, num_nodes,
                 epsilon=0.5):
    """(dX, dW) as spmm_backward_cuda_gin (GNNAdvisor_kernel.cu:696-747)."""
    d_weight = x_agg.T @ d_output
    d_ip = d_output @ weight.T
    d_input = epsilon * coo_aggregate(d_ip, coo_src, coo_dst, num_nodes)
    return d_input, d_weight


def dense_adjacency(
    row_pointers: np.ndarray, column_index: np.ndarray, dtype=np.float32
) -> np.ndarray:
    """Materialize the 0/1 adjacency (host-side; small graphs only)."""
    n = row_pointers.shape[0] - 1
    a = np.zeros((n, n), dtype=dtype)
    src = csr_to_coo(row_pointers, column_index)
    a[src, np.asarray(column_index)] = 1.0
    return a
