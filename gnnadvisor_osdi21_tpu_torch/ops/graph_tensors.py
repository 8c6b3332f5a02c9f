"""The ELL, dense and COO paths' graph tensors on one device.

The port of ``gnnadvisor_osdi21_tpu/ops/graph_tensors.py``: whichever
tensors the chosen aggregation path needs, built from the host graph and
put on the device (GNNA_main.py:107-110 moves the reference's CSR and
partition tensors to its GPU the same way).

- ``"ell"``: padded neighbor groups (``graphs/partition.py``), a gather
  and a two-level sorted segment sum (the warp-per-part kernel's
  analog);
- ``"dense"``: the materialized adjacency, ``A @ X`` as one matrix
  product (small graphs);
- ``"coo"``: a per-edge gather and a sorted segment sum (the
  Gunrock-style baseline, Gunrock/app/spmm/spmm_enactor.cuh:92-105,
  without atomics).

The hybrid path has its own tensors (``ops/hybrid_agg.HybridTensors``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.graphs.loader import GraphCSR
from gnnadvisor_osdi21_tpu_torch.graphs.partition import (
    NeighborGroups, build_neighbor_groups,
)
from gnnadvisor_osdi21_tpu_torch.ops import reference

METHODS = ("ell", "dense", "coo")
GEMM_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class GraphTensors:
    """The tensors an aggregation path may need, with the JAX
    ``GraphTensors`` fields; those its path does not use are None.  One
    field is the port's: ``seg_ptr``, the sorted segment sum's offsets
    (node i owns parts, or edges, ``seg_ptr[i]:seg_ptr[i+1]``), so that
    the reduction runs without atomics on the card."""

    degrees: torch.Tensor  # [N] f32 sqrt(max(deg, 1))
    part_cols: Optional[torch.Tensor] = None  # [P, S] int32
    part_lens: Optional[torch.Tensor] = None  # [P] int32
    part2node: Optional[torch.Tensor] = None  # [P] int32, sorted
    coo_src: Optional[torch.Tensor] = None  # [nnz] int32, sorted
    coo_dst: Optional[torch.Tensor] = None  # [nnz] int32
    dense_adj: Optional[torch.Tensor] = None  # [N, N]
    seg_ptr: Optional[torch.Tensor] = None  # [N + 1] int64 (ELL, COO)
    num_nodes: int = 0
    part_size: int = 0
    method: str = "ell"
    # the model's GEMM dtype (ops.aggregate._gemm): "bfloat16" multiplies
    # bf16 operands with f32 accumulation, beyond the reference's f32
    gemm_dtype: str = "float32"

    def with_method(self, method: str) -> "GraphTensors":
        return dataclasses.replace(self, method=method)


def _offsets(sorted_owner: np.ndarray, num_nodes: int) -> np.ndarray:
    """[N + 1] offsets of each owner's run in a sorted owner array."""
    counts = np.bincount(sorted_owner, minlength=num_nodes)
    return np.concatenate(([0], np.cumsum(counts))).astype(np.int64)


def build_graph_tensors(
    graph: GraphCSR,
    method: str = "ell",
    part_size: Optional[int] = None,
    groups: Optional[NeighborGroups] = None,
    adj_dtype=torch.float32,
    device=None,
    gemm_dtype: str = "float32",
) -> GraphTensors:
    """Build the tensors ``method`` needs and put them on ``device``
    (None: the card)."""
    if method == "hybrid":
        raise ValueError(
            "method='hybrid' has its own builder: graphs.hybrid.build_hybrid"
            " + ops.hybrid_agg.build_hybrid_tensors (it relabels nodes, so"
            " features/labels must be moved to the padded row space)"
        )
    if method not in METHODS:
        raise ValueError(f"unknown aggregation method: {method}")
    if gemm_dtype not in GEMM_DTYPES:
        raise ValueError(f"gemm_dtype must be one of {GEMM_DTYPES}")
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    kwargs: dict = dict(
        degrees=put(graph.degrees),
        num_nodes=graph.num_nodes,
        method=method,
        gemm_dtype=gemm_dtype,
    )
    if method == "ell":
        if groups is None:
            if part_size is None:
                part_size = max(int(graph.avg_degree), 1)
            groups = build_neighbor_groups(
                graph.row_pointers, graph.column_index, part_size
            )
        kwargs.update(
            part_cols=put(groups.part_cols),
            part_lens=put(groups.part_lens),
            part2node=put(groups.part2node),
            seg_ptr=put(_offsets(groups.part2node, graph.num_nodes)),
            part_size=groups.part_size,
        )
    elif method == "coo":
        kwargs.update(
            coo_src=put(reference.csr_to_coo(graph.row_pointers,
                                             graph.column_index)),
            coo_dst=put(graph.column_index),
            seg_ptr=put(np.asarray(graph.row_pointers, dtype=np.int64)),
        )
    else:
        adj = reference.dense_adjacency(graph.row_pointers, graph.column_index)
        kwargs.update(dense_adj=put(adj).to(adj_dtype))
    return GraphTensors(**kwargs)
