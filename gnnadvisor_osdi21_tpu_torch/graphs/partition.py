"""Neighbor-group partitioning: ragged CSR → static-shape padded groups.

The port's copy of ``gnnadvisor_osdi21_tpu/graphs/partition.py`` (same
arrays for the same inputs; the ELL path's ``ops/graph_tensors.py`` puts
them on the card).

The reference's ``build_part`` (GNNAdvisor.cpp:210-251) splits each node's CSR
neighbor list into fixed-size groups of ``partSize`` and emits two ragged
descriptors (``partPtr``: part → edge offset, ``part2Node``: part → owner);
one CUDA warp then processes one part with shared-memory staging and atomic
flushes (GNNAdvisor_kernel.cu:324-415).

Static shapes and deterministic reductions call for a **rectangle**:

- ``part_cols``  [P, S] int32 — neighbor ids, right-padded with 0,
- ``part_lens``  [P]    int32 — valid prefix length of each row (0..S),
- ``part2node``  [P]    int32 — owner node per part (padding rows → node 0
  with length 0, so they contribute exact zeros to any reduction).

Parts of one node occupy consecutive rows (CSR order), so the two-level
reduction — masked sum across the S axis, then a segment-sum over
``part2node`` — is a *sorted* segment reduction, which needs no atomics
(the deterministic replacement for ``atomicAdd_F``,
GNNAdvisor_kernel.cu:12-17).

Construction is fully vectorized NumPy (O(E)); ``native/graphtools``'s
``build_parts`` gives the ragged descriptors of the same groups.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class NeighborGroups:
    """Static-shape neighbor groups for one graph + one partSize."""

    part_cols: np.ndarray  # [P, S] int32 neighbor (dst) ids, 0-padded
    part_lens: np.ndarray  # [P] int32 valid length per part
    part2node: np.ndarray  # [P] int32 owner node id (0 for padding rows)
    part_size: int
    num_nodes: int
    num_real_parts: int  # parts before row padding

    @property
    def num_parts(self) -> int:
        return int(self.part_cols.shape[0])

    @property
    def padding_waste(self) -> float:
        """Fraction of part_cols slots that are padding (diagnostic,
        printed by verbose benches)."""
        total = self.part_cols.size
        valid = int(self.part_lens.sum())
        return 1.0 - valid / max(total, 1)


def build_neighbor_groups(
    row_pointers: np.ndarray,
    column_index: np.ndarray,
    part_size: int,
    pad_parts_to: int = 8,
) -> NeighborGroups:
    """Split every node's neighbor list into groups of ``part_size``.

    Semantics match ``build_part`` (GNNAdvisor.cpp:219-249): node ``i`` with
    degree ``d`` produces ``ceil(d / part_size)`` parts covering its CSR range
    ``[row_pointers[i], row_pointers[i+1])`` in order; the last part may be
    short.  ``pad_parts_to`` rounds the part count up so downstream kernels
    can assume divisibility (sublane alignment).
    """
    if part_size < 1:
        raise ValueError("part_size must be >= 1")
    rp = np.asarray(row_pointers, dtype=np.int64)
    ci = np.asarray(column_index, dtype=np.int32)
    num_nodes = rp.shape[0] - 1
    deg = rp[1:] - rp[:-1]
    parts_per_node = -(-deg // part_size)  # ceil
    num_real = int(parts_per_node.sum())

    part2node = np.repeat(np.arange(num_nodes, dtype=np.int64), parts_per_node)
    first_part_of_node = np.concatenate(([0], np.cumsum(parts_per_node)))[:-1]
    idx_in_node = np.arange(num_real, dtype=np.int64) - first_part_of_node[part2node]
    part_edge_start = rp[part2node] + idx_in_node * part_size
    part_lens = np.minimum(rp[part2node + 1] - part_edge_start, part_size)

    num_parts = -(-max(num_real, 1) // pad_parts_to) * pad_parts_to
    slots = part_edge_start[:, None] + np.arange(part_size, dtype=np.int64)[None, :]
    valid = slots < rp[part2node + 1][:, None]
    cols = np.zeros((num_parts, part_size), dtype=np.int32)
    cols[:num_real] = np.where(valid, ci[np.minimum(slots, ci.shape[0] - 1)], 0)

    lens = np.zeros(num_parts, dtype=np.int32)
    lens[:num_real] = part_lens
    # Padding rows repeat the final owner id so part2node stays sorted
    # (non-decreasing), as the sorted segment sum needs.
    # Their length is 0, so they contribute exact zeros.
    owners = np.full(num_parts, part2node[-1] if num_real else 0, dtype=np.int32)
    owners[:num_real] = part2node

    return NeighborGroups(
        part_cols=cols,
        part_lens=lens,
        part2node=owners,
        part_size=part_size,
        num_nodes=num_nodes,
        num_real_parts=num_real,
    )


def groups_to_ragged(groups: NeighborGroups) -> tuple[np.ndarray, np.ndarray]:
    """Recover the reference's ragged (partPtr, part2Node) descriptors.

    Only used by tests to cross-check against the reference layout contract
    (GNNAdvisor.cpp:210-251); the ELL path consumes the rectangle directly.
    """
    lens = groups.part_lens[: groups.num_real_parts]
    part_ptr = np.concatenate(([0], np.cumsum(lens))).astype(np.int32)
    return part_ptr, groups.part2node[: groups.num_real_parts].astype(np.int32)
