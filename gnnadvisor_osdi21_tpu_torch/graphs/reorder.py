"""Community-based node reordering (the rabbit-order preprocessing pass).

The port of ``gnnadvisor_osdi21_tpu/graphs/reorder.py``.  It re-expresses
the reference's ``rabbit.reorder(edge_index) -> edge_index`` API
(rabbit_module/src/reorder.cpp:235-295): detect communities by incremental
modularity-gain merging (rabbit_order.hpp:393-526), then relabel nodes so
each community occupies a contiguous id range, which turns the random row
gathers of the aggregation into mostly local ones.

Two implementations, as in the JAX package:

- the native C++/OpenMP library (``native/graphtools.cpp``, the same
  source), used whenever it can be built.  It merges sequentially below
  200,000 nodes, where its permutation is deterministic, and concurrently
  with per-community spinlocks above (graphtools.cpp:217), where two runs
  may give different permutations;
- the NumPy union-find ``rabbit_permutation`` below, deterministic and
  equal to the JAX package's on every graph, but a Python loop over the
  nodes: minutes at 400,000 nodes.

The JAX package falls back to NumPy on any failure of the native library;
the port falls back only when no ``g++`` can build it, and warns.  A
failed build, or a bad edge id, raises.
"""

from __future__ import annotations

import warnings

import numpy as np

from gnnadvisor_osdi21_tpu_torch.graphs.loader import GraphCSR
from gnnadvisor_osdi21_tpu_torch.native import graphtools


def _undirected_csr(edge_index: np.ndarray, num_nodes: int):
    """Symmetrized, dedup'd, self-loop-free CSR (reorder.cpp:32-97)."""
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    keys = np.unique(u * np.int64(num_nodes) + v)
    u = (keys // num_nodes).astype(np.int64)
    v = (keys % num_nodes).astype(np.int64)
    rp = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(u, minlength=num_nodes), out=rp[1:])
    return rp, v


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:  # path compression
            p[x], x = root, p[x]
        return root

    def union_into(self, child_root: int, parent_root: int):
        self.parent[child_root] = parent_root


def rabbit_permutation(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Return ``perm`` (old id → new id) from greedy modularity merging.

    Python fallback for the native implementation.  Vertices are scanned in
    increasing-degree order (rabbit's processing order); each is merged into
    the neighboring community with the best positive modularity gain
    ``ΔQ ∝ w_uv − s_u·s_v / (2W)`` (rabbit_order.hpp:455-476).  The final
    permutation groups each community's members contiguously.
    """
    rp, cols = _undirected_csr(edge_index, num_nodes)
    deg = (rp[1:] - rp[:-1]).astype(np.float64)
    two_w = float(deg.sum())
    if two_w == 0:
        return np.arange(num_nodes, dtype=np.int64)

    uf = _UnionFind(num_nodes)
    strength = deg.copy()  # community total degree, indexed by root
    order = np.argsort(deg, kind="stable")
    # dendrogram children per representative, in merge order
    children: list[list[int]] = [[] for _ in range(num_nodes)]

    for v in order:
        beg, end = rp[v], rp[v + 1]
        if beg == end:
            continue
        rv = uf.find(v)
        # Accumulate edge weight from v's community to each neighbor community.
        w_to: dict[int, float] = {}
        for n in cols[beg:end]:
            rn = uf.find(n)
            if rn != rv:
                w_to[rn] = w_to.get(rn, 0.0) + 1.0
        best_root, best_gain = -1, 0.0
        sv = strength[rv]
        for rn, w in w_to.items():
            gain = w - sv * strength[rn] / two_w
            if gain > best_gain:
                best_root, best_gain = rn, gain
        if best_root >= 0:
            uf.union_into(rv, best_root)
            strength[best_root] += sv
            children[best_root].append(int(rv))

    # Dendrogram DFS (rabbit_order.hpp:623-673 analog): emit each
    # representative, then its children subtrees in merge order — recently
    # merged sub-communities stay contiguous inside their community.
    perm = np.empty(num_nodes, dtype=np.int64)
    pos = 0
    parent = uf.parent
    for r in range(num_nodes):
        if parent[r] != r:
            continue
        stack = [r]
        while stack:
            u = stack.pop()
            perm[u] = pos
            pos += 1
            stack.extend(reversed(children[u]))
    assert pos == num_nodes
    return perm


def _permutation(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """The native permutation, or the NumPy one (with a warning) when no
    ``g++`` can build the native library."""
    if graphtools.available():
        return graphtools.rabbit_permutation(edge_index, num_nodes)
    warnings.warn(
        "no g++ to build native/graphtools.cpp: the NumPy rabbit_permutation "
        "runs instead (a Python loop over the nodes)", RuntimeWarning,
        stacklevel=3,
    )
    return rabbit_permutation(edge_index, num_nodes)


def reorder(edge_index: np.ndarray, num_nodes: int | None = None) -> np.ndarray:
    """``rabbit.reorder`` API parity: edge_index [2,E] -> relabeled
    edge_index (reorder.cpp:282-287)."""
    edge_index = np.asarray(edge_index)
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1
    perm = _permutation(edge_index, num_nodes)
    return np.stack([perm[edge_index[0]], perm[edge_index[1]]])


def rabbit_reorder_graph(graph: GraphCSR) -> GraphCSR:
    """Reorder a loaded graph and rebuild its CSR (dataset.py:138-175)."""
    perm = _permutation(np.asarray(graph.edge_index), graph.num_nodes)
    return graph.apply_permutation(perm)
