"""Standalone reorder tool, parity with the reference's ``reorder`` CLI
(rabbit_module/src/reorder.cc: ``reorder [-c] GRAPH_FILE`` prints the new
permutation, or community assignments plus modularity with ``-c``): the
port of ``gnnadvisor_osdi21_tpu/tools/reorder.py``.  Host only.

Usage:
    python -m gnnadvisor_osdi21_tpu_torch.tools.reorder [-c] GRAPH_FILE

The permutation is the native library's (``native/graphtools.cpp``,
built with g++ at first use); a library that cannot be built raises.
"""

from __future__ import annotations

import sys

import numpy as np

from gnnadvisor_osdi21_tpu_torch.graphs.reorder import (
    _UnionFind, _undirected_csr,
)


def communities_and_modularity(edge_index: np.ndarray, num_nodes: int):
    """Community id per node (from the rabbit merge forest) and the
    modularity Q = Σ_c (e_c / m − (d_c / 2m)²) over the symmetrized simple
    graph, the quantity reorder.cc's ``compute_modularity`` reports.  The
    greedy merge is ``graphs/reorder.rabbit_permutation``'s, in Python:
    the tool is offline."""
    rp, cols = _undirected_csr(edge_index, num_nodes)
    deg = (rp[1:] - rp[:-1]).astype(np.float64)
    two_m = float(deg.sum())
    uf = _UnionFind(num_nodes)
    strength = deg.copy()
    for v in np.argsort(deg, kind="stable"):
        beg, end = rp[v], rp[v + 1]
        if beg == end:
            continue
        rv = uf.find(int(v))
        w_to: dict[int, float] = {}
        for n in cols[beg:end]:
            rn = uf.find(int(n))
            if rn != rv:
                w_to[rn] = w_to.get(rn, 0.0) + 1.0
        best, best_gain = -1, 0.0
        for rn, w in w_to.items():
            gain = w - strength[rv] * strength[rn] / two_m
            if gain > best_gain:
                best, best_gain = rn, gain
        if best >= 0:
            uf.union_into(rv, best)
            strength[best] += strength[rv]
    roots = np.fromiter(
        (uf.find(i) for i in range(num_nodes)), dtype=np.int64, count=num_nodes
    )
    _, comm = np.unique(roots, return_inverse=True)
    if two_m == 0:
        return comm, 0.0
    src = np.repeat(np.arange(num_nodes), rp[1:] - rp[:-1])
    intra = comm[src] == comm[cols]
    e_frac = intra.sum() / two_m  # each undirected edge counted twice / 2m
    d_c = np.bincount(comm, weights=deg)
    q = float(e_frac - np.sum((d_c / two_m) ** 2))
    return comm, q


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    want_communities = "-c" in argv
    paths = [a for a in argv if not a.startswith("-")]
    if not paths:
        print(__doc__)
        return 2
    from gnnadvisor_osdi21_tpu_torch.graphs.loader import load_graph
    from gnnadvisor_osdi21_tpu_torch.native import graphtools

    g = load_graph(paths[0], load_from_txt=not paths[0].endswith(".npz"))
    if want_communities:
        comm, q = communities_and_modularity(g.edge_index, g.num_nodes)
        for c in comm:
            print(c)
        print(f"modularity: {q:.6f}", file=sys.stderr)
    else:
        for p in graphtools.rabbit_permutation(g.edge_index, g.num_nodes):
            print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
