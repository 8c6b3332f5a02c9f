"""The attention layout: a graph's edges with one self-loop per node, in
two orders, and the chunks the attention kernels walk them in.

GAT (``models/gat.py``) lets every node attend over its neighbours and
itself.  Its forward runs in row-owner order: row s holds the edges (s,
d), the softmax is taken over them and ``out[s]`` sums them.  Its
backward's adjoint ``dv[d] = sum over s of alpha_sd dout[s]`` runs in the
transposed order, where row d holds the edges (s, d).  Both orders come
from what the set-up already has: the row-owner order is the graph's CSR
and the transposed one the decider's census (``AttentionCensus``), which
sorts the edges once into (dst, src) order and keeps each edge's CSR
position (``pos``); the hybrid layouts' census (``EdgeCensus.of_graph``)
sorts (dst, src) keys and keeps no positions.  Self-loops go in by linear passes, no second sort: a node
without one gets (s, s) at its place in its row (columns ascending) and
in its column (rows ascending); a self-loop already in the edge list is
kept once.  ``perm`` maps each transposed edge to its row-owner position,
so that the backward reads the forward's per-edge values (alpha, the
logits' gradient) through it.

Each order is cut into chunks of at most ``CHUNK_EDGES`` edges of one
row, the unit of work of one warp.  amazon0505's transposed order has a
271,796-edge row (a hub column of the directed graph) beside a mean of
13; a row longer than a chunk is summed in chunks into partial rows, then
the partials in order (``fix_row``, ``fix_ptr``), so that no row waits
on one warp and no sum takes an atomic.  The chunks of split rows come
first, so that their long tail starts early.  Ids are int32.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import EdgeCensus, _id_dtype
from gnnadvisor_osdi21_tpu_torch.graphs.loader import GraphCSR
from gnnadvisor_osdi21_tpu_torch.utils import profiling

CHUNK_EDGES = 256  # edges a warp sums into one row at most


class AttentionCensus(EdgeCensus):
    """The census of ``graph``'s CSR edges, in ``EdgeCensus.of_graph``'s
    (dst, src) order, from one sort of (column, CSR position) keys: a
    CSR's positions ascend with its rows, so that is the (dst, src) order,
    and ``pos`` keeps each edge's CSR position, the permutation between
    the two orders.  Span ``census.sort``, counter ``census.sorts``."""

    def __init__(self, graph: GraphCSR):
        n = graph.num_nodes
        rp = np.asarray(graph.row_pointers, dtype=np.int64)
        nnz = int(rp[-1])
        ids = _id_dtype(n)
        with profiling.span("census.sort"):
            span = np.int64(max(nnz, 1))
            key = np.asarray(graph.column_index, dtype=np.int64) * span
            key += np.arange(nnz, dtype=np.int64)
            key.sort()
            dst, pos = np.divmod(key, span)
            src = np.repeat(np.arange(n, dtype=ids), np.diff(rp))[pos]
        profiling.count("census.sorts")
        super().__init__(src, dst.astype(ids), n, ordered=True)
        self.pos = pos.astype(_id_dtype(nnz))


@dataclasses.dataclass
class EdgeWalk:
    """One order of the edges: row pointers ``ptr`` [n+1], the node each
    edge reads ``idx`` [E], each edge's row-owner position ``pos`` [E]
    (None in the row-owner order itself), and its chunks: edges
    ``chunk_lo[c]:chunk_hi[c]`` of one row go to row ``chunk_dst[c]``
    when that is >= 0, else to partial row ``-1 - chunk_dst[c]``; row
    ``fix_row[r]`` is the sum of partial rows ``fix_ptr[r]:fix_ptr[r+1]``,
    in order."""

    ptr: np.ndarray
    idx: np.ndarray
    pos: np.ndarray | None
    chunk_lo: np.ndarray
    chunk_hi: np.ndarray
    chunk_dst: np.ndarray
    fix_row: np.ndarray
    fix_ptr: np.ndarray

    @property
    def num_partials(self) -> int:
        return int(self.fix_ptr[-1])

    @property
    def longest(self) -> int:
        return int(np.diff(self.ptr).max(initial=0))


@dataclasses.dataclass
class GatLayout:
    """A graph's attention edges (with self-loops) in row-owner order
    (``rows``: ``idx`` is each edge's column d) and transposed order
    (``cols``: ``idx`` is each edge's row s, ``pos`` the permutation)."""

    num_nodes: int
    num_edges: int
    loops_added: int
    rows: EdgeWalk
    cols: EdgeWalk


def chunks(ptr: np.ndarray, chunk: int):
    """``(chunk_lo, chunk_hi, chunk_dst, fix_row, fix_ptr)`` of the rows
    ``ptr[i]:ptr[i+1]``: one chunk a row of at most ``chunk`` edges (an
    empty row too, which sums to 0), consecutive chunks of ``chunk``
    edges a longer row, whose chunks come first and go to partial rows."""
    ptr = np.asarray(ptr, dtype=np.int64)
    deg = np.diff(ptr)
    per_row = np.maximum(-(-deg // chunk), 1)
    total = int(per_row.sum())
    row = np.repeat(np.arange(len(deg), dtype=np.int64), per_row)
    first = np.cumsum(per_row) - per_row
    k = np.arange(total, dtype=np.int64) - np.repeat(first, per_row)
    lo = ptr[row] + k * chunk
    hi = np.minimum(lo + chunk, ptr[row + 1])
    split = per_row > 1
    in_split = split[row]
    slot = np.cumsum(in_split) - 1
    dst = np.where(in_split, -1 - slot, row)
    order = np.concatenate([np.flatnonzero(in_split),
                            np.flatnonzero(~in_split)])
    fix_ptr = np.zeros(int(split.sum()) + 1, dtype=np.int64)
    np.cumsum(per_row[split], out=fix_ptr[1:])
    i32 = np.int32
    return (lo[order].astype(i32), hi[order].astype(i32),
            dst[order].astype(i32), np.flatnonzero(split).astype(i32),
            fix_ptr.astype(i32))


def _walk(ptr, idx, pos, chunk: int) -> EdgeWalk:
    lo, hi, dst, fix_row, fix_ptr = chunks(ptr, chunk)
    return EdgeWalk(np.asarray(ptr, dtype=np.int32),
                    np.asarray(idx, dtype=np.int32),
                    None if pos is None else np.asarray(pos, dtype=np.int32),
                    lo, hi, dst, fix_row, fix_ptr)


def build_gat_layout(graph: GraphCSR,
                     census: AttentionCensus | None = None,
                     chunk: int | None = None) -> GatLayout:
    """The attention layout of ``graph`` over its ``census`` (the
    decider's; built here when None), in chunks of ``chunk`` edges (None:
    ``CHUNK_EDGES``)."""
    n = graph.num_nodes
    chunk = CHUNK_EDGES if chunk is None else chunk
    if census is None:
        census = AttentionCensus(graph)
    if not isinstance(census, AttentionCensus) or census.num_nodes != n:
        raise ValueError("the attention layout needs the graph's own "
                         "AttentionCensus")
    rp = np.asarray(graph.row_pointers, dtype=np.int64)
    ci = np.asarray(graph.column_index, dtype=np.int64)
    nnz = int(rp[-1])
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    if nnz and (np.diff(ci) < 0)[src[1:] == src[:-1]].any():
        raise ValueError("the attention layout needs each CSR row's columns "
                         "in ascending order (graphs/loader.build_csr)")
    has_loop = np.zeros(n, dtype=bool)
    has_loop[src[ci == src]] = True
    added = ~has_loop
    shift = np.zeros(n + 1, dtype=np.int64)  # loops added before each node
    np.cumsum(added, out=shift[1:])
    e = nnz + int(shift[-1])
    nodes = np.flatnonzero(added)

    # row-owner order: row s's edges by ascending d, (s, s) at its place
    below = np.bincount(src[ci < src], minlength=n)  # columns before s
    ptr = rp + shift
    col = np.empty(e, dtype=np.int64)
    new_pos = np.arange(nnz) + shift[src] + (added[src] & (ci > src))
    col[new_pos] = ci
    col[ptr[nodes] + below[nodes]] = nodes

    # transposed order: column d's edges by ascending s (the census), (d,
    # d) at its place; perm = each one's row-owner position
    c_dst = np.asarray(census.dst, dtype=np.int64)
    c_src = np.asarray(census.src, dtype=np.int64)
    cptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(c_dst, minlength=n), out=cptr[1:])
    above = np.bincount(c_dst[c_src < c_dst], minlength=n)  # rows before d
    tptr = cptr + shift
    at = np.arange(nnz) + shift[c_dst] + (added[c_dst] & (c_src > c_dst))
    t_src = np.empty(e, dtype=np.int64)
    perm = np.empty(e, dtype=np.int64)
    t_src[at] = c_src
    perm[at] = new_pos[np.asarray(census.pos, dtype=np.int64)]
    loops = tptr[nodes] + above[nodes]
    t_src[loops] = nodes
    perm[loops] = ptr[nodes] + below[nodes]
    return GatLayout(n, e, len(nodes), _walk(ptr, col, None, chunk),
                     _walk(tptr, t_src, perm, chunk))
