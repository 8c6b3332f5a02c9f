"""Graph loading, CSR construction and synthetic graphs (host-side NumPy).

The torch port's own copy of ``gnnadvisor_osdi21_tpu/graphs/loader.py``:
the port imports nothing of the JAX package, so the host builders it needs
live here.  For the same seed every function returns byte-identical
arrays to its JAX-package counterpart (tests/test_torch_loader.py).

- CSR build with duplicate-edge merging (the reference's
  ``scipy.coo_matrix(...).tocsr()``, dataset.py:110-111);
- ``degrees[i] = sqrt(max(out_deg_i, 1))`` (dataset.py:121-122): the
  reference multiplies ``degrees[src]*degrees[dst]`` in its aggregation,
  so these are sqrt-degrees, not inverse sqrt-degrees;
- synthetic features ``randn(N, dim)``, all-ones labels and the
  100%/30%/10% train/val/test masks (dataset.py:45-53, 124-136);
- ``.npz`` graphs and text edge lists (``load_graph``), and the CSR
  rebuild after a reordering (``GraphCSR.apply_permutation``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from gnnadvisor_osdi21_tpu_torch.native import graphtools
from gnnadvisor_osdi21_tpu_torch.utils import profiling


def _sqrt_degrees(row_pointers: np.ndarray) -> np.ndarray:
    """degrees[i] = sqrt(max(deg_i, 1)), float32 (dataset.py:121-122)."""
    deg = (row_pointers[1:] - row_pointers[:-1]).astype(np.float64)
    return np.sqrt(np.maximum(deg, 1.0)).astype(np.float32)


def build_csr(
    edge_index: np.ndarray, num_nodes: int, dedup: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Build CSR (row_pointers, column_index) from a [2, E] edge index.

    Rows are source nodes, columns are destinations — matching the reference,
    which aggregates ``out[src] += norm * x[dst]`` over CSR-of-src
    (GNNAdvisor_kernel.cu:352-406).  Duplicate (src, dst) pairs are merged,
    as scipy's COO→CSR conversion does in the reference (dataset.py:110-111).
    """
    src = np.asarray(edge_index[0], dtype=np.int64)
    dst = np.asarray(edge_index[1], dtype=np.int64)
    keys = src * np.int64(num_nodes) + dst
    if dedup:
        keys = np.unique(keys)
    else:
        keys = np.sort(keys)
    src_s = (keys // num_nodes).astype(np.int64)
    dst_s = (keys % num_nodes).astype(np.int32)
    row_pointers = np.zeros(num_nodes + 1, dtype=np.int32)
    counts = np.bincount(src_s, minlength=num_nodes)
    np.cumsum(counts, out=row_pointers[1:])
    return row_pointers, dst_s.astype(np.int32)


@dataclasses.dataclass
class GraphCSR:
    """A loaded graph in CSR form plus the stats the decider consumes.

    Mirrors the observable state of the reference's ``custom_dataset``
    (dataset.py:20-136) minus the torch/CUDA residency — arrays are NumPy
    and are placed on device by the caller.
    """

    num_nodes: int
    num_edges: int  # raw edge count before dedup (reference keeps this)
    edge_index: np.ndarray  # [2, E] original (possibly reordered) edges
    row_pointers: np.ndarray  # [N+1] int32
    column_index: np.ndarray  # [nnz] int32
    degrees: np.ndarray  # [N] float32, sqrt(max(deg,1))
    avg_degree: float
    avg_edgeSpan: float
    num_features: int = 16
    num_classes: int = 10
    reordered: bool = False

    @property
    def nnz(self) -> int:
        return int(self.column_index.shape[0])

    def masks(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """train=100% / val=30% / test=10% prefix masks (dataset.py:45-53)."""
        n = self.num_nodes

        def prefix(frac: float) -> np.ndarray:
            m = np.zeros(n, dtype=bool)
            m[: int(n * frac)] = True
            return m

        return prefix(1.0), prefix(0.3), prefix(0.1)

    def init_embedding(self, dim: int, seed: int = 0) -> np.ndarray:
        """Synthetic node features, randn(N, dim) (dataset.py:129)."""
        rng = np.random.default_rng(seed)
        return rng.standard_normal((self.num_nodes, dim), dtype=np.float32)

    def init_labels(self, num_classes: int) -> np.ndarray:
        """All-ones labels (dataset.py:136) — reference never checks accuracy."""
        del num_classes
        return np.ones(self.num_nodes, dtype=np.int32)

    def apply_permutation(self, perm: np.ndarray) -> "GraphCSR":
        """Relabel nodes by ``perm`` (old id -> new id) and rebuild CSR.

        This is the post-reordering CSR rebuild of dataset.py:160-172; the
        permutation itself comes from the rabbit reordering pass.
        """
        new_edges = np.stack(
            [perm[self.edge_index[0]], perm[self.edge_index[1]]]
        ).astype(np.int64)
        row_pointers, column_index = build_csr(new_edges, self.num_nodes)
        span = (
            float(np.mean(np.abs(new_edges[0] - new_edges[1])))
            if new_edges.shape[1]
            else 0.0
        )
        return dataclasses.replace(
            self,
            edge_index=new_edges,
            row_pointers=row_pointers,
            column_index=column_index,
            degrees=_sqrt_degrees(row_pointers),
            avg_edgeSpan=span,
            reordered=True,
        )


def _from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_features: int,
    num_classes: int,
) -> GraphCSR:
    num_edges = int(src.shape[0])
    edge_index = np.stack([src, dst]).astype(np.int64)
    avg_degree = num_edges / max(num_nodes, 1)
    avg_edge_span = (
        float(np.mean(np.abs(src.astype(np.int64) - dst.astype(np.int64))))
        if num_edges
        else 0.0
    )
    row_pointers, column_index = build_csr(edge_index, num_nodes)
    return GraphCSR(
        num_nodes=int(num_nodes),
        num_edges=num_edges,
        edge_index=edge_index,
        row_pointers=row_pointers,
        column_index=column_index,
        degrees=_sqrt_degrees(row_pointers),
        avg_degree=avg_degree,
        avg_edgeSpan=avg_edge_span,
        num_features=num_features,
        num_classes=num_classes,
    )


def load_graph(
    path: str,
    num_features: int = 16,
    num_classes: int = 10,
    load_from_txt: bool = False,
    verbose: bool = False,
    use_native_parser: bool = True,
) -> GraphCSR:
    """Load a graph from a ``.txt`` edge list or a ``.npz`` file.

    API parity with ``custom_dataset(path, dim, num_class, load_from_txt)``
    (dataset.py:24).  ``.npz`` schema: ``src_li``, ``dst_li``, ``num_nodes``
    (dataset.py:87-94).  ``.txt`` (or any name with ``load_from_txt``):
    one "src dst" pair per line, ``#`` comments; the node count is
    ``max(node id) + 1`` (dataset.py:59-74).  The native parser
    (``native/graphtools``) reads it unless ``use_native_parser`` is False
    or no ``g++`` can build it; ``np.loadtxt`` reads it otherwise.

    Spans: ``graph.load``, around ``graph.parse`` (the file) and
    ``graph.csr`` (``_from_edges``).
    """
    with profiling.span("graph.load") as load:
        with profiling.span("graph.parse"):
            src, dst, num_nodes = _read_edges(path, load_from_txt,
                                              use_native_parser)
        with profiling.span("graph.csr"):
            g = _from_edges(src, dst, num_nodes, num_features, num_classes)
    if verbose:
        print(f"# Loading (s): {load.seconds:.3f}")
        print(f"# nodes: {g.num_nodes}")
        print(f"# avg_degree: {g.avg_degree:.2f}")
        print(f"# avg_edgeSpan: {int(g.avg_edgeSpan)}")
    return g


def _read_edges(path: str, load_from_txt: bool, use_native_parser: bool):
    """(src, dst, num_nodes) of the file ``load_graph`` reads."""
    if load_from_txt or path.endswith(".txt"):
        if use_native_parser and graphtools.available():
            src, dst = graphtools.parse_edge_list(path)
        else:
            data = np.loadtxt(path, dtype=np.int64, comments="#", ndmin=2)
            src, dst = data[:, 0], data[:, 1]
        return src, dst, int(max(src.max(), dst.max())) + 1
    if not path.endswith(".npz"):
        raise ValueError("graph file must be a .npz file")
    obj = np.load(path)
    return (np.asarray(obj["src_li"], dtype=np.int64),
            np.asarray(obj["dst_li"], dtype=np.int64),
            int(obj["num_nodes"]))


def synthesize_graph(
    num_nodes: int,
    num_edges: int,
    num_features: int = 16,
    num_classes: int = 10,
    kind: str = "powerlaw",
    seed: int = 0,
    zipf_a: float = 1.5,
) -> GraphCSR:
    """Generate a synthetic graph with realistic degree skew.

    The reference artifact ships external ``.npz`` graphs; for a
    self-contained repo we synthesize topologies with matching scale.
    ``powerlaw`` draws endpoints from a Zipf-like distribution over shuffled
    node ids (heavy-tailed degrees, like the Type I/III graphs in the OSDI
    dataset roster, 0_bench_GNNA_GCN.py:23-41); ``uniform`` is Erdős–Rényi.
    """
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
        dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    elif kind == "powerlaw":
        # Zipf ranks -> shuffled node ids so hubs are scattered (non-trivial
        # edgeSpan, so the reorder heuristic has something to do).
        ranks_s = np.minimum(
            rng.zipf(zipf_a, size=num_edges) - 1, num_nodes - 1
        ).astype(np.int64)
        dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
        shuffle = rng.permutation(num_nodes)
        src = shuffle[ranks_s]
        # Make it symmetric-ish: half the edges flipped, so both in/out
        # degree distributions are skewed.
        flip = rng.random(num_edges) < 0.5
        src2 = np.where(flip, dst, src)
        dst = np.where(flip, src, dst)
        src = src2
    elif kind == "community":
        # Planted partition: mostly intra-community edges; exercises rabbit
        # reordering (communities are detectable and reordering tightens
        # locality after a random relabeling).
        n_comm = max(int(np.sqrt(num_nodes)), 2)
        comm_of = rng.integers(0, n_comm, size=num_nodes)
        order = np.argsort(comm_of, kind="stable")
        # node ids randomly labeled; communities are contiguous in `order`
        comm_start = np.searchsorted(comm_of[order], np.arange(n_comm))
        comm_size = np.bincount(comm_of, minlength=n_comm)
        c = rng.integers(0, n_comm, size=num_edges)
        intra = rng.random(num_edges) < 0.9
        s_off = rng.integers(0, np.maximum(comm_size[c], 1))
        d_off = rng.integers(0, np.maximum(comm_size[c], 1))
        src = order[comm_start[c] + s_off]
        dst = np.where(
            intra,
            order[comm_start[c] + d_off],
            rng.integers(0, num_nodes, size=num_edges),
        )
    elif kind == "compound":
        # Disjoint small molecule-like components — the actual structure of
        # the Type II roster entries (TUDataset chemical-compound
        # collections: OVCAR-8H / Yeast / SW-620H / DD / PROTEINS_full are
        # thousands of ~10-160-atom graphs concatenated with contiguous
        # node ids; avg degree ~2-5).  Each component gets a path backbone
        # (degree ~2, like organic molecules) plus random intra-component
        # ring-closure edges to meet the edge budget.  An earlier
        # "community" stand-in produced ONE giant connected component,
        # which misrepresents both the locality structure (real compound
        # collections are near-block-diagonal) and the reorder economics.
        sizes = []
        total = 0
        while total < num_nodes:
            s = int(rng.normal(47.0, 18.0))
            s = min(max(8, min(s, 160)), num_nodes - total)
            sizes.append(s)
            total += s
        sizes = np.asarray(sizes, dtype=np.int64)
        starts = np.concatenate(([0], np.cumsum(sizes)))[:-1]
        # path backbone, both directions
        inner = np.arange(num_nodes, dtype=np.int64)
        is_last = np.zeros(num_nodes, dtype=bool)
        is_last[starts + sizes - 1] = True
        heads = inner[~is_last]
        src = np.concatenate([heads, heads + 1])
        dst = np.concatenate([heads + 1, heads])
        extra = num_edges - len(src)
        if extra > 0:
            # ring closures: random pairs within a size-weighted component
            c = rng.choice(len(sizes), size=extra, p=sizes / sizes.sum())
            a = starts[c] + rng.integers(0, sizes[c])
            b = starts[c] + rng.integers(0, sizes[c])
            src = np.concatenate([src, a])
            dst = np.concatenate([dst, b])
        else:
            keep = rng.permutation(len(src))[:num_edges]
            src, dst = src[keep], dst[keep]
    elif kind == "web":
        # Realistic web/co-purchase topology: communities with *internal*
        # preferential attachment (local hubs) + a global zipf backbone —
        # the degree-skew-plus-locality structure of SNAP graphs the
        # reference evaluates on (0_bench_GNNA_GCN.py:23-41).
        n_comm = max(int(np.sqrt(num_nodes) / 2), 2)
        comm_of = rng.integers(0, n_comm, size=num_nodes)
        order = np.argsort(comm_of, kind="stable")
        comm_start = np.searchsorted(comm_of[order], np.arange(n_comm))
        comm_size = np.bincount(comm_of, minlength=n_comm).astype(np.int64)
        e_local = int(num_edges * 0.85)
        c = rng.integers(0, n_comm, size=e_local)
        size_c = np.maximum(comm_size[c], 1)
        s_off = rng.integers(0, size_c)
        # local hub: zipf-distributed rank within the community
        d_rank = np.minimum(rng.zipf(1.4, size=e_local) - 1, size_c - 1)
        src_l = order[comm_start[c] + s_off]
        dst_l = order[comm_start[c] + d_rank]
        e_glob = num_edges - e_local
        gsrc = rng.integers(0, num_nodes, size=e_glob, dtype=np.int64)
        grank = np.minimum(rng.zipf(1.5, size=e_glob) - 1, num_nodes - 1)
        shuffle = rng.permutation(num_nodes)
        gdst = shuffle[grank]
        src = np.concatenate([src_l, gsrc])
        dst = np.concatenate([dst_l, gdst])
    else:
        raise ValueError(f"unknown graph kind: {kind}")
    return _from_edges(
        src.astype(np.int64), dst.astype(np.int64), num_nodes, num_features, num_classes
    )
