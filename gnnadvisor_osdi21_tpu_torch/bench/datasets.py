"""The 15-dataset evaluation roster (reference 0_bench_GNNA_GCN.py:23-41):
the port of ``gnnadvisor_osdi21_tpu/bench/datasets.py``.

Per-dataset input dim / classes match the reference grid exactly; node and
edge counts follow the OSDI'21 paper's dataset table (Type I: small
citation/bio graphs; Type II: chemical-compound collections; Type III:
SNAP social/co-purchase networks).

``get_dataset`` loads a real ``<data_dir>/<name>.npz`` when there is one
(the ``src_li/dst_li/num_nodes`` schema, dataset.py:87-94); otherwise it
synthesizes a topology of the same scale and structural type, from the
same seed as the JAX package (``zlib.crc32(name)``), so both packages
draw the same graph.  Syntheses are cached under the port's git-ignored
cache directory (``graphs/hybrid.cache_dir``), never in ``data/``.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import cache_dir
from gnnadvisor_osdi21_tpu_torch.graphs.loader import (
    GraphCSR, load_graph, synthesize_graph,
)

# name: (num_nodes, num_edges, dim, classes, type, synth_kind)
DATASETS = {
    # Type I — citation / bio graphs
    "citeseer": (3327, 9104, 3703, 6, "I", "community"),
    "cora": (2708, 10556, 1433, 7, "I", "community"),
    "pubmed": (19717, 88648, 500, 3, "I", "community"),
    "ppi": (56944, 818716, 50, 121, "I", "web"),
    # Type II — chemical compound collections: thousands of small disjoint
    # molecule graphs with contiguous node ids (TUDataset concatenation)
    "PROTEINS_full": (43471, 162088, 29, 2, "II", "compound"),
    "OVCAR-8H": (1890931, 3946402, 66, 2, "II", "compound"),
    "Yeast": (1714644, 3636546, 74, 2, "II", "compound"),
    "DD": (334925, 1686092, 89, 2, "II", "compound"),
    "TWITTER-Real-Graph-Partial": (580768, 1435116, 1323, 2, "II", "compound"),
    "SW-620H": (1889971, 3944206, 66, 2, "II", "compound"),
    # Type III — SNAP social / co-purchase networks
    "amazon0505": (410236, 4878874, 96, 22, "III", "web"),
    "artist": (50515, 1638396, 100, 12, "III", "web"),
    "com-amazon": (334863, 1851744, 96, 22, "III", "web"),
    "soc-BlogCatalog": (88784, 2093195, 128, 39, "III", "web"),
    "amazon0601": (403394, 3387388, 96, 22, "III", "web"),
}

TYPE_III = [k for k, v in DATASETS.items() if v[4] == "III"]

# Small roster for smoke runs / CI.
QUICK = ["citeseer", "cora", "pubmed"]

# the headline graph: synthetic web topology at amazon0505's scale
BENCH_NODES, BENCH_EDGES = 410_236, 4_878_874


def _save_edges(path: str, g: GraphCSR) -> None:
    """Write the graph's edge list as ``.npz``, atomically."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as fp:
            np.savez(fp, src_li=g.edge_index[0], dst_li=g.edge_index[1],
                     num_nodes=g.num_nodes)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def bench_graph(dim: int = 16, data_dir: str | None = None) -> GraphCSR:
    """The headline-bench graph: synthetic web topology at amazon0505 scale
    (410,236 n / 4,878,874 e, seed 0), cached as ``bench_web_410k.npz`` in
    ``data_dir`` (None: the port's cache directory)."""
    path = os.path.join(data_dir or cache_dir(), "bench_web_410k.npz")
    if os.path.exists(path):
        return load_graph(path, num_features=dim)
    g = synthesize_graph(BENCH_NODES, BENCH_EDGES, num_features=dim,
                         kind="web", seed=0)
    _save_edges(path, g)
    return g


def get_dataset(name: str, data_dir: str = "data", dim=None,
                classes=None) -> GraphCSR:
    """The roster graph ``name``: ``<data_dir>/<name>.npz`` when present,
    else its synthesis (cached under ``cache_dir()/datasets``)."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name}; roster: {list(DATASETS)}")
    n, e, d, c, _type, kind = DATASETS[name]
    d = dim if dim is not None else d
    c = classes if classes is not None else c
    real = os.path.join(data_dir, f"{name}.npz")
    if os.path.exists(real):
        return load_graph(real, num_features=d, num_classes=c)
    cached = os.path.join(cache_dir(), "datasets", f"{name}.npz")
    if os.path.exists(cached):
        return load_graph(cached, num_features=d, num_classes=c)
    # crc32, not hash(): Python string hashing is salted per process
    g = synthesize_graph(n, e, num_features=d, num_classes=c, kind=kind,
                         seed=zlib.crc32(name.encode()) % 2**31)
    _save_edges(cached, g)
    return g
