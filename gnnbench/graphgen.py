"""The traffic generator: a graph synthesized from a traffic file's recipe.

A traffic file (``traffic/<name>.json``) names a recipe and its
parameters: ``recipe``, ``nodes``, ``edges`` (distinct directed edges,
the dataset's published count), ``symmetric`` (every edge in both
directions, as an undirected dataset is stored), ``features``,
``classes``, ``graph_seed``, ``reorder`` and ``stands_for``.  The recipes
are copies of the port's ``graphs/loader.synthesize_graph`` (``web``,
``compound``, ``community``), kept here so that a change to the program
cannot change the benchmark's graphs; for the same seed and size they
draw the same edges, in the same order.  A recipe draws with repeats
(its hubs draw the same pair again), so ``synthesize`` draws it at
growing sizes until it holds enough distinct edges, and keeps the
published number of them.

The edge list is written once per checkout as an ``.npz`` in the schema
of the port's loader (``src_li``, ``dst_li``, ``num_nodes``), under the
harness's cache directory, and read from there by every later run.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

TRAFFIC_KEYS = ("recipe", "nodes", "edges", "symmetric", "features",
                "classes", "graph_seed", "reorder", "stands_for")
MAX_DRAWS = 12  # draws of growing size before synthesis gives up


def _web(rng, num_nodes: int, num_edges: int):
    """Communities with preferential attachment inside (local hubs) and a
    global Zipf backbone: the degree skew plus locality of SNAP graphs."""
    n_comm = max(int(np.sqrt(num_nodes) / 2), 2)
    comm_of = rng.integers(0, n_comm, size=num_nodes)
    order = np.argsort(comm_of, kind="stable")
    comm_start = np.searchsorted(comm_of[order], np.arange(n_comm))
    comm_size = np.bincount(comm_of, minlength=n_comm).astype(np.int64)
    e_local = int(num_edges * 0.85)
    c = rng.integers(0, n_comm, size=e_local)
    size_c = np.maximum(comm_size[c], 1)
    s_off = rng.integers(0, size_c)
    d_rank = np.minimum(rng.zipf(1.4, size=e_local) - 1, size_c - 1)
    src_l = order[comm_start[c] + s_off]
    dst_l = order[comm_start[c] + d_rank]
    e_glob = num_edges - e_local
    gsrc = rng.integers(0, num_nodes, size=e_glob, dtype=np.int64)
    grank = np.minimum(rng.zipf(1.5, size=e_glob) - 1, num_nodes - 1)
    shuffle = rng.permutation(num_nodes)
    gdst = shuffle[grank]
    return np.concatenate([src_l, gsrc]), np.concatenate([dst_l, gdst])


def _compound(rng, num_nodes: int, num_edges: int):
    """Disjoint molecule-like components of 8-160 nodes with contiguous
    ids (a TUDataset collection): a path backbone, both directions, plus
    random ring closures inside a component up to the edge budget."""
    sizes = []
    total = 0
    while total < num_nodes:
        s = int(rng.normal(47.0, 18.0))
        s = min(max(8, min(s, 160)), num_nodes - total)
        sizes.append(s)
        total += s
    sizes = np.asarray(sizes, dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    inner = np.arange(num_nodes, dtype=np.int64)
    is_last = np.zeros(num_nodes, dtype=bool)
    is_last[starts + sizes - 1] = True
    heads = inner[~is_last]
    src = np.concatenate([heads, heads + 1])
    dst = np.concatenate([heads + 1, heads])
    extra = num_edges - len(src)
    if extra > 0:
        c = rng.choice(len(sizes), size=extra, p=sizes / sizes.sum())
        a = starts[c] + rng.integers(0, sizes[c])
        b = starts[c] + rng.integers(0, sizes[c])
        src = np.concatenate([src, a])
        dst = np.concatenate([dst, b])
    else:
        keep = rng.permutation(len(src))[:num_edges]
        src, dst = src[keep], dst[keep]
    return src, dst


def _community(rng, num_nodes: int, num_edges: int):
    """A planted partition over randomly labelled nodes: 90% of the edges
    inside a community (the Type I citation graphs)."""
    n_comm = max(int(np.sqrt(num_nodes)), 2)
    comm_of = rng.integers(0, n_comm, size=num_nodes)
    order = np.argsort(comm_of, kind="stable")
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
    return src, dst


RECIPES = {"web": _web, "compound": _compound, "community": _community}


def load_traffic(path: str) -> dict:
    """A traffic file, checked for its keys and its recipe."""
    with open(path) as fp:
        t = json.load(fp)
    missing = [k for k in TRAFFIC_KEYS if k not in t]
    if missing:
        raise ValueError(f"{path}: missing keys {missing}")
    if t["recipe"] not in RECIPES:
        raise ValueError(f"{path}: unknown recipe {t['recipe']!r}; "
                         f"recipes: {sorted(RECIPES)}")
    return t


def _distinct(src: np.ndarray, dst: np.ndarray, n: int,
              symmetric: bool) -> np.ndarray:
    """The distinct edges as sorted keys ``src * n + dst``; symmetric: the
    distinct unordered pairs ``min * n + max``, self-loops left out."""
    if symmetric:
        keep = src != dst
        src, dst = np.minimum(src[keep], dst[keep]), np.maximum(src[keep],
                                                                  dst[keep])
    return np.unique(src * n + dst)


def synthesize(traffic: dict) -> tuple[np.ndarray, np.ndarray, int]:
    """(src, dst, num_nodes), int64: ``edges`` distinct directed edges.
    The recipe is drawn from the graph seed at growing sizes until it
    holds enough distinct edges (unordered pairs when ``symmetric``, each
    then stored in both directions, so ``edges`` must be even); the
    published number of them is kept, chosen at random by the same
    generator, in ascending order of (src, dst)."""
    n, e = int(traffic["nodes"]), int(traffic["edges"])
    symmetric = bool(traffic["symmetric"])
    if symmetric and e % 2:
        raise ValueError(f"a symmetric graph has an even edge count, not {e}")
    want = e // 2 if symmetric else e
    drawn = e
    for _ in range(MAX_DRAWS):
        rng = np.random.default_rng(int(traffic["graph_seed"]))
        src, dst = RECIPES[traffic["recipe"]](rng, n, drawn)
        keys = _distinct(src.astype(np.int64), dst.astype(np.int64), n,
                         symmetric)
        if len(keys) >= want:
            break
        drawn = int(drawn * want / max(len(keys), 1) * 1.05) + 1
    else:
        raise ValueError(f"{traffic['recipe']} draws under {want} distinct "
                         f"edges on {n} nodes after {MAX_DRAWS} tries")
    keys = keys[np.sort(rng.choice(len(keys), size=want, replace=False))]
    src, dst = keys // n, keys % n
    if symmetric:
        keys = np.sort(np.concatenate([src * n + dst, dst * n + src]))
        src, dst = keys // n, keys % n
    return src, dst, n


def edge_file(traffic: dict, cache_dir: str) -> str:
    """The path of the traffic's edge list; it is synthesized, its count of
    distinct edges checked, and written there on first use.  The name carries a digest of the recipe and its
    sizes, so that a traffic file with other parameters never reads a
    stale graph."""
    recipe = {k: traffic[k] for k in ("recipe", "nodes", "edges",
                                      "symmetric", "graph_seed")}
    digest = hashlib.sha256(
        json.dumps(recipe, sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(cache_dir, "graphs",
                        f"{traffic['recipe']}-{digest}.npz")
    if not os.path.exists(path):
        src, dst, n = synthesize(traffic)
        merged = len(np.unique(src * n + dst))
        if merged != int(traffic["edges"]):
            raise RuntimeError(f"{path}: {merged} distinct edges, the "
                               f"traffic asks for {traffic['edges']}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, src_li=src.astype(np.int32),
                 dst_li=dst.astype(np.int32), num_nodes=np.int64(n))
        os.replace(tmp, path)  # a concurrent reader never sees half a file
    return path


def read_edges(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    """(src, dst, num_nodes) of an edge-list file, int64."""
    with np.load(path) as f:
        return (f["src_li"].astype(np.int64), f["dst_li"].astype(np.int64),
                int(f["num_nodes"]))
