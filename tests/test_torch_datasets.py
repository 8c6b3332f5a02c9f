"""The port's dataset roster (``bench/datasets.py``) against the JAX
package's: the same roster, the same synthesized graphs, cached under the
port's cache directory and never in the data directory."""

import numpy as np
import pytest

from gnnadvisor_osdi21_tpu.bench import datasets as jax_datasets
from gnnadvisor_osdi21_tpu.graphs.loader import synthesize_graph as jax_graph
from gnnadvisor_osdi21_tpu_torch.bench import datasets
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import CACHE_DIR_ENV
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "port_cache"
    monkeypatch.setenv(CACHE_DIR_ENV, str(path))
    return path


def _same_graph(a, b):
    assert a.num_nodes == b.num_nodes
    for f in ("edge_index", "row_pointers", "column_index"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_roster_matches_jax():
    assert datasets.DATASETS == jax_datasets.DATASETS
    assert datasets.TYPE_III == jax_datasets.TYPE_III
    assert datasets.QUICK == jax_datasets.QUICK


def test_get_dataset_synthesizes_jax_edges_into_the_cache(tmp_path, cache):
    data = tmp_path / "data"
    g = datasets.get_dataset("cora", data_dir=str(data))
    want = jax_datasets.get_dataset("cora", data_dir=str(tmp_path / "jax"))
    _same_graph(g, want)
    assert (g.num_features, g.num_classes) == (1433, 7)
    assert not data.exists()  # nothing lands in the data directory
    assert (cache / "datasets" / "cora.npz").exists()
    again = datasets.get_dataset("cora", data_dir=str(data), dim=16,
                                 classes=3)
    _same_graph(again, g)
    assert (again.num_features, again.num_classes) == (16, 3)


def test_get_dataset_reads_a_real_npz(tmp_path, cache):
    g = synthesize_graph(50, 200, seed=9)
    np.savez(tmp_path / "citeseer.npz", src_li=g.edge_index[0],
             dst_li=g.edge_index[1], num_nodes=g.num_nodes)
    got = datasets.get_dataset("citeseer", data_dir=str(tmp_path))
    _same_graph(got, g)
    assert not cache.exists()
    with pytest.raises(KeyError, match="unknown dataset"):
        datasets.get_dataset("no-such-graph", data_dir=str(tmp_path))


def test_bench_graph_is_cached_in_the_cache(cache, monkeypatch):
    """The headline graph's recipe (web, seed 0), at a reduced size."""
    monkeypatch.setattr(datasets, "BENCH_NODES", 3000)
    monkeypatch.setattr(datasets, "BENCH_EDGES", 36000)
    g = datasets.bench_graph(16)
    _same_graph(g, jax_graph(3000, 36000, num_features=16, kind="web",
                             seed=0))
    assert (cache / "bench_web_410k.npz").exists()
    _same_graph(datasets.bench_graph(16), g)
