"""The torch port's graph loader against the JAX package's: same seed,
byte-identical CSR, features, labels and masks."""

import numpy as np
import pytest

from gnnadvisor_osdi21_tpu.graphs import loader as jl
from gnnadvisor_osdi21_tpu_torch.graphs import loader as tl


def _assert_same_graph(a, b):
    for name in ("edge_index", "row_pointers", "column_index", "degrees"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name
    for name in ("num_nodes", "num_edges", "avg_degree", "avg_edgeSpan",
                 "num_features", "num_classes", "nnz"):
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize(
    "kind", ["powerlaw", "uniform", "community", "compound", "web"]
)
def test_synthesize_graph_is_byte_identical(kind):
    kw = dict(num_features=12, num_classes=5, kind=kind, seed=11)
    a = jl.synthesize_graph(900, 7000, **kw)
    b = tl.synthesize_graph(900, 7000, **kw)
    _assert_same_graph(a, b)
    assert a.init_embedding(12, seed=3).tobytes() == b.init_embedding(
        12, seed=3
    ).tobytes()
    assert a.init_labels(5).tobytes() == b.init_labels(5).tobytes()
    for ma, mb in zip(a.masks(), b.masks()):
        assert np.array_equal(ma, mb)


def test_build_csr_merges_duplicates_like_jax():
    rng = np.random.default_rng(4)
    ei = rng.integers(0, 50, size=(2, 400))
    for dedup in (True, False):
        ra, ca = jl.build_csr(ei, 50, dedup=dedup)
        rb, cb = tl.build_csr(ei, 50, dedup=dedup)
        assert ra.tobytes() == rb.tobytes() and ca.tobytes() == cb.tobytes()


def test_load_graph_npz(tmp_path):
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 300, 2000), rng.integers(0, 300, 2000)
    path = str(tmp_path / "g.npz")
    np.savez(path, src_li=src, dst_li=dst, num_nodes=300)
    _assert_same_graph(
        jl.load_graph(path, num_features=8, num_classes=3),
        tl.load_graph(path, num_features=8, num_classes=3),
    )


def test_load_graph_refuses_text_edge_lists(tmp_path):
    path = tmp_path / "g.txt"
    path.write_text("0 1\n1 2\n")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.load_graph(str(path))
