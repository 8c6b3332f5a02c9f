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


TEXT = {
    "plain": "0 1\n1 2\n2 0\n10 3\n",
    "comments_and_blank_lines": "# a header\n0 1\n\n1 2\n# mid\n2 0\n\n10 3\n",
    "duplicates_and_self_loops": "# dup\n4 4\n0 1\n0 1\n1 0\n7 2\n",
}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", ["g.txt", "edges.el"])
@pytest.mark.parametrize("text", sorted(TEXT))
def test_load_graph_text_edge_lists(tmp_path, text, name, native):
    """Both parsers on both sides; a name without ``.txt`` loads as text
    with ``load_from_txt``."""
    path = tmp_path / name
    path.write_text(TEXT[text])
    kw = dict(num_features=8, num_classes=3, use_native_parser=native,
              load_from_txt=not name.endswith(".txt"))
    got = tl.load_graph(str(path), **kw)
    _assert_same_graph(jl.load_graph(str(path), **kw), got)
    # every parser reads the same graph
    _assert_same_graph(
        got, tl.load_graph(str(path), **{**kw, "use_native_parser": False}))


def test_text_and_npz_give_the_same_graph(tmp_path):
    g = tl.synthesize_graph(2000, 15000, kind="powerlaw", seed=3)
    txt, npz = str(tmp_path / "g.txt"), str(tmp_path / "g.npz")
    np.savetxt(txt, g.edge_index.T, fmt="%d")
    np.savez(npz, src_li=g.edge_index[0], dst_li=g.edge_index[1],
             num_nodes=int(g.edge_index.max()) + 1)
    want = tl.load_graph(npz)
    for native in (True, False):
        _assert_same_graph(tl.load_graph(txt, use_native_parser=native), want)


def test_text_edge_lists_without_gpp_use_loadtxt(tmp_path, monkeypatch):
    from gnnadvisor_osdi21_tpu_torch.native import graphtools

    path = tmp_path / "g.txt"
    path.write_text(TEXT["comments_and_blank_lines"])
    monkeypatch.setattr(graphtools, "available", lambda: False)
    monkeypatch.setattr(graphtools, "parse_edge_list", None)  # never reached
    _assert_same_graph(jl.load_graph(str(path)), tl.load_graph(str(path)))


def test_load_graph_refuses_other_files(tmp_path):
    with pytest.raises(ValueError, match=".npz"):
        tl.load_graph(str(tmp_path / "g.csv"))


@pytest.mark.parametrize("kind", ["powerlaw", "community"])
def test_apply_permutation_equals_jax(kind):
    a = jl.synthesize_graph(900, 7000, kind=kind, seed=2)
    b = tl.synthesize_graph(900, 7000, kind=kind, seed=2)
    perm = np.random.default_rng(1).permutation(900)
    pa, pb = a.apply_permutation(perm), b.apply_permutation(perm)
    _assert_same_graph(pa, pb)
    assert pa.reordered and pb.reordered
