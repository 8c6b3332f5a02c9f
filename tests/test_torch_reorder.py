"""The port's rabbit reordering and its native graph tools against the JAX
package's: the NumPy permutation equal on every graph, the native one
equal below 200,000 nodes (where graphtools.cpp merges sequentially), the
reordered graphs equal field by field, and the native library built only
under the port's ``_build/``."""

import filecmp
import os
import subprocess

import numpy as np
import pytest

from gnnadvisor_osdi21_tpu.graphs import reorder as jr
from gnnadvisor_osdi21_tpu.graphs.loader import _from_edges as jax_from_edges
from gnnadvisor_osdi21_tpu.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu.native import graphtools as jgt
from gnnadvisor_osdi21_tpu_torch.graphs import reorder as tr
from gnnadvisor_osdi21_tpu_torch.native import graphtools as tgt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _edges(case: str):
    """(edge_index [2, E] int64, num_nodes) of one test graph."""
    rng = np.random.default_rng(17)
    if case in ("powerlaw", "community", "web", "uniform"):
        g = synthesize_graph(1500, 12000, kind=case, seed=5)
        return g.edge_index, g.num_nodes
    if case == "self_loops_and_duplicates":
        src = rng.integers(0, 300, 2500)
        dst = np.where(rng.random(2500) < 0.2, src, rng.integers(0, 300, 2500))
        ei = np.stack([src, dst])
        return np.concatenate([ei, ei[:, :400]], axis=1), 300
    if case == "isolated_nodes":  # ids 400.. have no edge
        return rng.integers(0, 400, (2, 3000)), 700
    if case == "edgeless":
        return np.zeros((2, 0), np.int64), 50
    raise ValueError(case)


CASES = ["powerlaw", "community", "web", "uniform",
         "self_loops_and_duplicates", "isolated_nodes", "edgeless"]


@pytest.mark.parametrize("case", CASES)
def test_numpy_permutation_equals_jax(case):
    ei, n = _edges(case)
    want = jr.rabbit_permutation(ei, n)
    got = tr.rabbit_permutation(ei, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("case", CASES)
def test_native_permutation_equals_jax_native(case):
    """Below 200,000 nodes graphtools.cpp merges sequentially: the same
    source gives the same permutation."""
    ei, n = _edges(case)
    want = jgt.rabbit_permutation(ei, n)
    got = tgt.rabbit_permutation(ei, n)
    assert np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("case", CASES)
def test_rabbit_reorder_graph_equals_jax(case):
    ei, n = _edges(case)
    from gnnadvisor_osdi21_tpu_torch.graphs.loader import _from_edges

    a = jr.rabbit_reorder_graph(jax_from_edges(ei[0], ei[1], n, 8, 3))
    b = tr.rabbit_reorder_graph(_from_edges(ei[0], ei[1], n, 8, 3))
    for name in ("edge_index", "row_pointers", "column_index", "degrees"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert a.avg_edgeSpan == b.avg_edgeSpan
    assert a.reordered and b.reordered


@pytest.mark.parametrize("case", ["powerlaw", "isolated_nodes"])
def test_reorder_api_equals_jax(case):
    ei, n = _edges(case)
    assert np.array_equal(tr.reorder(ei, n), jr.reorder(ei, n))
    assert np.array_equal(tr.reorder(ei), jr.reorder(ei))


def test_reorder_shrinks_community_span():
    g = synthesize_graph(800, 12000, kind="community", seed=9)
    from gnnadvisor_osdi21_tpu_torch.graphs.loader import _from_edges

    tg = _from_edges(g.edge_index[0], g.edge_index[1], g.num_nodes, 8, 3)
    assert tr.rabbit_reorder_graph(tg).avg_edgeSpan < 0.7 * tg.avg_edgeSpan


def test_falls_back_to_numpy_only_without_gpp(monkeypatch):
    ei, n = _edges("powerlaw")
    monkeypatch.setattr(tgt, "available", lambda: False)
    with pytest.warns(RuntimeWarning, match="no g\\+\\+"):
        got = tr.reorder(ei, n)
    perm = jr.rabbit_permutation(ei, n)
    assert np.array_equal(got, np.stack([perm[ei[0]], perm[ei[1]]]))


def test_bad_edge_ids_raise():
    ei = np.array([[0, 1, 5], [1, 2, 0]])
    with pytest.raises(ValueError, match="outside"):
        tr.reorder(ei, 3)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "graphtools.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tgt, "SRC", str(bad))
    monkeypatch.setattr(tgt, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tgt.build()
    assert not os.listdir(tmp_path / "_build")


def test_source_is_the_jax_copy():
    assert filecmp.cmp(
        tgt.SRC,
        os.path.join(ROOT, "gnnadvisor_osdi21_tpu", "native", "graphtools.cpp"),
        shallow=False,
    )


def test_build_writes_only_under_the_ports_build_dir(monkeypatch):
    """Every path the build writes is under the port's ``_build/``; no
    library of the port lands in either package's ``native/``."""
    native_dirs = [os.path.dirname(tgt.SRC),
                   os.path.dirname(jgt.__file__)]
    port_native = sorted(os.listdir(native_dirs[0]))
    outputs = []
    run = subprocess.run

    def recording(cmd, *args, **kwargs):
        outputs.append(cmd[cmd.index("-o") + 1])
        return run(cmd, *args, **kwargs)

    monkeypatch.setattr(tgt.subprocess, "run", recording)
    so = tgt.library_path()
    if os.path.exists(so):  # built by an earlier test: build once more
        monkeypatch.setattr(tgt, "library_path", lambda: so + ".again.so")
    path = tgt.build()
    build_dir = os.path.join(ROOT, "gnnadvisor_osdi21_tpu_torch", "_build")
    assert os.path.dirname(path) == build_dir and os.path.exists(path)
    assert outputs and all(os.path.dirname(o) == build_dir for o in outputs)
    if path != so:
        os.remove(path)
    assert sorted(os.listdir(native_dirs[0])) == port_native
    for d in native_dirs:
        assert not [f for f in os.listdir(d) if f.startswith("libgraphtools_")]
