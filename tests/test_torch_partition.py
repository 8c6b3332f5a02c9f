"""The port's neighbor groups (``graphs/partition.py``) and native
``build_parts`` against the JAX package's: equal arrays for every part
size, zero-degree nodes included."""

import numpy as np
import pytest

from gnnadvisor_osdi21_tpu.graphs import partition as jp
from gnnadvisor_osdi21_tpu.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu.native import graphtools as jgt
from gnnadvisor_osdi21_tpu_torch.graphs import partition as tp
from gnnadvisor_osdi21_tpu_torch.native import graphtools as tgt


@pytest.fixture(scope="module")
def graph():
    """A skewed graph whose nodes 600.. have no out-edge."""
    g = synthesize_graph(800, 7000, kind="powerlaw", seed=7)
    keep = g.edge_index[0] < 600
    from gnnadvisor_osdi21_tpu.graphs.loader import _from_edges

    return _from_edges(g.edge_index[0][keep], g.edge_index[1][keep], 800, 8, 3)


def _sizes(g):
    return [1, 2, 4, 8, 32, int(np.diff(g.row_pointers).max()) + 5]


@pytest.mark.parametrize("which", range(6))
@pytest.mark.parametrize("pad", [8, 1])
def test_neighbor_groups_equal_jax(graph, which, pad):
    ps = _sizes(graph)[which]
    a = jp.build_neighbor_groups(graph.row_pointers, graph.column_index, ps,
                                 pad_parts_to=pad)
    b = tp.build_neighbor_groups(graph.row_pointers, graph.column_index, ps,
                                 pad_parts_to=pad)
    for name in ("part_cols", "part_lens", "part2node"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert (a.part_size, a.num_nodes, a.num_real_parts, a.num_parts) == (
        b.part_size, b.num_nodes, b.num_real_parts, b.num_parts)
    assert a.padding_waste == b.padding_waste
    assert b.num_parts % pad == 0
    # padding rows repeat the last owner with length 0
    assert np.all(np.diff(b.part2node) >= 0)
    assert not b.part_lens[b.num_real_parts:].any()
    for x, y in zip(jp.groups_to_ragged(a), tp.groups_to_ragged(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("which", range(6))
def test_build_parts_equals_jax_and_the_groups(graph, which):
    ps = _sizes(graph)[which]
    pp, p2n = tgt.build_parts(graph.row_pointers, ps)
    jpp, jp2n = jgt.build_parts(graph.row_pointers, ps)
    assert np.array_equal(pp, jpp) and np.array_equal(p2n, jp2n)
    groups = tp.build_neighbor_groups(graph.row_pointers, graph.column_index,
                                      ps)
    rpp, rp2n = tp.groups_to_ragged(groups)
    assert np.array_equal(np.diff(pp), np.diff(rpp))
    assert np.array_equal(p2n, rp2n)


def test_edgeless_graph_has_only_padding_parts():
    rp = np.zeros(11, np.int32)
    ci = np.zeros(0, np.int32)
    a = jp.build_neighbor_groups(rp, ci, 4)
    b = tp.build_neighbor_groups(rp, ci, 4)
    assert b.num_real_parts == 0 and b.num_parts == 8
    assert a.part_cols.tobytes() == b.part_cols.tobytes()
    assert a.part2node.tobytes() == b.part2node.tobytes()
    assert not b.part_lens.any()


def test_part_size_below_one_is_refused(graph):
    with pytest.raises(ValueError, match="part_size"):
        tp.build_neighbor_groups(graph.row_pointers, graph.column_index, 0)
    with pytest.raises(ValueError, match="part_size"):
        tgt.build_parts(graph.row_pointers, 0)
