"""The torch port's hybrid layout builder and decider against the JAX
package's (probe off): bit-identical slabs, masks and streams, and the
same auto choices."""

import dataclasses

import numpy as np
import pytest

from gnnadvisor_osdi21_tpu.graphs import hybrid as jh
from gnnadvisor_osdi21_tpu.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu.ops.spmm_pallas import pack_slab_bits_t
from gnnadvisor_osdi21_tpu.tuner.decider import InputProperty as JaxProperty
from gnnadvisor_osdi21_tpu_torch.graphs import hybrid as th
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty

TIERS = {
    "diag": dict(diag_b=512, hot_k=0),
    "hot": dict(diag_b=0, hot_k=512),
    "both": dict(diag_b=512, hot_k=512),
    "none": dict(diag_b=0, hot_k=0),
}
GEOMETRIES = {"ob512_s256": (512, 256), "ob64_s32": (64, 32)}


def assert_same_layout(a, b):
    assert [f.name for f in dataclasses.fields(a)] == [
        f.name for f in dataclasses.fields(b)
    ]
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("tiers", sorted(TIERS))
@pytest.mark.parametrize("graph", ["small_graph", "skewed_graph"])
def test_build_hybrid_bit_identical(graph, tiers, geometry, request):
    g = request.getfixturevalue(graph)
    res_ob, res_tile = GEOMETRIES[geometry]
    kw = dict(TIERS[tiers], res_ob=res_ob, res_tile=res_tile)
    assert_same_layout(
        jh.build_hybrid(g, probe=False, **kw), th.build_hybrid(g, **kw)
    )


@pytest.mark.parametrize("kind", ["powerlaw", "web", "community"])
def test_auto_layout_and_decider_match_jax(kind):
    """Auto tiers and residual geometry (the model alone: the JAX probe is
    off), through the decider as a user calls it."""
    g = synthesize_graph(6000, 60000, num_features=12, num_classes=5,
                         kind=kind, seed=2)
    jp = JaxProperty(g, hidden_dim=8, probe=False).decider()
    tp = InputProperty(g, hidden_dim=8).decider()
    assert (tp.diag_b, tp.hot_k) == (jp.diag_b, jp.hot_k)
    jp.build_tensors()
    tp.build_tensors(device="cpu")
    assert (tp.diag_b, tp.hot_k) == (jp.diag_b, jp.hot_k)
    assert_same_layout(jp.hybrid_graph, tp.hybrid_graph)
    x = g.init_embedding(12)
    assert np.array_equal(jp.pad_features(x), tp.pad_features(x))


def test_pack_slab_bits_t_matches_jax():
    rng = np.random.default_rng(3)
    rows, cols = rng.integers(0, 700, 5000), rng.integers(0, 1024, 5000)
    a = pack_slab_bits_t(rows, cols, 768, 1024)
    b = th.pack_slab_bits_t(rows, cols, 768, 1024)
    assert a.dtype == b.dtype == np.uint16 and a.tobytes() == b.tobytes()


def test_user_fixed_tiers_pass_through(skewed_graph):
    tp = InputProperty(
        skewed_graph, hidden_dim=8, method="hybrid", diag_b=512, hot_k=512
    ).decider()
    assert (tp.diag_b, tp.hot_k) == (512, 512)


def _graph_with_few_long_edges():
    """Mostly self loops: a mean edge span below the reorder threshold."""
    n = 3000
    src = np.concatenate([np.arange(n), np.arange(50)])
    dst = np.concatenate([np.arange(n), np.arange(50) + 1])
    from gnnadvisor_osdi21_tpu.graphs.loader import _from_edges

    return _from_edges(src, dst, n, 12, 5)


DECIDER_CASES = {
    "auto_dense": (3000, "powerlaw", {}),
    "auto_dense_reorder": (3000, "community", dict(enable_reorder=True)),
    "auto_hybrid": (6000, "web", {}),
    "auto_hybrid_reorder": (6000, "powerlaw", dict(enable_reorder=True)),
    "auto_ell": (3000, "powerlaw", dict(method="ell")),
    "auto_coo_user_part_size": (3000, "web", dict(method="coo", part_size=16)),
    "auto_no_reorder_needed": (None, None, dict(enable_reorder=True)),
    "manual": (3000, "powerlaw", dict(manual_mode=True)),
    "manual_reorder": (3000, "web", dict(manual_mode=True,
                                         enable_reorder=True)),
    "manual_user_values": (6000, "powerlaw", dict(
        manual_mode=True, method="coo", part_size=24, enable_reorder=True)),
    "manual_hybrid": (6000, "web", dict(manual_mode=True, method="hybrid")),
}


@pytest.mark.parametrize("case", sorted(DECIDER_CASES))
def test_decider_choices_equal_jax(case):
    """Method, part size, reordering, tiers and the (reordered) graph, in
    auto and manual mode."""
    n, kind, kw = DECIDER_CASES[case]
    g = (_graph_with_few_long_edges() if n is None else synthesize_graph(
        n, 10 * n, num_features=12, num_classes=5, kind=kind, seed=2))
    jp = JaxProperty(g, hidden_dim=8, probe=False, **kw).decider()
    tp = InputProperty(g, hidden_dim=8, **kw).decider()
    for lj, lt in ((jp.layer_input, tp.layer_input),
                   (jp.layer_hidden, tp.layer_hidden)):
        assert (lt.method, lt.part_size, lt.feature_dim) == (
            lj.method, lj.part_size, lj.feature_dim)
    assert tp.part_size == jp.part_size
    assert tp.reorder_status == jp.reorder_status
    assert tp.reorder_status == (kw.get("enable_reorder", False)
                                 and case != "auto_no_reorder_needed")
    assert (tp.diag_b, tp.hot_k) == (jp.diag_b, jp.hot_k)
    assert tp.graph.reordered == tp.reorder_status
    for name in ("edge_index", "row_pointers", "column_index", "degrees"):
        a, b = getattr(jp.graph, name), getattr(tp.graph, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert tp.graph.avg_edgeSpan == jp.graph.avg_edgeSpan


@pytest.mark.parametrize("method", ["ell", "dense", "coo"])
def test_non_hybrid_tensors_equal_jax(method):
    """One tensor set for both layers, the JAX tensors' arrays, and no
    padded row space."""
    g = synthesize_graph(3000, 30000, num_features=12, num_classes=5,
                         kind="powerlaw", seed=2)
    kw = dict(hidden_dim=8, method=method, enable_reorder=True)
    jin, jhid = JaxProperty(g, **kw).decider().build_tensors()
    tp = InputProperty(g, **kw).decider()
    tin, thid = tp.build_tensors(device="cpu")
    assert tin is thid and jin is jhid
    assert (tin.method, tin.part_size, tin.num_nodes, tin.gemm_dtype) == (
        jin.method, jin.part_size, jin.num_nodes, jin.gemm_dtype)
    for name in ("degrees", "part_cols", "part_lens", "part2node",
                 "coo_src", "coo_dst", "dense_adj"):
        a, b = getattr(jin, name), getattr(tin, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy()), name
    x = g.init_embedding(12)
    assert tp.pad_features(x) is x and tp.unpad_outputs(x) is x
    assert tp.hybrid_graph is None


def test_unknown_method_is_refused(skewed_graph):
    with pytest.raises(ValueError, match="unknown aggregation method"):
        InputProperty(skewed_graph, hidden_dim=8, method="csr").decider()


def test_layers_straddling_the_gather_width_limit(monkeypatch):
    """GCN aggregates at the hidden width, then at the class count; when
    the JAX width limit falls between them, the JAX layers differ in their
    residual gather.  The port's layers share one tensor set, whose
    ``res_src`` is each JAX layer's composed ids: its residual kernel
    gathers by them at any width."""
    from gnnadvisor_osdi21_tpu.graphs import hybrid as jax_hybrid

    g = synthesize_graph(6000, 60000, num_features=12, num_classes=22,
                         kind="web", seed=2)
    tp = InputProperty(g, hidden_dim=8, diag_b=0, hot_k=0).decider()
    hg = th.build_hybrid(g, diag_b=0, hot_k=0)
    assert hg.res_single
    limit = hg.num_res_slots * 10  # between 8 and 22 columns
    monkeypatch.setattr(jax_hybrid, "RES_SINGLE_MAX_CELLS", limit)
    ht_in, ht_hid = tp.build_tensors(device="cpu")
    jin, jhid = JaxProperty(
        g, hidden_dim=8, diag_b=0, hot_k=0, probe=False
    ).decider().build_tensors()
    assert jin.res_gather is None and jhid.res_gather is not None
    assert ht_in is ht_hid
    for j in (jin, jhid):
        dst = np.asarray(j.res_dst)
        rows = dst if j.res_gather is None else np.asarray(j.res_gather)[dst]
        assert np.array_equal(ht_in.res_src.numpy(), rows)
    assert ht_hid.res_mask_s is ht_in.res_mask_s
