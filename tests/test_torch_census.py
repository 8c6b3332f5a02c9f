"""The tier census's edge census (``graphs/hybrid.EdgeCensus``): the edges
sorted once into destination-major order, every candidate's unique
(out-block, destination) pairs counted in one linear pass over it.  Its
counts against an ``np.unique`` oracle written here, the rankings,
geometries and layouts with and without a census passed in, and its
counters and spans through the decider."""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import types

import numpy as np
import pytest

from gnnadvisor_osdi21_tpu_torch.graphs import hybrid as H
from gnnadvisor_osdi21_tpu_torch.graphs.loader import (
    _from_edges, synthesize_graph,
)
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty
from gnnadvisor_osdi21_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _symmetric():
    g = synthesize_graph(2500, 12000, kind="community", seed=5)
    src, dst = g.edge_index
    return _from_edges(np.concatenate([src, dst]), np.concatenate([dst, src]),
                       g.num_nodes, 8, 3)


GRAPHS = {
    "skewed": lambda: synthesize_graph(3000, 30000, kind="powerlaw", seed=7),
    "directed": lambda: synthesize_graph(5000, 40000, kind="web", seed=2),
    "symmetric": _symmetric,
    "empty": lambda: _from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                 700, 8, 3),
}


@pytest.fixture(params=sorted(GRAPHS))
def graph(request):
    return GRAPHS[request.param]()


@pytest.fixture
def store(monkeypatch):
    """A fresh span and counter store in place of the process's own."""
    s = profiling.Store()
    monkeypatch.setattr(profiling, "STORE", s)
    return s


def _edges(g):
    src = np.repeat(np.arange(g.num_nodes, dtype=np.int64),
                    np.diff(np.asarray(g.row_pointers, dtype=np.int64)))
    return src, np.asarray(g.column_index, dtype=np.int64)


def _oracle_pairs(src, dst, n, diag_b, ob):
    """The census of ``rank_tiers`` as a sort of keys: the off-diagonal
    edges' unique (src // ob, dst) pairs, per destination and in all, over
    the same hash-selected block sample above the edge limit."""
    off = src // diag_b != dst // diag_b if diag_b else np.ones(len(src), bool)
    od, blk = dst[off], src[off] // ob
    stride = 1
    if len(od) > H.CENSUS_EDGE_LIMIT:
        stride = -(-len(od) // H.CENSUS_EDGE_LIMIT)
        h = (blk * np.int64(2654435761)) & np.int64(0xFFFFFFFF)
        sel = (h % stride) == 0
        od, blk = od[sel], blk[sel]
    ukeys = np.unique(blk * np.int64(n + 1) + od)
    return (np.bincount(ukeys % np.int64(n + 1), minlength=n), len(ukeys),
            stride)


@pytest.mark.parametrize("limit", [None, 900], ids=["exact", "sampled"])
def test_pair_counts_equal_a_sort_of_keys(graph, limit, monkeypatch):
    """Every diagonal and every residual-block candidate: pairs per
    destination, unique pairs and the stride of ``pair_census``, and the
    pairs per block of ``block_pairs``, against ``np.unique``."""
    if limit is not None:
        monkeypatch.setattr(H, "CENSUS_EDGE_LIMIT", limit)
    n = graph.num_nodes
    src, dst = _edges(graph)
    census = H.EdgeCensus.of_graph(graph)
    assert len(census) == len(src) and census.src.dtype == np.int32
    for b in H.DIAG_CANDIDATES:
        for ob in H.RES_OB_CANDIDATES + (64, 256):
            off_dst, ppd, pairs, stride = census.pair_census(b, ob)
            want_ppd, want_pairs, want_stride = _oracle_pairs(
                src, dst, n, b, ob)
            assert np.array_equal(ppd, want_ppd), (b, ob)
            assert (pairs, stride) == (want_pairs, want_stride), (b, ob)
            keep = src // b != dst // b if b else np.ones(len(src), bool)
            assert np.array_equal(np.sort(off_dst), np.sort(dst[keep]))
    for ob in H.RES_OB_CANDIDATES + (64,):
        for b, k in ((0, 0), (512, 0), (0, 512), (512, 512)):
            rc = census.residual(b, k)
            keep = src // b != dst // b if b else np.ones(len(src), bool)
            if k:
                counts = np.bincount(dst[keep], minlength=n)
                top = np.argsort(counts)[::-1][:k]
                keep &= ~np.isin(dst, top[counts[top] > 0])
            rs, rd = src[keep], dst[keep]
            want = np.bincount(np.unique((rs // ob) * np.int64(n + 1) + rd)
                               // (n + 1))
            assert np.array_equal(rc.block_pairs(ob), want), (ob, b, k)


@pytest.mark.parametrize("limit", [None, 900], ids=["exact", "sampled"])
def test_rankings_and_geometry_with_and_without_a_census(
        graph, limit, monkeypatch, store):
    if limit is not None:
        monkeypatch.setattr(H, "CENSUS_EDGE_LIMIT", limit)
    n = graph.num_nodes
    src, dst = _edges(graph)
    census = H.EdgeCensus.of_graph(graph)
    for kw in ({}, {"diag_b": 512}, {"hot_k": 1024}, {"res_ob": 512}):
        alone = H.rank_tiers(src, dst, n, **kw)
        assert H.rank_tiers(src, dst, n, census=census, **kw) == alone
        # served again from the census, the same list to the bit
        assert H.rank_tiers(src, dst, n, census=census, **kw) == alone
        assert H.choose_tiers(src, dst, n, census=census, **kw) == (
            alone[0][1], alone[0][2])
    if len(src):
        assert store.counters["census.reused"] == 8
    keep = np.random.default_rng(1).random(len(src)) < 0.6
    rows = dict(row_align=1024, row_cost_ns=2.5)
    alone = H.choose_res_geometry(src[keep], dst[keep], n, **rows)
    rc = H.EdgeCensus(src[keep], dst[keep], n)
    assert H.choose_res_geometry(rc.src, rc.dst, n, census=rc, **rows) == alone


def assert_same_layout(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("kw", [{}, {"diag_b": 512}, {"hot_k": 512},
                                {"res_ob": 512, "res_tile": 128}],
                         ids=["auto", "diag", "hot", "geometry"])
def test_build_hybrid_with_and_without_a_census(graph, kw):
    census = H.EdgeCensus.of_graph(graph)
    H.rank_tiers(census.src, census.dst, graph.num_nodes, census=census,
                 hot_k=kw.get("hot_k"), diag_b=kw.get("diag_b"))
    alone = H.build_hybrid(graph, probe=False, **kw)
    over = H.build_hybrid(graph, probe=False, census=census, **kw)
    assert_same_layout(alone, over)
    assert alone.tier_probe == over.tier_probe == "not run"


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"census_reader_{name}",
        os.path.join(ROOT, "gnnbench", "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_one_sort_a_set_up_and_its_spans_nest_under_the_tier_choice(store):
    g = synthesize_graph(9000, 90000, num_features=8, num_classes=3,
                         kind="web", seed=4)
    prop = InputProperty(g, hidden_dim=8, probe=False).decider()
    prop.build_tensors(device="cpu")
    assert store.counters["census.sorts"] == 1
    assert store.counters["census.reused"] == 1
    # 5 diagonal candidates a ranking, 6 block sizes a geometry choice: the
    # decider's ranking, then one or two passes of the fixed point, whose
    # first ranking is the decider's, served again
    assert store.counters["census.passes"] in (5 + 6, 5 + 6 + 5 + 6)
    by_id = {r.id: r for r in store.records}
    census = [r for r in store.records if r.name.startswith("census.")]
    assert {r.name for r in census} == {"census.sort", "census.rank"}
    tiers = ("decider.choose_tiers", "layout.tiers")
    for rec in census:
        up = by_id[rec.parent]  # a census span outside them raises here
        while up.name not in tiers:
            up = by_id[up.parent]
    read = _reader("tier_choice_s").read(types.SimpleNamespace(on_card=True))
    assert sum(r.seconds for r in census) <= read
    assert read == pytest.approx(store.latest("decider.choose_tiers").seconds
                                 + store.latest("layout.tiers").seconds)
    assert "census.sorts 1" in profiling.format_counters()


def test_a_cached_probe_verdict_replays_over_the_census(
        store, monkeypatch, tmp_path):
    """The probe's key reads the top candidates, which the census leaves
    as they were: a second set-up replays the verdict, runs nothing, and
    builds the candidates' layouts over the decider's census."""
    monkeypatch.setenv(H.CACHE_DIR_ENV, str(tmp_path))
    times = iter([3.0, 1.0, 2.0])
    monkeypatch.setattr(H, "_probe_spmm_time", lambda hg, dev: next(times))
    g = synthesize_graph(10000, 120000, num_features=8, num_classes=3,
                         kind="powerlaw", seed=3)
    first = InputProperty(g, hidden_dim=8, probe=True).decider()
    first.build_tensors(device="cpu")
    assert store.counters["probe.runs"] == 3
    assert store.counters["census.sorts"] == 1
    again = InputProperty(g, hidden_dim=8, probe=True).decider()
    again.build_tensors(device="cpu")
    assert store.counters["probe.cache_hits"] == 1
    assert store.counters["probe.runs"] == 3
    assert store.counters["census.sorts"] == 2
    assert again.hybrid_graph.tier_probe == "cached"
    assert_same_layout(first.hybrid_graph, again.hybrid_graph)
