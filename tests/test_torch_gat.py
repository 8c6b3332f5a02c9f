"""GAT in the port (``models/gat.py``, ``ops/gat.py``, ``ops/gat_cuda.py``,
``graphs/gat.py``), on the host: the attention layout over the decider's
one census sort, the op's backward against float64 finite differences on
a directed graph, and the whole model on its normal path (decider,
layout, ``train``'s step and Adam) against the benchmark's plain
reference (``gnnbench/models/gat.py``).  The kernels themselves run on
the card only: ``chip_smoke.py`` phase 18 holds each against its plain
version there."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu_torch import train
from gnnadvisor_osdi21_tpu_torch.graphs import gat as gat_layout
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import EdgeCensus
from gnnadvisor_osdi21_tpu_torch.graphs.loader import (
    _from_edges, synthesize_graph,
)
from gnnadvisor_osdi21_tpu_torch.ops import gat as gat_op
from gnnadvisor_osdi21_tpu_torch.ops import gat_cuda
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty
from gnnadvisor_osdi21_tpu_torch.utils import profiling
from gnnbench import data, reference, spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN, HIDDEN, CLASSES = 12, 8, 5
HUB, LOOPED = 7, (3, 7)


def directed_graph(n: int = 300, seed: int = 0):
    """A directed graph with every case the layout must keep apart: a hub
    column (every node with out-edges points at ``HUB``), nodes with no
    out-edge (their rows hold their self-loop alone), duplicate edges
    (merged) and self-loops already in the list (kept once)."""
    rng = np.random.default_rng(seed)
    active = n * 5 // 6
    src = rng.integers(0, active, 6 * n)
    dst = rng.integers(0, n, 6 * n)
    src = np.concatenate([src, np.arange(active), src[:50], list(LOOPED)])
    dst = np.concatenate([dst, np.full(active, HUB), dst[:50], list(LOOPED)])
    return _from_edges(src, dst, n, IN, CLASSES)


GRAPHS = {
    "directed": directed_graph,
    "web": lambda: synthesize_graph(2000, 16000, num_features=IN,
                                    num_classes=CLASSES, kind="web", seed=3),
}


def _edge_set(ptr, idx, transposed: bool) -> set:
    rows = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    pairs = zip(idx, rows) if transposed else zip(rows, idx)
    return {(int(s), int(d)) for s, d in pairs}


# --- the layout ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_census_of_a_graph_keeps_the_order_and_the_csr_positions(name):
    """``AttentionCensus`` sorts (column, CSR position) keys: the same
    (dst, src) arrays as the hybrid layouts' census of the same graph
    (``EdgeCensus.of_graph``), and ``pos`` names each edge's CSR
    position."""
    g = GRAPHS[name]()
    rp = np.asarray(g.row_pointers, np.int64)
    src = np.repeat(np.arange(g.num_nodes), np.diff(rp))
    census = gat_layout.AttentionCensus(g)
    plain = EdgeCensus.of_graph(g)
    assert census.src.dtype == plain.src.dtype
    assert np.array_equal(census.src, plain.src)
    assert np.array_equal(census.dst, plain.dst)
    assert np.array_equal(src[census.pos], census.src)
    assert np.array_equal(g.column_index[census.pos], census.dst)


@pytest.mark.parametrize("chunk", [1, 4, 256])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_the_layout_holds_each_edge_and_one_self_loop_in_both_orders(
        name, chunk):
    g = GRAPHS[name]()
    lay = gat_layout.build_gat_layout(g, chunk=chunk)
    n = g.num_nodes
    want = _edge_set(g.row_pointers, g.column_index, False)
    loops = {(v, v) for v in range(n)}
    assert lay.loops_added == len(loops - want)
    want |= loops
    rows, cols = lay.rows, lay.cols
    assert lay.num_edges == len(want) == len(rows.idx) == len(cols.idx)
    assert _edge_set(rows.ptr, rows.idx, False) == want
    assert _edge_set(cols.ptr, cols.idx, True) == want
    # the permutation: each transposed edge's row-owner position
    r_rows = np.repeat(np.arange(n), np.diff(rows.ptr))
    t_rows = np.repeat(np.arange(n), np.diff(cols.ptr))
    assert sorted(cols.pos) == list(range(lay.num_edges))
    assert np.array_equal(r_rows[cols.pos], cols.idx)
    assert np.array_equal(rows.idx[cols.pos], t_rows)
    # both orders' rows ascend, the loops at their places
    for w in (rows, cols):
        within = np.repeat(np.arange(n), np.diff(w.ptr))
        assert (np.diff(w.idx)[within[1:] == within[:-1]] > 0).all()
    for w in (rows, cols):
        assert w.idx.dtype == w.ptr.dtype == np.int32
        assert w.longest == int(np.diff(w.ptr).max())


@pytest.mark.parametrize("chunk", [1, 3, 16, 256])
def test_chunks_cover_every_row_in_pieces_of_at_most_a_chunk(chunk):
    ptr = np.array([0, 0, 5, 6, 40, 40, 41, 300])
    lo, hi, dst, fix_row, fix_ptr = gat_layout.chunks(ptr, chunk)
    assert all(h - lo_ <= chunk for lo_, h in zip(lo, hi))
    covered = np.zeros(ptr[-1], int)
    for a, b in zip(lo, hi):
        covered[a:b] += 1
    assert (covered == 1).all()
    deg = np.diff(ptr)
    split = np.flatnonzero(deg > chunk)
    assert list(fix_row) == list(split)
    assert fix_ptr[-1] == (dst < 0).sum()
    # a split row's chunks come first, and fill its partial rows in order
    assert all(dst[: fix_ptr[-1]] < 0) and all(dst[fix_ptr[-1]:] >= 0)
    for r, p0, p1 in zip(fix_row, fix_ptr[:-1], fix_ptr[1:]):
        at = {-1 - int(d): (int(a), int(b))
              for a, b, d in zip(lo, hi, dst) if d < 0}
        spans = [at[p] for p in range(p0, p1)]
        assert spans[0][0] == ptr[r] and spans[-1][1] == ptr[r + 1]
        assert all(spans[i][1] == spans[i + 1][0]
                   for i in range(len(spans) - 1))
    whole = {int(d) for d in dst if d >= 0}
    assert whole == set(range(len(deg))) - set(split.tolist())


# --- the op's backward --------------------------------------------------------

@pytest.mark.parametrize("chunk", [2, 256])
def test_the_plain_op_backward_is_the_adjoint_on_a_directed_graph(chunk):
    """``torch.autograd.gradcheck`` in float64 over the op's inputs (v and
    both node scores) on the plain versions: the backward is the adjoint
    of the forward, not the forward again (the graph is directed)."""
    g = directed_graph(40, seed=1)
    lay = gat_layout.build_gat_layout(g, chunk=chunk)
    gt = gat_op.GatTensors(lay.num_nodes, lay.num_edges,
                           gat_cuda.Walk.of(lay.rows, "cpu"),
                           gat_cuda.Walk.of(lay.cols, "cpu"), torch.float64)
    k, f = 2, 3
    gen = torch.Generator().manual_seed(5)
    args = [torch.randn(s, generator=gen, dtype=torch.float64,
                        requires_grad=True)
            for s in ((g.num_nodes, k * f), (g.num_nodes, k),
                      (g.num_nodes, k))]
    assert torch.autograd.gradcheck(
        lambda v, a, b: gat_op.attention(v, a, b, gt, k, 0.2), args,
        eps=1e-6, atol=1e-7, rtol=1e-6)


# --- the model on its normal path against the reference -----------------------

def _config() -> dict:
    with open(os.path.join(ROOT, "gnnbench", "configs", "gat.json")) as fp:
        cfg = json.load(fp)
    cfg["hidden"] = HIDDEN
    return cfg


# The port against the reference, from the same weights and inputs:
# float32 operands: the two sum in other orders (the chunks, the online
# softmax, the adjoint's transposed rows), so values agree to float32
# rounding, amplified a little where a softmax backward subtracts near
# values: 1e-5 of the largest log-probability or gradient entry, and the
# weights after 3 Adam steps, whose first steps turn a rounding-level
# gradient entry into a whole step of lr, within 1e-4 by norm;
# bfloat16 operands: both round the same float32 values, so a value at a
# rounding boundary may land a bf16 step (2^-8) apart: 2^-8 relative.
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -8, 2.0 ** -8)}


def _port_and_reference(name: str, agg: str, monkeypatch, chunk=None):
    g = GRAPHS[name]()
    if chunk is not None:
        monkeypatch.setattr(gat_layout, "CHUNK_EDGES", chunk)
    cfg = _config()
    model = spec.Model(cfg)
    traffic = {"nodes": g.num_nodes, "features": IN, "classes": CLASSES}
    prop = InputProperty(g, HIDDEN, model="gat", agg_dtype=agg).decider()
    hts = prop.build_tensors(device="cpu")
    x, labels, params0 = data.make_inputs(11, model, traffic, "cpu")
    net = train.build_model("gat", torch.Generator().manual_seed(0), IN,
                            HIDDEN, CLASSES, device="cpu",
                            model_kwargs=model.arch.port_kwargs(cfg))
    names = [k for k, _ in net.named_parameters()]
    net.params_from_jax({k: p.numpy() for k, p in zip(names, params0)})
    rp = np.asarray(g.row_pointers, np.int64)
    graph = reference.Graph(np.repeat(np.arange(g.num_nodes), np.diff(rp)),
                            g.column_index, g.num_nodes, "cpu")
    return g, cfg, model, prop, hts, x, labels, params0, net, graph


@pytest.mark.parametrize("chunk", [None, 4], ids=["chunk256", "chunk4"])
@pytest.mark.parametrize("agg", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_the_port_matches_the_reference(name, agg, chunk, monkeypatch):
    """Log-probabilities, every weight's first gradient (the attention
    vectors too) and the weights after 3 Adam steps, the port on the
    decider's layout and ``train``'s step against the reference."""
    (g, cfg, model, prop, hts, x, labels, params0, net,
     graph) = _port_and_reference(name, agg, monkeypatch, chunk)
    assert prop.layer_input.method == "gat" and prop.hybrid_graph is None
    tol, step_tol = TOL[agg]
    logp = net(x, hts)
    ps = [p.clone().requires_grad_(True) for p in params0]
    ref_logp = reference.forward(model, ps, x, graph, operand=agg)
    assert float((logp - ref_logp).abs().max()) <= tol * float(
        ref_logp.abs().max())
    ref = reference.follow(model, graph, x, labels, params0, 3, operand=agg)
    opt = train.make_optimizer(net, cfg["optimizer"]["lr"])
    step = train.make_train_step(net, hts, opt)
    losses = []
    for i in range(3):
        losses.append(float(step(x, labels)))
        if i == 0:
            for (k, p), r in zip(net.named_parameters(), ref["grad1"]):
                err = float((p.grad - r).abs().max())
                assert err <= tol * float(r.abs().max()), (k, err)
    assert np.allclose(losses, ref["losses"], rtol=tol, atol=0)
    for (k, p), p0, d in zip(net.named_parameters(), params0, ref["delta"]):
        gap = float(((p.detach() - p0) - d).norm() / d.norm())
        assert gap <= step_tol, (k, gap)


@pytest.mark.parametrize("agg", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_the_forward_is_the_references_bit_for_bit(name, agg, monkeypatch):
    """Where no row-owner row is longer than a chunk, the port's forward
    sums as the reference's plain float32 forward does (the scores as one
    product, the softmax and the aggregation in edge order, each product
    rounded): the same log-probabilities, bit for bit, at either operand
    precision."""
    (g, cfg, model, prop, hts, x, labels, params0, net,
     graph) = _port_and_reference(name, agg, monkeypatch)
    assert prop.gat_layout.rows.longest <= gat_layout.CHUNK_EDGES
    with torch.no_grad():
        assert torch.equal(net(x, hts),
                           reference.forward(model, params0, x, graph,
                                             operand=agg))


def test_the_decider_gives_gat_its_layout_at_every_size_and_mode(monkeypatch):
    store = profiling.Store()
    monkeypatch.setattr(profiling, "STORE", store)
    small = directed_graph(120)
    large = synthesize_graph(5000, 30000, num_features=IN, num_classes=CLASSES,
                             kind="web", seed=1)
    edges = 0
    for g in (small, large):  # below and above DENSE_MAX_NODES
        for manual in (False, True):
            prop = InputProperty(g, HIDDEN, model="gat",
                                 manual_mode=manual).decider()
            assert prop.layer_input.method == "gat"
            hts = prop.build_tensors(device="cpu")
            assert hts[0] is hts[1] and isinstance(hts[0], gat_op.GatTensors)
            assert prop.hybrid_graph is None
            x = g.init_embedding(IN)
            assert prop.pad_features(x) is x
            edges += hts[0].num_edges
            # one sort a set-up, under decider.census; the build under
            # layout
            decider = store.latest("decider")
            assert [c.name for c in store.children(decider)] == [
                "decider.census"]
            assert [c.name for c in store.children(
                store.children(decider)[0])] == ["census.sort"]
            assert [c.name for c in store.children(store.latest(
                "layout"))] == ["layout.edges", "layout.to_device"]
    assert store.counters["census.sorts"] == 4
    assert store.counters["attn.edges"] == edges
    for method in ("hybrid", "ell", "dense"):
        with pytest.raises(ValueError, match="method gat"):
            InputProperty(small, HIDDEN, model="gat", method=method).decider()
    with pytest.raises(ValueError, match="method gat"):
        InputProperty(small, HIDDEN, model="gcn", method="gat").decider()


def test_train_and_time_and_the_counters(monkeypatch):
    store = profiling.Store()
    monkeypatch.setattr(profiling, "STORE", store)
    g = directed_graph(150)
    prop = InputProperty(g, HIDDEN, model="gat").decider()
    hts = prop.build_tensors(device="cpu")
    res = train.train_and_time(
        "gat", hts, g.init_embedding(IN), g.init_labels(CLASSES), HIDDEN,
        CLASSES, num_epochs=2, dry_run=1, device="cpu",
        model_kwargs={"heads": 4, "out_heads": 2})
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    net = res["model"]
    assert tuple(net.conv1.shape) == (IN, 4 * HIDDEN)
    assert tuple(net.att_src2.shape) == (2, CLASSES)
    assert store.counters["attn.heads"] == 6
    assert store.counters["attn.edges"] == hts[0].num_edges
    names = {r.name for r in store.records}
    for span in ("forward.layer0.gemm", "forward.layer0.attention",
                 "forward.layer1.attention", "forward.layer0.elu",
                 "forward.layer1.mean", "forward.log_softmax",
                 "attention.backward", "aggregate.passes",
                 "aggregate.tiers"):
        assert span in names, span
    # the aggregation's spans: inside each layer's attention and under the
    # backward, forward and adjoint
    tiers = [r for r in store.records if r.name == "aggregate.tiers"]
    parents = {store_parent(store, r) for r in tiers}
    assert {"forward.layer0.attention", "forward.layer1.attention",
            "backward"} <= parents


def store_parent(store, rec) -> str | None:
    by_id = {r.id: r for r in store.records}
    p = by_id.get(rec.parent)
    while p is not None and p.name not in ("forward.layer0.attention",
                                           "forward.layer1.attention",
                                           "backward"):
        p = by_id.get(p.parent)
    return None if p is None else p.name


@pytest.mark.parametrize("heads,features", [(3, 8), (8, 40), (64, 1)])
def test_the_kernels_refuse_what_they_cannot_take(heads, features):
    """K must divide 32 and K * pieces(F) be at most 32, on the CPU too, so
    that a configuration the card refuses fails here first."""
    n = 10
    with pytest.raises(ValueError):
        gat_cuda.aggregate(
            torch.zeros((n, heads * gat_cuda.pieces(features) * 8)), heads,
            features, gat_cuda.Walk.of(
                gat_layout.build_gat_layout(directed_graph(n)).rows, "cpu"),
            torch.zeros((0, heads)))
