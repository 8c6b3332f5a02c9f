"""The plain reference by hand on a 4-node graph, and the traffic
generator: its recipes against the port's, and the published count of
distinct edges."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from gnnbench import graphgen, reference, spec

# (0,1) twice: merged; node 3 reads node 0; node 0 has out-degree 2
SRC = np.array([0, 0, 1, 2, 0, 3])
DST = np.array([1, 2, 2, 0, 1, 0])


def graph():
    return reference.Graph(SRC, DST, 4, "cpu")


def test_csr_merges_duplicates():
    indptr, cols = reference.build_csr(SRC, DST, 4)
    assert indptr.tolist() == [0, 2, 3, 4, 5]
    assert cols.tolist() == [1, 2, 2, 0, 0]


def test_aggregate_by_hand():
    g = graph()
    x = torch.tensor([[1.0, -1.0], [10.0, 2.0], [100.0, 0.5], [1000.0, 3.0]])
    plain = reference.aggregate(x, g, norm=False)
    assert plain.tolist() == [[110.0, 2.5], [100.0, 0.5], [1.0, -1.0],
                              [1.0, -1.0]]
    r2 = math.sqrt(2.0)
    gcn = reference.aggregate(x, g, norm=True)
    want = torch.tensor([[110 * r2, 2.5 * r2], [100.0, 0.5], [r2, -r2],
                         [r2, -r2]])
    torch.testing.assert_close(gcn, want)


@pytest.mark.parametrize("norm", [False, True])
def test_backward_is_the_same_aggregation(norm):
    g = graph()
    x = torch.randn(4, 3, requires_grad=True)
    up = torch.randn(4, 3)
    (reference._Agg.apply(x, g, norm, "float32") * up).sum().backward()
    torch.testing.assert_close(x.grad, reference.aggregate(up, g, norm))


def test_operands_round_as_named():
    x = torch.linspace(-3.0, 5.0, 1001)

    def rel(y):
        return ((y - x).abs() / x.abs().clamp(min=1e-3)).max()

    assert 0 < rel(reference._bf16(x)) <= 2.0 ** -8
    # int8 under one scale: an absolute step of 5/127
    assert ((reference._int8(x) - x).abs().max()
            <= 0.5 * 5.0 / 127 + 1e-6)
    assert 0 < rel(reference._tf32(x)) <= 2.0 ** -11


def test_gcn_operand_is_rounded_after_its_degree_scale():
    g = graph()
    x = torch.full((4, 1), 1.0 + 2.0 ** -9)  # a bfloat16 tie
    want = reference.aggregate(
        (x * g.deg[:, None]).to(torch.bfloat16).float() / g.deg[:, None],
        g, norm=True)
    torch.testing.assert_close(
        reference.aggregate(x, g, norm=True, operand="bfloat16"), want)
    assert reference.aggregate(x, g, norm=False,
                               operand="bfloat16")[1, 0] == 1.0


def test_follow_matches_torch_adam_on_a_dense_model():
    """Three steps of the reference's Adam against torch.optim.Adam on the
    same gradients."""
    g = graph()
    model = spec.Model({"model": "gin", "epsilon": 0.5,
                        "optimizer": {"lr": 0.01, "b1": 0.9, "b2": 0.999,
                                      "eps": 1e-8}})
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, generator=gen)
    y = torch.tensor([0, 1, 1, 0])
    p0 = [torch.randn(3, 4, generator=gen), torch.randn(4, 2, generator=gen)]
    got = reference.follow(model, g, x, y, p0, steps=3, operand="float32")
    ps = [p.clone().requires_grad_(True) for p in p0]
    opt = torch.optim.Adam(ps, lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(3):
        opt.zero_grad()
        logp = reference.forward(model, ps, x, g)
        (-logp.gather(1, y[:, None]).mean()).backward()
        opt.step()
    for d, p, q in zip(got["delta"], ps, p0):
        torch.testing.assert_close(d, p.detach() - q, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("recipe", sorted(graphgen.RECIPES))
def test_recipes_draw_the_ports_edges(recipe):
    from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph

    src, dst = graphgen.RECIPES[recipe](np.random.default_rng(11), 3000,
                                        20000)
    g = synthesize_graph(3000, 20000, kind=recipe, seed=11)
    np.testing.assert_array_equal(np.stack([src, dst]), g.edge_index)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("recipe", sorted(graphgen.RECIPES))
def test_synthesis_keeps_the_published_distinct_edges(recipe, symmetric):
    t = {"recipe": recipe, "nodes": 3000, "edges": 20000,
         "symmetric": symmetric, "graph_seed": 11}
    src, dst, n = graphgen.synthesize(t)
    keys = src * n + dst
    assert n == 3000 and len(keys) == 20000
    assert len(np.unique(keys)) == 20000
    if symmetric:
        np.testing.assert_array_equal(np.sort(keys), np.sort(dst * n + src))
        assert not (src == dst).any()
    again = graphgen.synthesize(t)
    np.testing.assert_array_equal(src, again[0])
    np.testing.assert_array_equal(dst, again[1])


def test_a_symmetric_graph_has_an_even_edge_count():
    with pytest.raises(ValueError, match="even"):
        graphgen.synthesize({"recipe": "web", "nodes": 300, "edges": 1001,
                             "symmetric": True, "graph_seed": 1})


def test_edge_file_is_written_once(tmp_path):
    t = {"recipe": "compound", "nodes": 500, "edges": 1500,
         "symmetric": True, "graph_seed": 3}
    path = graphgen.edge_file(t, str(tmp_path))
    stamp = (tmp_path / path).stat().st_mtime_ns
    assert graphgen.edge_file(t, str(tmp_path)) == path
    assert (tmp_path / path).stat().st_mtime_ns == stamp
    src, dst, n = graphgen.read_edges(path)
    want = graphgen.synthesize(t)
    np.testing.assert_array_equal(src, want[0])
    np.testing.assert_array_equal(dst, want[1])
    assert n == 500
