"""The port's ELL, dense and COO aggregation paths (``ops/graph_tensors.py``,
``ops/aggregate.py``) and its oracle (``ops/reference.py``) against the
JAX package's, on the same seeded inputs: ``aggregate``, ``sag``,
``gcn_conv`` and ``gin_conv``, forward and backward.

Tolerance at f32: 1e-5·(|A|·|x|) + 1e-6 per element, |A|·|x| being the
same function of the operands' magnitudes (computed in f64): both sides
sum exact products in f32, in different orders.  All-ones features with
``norm=False`` are exact.  At ``gemm_dtype="bfloat16"`` both sides
multiply the same bf16 operands: within 2^-8 of the largest value."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu.ops import reference as jref
from gnnadvisor_osdi21_tpu.ops.graph_tensors import (
    build_graph_tensors as jax_build,
)
from gnnadvisor_osdi21_tpu_torch.ops import aggregate as ta
from gnnadvisor_osdi21_tpu_torch.ops import reference as tref
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import (
    GraphTensors, build_graph_tensors,
)

METHODS = ["ell", "dense", "coo"]
DIMS = [16, 96]
EPS = 0.5
# the JAX package's ``ops`` exports a function named ``aggregate``
ja = importlib.import_module("gnnadvisor_osdi21_tpu.ops.aggregate")


@pytest.fixture(scope="module")
def graph():
    """A directed, degree-skewed graph with zero-degree nodes."""
    return synthesize_graph(700, 6000, num_features=16, kind="powerlaw",
                            seed=7)


def _np(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(graph, method, **kw):
    return (jax_build(graph, method=method, part_size=4, **kw),
            build_graph_tensors(graph, method=method, part_size=4,
                                device="cpu", **kw))


def _abs_agg(graph, a: np.ndarray, norm: bool) -> np.ndarray:
    """|A|·a in f64 for a >= 0 (the tolerance's scale)."""
    src = jref.csr_to_coo(graph.row_pointers, graph.column_index)
    dst = np.asarray(graph.column_index)
    vals = a[dst].astype(np.float64)
    if norm:
        deg = graph.degrees.astype(np.float64)
        vals = vals * (deg[src] * deg[dst])[:, None]
    out = np.zeros((graph.num_nodes, a.shape[1]))
    np.add.at(out, src, vals)
    return out


def assert_within(got, want, scale) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    tol = 1e-5 * np.asarray(scale) + 1e-6
    assert (err <= tol).all(), float((err - tol).max())


def test_graph_tensors_equal_jax(graph):
    for method in METHODS:
        j, t = _both(graph, method)
        assert isinstance(t, GraphTensors) and t.method == method
        assert t.num_nodes == j.num_nodes and t.part_size == j.part_size
        for name in ("degrees", "part_cols", "part_lens", "part2node",
                     "coo_src", "coo_dst", "dense_adj"):
            a, b = getattr(j, name), getattr(t, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert np.array_equal(np.asarray(a), b.numpy()), name
        owner = t.part2node if method == "ell" else t.coo_src
        if owner is None:
            assert t.seg_ptr is None
        else:  # node i owns seg_ptr[i]:seg_ptr[i+1], padding parts included
            counts = np.bincount(owner.numpy(), minlength=graph.num_nodes)
            assert np.array_equal(np.diff(t.seg_ptr.numpy()), counts)
    assert t.with_method("coo").method == "coo"


def test_unknown_and_hybrid_methods_are_refused(graph):
    with pytest.raises(ValueError, match="own builder"):
        build_graph_tensors(graph, method="hybrid", device="cpu")
    with pytest.raises(ValueError, match="unknown aggregation method"):
        build_graph_tensors(graph, method="csr", device="cpu")
    with pytest.raises(ValueError, match="gemm_dtype"):
        build_graph_tensors(graph, method="coo", device="cpu",
                            gemm_dtype="float16")


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_aggregate_forward_and_backward_equal_jax(graph, method, norm, dim):
    jgt, tgt = _both(graph, method)
    x, g = _np(1, graph.num_nodes, dim), _np(2, graph.num_nodes, dim)
    want, vjp = jax.vjp(lambda x_: ja.aggregate(x_, jgt, norm), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = ta.aggregate(xt, tgt, norm)
    out.backward(torch.from_numpy(g))
    assert_within(out.detach(), want, _abs_agg(graph, np.abs(x), norm))
    assert_within(xt.grad, want_dx, _abs_agg(graph, np.abs(g), norm))
    # and the port's oracle
    src, dst = tgt.coo_src, tgt.coo_dst
    if src is None:
        src = torch.from_numpy(tref.csr_to_coo(graph.row_pointers,
                                               graph.column_index))
        dst = torch.from_numpy(graph.column_index)
    deg = torch.from_numpy(graph.degrees)
    oracle = (tref.gcn_aggregate(torch.from_numpy(x), src, dst, deg,
                                 graph.num_nodes) if norm else
              tref.sag(torch.from_numpy(x), src, dst, graph.num_nodes))
    assert_within(out.detach(), oracle, _abs_agg(graph, np.abs(x), norm))


@pytest.mark.parametrize("method", METHODS)
def test_sag_is_exact_on_all_ones(graph, method):
    jgt, tgt = _both(graph, method)
    x = np.ones((graph.num_nodes, 16), np.float32)
    got = ta.sag(torch.from_numpy(x), tgt).numpy()
    deg = np.diff(graph.row_pointers).astype(np.float32)
    assert np.array_equal(got, np.repeat(deg[:, None], 16, axis=1))
    assert np.array_equal(got, np.asarray(ja.sag(jnp.asarray(x), jgt)))


def _conv_case(graph, method, conv: str, dim: int, gemm_dtype="float32"):
    """(port out, JAX out, port (dx, dW), JAX (dx, dW), x, w, g)."""
    jgt, tgt = _both(graph, method, gemm_dtype=gemm_dtype)
    x, w = _np(3, graph.num_nodes, dim), _np(4, dim, 8)
    g = _np(5, graph.num_nodes, 8)
    jfn = {"gcn": ja.gcn_conv,
           "gin": lambda x_, w_, gt: ja.gin_conv(x_, w_, gt, EPS)}[conv]
    tfn = {"gcn": ta.gcn_conv,
           "gin": lambda x_, w_, gt: ta.gin_conv(x_, w_, gt, EPS)}[conv]
    want, vjp = jax.vjp(lambda x_, w_: jfn(x_, w_, jgt), jnp.asarray(x),
                        jnp.asarray(w))
    want_grads = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tfn(xt, wt, tgt)
    out.backward(torch.from_numpy(g))
    return out.detach(), want, (xt.grad, wt.grad), want_grads, x, w, g


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("method", METHODS)
def test_gcn_conv_equals_jax(graph, method, dim):
    out, want, (dx, dw), (jdx, jdw), x, w, g = _conv_case(
        graph, method, "gcn", dim)
    ax, aw, ag = np.abs(x), np.abs(w), np.abs(g)
    assert_within(out, want, _abs_agg(graph, ax @ aw, True))
    agg_g = _abs_agg(graph, ag, True)
    assert_within(dx, jdx, agg_g @ aw.T)
    assert_within(dw, jdw, ax.T @ agg_g)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("method", METHODS)
def test_gin_conv_equals_jax(graph, method, dim):
    out, want, (dx, dw), (jdx, jdw), x, w, g = _conv_case(
        graph, method, "gin", dim)
    ax, aw, ag = np.abs(x), np.abs(w), np.abs(g)
    x_agg = EPS * _abs_agg(graph, ax, False)
    assert_within(out, want, x_agg @ aw)
    assert_within(dx, jdx, EPS * _abs_agg(graph, ag @ aw.T, False))
    assert_within(dw, jdw, x_agg.T @ ag)


@pytest.mark.parametrize("conv", ["gcn", "gin"])
@pytest.mark.parametrize("method", METHODS)
def test_bf16_gemm_equals_jax(graph, method, conv):
    """Both sides multiply the same bf16 operands into f32 sums."""
    out, want, grads, jgrads, *_ = _conv_case(graph, method, conv, 16,
                                               gemm_dtype="bfloat16")
    for got, ref in ((out, want), *zip(grads, jgrads)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2 ** -8,
                                   atol=2 ** -8 * float(np.abs(ref).max()))


@pytest.mark.parametrize("norm", [False, True])
def test_ell_chunked_equals_unchunked(graph, norm, monkeypatch):
    """Several blocks and a ragged tail, the budget patched on both sides:
    the blocks add the same part sums as one pass, and equal the JAX
    package's chunked pass."""
    jgt, tgt = _both(graph, "ell")
    x = _np(6, graph.num_nodes, 32)
    whole = ta.aggregate(torch.from_numpy(x), tgt, norm)
    budget = 4 * 32 * 4 * 3  # 3 parts a block
    monkeypatch.setattr(ta, "_ELL_SCRATCH_BUDGET", budget)
    monkeypatch.setattr(ja, "_ELL_SCRATCH_BUDGET", budget)
    assert tgt.part_cols.shape[0] % 3 != 0
    chunked = ta.aggregate(torch.from_numpy(x), tgt, norm)
    assert torch.equal(chunked, whole)
    want = ja.aggregate(jnp.asarray(x), jgt, norm)
    assert_within(chunked, want, _abs_agg(graph, np.abs(x), norm))


def test_reference_oracle_equals_jax(graph):
    src = jref.csr_to_coo(graph.row_pointers, graph.column_index)
    assert np.array_equal(
        tref.csr_to_coo(graph.row_pointers, graph.column_index), src)
    assert np.array_equal(
        tref.dense_adjacency(graph.row_pointers, graph.column_index),
        jref.dense_adjacency(graph.row_pointers, graph.column_index))
    dst, deg, n = graph.column_index, graph.degrees, graph.num_nodes
    x, w, g = _np(7, n, 16), _np(8, 16, 8), _np(9, n, 8)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    j = jnp.asarray
    pairs = [
        (tref.gcn_forward(t(x), t(w), t(src), t(dst), t(deg), n),
         jref.gcn_forward(j(x), j(w), j(src), j(dst), j(deg), n)),
        *zip(tref.gcn_backward(t(g), t(x), t(w), t(src), t(dst), t(deg), n),
             jref.gcn_backward(j(g), j(x), j(w), j(src), j(dst), j(deg), n)),
        *zip(tref.gin_forward(t(x), t(w), t(src), t(dst), n, EPS),
             jref.gin_forward(j(x), j(w), j(src), j(dst), n, EPS)),
    ]
    x_agg = jref.gin_forward(j(x), j(w), j(src), j(dst), n, EPS)[1]
    pairs += zip(
        tref.gin_backward(t(g), t(x_agg), t(w), t(src), t(dst), n, EPS),
        jref.gin_backward(j(g), x_agg, j(w), j(src), j(dst), n, EPS))
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
