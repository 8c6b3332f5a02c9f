"""The port's ``hybrid_aggregate`` (plain kernels on the CPU) against the
JAX package's, on the same graph, layout parameters and features.

Tolerance rtol 1e-5 and atol 1e-5 x the largest output: both sides round
the (pre-scaled) features to the aggregation dtype the same way and add
exact f32 products in f32; only the order of the sums differs, and a hub
row's sum of hundreds of degree-weighted terms can cancel to a small
value, so the absolute error scales with the output's magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu.graphs.hybrid import build_hybrid as jax_build
from gnnadvisor_osdi21_tpu.graphs.loader import _from_edges
from gnnadvisor_osdi21_tpu.ops.aggregate import aggregate as jax_aggregate
from gnnadvisor_osdi21_tpu.ops.hybrid_agg import (
    build_hybrid_tensors as jax_tensors,
    hybrid_aggregate as jax_hybrid_aggregate,
)
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import build_hybrid
from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import aggregate
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
    build_hybrid_tensors, hybrid_aggregate,
)
from gnnadvisor_osdi21_tpu_torch.utils import profiling


def jax_slot_rows(jt) -> np.ndarray:
    """The JAX layer's residual slot ids composed to rows of x: its
    ``res_dst`` when single-stage, else ``res_gather[res_dst]``."""
    dst = np.asarray(jt.res_dst)
    return dst if jt.res_gather is None else np.asarray(jt.res_gather)[dst]


def assert_close(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max())
    )


# (label, graph, layout kwargs, residual covers every block)
LAYOUTS = [
    ("both_tiers", "spread", dict(diag_b=512, hot_k=64, res_ob=128,
                                  res_tile=32), True),
    ("diag", "spread", dict(diag_b=512, hot_k=0, res_ob=128, res_tile=64),
     True),
    ("residual_only", "spread", dict(diag_b=0, hot_k=0, res_ob=512,
                                     res_tile=128), True),
    ("residual_only", "local", dict(diag_b=0, hot_k=0, res_ob=64,
                                    res_tile=32), False),
    ("hot", "local", dict(diag_b=0, hot_k=64, res_ob=128, res_tile=32),
     False),
    ("hot_list", "spread", dict(diag_b=0, hot_k=512, res_ob=128,
                                res_tile=32), True),
]
# layouts whose hot tier goes to the device as lists, without a residual
# tier: every column hot
LIST_LAYOUTS = {
    "hot_only": dict(diag_b=0, hot_k=1024, res_ob=128, res_tile=32),
    "diag_hot": dict(diag_b=512, hot_k=1024, res_ob=128, res_tile=32),
}


def _undirected(src, dst, n=1000):
    ei = np.concatenate([np.stack([src, dst]), np.stack([dst, src])], axis=1)
    return _from_edges(ei[0], ei[1], n, 16, 4)


@pytest.fixture(scope="module")
def graphs():
    """Two undirected 1000-node graphs with a 64-node hub set: "spread"
    has edges everywhere, so every residual block has tiles; "local" has
    edges among its first 300 nodes only, so blocks past them stay
    empty."""
    rng = np.random.default_rng(9)
    src = rng.integers(0, 300, 4000)
    dst = np.where(rng.random(4000) < 0.3, rng.integers(0, 64, 4000),
                   rng.integers(0, 300, 4000))
    local = _undirected(src, dst)
    src = rng.integers(0, 1000, 3000)
    dst = np.where(rng.random(3000) < 0.3, rng.integers(0, 64, 3000),
                   rng.integers(0, 1000, 3000))
    return {"local": local, "spread": _undirected(src, dst)}


@pytest.mark.parametrize("agg_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stage", ["single", "two"])
@pytest.mark.parametrize(
    "layout", LAYOUTS, ids=[f"{lay[0]}-{lay[1]}" for lay in LAYOUTS]
)
def test_hybrid_aggregate_matches_jax(graphs, layout, stage, agg_dtype):
    _, name, kw, covers = layout
    graph = graphs[name]
    jhg, thg = jax_build(graph, probe=False, **kw), build_hybrid(graph, **kw)
    assert thg.res_covers_all == jhg.res_covers_all == covers
    assert thg.res_single
    # the JAX width gate picks its gather: single below
    # RES_SINGLE_MAX_CELLS; the port's kernel reads the composed ids, the
    # same at every width
    width = None if stage == "single" else 10**9
    jt = jax_tensors(jhg, agg_dtype=agg_dtype, transposed=True,
                     agg_feature_dim=width)
    tt = build_hybrid_tensors(thg, device="cpu", agg_dtype=agg_dtype)
    assert (jt.res_gather is None) == (stage == "single")
    assert np.array_equal(tt.res_src.numpy(), jax_slot_rows(jt))
    x = np.random.default_rng(1).standard_normal(
        (22, thg.num_rows)).astype(np.float32)
    for norm in (False, True):
        want = np.asarray(jax_hybrid_aggregate(jnp.asarray(x), jt, norm))
        got = hybrid_aggregate(torch.from_numpy(x), tt, norm)
        assert got.dtype == torch.float32
        assert_close(got.numpy(), want)


@pytest.mark.parametrize("agg_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", sorted(LIST_LAYOUTS))
def test_hot_list_layouts_match_jax(graphs, layout, agg_dtype):
    """A hot tier walked as lists, alone or adding the diagonal slab's
    sum, gives the JAX package's slab aggregation; the layout has no
    residual tier, so the list's sum is the whole aggregation."""
    kw = LIST_LAYOUTS[layout]
    graph = graphs["spread"]
    jhg, thg = jax_build(graph, probe=False, **kw), build_hybrid(graph, **kw)
    assert thg.num_res_edges == 0 and thg.num_hot_edges > 0
    jt = jax_tensors(jhg, agg_dtype=agg_dtype, transposed=True)
    tt = build_hybrid_tensors(thg, device="cpu", agg_dtype=agg_dtype)
    assert tt.hot_src is not None and tt.hot_bits is None
    x = np.random.default_rng(4).standard_normal(
        (22, thg.num_rows)).astype(np.float32)
    for norm in (False, True):
        want = np.asarray(jax_hybrid_aggregate(jnp.asarray(x), jt, norm))
        got = hybrid_aggregate(torch.from_numpy(x), tt, norm)
        assert_close(got.numpy(), want)


def test_the_hot_list_counters_count(graphs):
    """``hot_list.builds`` and ``hot_list.entries`` count each layout
    build that takes the list, and ``launches["hot_list_t"]`` each launch
    of its kernel (a CPU call runs the plain version and counts none);
    tensor builds and the slab's layouts count nothing."""
    counters = profiling.STORE.counters
    before = {k: counters.get(k, 0) for k in ("hot_list.builds",
                                              "hot_list.entries")}
    graph = graphs["spread"]
    hg = build_hybrid(graph, **LIST_LAYOUTS["hot_only"])
    build_hybrid_tensors(hg, device="cpu")
    build_hybrid_tensors(hg, device="cpu", transposed=False)
    slab = build_hybrid(graph, **LAYOUTS[4][2])
    assert slab.hot_k and slab.hot_src is None
    build_hybrid_tensors(slab, device="cpu")
    assert counters["hot_list.builds"] - before["hot_list.builds"] == 1
    assert (counters["hot_list.entries"] - before["hot_list.entries"]
            == hg.num_hot_edges)
    assert "hot_list_t" in spmm_cuda.launches
    spmm_cuda.reset_launches()
    spmm_cuda.launches["hot_list_t"] += 1  # what a launch on the card adds
    assert counters["launches.hot_list_t"] == 1
    assert "launches.hot_list_t 1" in profiling.format_counters()
    spmm_cuda.reset_launches()


def test_aggregate_backward_is_the_same_aggregation(graphs):
    """The custom backward applies the forward aggregation to the incoming
    gradient, as the JAX custom_vjp does."""
    kw = dict(diag_b=512, hot_k=64, res_ob=128, res_tile=32)
    graph = graphs["spread"]
    jt = jax_tensors(jax_build(graph, probe=False, **kw), transposed=True)
    tt = build_hybrid_tensors(build_hybrid(graph, **kw), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, tt.num_rows)).astype(np.float32)
    g = rng.standard_normal((5, tt.num_rows)).astype(np.float32)
    for norm in (False, True):
        _, vjp = jax.vjp(lambda a: jax_aggregate(a, jt, norm), jnp.asarray(x))
        (want,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_(True)
        aggregate(xt, tt, norm).backward(torch.from_numpy(g))
        assert_close(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "layout", LAYOUTS, ids=[f"{lay[0]}-{lay[1]}" for lay in LAYOUTS]
)
def test_transposed_tiers_gather_only_the_hot_table(graphs, layout,
                                                    monkeypatch):
    """Outside the kernels the transposed tiers gather the hot table alone
    (one ``index_select`` when the layout's hot tier is a slab, none when
    it is a list or absent): the hot list reads x's rows in place and adds
    the diagonal slab's sum, the residual kernel reads its slot rows from
    x by ``res_src`` itself and adds the slab tiers' sum, so no separate
    sum runs either; and every kernel gets its features as the view of one
    row-major table."""
    label, name, kw, _ = layout
    tt = build_hybrid_tensors(build_hybrid(graphs[name], **kw), device="cpu")
    gathers, adds, inside, operands = [], [], [], []
    select, add = torch.Tensor.index_select, torch.Tensor.__add__

    def counting_select(t, *a, **k):
        if not inside:
            gathers.append(a)
        return select(t, *a, **k)

    def counting_add(t, *a, **k):
        if not inside:
            adds.append(a)
        return add(t, *a, **k)

    for kname in spmm_cuda.KERNELS:
        fn = getattr(spmm_cuda, kname)

        def kernel(*a, _f=fn, **k):
            operands.extend(t for t in a if isinstance(t, torch.Tensor)
                            and t.is_floating_point())
            inside.append(1)
            try:
                return _f(*a, **k)
            finally:
                inside.pop()

        monkeypatch.setattr(spmm_cuda, kname, kernel)
    monkeypatch.setattr(torch.Tensor, "index_select", counting_select)
    monkeypatch.setattr(torch.Tensor, "__add__", counting_add)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, tt.num_rows)).astype(np.float32))
    hybrid_aggregate(x, tt, False)
    assert tt.res_src is not None
    assert (tt.hot_src is not None) == (tt.hot_k > 0 and label != "hot")
    assert len(gathers) == (1 if tt.hot_bits is not None else 0)
    assert adds == []
    # features (not the addend) arrive as the transposed view of a table
    feats = [t for t in operands if t.dtype == torch.float32
             and t.shape[0] == 6 and t.stride(0) == 1]
    assert feats and all(t.stride(1) == 8 for t in feats)
