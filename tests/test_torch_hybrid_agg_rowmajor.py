"""The port's row-major ``hybrid_aggregate`` (plain kernels on the CPU)
against the JAX package's row-major path (``transposed=False``), on the
same graph, layout parameters and features, and the layout's tensors as
the row-major kernels need them.

Tolerance rtol 1e-5 and atol 1e-5 x the largest output, for the reasons
given in test_torch_hybrid_agg.py: only the order of the f32 sums
differs."""

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
    build_hybrid_tensors, build_layer_tensors, hybrid_aggregate,
)


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
]


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
def test_rowmajor_hybrid_aggregate_matches_jax(graphs, layout, stage,
                                               agg_dtype):
    _, name, kw, covers = layout
    graph = graphs[name]
    jhg, thg = jax_build(graph, probe=False, **kw), build_hybrid(graph, **kw)
    assert thg.res_covers_all == jhg.res_covers_all == covers
    width = None if stage == "single" else 10**9
    jt = jax_tensors(jhg, agg_dtype=agg_dtype, transposed=False,
                     agg_feature_dim=width)
    tt = build_hybrid_tensors(thg, device="cpu", agg_dtype=agg_dtype,
                              transposed=False)
    # the JAX layer gathers in one or two stages; the port's kernel reads
    # the composed ids, the same at every width
    assert (jt.res_gather is None) == (stage == "single")
    assert not hasattr(tt, "res_gather") and not hasattr(tt, "res_dst")
    assert np.array_equal(tt.res_src.numpy(), jax_slot_rows(jt))
    x = np.random.default_rng(1).standard_normal(
        (thg.num_rows, 22)).astype(np.float32)
    for norm in (False, True):
        want = np.asarray(jax_hybrid_aggregate(jnp.asarray(x), jt, norm))
        got = hybrid_aggregate(torch.from_numpy(x), tt, norm)
        assert got.dtype == torch.float32 and got.shape == x.shape
        assert_close(got.numpy(), want)


def test_only_the_rowmajor_mask_is_kept(graphs):
    """Each layout keeps the one residual mask its kernels read, as the
    JAX build does for the TPU (hybrid_agg.py:110-114)."""
    hg = build_hybrid(graphs["spread"], diag_b=0, hot_k=0, res_ob=128,
                      res_tile=32)
    rm = build_hybrid_tensors(hg, device="cpu", transposed=False)
    tr = build_hybrid_tensors(hg, device="cpu")
    assert rm.res_mask_s is None and rm.res_mask.dtype == torch.uint32
    assert np.array_equal(rm.res_mask.numpy(), hg.res_mask)
    assert tr.res_mask is None and tr.res_mask_s is not None
    assert (rm.transposed, tr.transposed) == (False, True)


def test_rowmajor_tiers_launch_the_rowmajor_kernels(graphs, monkeypatch):
    """Both slab tiers run as one fused call and the residual as one
    combine; no transposed kernel is reached."""
    calls = []
    for name in spmm_cuda.KERNELS:
        fn = getattr(spmm_cuda, name)
        monkeypatch.setattr(spmm_cuda, name,
                            lambda *a, _n=name, _f=fn, **kw: calls.append(_n)
                            or _f(*a, **kw))
    kw = dict(diag_b=512, hot_k=64, res_ob=128, res_tile=32)
    tt = build_hybrid_tensors(build_hybrid(graphs["spread"], **kw),
                              device="cpu", transposed=False)
    hybrid_aggregate(torch.zeros((tt.num_rows, 4)), tt, True)
    assert calls == ["fused_slab_matmul", "residual_combine"]


def test_rowmajor_aggregate_backward_is_the_same_aggregation(graphs):
    kw = dict(diag_b=512, hot_k=64, res_ob=128, res_tile=32)
    graph = graphs["spread"]
    jt = jax_tensors(jax_build(graph, probe=False, **kw), transposed=False)
    tt = build_hybrid_tensors(build_hybrid(graph, **kw), device="cpu",
                              transposed=False)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((tt.num_rows, 5)).astype(np.float32)
    g = rng.standard_normal((tt.num_rows, 5)).astype(np.float32)
    for norm in (False, True):
        _, vjp = jax.vjp(lambda a: jax_aggregate(a, jt, norm), jnp.asarray(x))
        (want,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_(True)
        aggregate(xt, tt, norm).backward(torch.from_numpy(g))
        assert_close(xt.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "layout", LAYOUTS, ids=[f"{lay[0]}-{lay[1]}" for lay in LAYOUTS]
)
def test_rowmajor_tiers_gather_only_the_hot_table(graphs, layout,
                                                  monkeypatch):
    """Outside the kernels the row-major tiers gather the hot table alone
    (one ``index_select`` when the layout has a hot tier, else none): the
    residual kernel reads its slot rows from x by ``res_src`` itself, and
    adds the slab tiers' sum, so no separate sum runs either."""
    _, name, kw, _ = layout
    tt = build_hybrid_tensors(build_hybrid(graphs[name], **kw),
                              device="cpu", transposed=False)
    gathers, adds, inside = [], [], []
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
            inside.append(1)
            try:
                return _f(*a, **k)
            finally:
                inside.pop()

        monkeypatch.setattr(spmm_cuda, kname, kernel)
    monkeypatch.setattr(torch.Tensor, "index_select", counting_select)
    monkeypatch.setattr(torch.Tensor, "__add__", counting_add)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (tt.num_rows, 6)).astype(np.float32))
    hybrid_aggregate(x, tt, False)
    assert tt.res_src is not None
    assert len(gathers) == (1 if tt.hot_k else 0)
    assert adds == []


@pytest.mark.parametrize("stage", ["single", "two"])
def test_rowmajor_res_src_is_the_composed_gather(graphs, stage):
    """``res_src`` is ``res_gather[res_dst]``, the ids the JAX layer's one-
    or two-stage gather reads in the end, one int32 row of x per slot, pad
    slots included; a row-major layout keeps no other residual ids, and
    its layers, whatever their widths, share one tensor set.  The
    transposed layout carries the same ``res_src``."""
    graph = graphs["spread"]
    kw = dict(diag_b=0, hot_k=64, res_ob=128, res_tile=32)
    hg = build_hybrid(graph, **kw)
    width = None if stage == "single" else 10**9
    jt = jax_tensors(jax_build(graph, probe=False, **kw), transposed=False,
                     agg_feature_dim=width)
    assert (jt.res_gather is None) == (stage == "single")
    rm = build_hybrid_tensors(hg, device="cpu", transposed=False)
    assert not hasattr(rm, "res_gather") and not hasattr(rm, "res_dst")
    src = rm.res_src.numpy()
    assert rm.res_src.dtype == torch.int32
    assert np.array_equal(src, hg.res_gather[hg.res_dst])
    assert np.array_equal(src, jax_slot_rows(jt))
    assert src.min() >= 0 and src.max() < hg.num_rows
    ht_in, ht_hid = build_layer_tensors(hg, device="cpu", transposed=False)
    assert ht_in is ht_hid and np.array_equal(ht_in.res_src.numpy(), src)
    assert np.array_equal(
        build_hybrid_tensors(hg, device="cpu").res_src.numpy(), src)
