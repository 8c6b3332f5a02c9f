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
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import aggregate
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
    build_hybrid_tensors, hybrid_aggregate,
)



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
def test_hybrid_aggregate_matches_jax(graphs, layout, stage, agg_dtype):
    _, name, kw, covers = layout
    graph = graphs[name]
    jhg, thg = jax_build(graph, probe=False, **kw), build_hybrid(graph, **kw)
    assert thg.res_covers_all == jhg.res_covers_all == covers
    assert thg.res_single
    # the width gate picks the gather: single below RES_SINGLE_MAX_CELLS
    width = None if stage == "single" else 10**9
    jt = jax_tensors(jhg, agg_dtype=agg_dtype, transposed=True,
                     agg_feature_dim=width)
    tt = build_hybrid_tensors(thg, device="cpu", agg_dtype=agg_dtype,
                              agg_feature_dim=width)
    assert (tt.res_gather is None) == (stage == "single")
    x = np.random.default_rng(1).standard_normal(
        (22, thg.num_rows)).astype(np.float32)
    for norm in (False, True):
        want = np.asarray(jax_hybrid_aggregate(jnp.asarray(x), jt, norm))
        got = hybrid_aggregate(torch.from_numpy(x), tt, norm)
        assert got.dtype == torch.float32
        assert_close(got.numpy(), want)


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
