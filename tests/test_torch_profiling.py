"""Roofline accounting (``utils/profiling.py``) and the cost model's
price of a built layout (``graphs/hybrid.model_pipeline_ns``) against the
JAX package's."""

import json
import os

import pytest

from gnnadvisor_osdi21_tpu.graphs.hybrid import (
    build_hybrid as jax_build, model_pipeline_ns as jax_model,
)
from gnnadvisor_osdi21_tpu.graphs.loader import synthesize_graph as jax_graph
from gnnadvisor_osdi21_tpu.utils.profiling import spmm_roofline as jax_roofline
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import model_pipeline_ns
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty
from gnnadvisor_osdi21_tpu_torch.utils import profiling


@pytest.mark.parametrize("nnz,dim,nodes,nbytes", [
    (1_000_000, 16, 100_000, 4), (4_878_874, 16, 410_236, 4),
    (3_395_066, 96, 410_236, 2), (1, 1, 1, 4),
])
def test_roofline_counts_the_jax_bytes_and_flops(nnz, dim, nodes, nbytes):
    got = profiling.spmm_roofline(1e-3, nnz, dim, nodes, nbytes)
    want = jax_roofline(1e-3, nnz, dim, nodes, nbytes)
    assert (got.bytes_accessed, got.flops) == (want.bytes_accessed,
                                               want.flops)
    assert got.hbm_fraction == pytest.approx(
        got.bytes_accessed / 1e-3 / 3.35e12)
    assert "GB/s" in str(got)


def test_peaks_are_the_h100_data_sheet():
    assert (profiling.HBM_BYTES_PER_S, profiling.BF16_FLOPS,
            profiling.F32_FLOPS) == (3.35e12, 989e12, 67e12)


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with profiling.trace(str(tmp_path)):
        torch.ones(64).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as fp:
        assert "traceEvents" in json.load(fp)


@pytest.mark.parametrize("tiers", [(None, None), (512, 512), (0, 4096)],
                         ids=["auto", "diag512_hot512", "hot4096"])
@pytest.mark.parametrize("transposed", [True, False])
def test_model_pipeline_ns_matches_jax(tiers, transposed):
    """The 10k power-law graph's layout, built by the decider of either
    orientation (one host layout serves both), priced term by term."""
    diag_b, hot_k = tiers
    kw = dict(num_features=16, num_classes=4, kind="powerlaw")
    g = synthesize_graph(10000, 120000, **kw)
    prop = InputProperty(g, hidden_dim=16, diag_b=diag_b, hot_k=hot_k,
                         transposed=transposed, probe=False).decider()
    prop.build_tensors(device="cpu")
    hg = prop.hybrid_graph
    want = jax_model(jax_build(jax_graph(10000, 120000, **kw), hot_k=hot_k,
                               diag_b=diag_b, probe=False))
    got = model_pipeline_ns(hg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-12), k
