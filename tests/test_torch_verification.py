"""The port's ``Verification`` against the JAX package's on one graph,
for the dense, ELL, COO and (transposed) hybrid paths: the aggregation of
all-ones features and the oracle are integer counts, exact on both
sides."""

import numpy as np
import pytest

from gnnadvisor_osdi21_tpu.graphs.loader import synthesize_graph as jax_graph
from gnnadvisor_osdi21_tpu.tuner.decider import InputProperty as JaxProperty
from gnnadvisor_osdi21_tpu.verification import Verification as JaxVerification
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty
from gnnadvisor_osdi21_tpu_torch.verification import Verification

DIM = 16


@pytest.fixture(scope="module", params=["dense", "ell", "coo", "hybrid"])
def pair(request):
    """(port, JAX) Verification on a 5,000-node web graph; dense on a
    3,000-node one (the decider's dense range)."""
    method = request.param
    n, e = (3000, 24000) if method == "dense" else (5000, 40000)
    kw = dict(num_features=DIM, num_classes=4, kind="web", seed=4)
    tg, jg = synthesize_graph(n, e, **kw), jax_graph(n, e, **kw)
    tp = InputProperty(tg, hidden_dim=DIM, method=method).decider()
    jp = JaxProperty(jg, hidden_dim=DIM, method=method, probe=False).decider()
    thts, jgts = tp.build_tensors(device="cpu"), jp.build_tensors()
    assert tp.layer_input.method == method
    if method == "hybrid":
        assert thts[0].transposed
    return Verification(DIM, tp, thts[0]), JaxVerification(DIM, jp, jgts[0])


def test_compute_and_reference_match_jax(pair):
    port, jax_v = pair
    got, want = port.compute(), np.asarray(jax_v.compute())
    assert got.shape == want.shape == (port.graph.num_nodes, DIM)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.reference(),
                                  np.asarray(jax_v.reference()))
    assert port.compare()


def test_a_corrupted_result_fails(pair, capsys):
    port, _ = pair
    port.compute()
    port.reference()
    bad = port.result.copy()
    bad[: max(1, bad.shape[0] // 100)] += 1.0  # 1% of the rows off by one
    port.result = bad
    assert not port.compare()
    assert "Verification FAILED" in capsys.readouterr().out


def test_profile_spmm_times_the_aggregation(pair):
    port, _ = pair
    assert port.profile_spmm(rounds=2) > 0
