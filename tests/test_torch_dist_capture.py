"""The distributed step captured as one CUDA graph
(``dist_ops.make_captured_dist_step``), off the card.  gloo cannot
capture, so the host checks that asking it to raises, on both paths, and
that the step-by-step timing loop the host runs instead
(``dist_ops.timed_dist_steps``) trains as a plain loop of the same steps,
bitwise.  That the captured step equals the step-by-step loop within 1e-6
over 10 Adam steps is checked on the card (chip_smoke.py phase 14,
``tools/dist_check.py``)."""

import pytest
import torch

from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.parallel import dist_hybrid, dist_ops, mesh
from gnnadvisor_osdi21_tpu_torch.parallel.hybrid_partition import (
    shard_graph_hybrid,
)
from gnnadvisor_osdi21_tpu_torch.parallel.partition import shard_graph
from gnnadvisor_osdi21_tpu_torch.tools import dist_check

DIM, HIDDEN, CLASSES = 16, 8, 4


@pytest.fixture(scope="module")
def graph():
    return synthesize_graph(3000, 30000, num_features=DIM,
                            num_classes=CLASSES, kind="community", seed=5)


@pytest.fixture
def group():
    g = mesh.make_group(1, "cpu")
    yield g
    mesh.destroy_group(g)


def _path(name, graph, group):
    if name == "hybrid":
        sg = shard_graph_hybrid(graph, 1, diag_b=512, hot_k=512)
        step, init = dist_hybrid.make_dist_train_step(group, sg, "gcn")
    else:
        sg = shard_graph(graph, 1)
        step, init = dist_ops.make_dist_train_step(group, sg, "gcn")
    return step, lambda: init(torch.Generator().manual_seed(0), DIM, HIDDEN,
                              CLASSES, graph.init_embedding(DIM),
                              graph.init_labels(CLASSES))


@pytest.mark.parametrize("path", ["hybrid", "ell"])
def test_gloo_group_refuses_capture(path, graph, group):
    step, init = _path(path, graph, group)
    with pytest.raises(ValueError, match="gloo group cannot be captured"):
        dist_ops.make_captured_dist_step(step, *init(), group)


def test_blocking_wait_is_refused(monkeypatch):
    """``TORCH_NCCL_BLOCKING_WAIT`` makes ``wait()`` block the host, which
    capture forbids: refused before anything is captured."""
    monkeypatch.setenv("TORCH_NCCL_BLOCKING_WAIT", "1")
    nccl = mesh.Group(0, 1, torch.device("cpu"), "nccl", None)
    with pytest.raises(ValueError, match="TORCH_NCCL_BLOCKING_WAIT"):
        dist_ops.make_captured_dist_step(None, None, None, None, None, nccl)


@pytest.mark.parametrize("path", ["hybrid", "ell"])
def test_step_by_step_timing_trains_as_a_plain_loop(path, graph, group):
    """``timed_dist_steps(capture=False)``: every step's loss, the warm-up
    ones included, and the final weights equal a plain loop's, bitwise."""
    step, init = _path(path, graph, group)
    net, opt, x, y = init()
    ms, losses = dist_ops.timed_dist_steps(step, net, opt, x, y, group,
                                           warmup=2, epochs=3, capture=False)
    ref, ref_opt, rx, ry = init()
    want = [float(step(ref, ref_opt, rx, ry)) for _ in range(5)]
    assert losses == want and ms > 0
    for p, q in zip(net.parameters(), ref.parameters()):
        assert torch.equal(p, q)


def test_dist_check_records_the_refusal(graph):
    """On gloo ``dist_check.run`` holds each path's refusal to capture as a
    passing check, and measures nothing."""
    checks, info = dist_check.run(graph, dim=DIM, hidden=HIDDEN,
                                  classes=CLASSES, device="cpu", steps=2,
                                  log=lambda m: None)
    refusals = [r for r in checks.rows if "refuses to capture" in r[0]]
    assert [r[0].split(":")[0] for r in refusals] == ["hybrid (bf16 tiers)",
                                                      "ELL"]
    assert all(r[3] for r in refusals) and checks.ok
    assert info["capture"] == {} and info["capture_ell"] == {}


def test_group_takes_its_card_by_local_rank():
    """Rank 3 of 4 at local rank ``have`` needs ``have + 1`` cards on its
    host, not 4: the refusal names the local count."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"need {have + 1} CUDA cards"):
        mesh.make_group(4, None, rank=3, init_file="unused",
                        local_rank=have)
