"""``tools/dist_check.py`` on the host (gloo, plain versions): the checks
it runs on the card hold on a small graph, on one rank and on two."""

from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.tools import dist_check


def _graph():
    return synthesize_graph(3000, 30000, num_features=16, num_classes=4,
                            kind="web", seed=5)


def test_one_rank_checks_hold():
    checks, info = dist_check.run(_graph(), dim=16, hidden=8, classes=4,
                                  device="cpu", steps=3, log=lambda m: None)
    assert checks.ok, [r for r in checks.rows if not r[3]]
    # off the card nothing is timed
    assert info["dist_ms"] is None and info["single_ms"] is None


def test_two_ranks_checks_hold():
    checks, info = dist_check.run_ranks_check(
        _graph(), 2, dim=16, hidden=8, classes=4, device="cpu", steps=3,
        log=lambda m: None)
    assert checks.ok, [r for r in checks.rows if not r[3]]
    assert info == {}
