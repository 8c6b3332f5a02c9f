"""``train_and_time``'s result, the optimizer and the captured step's
bookkeeping, off the card.  The CPU has nothing to capture: that the
captured step trains as the step-by-step loop does is checked on the card
(chip_smoke.py phase 13, ``use_scan`` False against True)."""

import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.train import (
    CapturedStep, build_model, make_captured_step, make_optimizer,
    make_train_step, train_and_time,
)
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty


def test_train_and_time_result_keys():
    """The result's keys; on the CPU ``use_scan`` runs the same eager
    steps as ``use_scan=False`` (the same losses and weights)."""
    g = synthesize_graph(2000, 16000, num_features=12, num_classes=5,
                         kind="web", seed=4)
    prop = InputProperty(g, hidden_dim=8, method="hybrid").decider()
    hts = prop.build_tensors(device="cpu")
    res, eager = (
        train_and_time("gcn", hts, prop.pad_features(g.init_embedding(12)),
                       prop.pad_features(g.init_labels(5)), 8, 5,
                       num_epochs=3, dry_run=2,
                       mask=prop.hybrid_graph.row_mask, device="cpu",
                       use_scan=use_scan)
        for use_scan in (True, False))
    assert res["losses"] == eager["losses"]
    for name in res["params"]:
        np.testing.assert_array_equal(res["params"][name],
                                      eager["params"][name])
    assert res["epoch_ms"] is None and res["step"] == 5
    assert len(res["losses"]) == 5
    assert res["replays"] == 0 and res["graph_launches"] is None
    assert int(res["opt_state"]["count"]) == 5
    assert sorted(res["opt_state"]) == ["count", "mu", "nu"]
    names = [n for n, _ in res["model"].named_parameters()]
    assert sorted(res["params"]) == names == ["conv1", "conv2"]
    assert res["params"]["conv1"].shape == (12, 8)
    assert all(isinstance(v, np.ndarray) for v in res["params"].values())


def test_make_optimizer_is_optax_adam_on_the_cpu():
    """optax.adam's constants; capturable only for parameters on the card
    (capturable Adam does not run on the CPU)."""
    net = build_model("gcn", torch.Generator().manual_seed(0), 4, 4, 3,
                      device="cpu")
    opt = make_optimizer(net, lr=0.02)
    d = opt.defaults
    assert (d["lr"], d["betas"], d["eps"]) == (0.02, (0.9, 0.999), 1e-8)
    assert d["capturable"] is False


class _Graph:
    """Stands in for a CUDA graph: each replay writes the next loss."""

    def __init__(self, history):
        self.history, self.n = history, 0

    def replay(self):
        self.history[self.n] = 10.0 - self.n
        self.n += 1


def test_captured_step_keeps_each_replays_loss():
    history = torch.zeros(4)
    step = CapturedStep(_Graph(history), history, {"slab_matmul_t": 4})
    for _ in range(3):
        step.replay()
    assert step.replays == 3 and step.losses() == [10.0, 9.0, 8.0]
    assert step.launches == {"slab_matmul_t": 4}


def test_captured_step_refuses_replays_past_its_history():
    history = torch.zeros(2)
    step = CapturedStep(_Graph(history), history, {})
    step.replay()
    step.replay()
    with pytest.raises(RuntimeError, match="holds 2 replays"):
        step.replay()
    assert step.replays == 2


def test_make_train_step_matches_train_and_time():
    g = synthesize_graph(3000, 24000, num_features=12, num_classes=5,
                         seed=2)
    prop = InputProperty(g, hidden_dim=8).decider()
    hts = prop.build_tensors(device="cpu")
    x, y = g.init_embedding(12), g.init_labels(5)
    net = build_model("gcn", torch.Generator().manual_seed(0), 12, 8, 5,
                      device="cpu")
    step = make_train_step(net, hts, make_optimizer(net), None)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y).long()
    losses = [float(step(xs, ys)) for _ in range(3)]
    res = train_and_time("gcn", hts, x, y, 8, 5, num_epochs=0, dry_run=3,
                         device="cpu")
    assert losses == res["losses"]


def test_capture_needs_the_card():
    g = synthesize_graph(300, 2000, num_features=4, num_classes=3, seed=1)
    prop = InputProperty(g, hidden_dim=4).decider()
    hts = prop.build_tensors(device="cpu")
    net = build_model("gcn", torch.Generator().manual_seed(0), 4, 4, 3,
                      device="cpu")
    x = torch.from_numpy(g.init_embedding(4))
    with pytest.raises(ValueError, match="on the card"):
        make_captured_step(net, hts, make_optimizer(net), x,
                           torch.ones(300, dtype=torch.int64))
