"""The harness end to end on the host (the port's plain versions, tiny
cells): a cell and a model added by files alone, sound runs, and runs
with the timed path broken underneath, which must come out not
correct."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import REPO, TINY_LIMITS, copy_harness, last_json

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
READER = '''"""edges_per_node: the graph's merged edges over its nodes."""


def read(ctx):
    return ctx.edges / ctx.nodes
'''
# a model the harness has no file of: layer Agg(h) W over plain neighbour
# sums, ReLU between layers; the port's GIN at epsilon 1 computes it
SUM_CONV = '''"""sum_conv: layer ``Agg(h) W``, ReLU between layers."""

from __future__ import annotations

import torch

PORT = "gin"
KEYS = ()


def widths(config, traffic):
    layers = int(config["num_layers"])
    return ([int(traffic["features"])] + [int(config["hidden"])] * (layers - 1)
            + [int(traffic["classes"])])


def weights(config, traffic):
    ws = widths(config, traffic)
    return [(f"conv{i + 1}", (a, b), 1.0 / float(b) ** 0.5)
            for i, (a, b) in enumerate(zip(ws[:-1], ws[1:]))]


def port_kwargs(config):
    return {"epsilon": 1.0}


def forward(config, params, x, g, k):
    h = x
    for i, w in enumerate(params):
        h = k.gemm(k.agg(h, g), w)
        if i < len(params) - 1:
            h = torch.relu(h)
    return torch.log_softmax(h, dim=1)


def step_ops(config, rf, n, e, widths, operand):
    ops = []
    layers = list(zip(widths[:-1], widths[1:]))
    for a, b in layers:
        ops += [rf.agg(n, e, a, False, operand), rf.gemm(n, a, b)]
    for i, (a, b) in reversed(list(enumerate(layers))):
        ops.append(rf.gemm(a, n, b))
        if i > 0:
            ops += [rf.gemm(n, b, a), rf.agg(n, e, a, False, operand)]
    return ops
'''


def run_cli(root: str, *args: str, device: str = "cpu"):
    """``gnnbench.run`` in a fresh process from checkout ``root``, on
    ``device`` ("" for the command line as the benchmark runs it)."""
    code = ("import sys; from gnnbench import run; "
            f"sys.exit(run.main(sys.argv[1:], device={device!r}))"
            if device else None)
    cmd = ([sys.executable, "-c", code] if code
           else [sys.executable, "-m", "gnnbench.run"]) + list(args)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]))
    return subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)


def digests(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        if "_cache" in d or "__pycache__" in d:
            continue
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fp:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fp.read()).hexdigest()
    return out


def test_a_new_cell_is_files_and_entries(tmp_path):
    root = copy_harness(str(tmp_path / "checkout"))
    before = digests(root)
    here = os.path.join(root, "gnnbench")
    with open(os.path.join(here, "traffic", "tiny_compound.json"), "w") as fp:
        json.dump({"recipe": "compound", "nodes": 5000, "edges": 12000,
                   "symmetric": True, "features": 6, "classes": 2, "graph_seed": 9,
                   "reorder": False, "stands_for": "a tiny compound graph"},
                  fp)
    with open(os.path.join(here, "configs", "gcn.json")) as fp:
        cfg = json.load(fp)
    cfg["optimizer"]["lr"] = 0.02
    with open(os.path.join(here, "configs", "gcn_lr2.json"), "w") as fp:
        json.dump(cfg, fp)
    with open(os.path.join(here, "metrics", "edges_per_node.py"), "w") as fp:
        fp.write(READER)
    with open(os.path.join(here, "limits", "gcn_lr2.tiny_compound.json"),
              "w") as fp:
        json.dump({"loss1_gap": 1e-5, "grad_diff": 1e-3}, fp)
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    bench["configs"].append({"name": "gcn_lr2", "source": "a test",
                             "file": "gnnbench/configs/gcn_lr2.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "gcn_lr2.tiny_compound",
                               "config": "gcn_lr2", "traffic": "tiny_compound",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "edges_per_node", "unit": "edges/node",
                               "better": "higher", "source": "program_counter",
                               "layer": "set-up: loader, decider, layout",
                               "moves": "setup_s",
                               "workloads": ["gcn_lr2.tiny_compound"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fp:
        json.dump(bench, fp)

    common = ("--workload", "gcn_lr2.tiny_compound", "--seed", "2500000001",
              "--seconds", "0.5")
    res0 = run_cli(root, *common, "--trace", "0")
    assert res0.returncode == 0, res0.stderr[-3000:]
    line0 = last_json(res0.stdout)
    assert RESULT_KEYS <= set(line0)
    assert list(line0)[-1] == "checks"
    assert line0["correct"] is True
    assert set(line0["metrics"]) == {"epoch_ms", "setup_s"}
    res1 = run_cli(root, *common, "--trace", "1")
    assert res1.returncode == 0, res1.stderr[-3000:]
    line1 = last_json(res1.stdout)
    assert line1["correct"] is True
    assert line1["metrics"]["edges_per_node"]["unit"] == "edges/node"
    assert 1.0 < line1["metrics"]["edges_per_node"]["value"] < 3.0
    assert "layout_s" in line1["metrics"]
    assert "breakdown" in line1
    after = digests(root)
    changed = [p for p, h in before.items()
               if p != "BENCHMARK.json" and after.get(p) != h]
    assert changed == []


def test_a_new_model_is_files_and_entries(tmp_path, monkeypatch, capsys):
    """A model module, its configuration, traffic, limits and entries, all
    new files and entries: a sound run is correct, a step that leaves its
    state unchanged is not, and its counts are the port's GIN's."""
    from gnnbench import roofline, run, spec

    root = copy_harness(str(tmp_path / "checkout"))
    before = digests(root)
    here = os.path.join(root, "gnnbench")
    with open(os.path.join(here, "models", "sum_conv.py"), "w") as fp:
        fp.write(SUM_CONV)
    with open(os.path.join(here, "configs", "gin.json")) as fp:
        cfg = json.load(fp)
    cfg.update(model="sum_conv", hidden=16)
    del cfg["epsilon"]
    with open(os.path.join(here, "configs", "sum_conv.json"), "w") as fp:
        json.dump(cfg, fp)
    with open(os.path.join(here, "traffic", "tiny_sum.json"), "w") as fp:
        # over the decider's 4,096 nodes of the dense method, which
        # aggregates in float32 whatever the configuration states
        json.dump({"recipe": "web", "nodes": 6000, "edges": 30000,
                   "symmetric": True, "features": 6, "classes": 4,
                   "graph_seed": 13, "reorder": False,
                   "stands_for": "a tiny web graph"}, fp)
    with open(os.path.join(here, "limits", "sum_conv.tiny_sum.json"),
              "w") as fp:
        json.dump(TINY_LIMITS, fp)
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    bench["configs"].append({"name": "sum_conv", "source": "a test",
                             "file": "gnnbench/configs/sum_conv.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "sum_conv.tiny_sum",
                               "config": "sum_conv", "traffic": "tiny_sum",
                               "chips": 1, "why": "a test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fp:
        json.dump(bench, fp)

    common = ["--workload", "sum_conv.tiny_sum", "--seconds", "0.3"]
    res = run_cli(root, *common, "--seed", "2500000011", "--trace", "0")
    assert res.returncode == 0, res.stderr[-3000:]
    assert last_json(res.stdout)["correct"] is True, res.stderr[-2000:]
    _state_unchanged(monkeypatch)
    capsys.readouterr()
    assert run.main(common + ["--seed", "2500000013"], device="cpu",
                    root=root) == 0
    assert last_json(capsys.readouterr().out)["correct"] is False

    cell = spec.Cell("sum_conv.tiny_sum", root)
    model, ws = cell.model, [6, 16, 16, 16, 16, 4]
    assert model.arch.widths(model.config, cell.traffic) == ws
    assert (roofline.step_ops(model, 6000, 30000, ws, 2)
            == roofline.step_ops("gin", 6000, 30000, ws, 2))
    after = digests(root)
    changed = [p for p, h in before.items()
               if p != "BENCHMARK.json" and after.get(p) != h]
    assert changed == []


@pytest.mark.parametrize("cell", ["gcn.tiny", "gin.tiny"])
def test_sound_runs_are_correct(harness, cell, capsys):
    from gnnbench import run

    rc = run.main(["--workload", cell, "--seed", "3000000019", "--seconds",
                   "0.5"], device="cpu", root=harness)
    assert rc == 0
    line = last_json(capsys.readouterr().out)
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from gnnadvisor_osdi21_tpu_torch import train

    plain = train.nll_loss

    def half(log_probs, labels, mask=None, transposed=True):
        rows = labels.shape[0]
        keep = (torch.arange(rows, device=labels.device) % 2 == 0).float()
        mask = keep if mask is None else mask * keep
        return plain(log_probs, labels, mask, transposed)

    monkeypatch.setattr(train, "nll_loss", half)


@pytest.mark.parametrize("cell", ["gcn.tiny", "gin.tiny"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(harness, cell, fault, monkeypatch,
                                      capsys):
    from gnnbench import run

    fault(monkeypatch)
    rc = run.main(["--workload", cell, "--seed", "3000000023", "--seconds",
                   "0.2"], device="cpu", root=harness)
    assert rc == 0
    line = last_json(capsys.readouterr().out)
    assert line["correct"] is False


def test_without_a_card_there_is_no_result(harness):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run the cell")
    res = run_cli(harness, "--workload", "gcn.tiny", "--seed", "1",
                  "--seconds", "1", "--trace", "0", device="")
    assert res.returncode != 0
    assert "{" not in res.stdout


def test_without_the_program_there_is_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the harness."""
    root = copy_harness(str(tmp_path / "bare"))
    code = ("import sys; from gnnbench import run; "
            "sys.exit(run.main(sys.argv[1:], device='cpu'))")
    res = subprocess.run(
        [sys.executable, "-c", code, "--workload", "gcn.tiny", "--seed", "1",
         "--seconds", "1"], cwd=root, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "{" not in res.stdout
