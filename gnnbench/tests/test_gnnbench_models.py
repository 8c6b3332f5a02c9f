"""The models' modules (``gnnbench/models/``) compute what the harness
computed before they existed, bit for bit: the seeded inputs, the
reference's first steps at the configuration's precision and under each
control, and the roofline's counts at the four cells' published sizes.
The pre-module code is kept here as it was."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from conftest import REPO
from gnnbench import data, graphgen, reference, roofline, spec

CELLS = ["gcn.amazon0505", "gin.amazon0505", "gin.yeast", "gcn.yeast"]
SEEDS = [7, 2**31 + 11]


def config(model: str) -> dict:
    path = os.path.join(REPO, "gnnbench", "configs", f"{model}.json")
    with open(path) as fp:
        return json.load(fp)


# --- the harness before the model modules ------------------------------

def old_widths(config: dict, traffic: dict) -> list[int]:
    layers = int(config["num_layers"])
    return ([int(traffic["features"])] + [int(config["hidden"])] * (layers - 1)
            + [int(traffic["classes"])])


def old_make_inputs(seed: int, config: dict, traffic: dict, device):
    n = int(traffic["nodes"])
    ws = old_widths(config, traffic)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = torch.randn((n, ws[0]), generator=gen, device=device)
    labels = torch.randint(0, ws[-1], (n,), generator=gen, device=device)
    shapes = list(zip(ws[:-1], ws[1:]))
    flat = torch.rand(sum(a * b for a, b in shapes), generator=gen,
                      device=device)
    params, at = [], 0
    for a, b in shapes:
        bound = 1.0 / float(b) ** 0.5
        params.append((flat[at:at + a * b].view(a, b) * 2 - 1) * bound)
        at += a * b
    return x, labels, params


def old_forward(model: dict, params, x, g, operand="float32", tf32=False):
    h = x
    last = len(params) - 1
    for i, w in enumerate(params):
        if model["model"] == "gcn":
            h = reference._Agg.apply(reference._gemm(h, w, tf32), g, True,
                                     operand)
        elif model["model"] == "gin":
            h = reference._gemm(
                model["epsilon"] * reference._Agg.apply(h, g, False, operand),
                w, tf32)
        else:
            raise ValueError(f"unknown model {model['model']!r}")
        if i < last:
            h = torch.relu(h)
    return torch.log_softmax(h, dim=1)


def old_step_ops(model: str, n: int, e: int, widths: list[int],
                 operand: int = roofline.F32) -> list:
    agg, gemm = roofline.agg, roofline.gemm
    ops = []
    layers = list(zip(widths[:-1], widths[1:]))
    for i, (a, b) in enumerate(layers):
        if model == "gcn":
            ops += [gemm(n, a, b), agg(n, e, b, True, operand)]
        elif model == "gin":
            ops += [agg(n, e, a, False, operand), gemm(n, a, b)]
        else:
            raise ValueError(f"unknown model {model!r}")
    for i, (a, b) in reversed(list(enumerate(layers))):
        if model == "gcn":
            ops.append(agg(n, e, b, True, operand))
            ops.append(gemm(a, n, b))
            if i > 0:
                ops.append(gemm(n, b, a))
        else:
            ops.append(gemm(a, n, b))
            if i > 0:
                ops.append(gemm(n, b, a))
                ops.append(agg(n, e, a, False, operand))
    return ops


# --- the comparisons ---------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_the_inputs_are_drawn_as_before(model, seed):
    cfg = config(model)
    traffic = {"nodes": 3000, "features": 96, "classes": 22}
    got = data.make_inputs(seed, spec.Model(cfg), traffic, "cpu")
    want = old_make_inputs(seed, cfg, traffic, "cpu")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(got[2]) == len(want[2]) == int(cfg["num_layers"])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))


@pytest.mark.parametrize("control", [None, *reference.CONTROLS])
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_the_reference_follows_as_before(model, control, monkeypatch):
    cfg = config(model)
    traffic = {"recipe": "web", "nodes": 2000, "edges": 14000,
               "symmetric": False, "features": 8, "classes": 3,
               "graph_seed": 21}
    src, dst, n = graphgen.synthesize(traffic)
    g = reference.Graph(src, dst, n, "cpu")
    lower = reference.CONTROLS[control] if control else {}
    m = spec.Model(cfg)
    x, labels, params0 = data.make_inputs(3000000041, m, traffic, "cpu")
    got = reference.follow(m, g, x, labels, params0, **lower)
    monkeypatch.setattr(
        reference, "forward",
        lambda model, params, x, g, operand, tf32: old_forward(
            model.config, params, x, g, operand, tf32))
    want = reference.follow(m, g, x, labels, params0, **lower)
    assert got["losses"] == want["losses"]
    assert got["top_share"] == want["top_share"]
    for key in ("grad1", "delta"):
        assert all(torch.equal(a, b) for a, b in zip(got[key], want[key]))


@pytest.mark.parametrize("cell", CELLS)
def test_the_counts_are_as_before(cell):
    c = spec.Cell(cell)
    n, e = int(c.traffic["nodes"]), int(c.traffic["edges"])
    widths = c.model.arch.widths(c.config, c.traffic)
    assert widths == old_widths(c.config, c.traffic)
    operand = roofline.DTYPE_BYTES[c.config["precision"]["agg_operands"]]
    want = old_step_ops(c.config["model"], n, e, widths, operand)
    assert roofline.step_ops(c.model, n, e, widths, operand) == want
    assert roofline.step_ops(c.config["model"], n, e, widths,
                             operand) == want


def test_the_graph_carries_its_row_pointers():
    src, dst = np.array([0, 0, 2, 2, 2, 1]), np.array([1, 2, 0, 1, 0, 0])
    g = reference.Graph(src, dst, 4, "cpu")
    assert g.indptr.tolist() == [0, 2, 3, 5, 5]
    assert torch.equal(torch.repeat_interleave(
        torch.arange(4), g.indptr.diff()), g.rows)


def test_a_model_module_may_define_a_dataclass(tmp_path):
    models = tmp_path / "gnnbench" / "models"
    models.mkdir(parents=True)
    (models / "with_dataclass.py").write_text(
        "from __future__ import annotations\n\n"
        "import dataclasses\n\n\n"
        "@dataclasses.dataclass(frozen=True)\n"
        "class Head:\n"
        "    width: int\n")
    model = spec.Model({"model": "with_dataclass"}, str(tmp_path))
    assert model.arch.Head(8).width == 8
