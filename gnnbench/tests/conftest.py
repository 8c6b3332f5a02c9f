"""Fixtures of the benchmark's own tests: a copy of the harness with a
tiny cell, and the decision whether a CUDA card is present (taken in a
fixture, never while a module is imported)."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_TRAFFIC = {"recipe": "web", "nodes": 5000, "edges": 40000,
                "symmetric": True, "features": 8, "classes": 3, "graph_seed": 5,
                "reorder": False, "stands_for": "a tiny web graph for tests"}
# limits of the tiny cells, from CPU readings on 6 seeds against the
# reference at the configurations' precision: sound runs read at most 0
# (first loss), 1.4e-7 (gradient norms), 7.1e-7 (gradient difference)
# and 1.9e-7 (change after three steps); the int8 and TF32 controls and
# the half-batch fault read at least 3.4e-5, 4.8e-4, 9.8e-4 and 3.8e-5
TINY_LIMITS = {"loss1_gap": 1e-5, "grad_gap": 1e-4, "grad_diff": 1e-3,
               "delta_gap": 1e-4}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda:0")


def copy_harness(dest: str) -> str:
    """A checkout holding BENCHMARK.json and the harness, plus the tiny
    cells ``gcn.tiny`` and ``gin.tiny``; returns its root."""
    os.makedirs(dest, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(REPO, "gnnbench"),
                    os.path.join(dest, "gnnbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                  "tests"))
    add_cells(dest)
    return dest


def add_cells(root: str) -> None:
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fp:
        bench = json.load(fp)
    with open(os.path.join(root, "gnnbench", "traffic", "tiny.json"),
              "w") as fp:
        json.dump(TINY_TRAFFIC, fp)
    for model in ("gcn", "gin"):
        bench["workloads"].append({"name": f"{model}.tiny", "config": model,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "a tiny cell for the tests"})
        with open(os.path.join(root, "gnnbench", "limits",
                               f"{model}.tiny.json"), "w") as fp:
            json.dump(TINY_LIMITS, fp)
    with open(path, "w") as fp:
        json.dump(bench, fp, indent=1)


@pytest.fixture(scope="session")
def harness(tmp_path_factory) -> str:
    return copy_harness(str(tmp_path_factory.mktemp("checkout")))


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
