"""What ``BENCHMARK.json`` names, found by name: a cell (workload), its
configuration file, its traffic file, its limits file and the readers of
its per-layer metrics."""

from __future__ import annotations

import importlib.util
import json
import os

from gnnbench import graphgen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONFIG_KEYS = ("model", "num_layers", "hidden", "epsilon", "optimizer",
               "precision", "source", "assumed", "reduced")
NUMBERS = ("loss1_gap", "loss_gap", "grad_gap", "grad_diff", "delta_gap")


def _read_json(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: str = ROOT):
        bench = _read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"workloads: {sorted(cells)}")
        self.name = name
        self.root = root
        self.here = os.path.join(root, "gnnbench")
        self.workload = cells[name]
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _read_json(
            os.path.join(root, configs[self.workload["config"]]["file"]))
        missing = [k for k in CONFIG_KEYS if k not in self.config]
        if missing:
            raise ValueError(f"configuration {self.workload['config']}: "
                             f"missing keys {missing}")
        self.traffic = graphgen.load_traffic(os.path.join(
            self.here, "traffic", f"{self.workload['traffic']}.json"))
        self.limits = _read_json(
            os.path.join(self.here, "limits", f"{name}.json"))
        unknown = [k for k in self.limits if k not in NUMBERS]
        if unknown or not self.limits:
            raise ValueError(f"limits of {name}: {sorted(self.limits)}; "
                             f"compare one or more of {NUMBERS}")
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if self._has(m) and m["moves"] in e2e]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric: str):
        """The module ``metrics/<metric>.py``: ``read(ctx)`` returns the
        metric's value, or None where the run gives it nothing to read."""
        path = os.path.join(self.here, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            f"gnnbench_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
