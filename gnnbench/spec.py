"""What ``BENCHMARK.json`` names, found by name: a cell (workload), its
configuration file and the module of the configuration's model, its
traffic file, its limits file and the readers of its per-layer
metrics."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

from gnnbench import graphgen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the keys every configuration has; a model's module names its own (KEYS)
CONFIG_KEYS = ("model", "num_layers", "hidden", "optimizer", "precision",
               "source", "assumed", "reduced")
NUMBERS = ("loss1_gap", "loss_gap", "grad_gap", "grad_diff", "delta_gap")


def _read_json(path: str) -> dict:
    with open(path) as fp:
        return json.load(fp)


def _load(path: str, name: str):
    """The Python file at ``path``, loaded as a module named ``name`` and
    registered under it: ``dataclasses`` looks a class's module up while
    it makes the class."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Model:
    """A configuration and the module of its architecture,
    ``models/<model>.py``, found by the configuration's ``model``.  The
    module holds all that the harness knows of one architecture; each
    function takes the configuration first:

    - ``PORT``: the port's model that trains it (a key of the port's
      ``train.MODELS``, and the decider's ``model``);
    - ``KEYS``: the configuration keys it needs beyond ``CONFIG_KEYS``;
    - ``widths(config, traffic)``: the layers' widths, input to output;
    - ``weights(config, traffic)``: ``(name, shape, bound)`` for each
      weight in draw order: its name as the port's model calls it, its
      shape, and its draw, uniform in +-bound (``data.make_inputs``);
    - ``port_kwargs(config)``: the port's constructor's arguments beyond
      ``(in_dim, hidden, num_classes)``;
    - ``forward(config, params, x, g, k)``: the reference's
      log-probabilities [n, classes] in plain torch, from the weights,
      the features and ``reference.Graph`` ``g``, reaching the
      aggregation and the GEMMs only through ``k``
      (``reference.Kernels``), which carries the run's precision;
    - ``step_ops(config, rf, n, e, widths, operand)``: the
      ``roofline.Op`` list of one training step, forward and backward,
      counted with the shared tools of ``rf`` (``gnnbench.roofline``).

    The module imports nothing but ``numpy`` and ``torch``: the harness
    hands it the reference's and the roofline's tools."""

    def __init__(self, config: dict, root: str = ROOT):
        name = config["model"]
        path = os.path.join(root, "gnnbench", "models", f"{name}.py")
        if not os.path.isfile(path):
            raise ValueError(f"model {name!r}: no module {path}")
        self.config = config
        self.arch = _load(path, f"gnnbench_model_{name.replace('.', '_')}")


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
        if not missing:
            self.model = Model(self.config, root)
            missing = [k for k in self.model.arch.KEYS
                       if k not in self.config]
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
        return _load(os.path.join(self.here, "metrics", f"{metric}.py"),
                     f"gnnbench_metric_{metric.replace('.', '_')}")
