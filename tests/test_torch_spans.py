"""The port's span and counter store (``utils/profiling.py``), the spans
the set-up and the training step open, and the benchmark's readers of
them (``gnnbench/metrics``), all on the host."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu_torch import train
from gnnadvisor_osdi21_tpu_torch.cli import main as cli_main
from gnnadvisor_osdi21_tpu_torch.graphs.loader import (
    load_graph, synthesize_graph,
)
from gnnadvisor_osdi21_tpu_torch.ops import fmtprobe_cuda, probe_cuda, spmm_cuda
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty
from gnnadvisor_osdi21_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = os.path.join(ROOT, "gnnbench", "metrics")
NEW_METRICS = ("load_s", "tier_choice_s", "layout_pack_s", "model_ms",
               "agg_passes_ms")


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"test_reader_{name}", os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ctx(on_card: bool = True):
    return types.SimpleNamespace(on_card=on_card)


@pytest.fixture
def store(monkeypatch):
    """A fresh store in place of the process's own."""
    s = profiling.Store()
    monkeypatch.setattr(profiling, "STORE", s)
    return s


# --- the store ---------------------------------------------------------------

def test_spans_record_parents_and_self_time(store):
    with profiling.span("outer", kind="test") as outer:
        time.sleep(0.002)
        with profiling.span("inner") as inner:
            time.sleep(0.004)
        with profiling.span("inner") as inner2:
            with profiling.span("leaf") as leaf:
                time.sleep(0.001)
    assert outer.parent is None and outer.attrs == {"kind": "test"}
    assert inner.parent == outer.id and inner2.parent == outer.id
    assert leaf.parent == inner2.id
    assert [r.name for r in store.records] == ["inner", "leaf", "inner",
                                               "outer"]
    assert store.children(outer) == [inner, inner2]
    assert store.descendants(outer) == [inner, inner2, leaf]
    assert store.latest("inner") is inner2
    assert store.latest("missing") is None
    want = outer.seconds - inner.seconds - inner2.seconds
    assert store.self_s(outer) == pytest.approx(want, abs=1e-9)
    assert store.self_s(outer) >= 0.002
    assert store.self_s(inner2) == pytest.approx(
        inner2.seconds - leaf.seconds, abs=1e-9)
    assert store.self_s(leaf) == pytest.approx(leaf.seconds)
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns


def test_a_span_that_raises_is_recorded_and_the_error_passes(store):
    with pytest.raises(ValueError):
        with profiling.span("fails"):
            raise ValueError("boom")
    assert store.latest("fails") is not None
    with profiling.span("after") as rec:
        pass
    assert rec.parent is None


def test_the_buffer_keeps_the_newest_and_counts_what_it_drops():
    s = profiling.Store(capacity=4)
    for i in range(10):
        with s.span(f"s{i}"):
            pass
    assert [r.name for r in s.records] == ["s6", "s7", "s8", "s9"]
    assert (s.closed, s.dropped) == (10, 6)
    assert s.latest("s2") is None and s.latest("s9").name == "s9"


def test_counters_and_the_launch_views(store, monkeypatch):
    profiling.count("probe.runs")
    profiling.count("probe.runs", 2)
    assert store.counters["probe.runs"] == 3
    view = profiling.CounterView("launches.", ("a", "b"), store)
    view["a"] += 2
    assert store.counters["launches.a"] == 2
    assert view == {"a": 2, "b": 0} and dict(view) == {"a": 2, "b": 0}
    assert {**view} == {"a": 2, "b": 0} and repr(view) == "{'a': 2, 'b': 0}"
    with pytest.raises(KeyError):
        view["c"] += 1
    # the kernels' launch counts are the process store's counters
    for mod in (spmm_cuda, probe_cuda, fmtprobe_cuda):
        assert isinstance(mod.launches, profiling.CounterView)
    spmm_cuda.reset_launches()
    spmm_cuda.launches["residual_combine_t"] += 1
    assert profiling.STORE is store
    name = "launches.residual_combine_t"
    assert spmm_cuda.launches._store.counters[name] == 1
    spmm_cuda.reset_launches()
    assert spmm_cuda.launches == dict.fromkeys(spmm_cuda.KERNELS, 0)
    assert "launches" not in profiling.format_counters(
        spmm_cuda.launches._store)


def test_format_tree_sums_one_name_under_one_parent(store):
    with profiling.span("root") as root:
        for _ in range(3):
            with profiling.span("step"):
                with profiling.span("gemm"):
                    pass
    profiling.count("kernels.builds")
    lines = profiling.format_tree([root])
    assert lines[0].startswith("root: ") and "self" in lines[0]
    assert lines[1].startswith("  step x3: ")
    assert lines[2].startswith("    gemm x3: ")
    assert profiling.format_counters() == "kernels.builds 1, spans dropped 0"


# --- the profiler's clock -------------------------------------------------

def test_a_span_is_its_annotation_on_the_traces_clock(store, tmp_path):
    """``trace_us`` puts a span's start and end on its annotation's, to
    within 100 us in the median of 21 spans (one read can be late by a
    preemption of this process)."""
    from torch.profiler import ProfilerActivity, profile

    assert not profiling.profiler_active()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.profiler_active()
        with profiling.span("clock.warm"):  # the annotation's first cost
            pass
        recs = []
        for i in range(21):
            with profiling.span(f"clock.probe{i}") as rec:
                torch.ones(4096).sum()
            recs.append(rec)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fp:
        trace = json.load(fp)
    anns = {e["name"]: e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    offset = profiling.clock_offset_ns()
    starts, ends = [], []
    for rec in recs:
        ann = anns[rec.name]
        a, b = float(ann["ts"]), float(ann["ts"]) + float(ann["dur"])
        starts.append(abs(profiling.trace_us(rec.start_ns, trace, offset) - a))
        ends.append(abs(profiling.trace_us(rec.end_ns, trace, offset) - b))
    assert float(np.median(starts)) < 100.0, starts
    assert float(np.median(ends)) < 100.0, ends


# --- the replay, the capture and the timed warm-up step --------------------

class _Graph:
    def __init__(self, history):
        self.history, self.n = history, 0

    def replay(self):
        self.history[self.n] = 1.0
        self.n += 1


class _Event:
    """Counts what would have been CUDA events."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.stream = stream
        self.t = time.perf_counter()

    def query(self):
        return False

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_a_replay_records_nothing_without_a_profiler(store, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(_Event, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    history = torch.zeros(4)
    step = train.CapturedStep(_Graph(history), history, {})
    step.replay()
    step.replay()
    assert store.closed == 0 and _Event.made == 0
    with profile(activities=[ProfilerActivity.CPU]):
        step.replay()
    assert [r.name for r in store.records] == ["step.replay"]
    assert _Event.made == 0 and step.replays == 3


def test_capture_records_no_event(store, monkeypatch):
    monkeypatch.setattr(_Event, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())

    class _Capture:
        def __init__(self, graph, capture_error_mode="global"):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "graph", _Capture)

    def step():
        with profiling.span("loss"):
            return torch.tensor(2.0)

    captured = train.capture_step(step, torch.device("cpu"), capacity=2)
    assert isinstance(captured, train.CapturedStep)
    assert _Event.made == 0
    cap = store.latest("capture")
    assert [r.name for r in store.children(cap)] == ["loss"]
    assert all(r.device_s is None for r in store.records)


def test_device_timed_times_every_span_inside_it(store, monkeypatch):
    """On fakes of the card's sleep, events and synchronise: the timed
    span and each span inside it get device seconds, the hold comes
    first, and a span opened after it records no event."""
    calls = []
    monkeypatch.setattr(_Event, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: calls.append(("sleep", cycles)))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(("sync",)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: "the side stream")

    def step():
        with profiling.span("forward.layer0.gemm"):
            time.sleep(0.001)
        with profiling.span("backward"):
            with profiling.span("aggregate.tiers"):
                time.sleep(0.002)
        return 7

    assert profiling.device_timed(step, "timed", 0.01) == 7
    assert calls == [("sleep", int(0.01 * profiling.SLEEP_CYCLES_PER_S)),
                     ("sync",)]
    rec = store.latest("timed")
    assert rec.attrs == {"hold_s": 0.01, "held": True}
    inside = store.descendants(rec)
    assert [r.name for r in inside] == ["forward.layer0.gemm", "backward",
                                        "aggregate.tiers"]
    for r in [rec] + inside:
        assert r.device_s == pytest.approx(r.seconds, abs=5e-4)
    assert _Event.made == 1 + 2 * 4  # the hold's end, two a span
    with profiling.span("later") as later:
        pass
    assert later.device_s is None and _Event.made == 9
    with pytest.raises(RuntimeError, match="does not nest"):
        profiling.device_timed(
            lambda: profiling.device_timed(step, "inner", 0.0), "outer", 0.0)


def _tiny_step():
    g = synthesize_graph(1000, 8000, num_features=8, num_classes=3, seed=1)
    prop = InputProperty(g, hidden_dim=8, model="gin", method="hybrid",
                         probe=False)
    hts = prop.decider().build_tensors(device="cpu")
    x = torch.from_numpy(prop.pad_features(g.init_embedding(8))).t()
    y = torch.from_numpy(prop.pad_features(g.init_labels(3))).long()
    net = train.build_model("gin", torch.Generator().manual_seed(0), 8, 8, 3,
                            device="cpu")
    step = train.make_train_step(net, hts, train.make_optimizer(net),
                                 hts[0].row_mask)
    return lambda: step(x.contiguous(), y)


def test_the_warm_ups_timed_step_takes_the_host_clock_on_the_cpu(store):
    step = _tiny_step()
    losses = train.warm_up(step, 3, torch.device("cpu"))
    assert len(losses) == 3
    warm = store.latest("warm_up")
    timed = store.latest(train.TIMED_STEP)
    assert timed.parent == warm.id and timed.device_s is None
    assert timed.attrs == {}
    top = [r.name for r in store.children(timed)]
    assert top[:4] == ["forward.layer0.aggregate", "forward.layer0.epsilon",
                       "forward.layer0.gemm", "forward.layer0.relu"]
    assert top[-4:] == ["forward.log_softmax", "loss", "backward", "adam"]
    inside = store.descendants(timed)
    names = [r.name for r in inside]
    # five forward aggregations; the backward runs four (x needs none)
    assert names.count("aggregate.tiers") == 9
    assert names.count("aggregate.passes") == 18
    backward = store.latest("backward")
    assert [r.name for r in store.children(backward)].count(
        "aggregate.tiers") == 4
    assert all(r.device_s is None for r in inside)
    for name in ("model_ms", "agg_passes_ms"):
        assert reader(name).read(ctx(on_card=False)) is None
        assert reader(name).read(ctx(on_card=True)) is None
    # one step alone is not timed
    train.warm_up(step, 1, torch.device("cpu"))
    assert store.latest(train.TIMED_STEP) is timed


# --- the set-up spans ------------------------------------------------------

def test_set_up_spans_and_their_readers(store, tmp_path):
    g = synthesize_graph(6000, 48000, num_features=8, num_classes=3, seed=3)
    path = str(tmp_path / "g.npz")
    np.savez(path, src_li=g.edge_index[0], dst_li=g.edge_index[1],
             num_nodes=g.num_nodes)
    loaded = load_graph(path, num_features=8, num_classes=3)
    prop = InputProperty(loaded, hidden_dim=8, probe=False)
    prop.decider().build_tensors(device="cpu")
    load = store.latest("graph.load")
    assert [r.name for r in store.children(load)] == ["graph.parse",
                                                      "graph.csr"]
    decider = store.latest("decider")
    assert [r.name for r in store.children(decider)] == [
        "decider.choose_tiers"]
    layout = store.latest("layout")
    assert [r.name for r in store.children(layout)] == [
        "layout.tiers", "layout.pack_slabs", "layout.residual_stream",
        "layout.to_device"]
    assert reader("load_s").read(ctx()) == load.seconds
    tiers = store.latest("layout.tiers").seconds + store.latest(
        "decider.choose_tiers").seconds
    assert reader("tier_choice_s").read(ctx()) == pytest.approx(tiers)
    pack = sum(store.latest(n).seconds for n in (
        "layout.pack_slabs", "layout.residual_stream", "layout.to_device"))
    assert reader("layout_pack_s").read(ctx()) == pytest.approx(pack)
    assert store.self_s(layout) < layout.seconds


def test_a_probe_counts_its_runs_and_its_layouts_nest_under_it(
        store, monkeypatch, tmp_path):
    from gnnadvisor_osdi21_tpu_torch.graphs import hybrid

    monkeypatch.setenv(hybrid.CACHE_DIR_ENV, str(tmp_path))
    monkeypatch.setattr(hybrid, "_probe_spmm_time", lambda hg, dev: 1.0)
    g = synthesize_graph(10000, 120000, num_features=8, num_classes=3)
    prop = InputProperty(g, hidden_dim=8, probe=True).decider()
    prop.build_tensors(device="cpu")
    runs = store.counters["probe.runs"]
    assert runs >= 2 and "probe.cache_hits" not in store.counters
    layout = store.latest("layout")
    probe = [r for r in store.children(layout) if r.name == "layout.probe"]
    assert len(probe) == 1 and probe[0].attrs["tiers"].startswith("timed")
    # the candidates' own layouts sit inside the probe, not beside it
    assert [r.name for r in store.children(layout)].count("layout.tiers") == 1
    assert "layout.tiers" in [r.name for r in store.descendants(probe[0])]
    InputProperty(g, hidden_dim=8, probe=True).decider().build_tensors(
        device="cpu")
    assert store.counters["probe.cache_hits"] == 1
    assert store.counters["probe.runs"] == runs


# --- the readers on a store filled by hand ---------------------------------

def _rec(store, name, parent=None, start=0, end=0, device_s=None):
    rec = profiling.Record(next(store._ids), name, {})
    rec.parent = None if parent is None else parent.id
    rec.start_ns, rec.end_ns, rec.device_s = start, end, device_s
    store.records.append(rec)
    store.closed += 1
    return rec


def test_the_set_up_readers_on_a_store_filled_by_hand(store):
    s = 1_000_000_000
    load = _rec(store, "graph.load", None, 0, 3 * s)
    _rec(store, "graph.parse", load, 0, 1 * s)
    dec = _rec(store, "decider", None, 3 * s, 5 * s)
    _rec(store, "decider.choose_tiers", dec, 3 * s, 4 * s)
    lay = _rec(store, "layout", None, 5 * s, 20 * s)
    _rec(store, "layout.tiers", lay, 5 * s, 9 * s)
    probe = _rec(store, "layout.probe", lay, 9 * s, 12 * s)
    _rec(store, "layout.tiers", probe, 9 * s, 10 * s)  # a candidate's
    _rec(store, "layout.pack_slabs", probe, 10 * s, 11 * s)
    _rec(store, "layout.pack_slabs", lay, 12 * s, 14 * s)
    _rec(store, "layout.residual_stream", lay, 14 * s, 17 * s)
    _rec(store, "layout.to_device", lay, 17 * s, 19 * s)
    assert reader("load_s").read(ctx()) == 3.0
    assert reader("tier_choice_s").read(ctx()) == 1.0 + 4.0 + 3.0
    assert reader("layout_pack_s").read(ctx()) == 2.0 + 3.0 + 2.0
    assert store.self_s(lay) == 1.0


def test_the_step_readers_on_a_store_filled_by_hand(store):
    step = _rec(store, train.TIMED_STEP, None, 0, 10, device_s=0.0100)
    agg = _rec(store, "forward.layer0.aggregate", step, 0, 1, 0.0030)
    _rec(store, "aggregate.passes", agg, 0, 1, 0.0005)
    _rec(store, "aggregate.tiers", agg, 0, 1, 0.0020)
    _rec(store, "aggregate.passes", agg, 0, 1, 0.0005)
    _rec(store, "forward.layer0.gemm", step, 1, 2, 0.0010)
    _rec(store, "loss", step, 2, 3, 0.0002)
    bwd = _rec(store, "backward", step, 3, 4, 0.0040)
    _rec(store, "aggregate.passes", bwd, 3, 4, 0.0006)
    _rec(store, "aggregate.tiers", bwd, 3, 4, 0.0025)
    _rec(store, "adam", step, 4, 5, 0.0008)
    model = reader("model_ms").read(ctx())
    assert model == pytest.approx(1e3 * (0.0030 + 0.0010 + 0.0002 + 0.0040
                                         + 0.0008 - 0.0045 - 0.0008))
    assert reader("agg_passes_ms").read(ctx()) == pytest.approx(1.6)
    assert reader("model_ms").read(ctx(on_card=False)) is None


@pytest.mark.parametrize("name", NEW_METRICS)
def test_the_readers_give_nothing_without_the_store(name, monkeypatch):
    """A program without the store (an older checkout) reads as None."""
    monkeypatch.delattr(profiling, "STORE")
    assert reader(name).read(ctx()) is None


@pytest.mark.parametrize("name", NEW_METRICS)
def test_the_readers_give_nothing_from_an_empty_store(name, store):
    assert reader(name).read(ctx()) is None


def test_the_new_metrics_are_benchmark_entries():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW_METRICS:
        m = per_layer[name]
        assert m["source"] == "program_span" and "workloads" not in m
        assert m["moves"] == ("epoch_ms" if name.endswith("_ms")
                              else "setup_s")
        assert os.path.exists(os.path.join(METRICS, f"{name}.py"))


# --- the CLI's print and the harness's line -------------------------------

def test_the_clis_verbose_print_shows_the_set_up_tree(tmp_path, capsys):
    g = synthesize_graph(900, 9000, num_features=8, num_classes=3, seed=4)
    np.savez(tmp_path / "g.npz", src_li=g.edge_index[0],
             dst_li=g.edge_index[1], num_nodes=g.num_nodes)
    rc = cli_main(["--dataDir", str(tmp_path), "--dataset", "g", "--dim", "8",
                   "--hidden", "8", "--classes", "3", "--num_epoches", "2",
                   "--manual_mode", "False", "--method", "hybrid",
                   "--verbose_mode", "True", "--platform", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and out[-1].startswith("Time (ms): ")
    at = out.index("# set-up spans (seconds, self seconds):")
    tree = [line[4:] for line in out[at + 1:] if line.startswith("#   ")]
    roots = [line.split(":")[0] for line in tree if not line.startswith(" ")]
    assert roots == ["graph.load", "decider", "layout", "model.init",
                     "optimizer.init"]
    assert any(line.startswith("  layout.tiers: ") for line in tree)
    assert any(line.startswith("# counters: ") for line in out)
    assert any(line.startswith("# Loading (s): ") for line in out)


def test_the_clis_verbose_print_shows_the_gat_set_up_tree(tmp_path, capsys):
    """GAT's set-up through the CLI: the census sorted once under
    ``decider``, the edge layout under ``layout``; and only this run's
    spans, after another run in the same process."""
    g = synthesize_graph(900, 9000, num_features=8, num_classes=3, seed=4)
    np.savez(tmp_path / "g.npz", src_li=g.edge_index[0],
             dst_li=g.edge_index[1], num_nodes=g.num_nodes)
    argv = ["--dataDir", str(tmp_path), "--dataset", "g", "--dim", "8",
            "--hidden", "4", "--classes", "3", "--num_epoches", "2",
            "--manual_mode", "False", "--platform", "cpu"]
    assert cli_main(argv + ["--method", "hybrid"]) == 0
    capsys.readouterr()
    rc = cli_main(argv + ["--model", "gat", "--heads", "2", "--out_heads",
                          "2", "--verbose_mode", "True"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and out[-1].startswith("Time (ms): ")
    at = out.index("# set-up spans (seconds, self seconds):")
    tree = [line[4:] for line in out[at + 1:] if line.startswith("#   ")]
    roots = [line.split(":")[0] for line in tree if not line.startswith(" ")]
    assert roots == ["graph.load", "decider", "layout", "model.init",
                     "optimizer.init"]
    names = [line.split(":")[0] for line in tree]
    layout = names.index("layout")
    assert names[layout + 1:layout + 3] == ["  layout.edges",
                                            "  layout.to_device"]
    decider = names.index("decider")
    assert names[decider + 1:decider + 3] == ["  decider.census",
                                              "    census.sort"]
    counters = next(line for line in out if line.startswith("# counters: "))
    assert "attn.heads 4" in counters and "census.sorts" in counters
    assert any(line.startswith("# attention layout: ") for line in out)


def test_the_edge_layout_reader_on_a_store_filled_by_hand(store):
    s = 1_000_000_000
    lay = _rec(store, "layout", None, 0, 5 * s)
    _rec(store, "layout.edges", lay, 0, 3 * s)
    _rec(store, "layout.to_device", lay, 3 * s, 4 * s)
    assert reader("edge_layout_s").read(ctx()) == 3.0
    assert reader("layout_pack_s").read(ctx()) == 1.0
    assert reader("tier_choice_s").read(ctx()) is None  # no decider
    _rec(store, "decider", None, 0, s)
    assert reader("tier_choice_s").read(ctx()) == 0.0


@pytest.mark.parametrize("case", ["no store", "empty store", "no edges"])
def test_the_edge_layout_reader_gives_nothing_where_nothing_was_built(
        case, store, monkeypatch):
    if case == "no store":
        monkeypatch.delattr(profiling, "STORE")
    elif case == "no edges":  # a hybrid layout
        lay = _rec(store, "layout", None, 0, 5)
        _rec(store, "layout.pack_slabs", lay, 0, 3)
    assert reader("edge_layout_s").read(ctx()) is None


def _harness_conftest():
    spec = importlib.util.spec_from_file_location(
        "gnnbench_tests_conftest",
        os.path.join(ROOT, "gnnbench", "tests", "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", ["gcn.tiny", "gin.tiny"])
def test_a_traced_harness_run_carries_the_set_up_metrics(cell, tmp_path):
    """``gnnbench.run --trace 1`` on the harness's tiny cells, on the host,
    in a process of its own (the harness refuses a process that loaded
    JAX): the line carries the set-up's span metrics, and not the card's
    step metrics."""
    root = _harness_conftest().copy_harness(str(tmp_path / "checkout"))
    code = ("import sys; from gnnbench import run; "
            "sys.exit(run.main(sys.argv[1:], device='cpu'))")
    res = subprocess.run(
        [sys.executable, "-c", code, "--workload", cell, "--seed",
         "3000000037", "--seconds", "0.2", "--trace", "1"],
        cwd=root, env=dict(os.environ,
                           PYTHONPATH=os.pathsep.join([root, ROOT])),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    metrics = line["metrics"]
    for name in ("load_s", "tier_choice_s", "layout_pack_s"):
        assert metrics[name]["unit"] == "s"
        assert metrics[name]["value"] > 0
    covered = metrics["tier_choice_s"]["value"] + metrics[
        "layout_pack_s"]["value"]
    assert covered <= metrics["layout_s"]["value"]
    assert "model_ms" not in metrics and "agg_passes_ms" not in metrics
