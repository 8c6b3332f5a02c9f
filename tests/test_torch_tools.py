"""The port's tools and multi-device drivers (``tools/reorder.py``,
``bench/bench_scaling.py``, ``tools/ogb_scale_demo.py``,
``tools/overlap_ablation.py``, ``tools/multihost_demo.py``) on the host,
against the JAX package's twins where those run on the CPU, and against a
group of gloo ranks (``parallel.mesh.run_ranks``) running the same steps.

Tolerances: the reorder's permutation and communities exactly, its
modularity within 1e-12; the plan statistics exactly; the layout and
exchange lines equal with their times masked; the ablation's two arms
bitwise, every rank's loss equal, and the losses within rtol 1e-6 of the
gloo group's (the demo prints 9 significant digits).
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu.graphs.loader import (
    synthesize_graph as jax_synthesize,
)
from gnnadvisor_osdi21_tpu.graphs.reorder import (
    rabbit_reorder_graph as jax_reorder,
)
from gnnadvisor_osdi21_tpu.parallel.partition import shard_graph as jax_shard
from gnnadvisor_osdi21_tpu.tools import ogb_scale_demo as jax_ogb
from gnnadvisor_osdi21_tpu.tools import reorder as jax_reorder_tool
from gnnadvisor_osdi21_tpu_torch.bench import bench_scaling
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.graphs.reorder import rabbit_reorder_graph
from gnnadvisor_osdi21_tpu_torch.parallel import dist_hybrid, dist_ops, mesh
from gnnadvisor_osdi21_tpu_torch.parallel.hybrid_partition import (
    shard_graph_hybrid,
)
from gnnadvisor_osdi21_tpu_torch.parallel.partition import shard_graph
from gnnadvisor_osdi21_tpu_torch.tools import (
    multihost_demo, ogb_scale_demo, overlap_ablation, reorder,
)

LOSS_RTOL = 1e-6
RANKS = 2
JOIN_TIMEOUT_S = 120
# the ablation's graph, cut to a few thousand nodes, with a diagonal tier
ABLATION = dict(nodes=3000, edges=36000, epochs=2, diag_b=512)


def _lines(fn, argv, err: bool = False) -> list[str]:
    out, errs = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(errs):
        assert fn(argv) == 0
    return (errs if err else out).getvalue().splitlines()


# --- tools/reorder -------------------------------------------------------


def _graph_40(path):
    """tests/test_cli.py::test_reorder_tool's graph: 200 random pairs over
    40 nodes."""
    rng = np.random.default_rng(0)
    lines = [f"{a} {b}" for a, b in (rng.integers(0, 40, 2)
                                     for _ in range(200))]
    path.write_text("\n".join(lines) + "\n")


def _graph_3000(path):
    g = synthesize_graph(3000, 20000, kind="community", seed=2)
    path.write_text("\n".join(f"{s} {d}" for s, d in g.edge_index.T) + "\n")


@pytest.fixture(params=[_graph_40, _graph_3000], ids=["40", "3000"])
def text_graph(request, tmp_path):
    path = tmp_path / "g.txt"
    request.param(path)
    return str(path)


def test_reorder_permutation_matches_jax(text_graph):
    mine = _lines(reorder.main, [text_graph])
    assert mine == _lines(jax_reorder_tool.main, [text_graph])
    assert sorted(int(v) for v in mine) == list(range(len(mine)))


def test_reorder_communities_match_jax(text_graph):
    from gnnadvisor_osdi21_tpu.graphs.loader import load_graph as jax_load

    from gnnadvisor_osdi21_tpu_torch.graphs.loader import load_graph

    g, jg = load_graph(text_graph), jax_load(text_graph)
    comm, q = reorder.communities_and_modularity(g.edge_index, g.num_nodes)
    jcomm, jq = jax_reorder_tool.communities_and_modularity(jg.edge_index,
                                                            jg.num_nodes)
    np.testing.assert_array_equal(comm, jcomm)
    assert abs(q - jq) <= 1e-12 and comm.max() < g.num_nodes - 1
    assert _lines(reorder.main, ["-c", text_graph]) == _lines(
        jax_reorder_tool.main, ["-c", text_graph])
    assert _lines(reorder.main, ["-c", text_graph], err=True) == [
        f"modularity: {q:.6f}"]


# --- bench/bench_scaling -------------------------------------------------


def test_bench_scaling_plan_statistics_match_jax():
    """``--devices 1,2,4`` on gloo ranks: a CSV row per count whose
    ``halo_rows`` and ``interior_frac`` are the JAX tool's statistics of
    the JAX ``shard_graph`` on the same reordered graph, exactly."""
    nodes, edges, dim = 3000, 30000, 16
    lines = []
    rows = bench_scaling.run([4, 1, 2], nodes, edges, dim, epochs=1,
                             device="cpu", log=lines.append)
    jg = jax_reorder(jax_synthesize(nodes, edges, num_features=dim,
                                    num_classes=16, kind="web", seed=0))
    assert [r["devices"] for r in rows] == [1, 2, 4]
    for row in rows:
        sg = jax_shard(jg, num_devices=row["devices"])
        interior = float(sg.int_lens.sum()) / max(
            float(sg.int_lens.sum() + sg.bnd_lens.sum()), 1.0)
        assert (row["halo_rows"], row["interior_frac"]) == (sg.halo, interior)
        assert len(set(row["loss"])) == 1 and np.isfinite(row["loss"][0])
        csv = [ln for ln in lines if ln.startswith(f"{row['devices']},")]
        assert len(csv) == 1 and csv[0].endswith(
            f",{sg.halo},{interior:.3f}")
    assert lines[0].startswith("# --device cpu: gloo ranks step by step")
    assert "devices,epoch_ms,edges_per_s,halo_rows,interior_frac" in lines
    model = [ln for ln in lines if ln.startswith("  model nd=")]
    assert len(model) == 3 and all("NVLink data-sheet rate" in ln
                                   for ln in model)


def test_bench_scaling_refuses_more_ranks_than_cards(capsys):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert bench_scaling.main(["--devices", f"1,{have + 1}"]) == 2
    assert f"need {have + 1} CUDA cards (one per rank), have {have}" in (
        capsys.readouterr().err)


# --- tools/ogb_scale_demo ------------------------------------------------


def test_ogb_scale_demo_layout_matches_jax(monkeypatch):
    """At 20,000 nodes (the smallest of these web graphs whose layout has
    a residual tier) with ``--shard_devices 2,4``: the synthesis, layout
    and exchange-row lines equal the JAX tool's, times masked; the port
    prints its own plan bytes where the JAX tool prints its TPU and CPU
    mesh plans."""
    monkeypatch.setattr("gnnadvisor_osdi21_tpu.utils.cache."
                        "enable_compile_cache", lambda *a, **k: None)
    argv = ["--nodes", "20000", "--edges", "250000", "--epochs", "1",
            "--shard_devices", "2,4"]
    mine = _lines(ogb_scale_demo.main, argv + ["--device", "cpu"])
    theirs = _lines(jax_ogb.main, argv)
    seconds = re.compile(r"\s*[0-9.]+s\b")

    def kept(lines):
        return [seconds.sub(" #s", ln.split(" | plan bytes")[0])
                for ln in lines
                if ln.startswith(("synthesize:", "rabbit reorder:",
                                  "hybrid build:", "shard plan nd="))]

    assert kept(mine) == kept(theirs) and len(kept(mine)) == 5
    assert "res=0 " not in kept(mine)[2]
    plans = [ln for ln in mine if ln.startswith("shard plan nd=")]
    g = rabbit_reorder_graph(synthesize_graph(20000, 250000, num_features=100,
                                              num_classes=47, kind="web"))
    for nd, ln in zip((2, 4), plans):
        sg = shard_graph_hybrid(g, num_devices=nd)
        want = max(dist_ops.halo_plan(sg, r, "cpu").send_rows.numel()
                   for r in range(nd)) * 8 + 2 * nd * 8
        assert ln.endswith(f"plan bytes/dev {want:,} (send_rows and the "
                           "split lists)")
    assert ("SpMM dim=16 on all-ones x: each row's sum equals its degree: "
            "exact") in mine
    assert mine[0].startswith("# device: cpu")


# --- the ablation and the multi-host demo on gloo ranks ------------------


def _reference_rank(group, sg_hybrid, x, y, classes, steps, demo, out_dir):
    """The ablation's step (overlap on) and the demo's ELL step, each from
    the tools' weights, run by a ``run_ranks`` group: every step's loss."""
    g = demo
    res = {}
    step, init = dist_hybrid.make_dist_train_step(group, sg_hybrid, "gcn")
    net, opt, xb, yb = init(torch.Generator().manual_seed(0),
                            overlap_ablation.DIM, overlap_ablation.HIDDEN,
                            classes, x, y)
    res["ablation"] = np.asarray(
        [float(step(net, opt, xb, yb)) for _ in range(steps)])
    sg = shard_graph(g, num_devices=group.world, part_size=4)
    step, init = dist_ops.make_dist_train_step(group, sg, "gcn")
    net, opt, xb, yb = init(torch.Generator().manual_seed(0), 16, 16,
                            g.num_classes, g.init_embedding(16),
                            g.init_labels(g.num_classes))
    res["demo"] = np.asarray([float(step(net, opt, xb, yb))
                              for _ in range(multihost_demo.STEPS)])
    np.savez(os.path.join(out_dir, f"rank{group.rank}.npz"), **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One spawn of RANKS gloo ranks: both tools' steps."""
    g = rabbit_reorder_graph(synthesize_graph(
        ABLATION["nodes"], ABLATION["edges"], num_features=32, num_classes=8,
        kind="community", seed=5))
    sg = shard_graph_hybrid(g, num_devices=RANKS, diag_b=ABLATION["diag_b"])
    demo = synthesize_graph(64 * RANKS, 512 * RANKS, num_features=16,
                            num_classes=5, seed=1)
    out = str(tmp_path_factory.mktemp("reference"))
    steps = overlap_ablation.WARMUP + ABLATION["epochs"]
    mesh.run_ranks(_reference_rank, RANKS, "cpu", args=(
        sg, g.init_embedding(32, seed=0), g.init_labels(g.num_classes),
        g.num_classes, steps, demo, out), timeout=JOIN_TIMEOUT_S)
    per = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
           for r in range(RANKS)]
    for p in per[1:]:
        for key in p:
            np.testing.assert_array_equal(p[key], per[0][key])
    return per[0]


def test_overlap_ablation_arms_agree(reference):
    lines = []
    res = overlap_ablation.run(devices=RANKS, device="cpu", log=lines.append,
                               **ABLATION)
    assert res["diag_b"] == ABLATION["diag_b"]
    arms = res["losses"]
    assert arms[True] == arms[False]  # bitwise: one program, two orders
    assert all(r == arms[True][0] for r in arms[True])  # every rank's
    np.testing.assert_allclose(arms[True][0], reference["ablation"],
                               rtol=LOSS_RTOL)
    assert len(arms[True][0]) == overlap_ablation.WARMUP + ABLATION["epochs"]
    assert [ln.split(":")[0] for ln in lines if ln.startswith("overlap=")] \
        == ["overlap=True", "overlap=False"]
    assert lines[-1].startswith("exchange time hidden behind the diagonal "
                                "tier: ")
    assert any("2 gloo ranks, step by step" in ln for ln in lines)


def test_overlap_ablation_says_when_it_measures_nothing(monkeypatch):
    """A layout without a diagonal tier: the ``#`` line says so (the ranks
    are not run here)."""
    monkeypatch.setattr("gnnadvisor_osdi21_tpu_torch.parallel.mesh."
                        "run_ranks", _no_ranks)
    lines = []
    with pytest.raises(_Stopped):
        overlap_ablation.run(devices=RANKS, device="cpu", log=lines.append,
                             nodes=3000, edges=36000, diag_b=0)
    assert "diag_b=0 " in lines[0]
    assert lines[1].startswith("# the layout has no diagonal tier")


class _Stopped(Exception):
    pass


def _no_ranks(*args, **kwargs):
    raise _Stopped


def test_multihost_demo_on_gloo(reference):
    lines = []
    res = multihost_demo.run(RANKS, 1, "cpu", log=lines.append)
    assert res["ok"] and res["rcs"] == [0] * RANKS
    assert len(set(res["losses"])) == 1
    np.testing.assert_allclose(res["losses"][0], reference["demo"][-1],
                               rtol=LOSS_RTOL)
    assert lines[-1] == "multihost demo: OK"
    assert [ln.split("]")[0] for ln in lines if "loss after" in ln] == [
        "[host 0", "[host 1"]


def test_multihost_demo_needs_a_card_per_rank(capsys):
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert multihost_demo.main(["--hosts", str(have + 1),
                                "--local_devices", "1"]) == 2
    assert f"need {have + 1} CUDA cards (one per rank), have {have}" in (
        capsys.readouterr().err)
