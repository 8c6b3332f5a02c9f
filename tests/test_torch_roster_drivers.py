"""The roster drivers (``bench/campaign.py``, ``bench_models.py``,
``studies.py``, ``verify_all.py``, ``baseline_campaign.py``), the
scrapers (``log2csv``, ``study2csv``, ``roster2md``), the baselines
(``baselines/naive.py``, ``torch_baseline.py``) and the headline's
campaign quiesce, against the JAX package's on the CPU.  Child runs are
stubbed: ``subprocess.run`` records each command and writes a canned
log, so the drivers' configs, commands, resume and assembly are compared
without running a model."""

import contextlib
import io
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu.baselines import jax_naive
from gnnadvisor_osdi21_tpu.baselines import torch_baseline as jax_tb
from gnnadvisor_osdi21_tpu.bench import baseline_campaign as jax_bc
from gnnadvisor_osdi21_tpu.bench import bench_models as jax_bench_models
from gnnadvisor_osdi21_tpu.bench import campaign as jax_campaign
from gnnadvisor_osdi21_tpu.bench import log2csv as jax_log2csv
from gnnadvisor_osdi21_tpu.bench import roster2md as jax_roster2md
from gnnadvisor_osdi21_tpu.bench import studies as jax_studies
from gnnadvisor_osdi21_tpu.bench import study2csv as jax_study2csv
from gnnadvisor_osdi21_tpu.bench import verify_all as jax_verify_all
from gnnadvisor_osdi21_tpu.graphs.loader import (
    synthesize_graph as jax_synthesize_graph,
)
from gnnadvisor_osdi21_tpu.models import gcn_apply, gin_apply
from gnnadvisor_osdi21_tpu.ops.graph_tensors import (
    build_graph_tensors as jax_build_graph_tensors,
)
from gnnadvisor_osdi21_tpu_torch import cli
from gnnadvisor_osdi21_tpu_torch.baselines import naive, torch_baseline
from gnnadvisor_osdi21_tpu_torch.bench import (
    baseline_campaign, bench_models, campaign, headline, log2csv, roster2md,
    studies, study2csv, verify_all,
)
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import CACHE_DIR_ENV
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = os.path.join(ROOT, "logs")  # the JAX campaign's tracked records
JAX_PKG, PORT_PKG = "gnnadvisor_osdi21_tpu", "gnnadvisor_osdi21_tpu_torch"


@pytest.fixture(autouse=True)
def _port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_DIR_ENV, str(tmp_path / "port_cache"))


def _as_port(cmd: list[str]) -> list[str]:
    """A JAX driver's command with the JAX package's module names renamed
    to the port's."""
    out = []
    for a in cmd:
        if a == JAX_PKG or a.startswith(JAX_PKG + "."):
            a = PORT_PKG + a[len(JAX_PKG):]
        out.append(a.replace("baselines.jax_naive", "baselines.naive"))
    return out


class Children:
    """``subprocess.run`` stand-in: records each command and answers with
    a canned log (``Time (ms):`` unless the command's dataset is in
    ``fail``) on the run's stdout, as a real CLI run would."""

    def __init__(self, fail=()):
        self.cmds, self.fail = [], set(fail)

    def __call__(self, cmd, stdout=None, stderr=None, timeout=None, **kw):
        self.cmds.append(list(cmd))
        ds = cmd[cmd.index("--dataset") + 1] if "--dataset" in cmd else "?"
        text = f"Namespace(dataset='{ds}', agg_dtype='bfloat16')\n"
        if ds not in self.fail:
            text += f"Time (ms): {len(self.cmds)}.250\n"
        if stdout is None:
            sys.stdout.write(text)
        else:
            stdout.write(text)
        return subprocess.CompletedProcess(cmd, 1 if ds in self.fail else 0)


def _out(fn, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _files(root: str) -> dict[str, bytes]:
    found = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as fp:
                found[os.path.relpath(p, root)] = fp.read()
    return found


# --- the scrapers ------------------------------------------------------


def _port_cpu_log(tmp_path) -> str:
    """A real port CLI log (``--platform cpu``), with its note line."""
    _, text = _out(cli.main, [
        "--synthetic", "600:5000:community", "--manual_mode", "False",
        "--num_epoches", "2", "--platform", "cpu"])
    path = tmp_path / "port_cpu.log"
    path.write_text(text)
    return str(path)


def test_log2csv_byte_identical(tmp_path):
    """The JAX roster logs and a real port ``--platform cpu`` log through
    both scrapers: the same CSV bytes.  The port's note line holds ``Time
    (ms)`` without a colon and is not scraped: one row, the real time."""
    cpu_log = _port_cpu_log(tmp_path)
    with open(cpu_log) as fp:
        text = fp.read()
    assert "# --platform cpu: Time (ms) below" in text
    for src in (os.path.join(LOGS, "gcn.log"), os.path.join(LOGS, "gin.log"),
                cpu_log):
        for name, mod in (("jax", jax_log2csv), ("port", log2csv)):
            d = tmp_path / name
            d.mkdir(exist_ok=True)
            shutil.copy(src, d / "run.log")
            _out(mod.main, [str(d / "run.log")])
        assert (tmp_path / "port" / "run.csv").read_bytes() == \
            (tmp_path / "jax" / "run.csv").read_bytes()
    rows = (tmp_path / "port" / "run.csv").read_text().splitlines()
    want = text.strip().splitlines()[-1].split("Time (ms):")[1].strip()
    assert rows == ["dataset,Avg.Epoch (ms)", f"synthetic,{want}"]


@pytest.mark.parametrize("study", ["reorder", "partsize", "dimtile", "hidden"])
def test_study2csv_byte_identical(tmp_path, study):
    for name, mod in (("jax", jax_study2csv), ("port", study2csv)):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(os.path.join(LOGS, f"study_{study}.log"), d / "s.log")
        _out(mod.main, [str(d / "s.log")])
    got = (tmp_path / "port" / "s.csv").read_bytes()
    assert got == (tmp_path / "jax" / "s.csv").read_bytes()
    assert got.count(b"\n") > 1


def test_roster2md_byte_identical(tmp_path):
    """Both of the JAX campaign's assembled rosters (its CSVs, and the
    agg_dtype scraped from the CLI's Namespace echo): the same
    markdown."""
    for log_dir in (LOGS, os.path.join(LOGS, "r3_assembled")):
        rc, mine = _out(roster2md.main, [log_dir])
        rc2, theirs = _out(jax_roster2md.main, [log_dir])
        assert rc == rc2 == 0 and mine == theirs
        assert mine.count("\n| GCN") == 15 and "| bfloat16 |" in mine


# --- configs and commands ----------------------------------------------


@pytest.mark.parametrize("quick", [True, False])
def test_campaign_configs_match_jax(quick, monkeypatch):
    monkeypatch.setattr(jax_campaign, "SMOKE_ARGS", [])
    mine = list(campaign.roster_configs(quick))
    theirs = list(jax_campaign.roster_configs(quick))
    assert [(t, m, c) for t, m, c in mine] == [
        (t, m, _as_port(c)) for t, m, c in theirs]
    assert len(mine) == (6 if quick else 30)
    mine = list(campaign.study_configs(quick))
    theirs = list(jax_campaign.study_configs(quick))
    assert mine == [(t, s, _as_port(c), h) for t, s, c, h in theirs]


@pytest.mark.parametrize("quick", [True, False])
def test_baseline_configs_match_jax(quick):
    mine = list(baseline_campaign.configs(quick, None))
    theirs = list(jax_bc.configs(quick, None))
    assert mine == [(t, b, m, n, _as_port(c)) for t, b, m, n, c in theirs]
    assert len(mine) == (12 if quick else 60)
    assert list(baseline_campaign.configs(True, "naive"))[0][-1][2] == \
        "gnnadvisor_osdi21_tpu_torch.baselines.naive"


@pytest.mark.parametrize("driver,argv", [
    ("bench_models", ["gcn", "--quick"]),
    ("bench_models", ["gin"]),
    ("verify_all", ["--quick"]),
    ("verify_all", ["--agg_dtype", "float32", "--platform", "cpu"]),
    ("studies", ["partsize", "--quick"]),
    ("studies", ["dimtile"]),
    ("studies", ["reorder", "--quick"]),
    ("studies", ["hidden", "--quick"]),
])
def test_spawning_drivers_match_jax(driver, argv, monkeypatch):
    """The same commands, in order, and the same lines printed (the
    children's canned output included)."""
    port_mod = {"bench_models": bench_models, "verify_all": verify_all,
                "studies": studies}[driver]
    jax_mod = {"bench_models": jax_bench_models, "verify_all": jax_verify_all,
               "studies": jax_studies}[driver]
    runs = {}
    for name, mod in (("port", port_mod), ("jax", jax_mod)):
        kids = Children()
        monkeypatch.setattr(mod.subprocess, "run", kids)
        rc, out = _out(mod.main, argv)
        runs[name] = (rc, out, kids.cmds)
    assert runs["port"][0] == runs["jax"][0] == 0
    assert runs["port"][2] == [_as_port(c) for c in runs["jax"][2]]
    assert runs["port"][1] == runs["jax"][1] and runs["port"][2]


@pytest.mark.parametrize("driver,argv", [
    ("bench_models", ["gcn", "--quick"]),
    ("studies", ["hidden", "--quick"]),
    ("verify_all", ["--quick"]),
])
def test_a_failed_child_fails_the_run(driver, argv, monkeypatch):
    """A child that exits non-zero: the port's driver exits 1 and names
    it.  The JAX ``bench_models`` and ``studies`` ignore their children's
    exit codes and return 0 (a difference kept on purpose: on the card it
    would hide a failed run); its ``verify_all`` fails as the port's."""
    fail = "cora" if driver != "studies" else "amazon0505"
    port_mod = {"bench_models": bench_models, "verify_all": verify_all,
                "studies": studies}[driver]
    jax_mod = {"bench_models": jax_bench_models, "verify_all": jax_verify_all,
               "studies": jax_studies}[driver]
    monkeypatch.setattr(port_mod.subprocess, "run", Children(fail=[fail]))
    rc, out = _out(port_mod.main, argv)
    assert rc == 1 and "FAILED" in out and fail in out.splitlines()[-1]
    monkeypatch.setattr(jax_mod.subprocess, "run", Children(fail=[fail]))
    rc, _ = _out(jax_mod.main, argv)
    assert rc == (1 if driver == "verify_all" else 0)


# --- campaign runs, resume and assembly ---------------------------------


def test_campaign_assembles_jax_csvs(tmp_path, monkeypatch):
    """The JAX campaign's tracked per-run logs (``logs/runs_r2``: the full
    roster and some study arms) assembled by both drivers: the same
    protocol logs and CSVs, byte for byte."""
    for name in ("jax", "port"):
        shutil.copytree(os.path.join(LOGS, "runs_r2"), tmp_path / name / "runs")
    monkeypatch.setattr(jax_campaign, "LOG_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(jax_campaign, "RUN_DIR", str(tmp_path / "jax" / "runs"))
    _out(lambda a: jax_campaign._assemble(False), [])
    _out(lambda a: campaign._assemble(False, str(tmp_path / "port")), [])
    mine, theirs = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert mine == theirs
    assert {"gcn.csv", "gin.csv", "roster.csv", "study_reorder.csv"} <= set(mine)
    assert mine["roster.csv"].count(b"\n") == 31


def test_baseline_assembly_matches_jax(tmp_path, monkeypatch):
    """The JAX baseline campaign's tracked logs and roster through both
    assemblies: ``baselines.csv`` byte for byte; ``speedups.csv`` with the
    JAX rows and values, the card's column names, and the device the
    baselines' logs record (none in the JAX logs: empty)."""
    for name in ("jax", "port"):
        shutil.copytree(os.path.join(LOGS, "baseline_runs"),
                        tmp_path / name / "baseline_runs")
        shutil.copy(os.path.join(LOGS, "roster.csv"), tmp_path / name)
    monkeypatch.setattr(jax_bc, "LOG_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(jax_bc, "RUN_DIR",
                        str(tmp_path / "jax" / "baseline_runs"))
    _out(lambda a: jax_bc.assemble(False), [])
    _out(lambda a: baseline_campaign.assemble(False, str(tmp_path / "port")),
         [])
    read = lambda n, f: (tmp_path / n / f).read_text().splitlines()
    assert read("port", "baselines.csv") == read("jax", "baselines.csv")
    mine, theirs = read("port", "speedups.csv"), read("jax", "speedups.csv")
    assert mine[0] == ("model,dataset,tuned_ms,naive_ms,torch_ms,"
                       "speedup_vs_naive,speedup_vs_torch,device")
    assert [r + "," for r in theirs[1:]] == mine[1:] and len(mine) == 31


def test_campaign_resumes_and_fails_on_a_failed_run(tmp_path, monkeypatch):
    """``--quick --only roster``: a finished run's log is skipped, the
    others run, a run that writes no time fails the campaign (exit 1,
    named), and the roster assembles from the finished ones; the pidfile
    is gone afterwards."""
    log_dir = tmp_path / "logs_here"
    (log_dir / "runs").mkdir(parents=True)
    (log_dir / "runs" / "roster_gcn_citeseer.log").write_text(
        "Namespace(dataset='citeseer', agg_dtype='bfloat16')\n"
        "Time (ms): 9.000\n")
    kids = Children(fail=["pubmed"])
    monkeypatch.setattr(campaign.subprocess, "run", kids)
    rc, out = _out(campaign.main, ["--quick", "--only", "roster",
                                   "--log_dir", str(log_dir)])
    assert rc == 1 and "[skip] roster_gcn_citeseer" in out
    assert "campaign FAILED: ['roster_gcn_pubmed', 'roster_gin_pubmed']" in out
    assert len(kids.cmds) == 5
    assert all(c[2] == PORT_PKG for c in kids.cmds)
    roster = (log_dir / "roster.csv").read_text().splitlines()
    assert roster == ["model,dataset,Avg.Epoch (ms)", "gcn,citeseer,9.000",
                      "gcn,cora,1.250", "gin,citeseer,3.250",
                      "gin,cora,4.250"]
    assert not os.path.exists(campaign.pidfile())


def test_drivers_write_only_under_ignored_paths(tmp_path, monkeypatch):
    """From an empty working directory: the campaign's ``--smoke`` sweep
    and ``--assemble-only``, and the baseline campaign's quick sweep,
    write only under ``chiprun_out/`` (git-ignored), never
    ``logs/`` or ``data/``; the smoke runs are host runs."""
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    kids = Children()
    monkeypatch.setattr(campaign.subprocess, "run", kids)  # both drivers'
    assert _out(campaign.main, ["--smoke"])[0] == 0
    assert _out(campaign.main, ["--assemble-only"])[0] == 0
    assert _out(baseline_campaign.main, ["--quick"])[0] == 0
    made = sorted(_files(str(work)))
    assert made and all(p.startswith("chiprun_out" + os.sep) for p in made)
    assert "chiprun_out/campaign/smoke/roster.csv" in made
    assert "chiprun_out/campaign/speedups.csv" in made
    smoke = [c for c in kids.cmds if c[2] == PORT_PKG]
    assert smoke and all(c[-4:] == ["--platform", "cpu", "--num_epoches", "3"]
                         for c in smoke)


# --- the headline's campaign quiesce -----------------------------------


def _sleeper(tmp_path, name: str) -> subprocess.Popen:
    """A process whose command line names ``name``."""
    script = tmp_path / f"{name}.py"
    script.write_text("import time\ntime.sleep(60)\n")
    return subprocess.Popen([sys.executable, str(script)])


@pytest.mark.parametrize("name,stopped", [("campaign", True),
                                          ("unrelated", False)])
def test_quiesce_stops_only_a_campaign(tmp_path, name, stopped):
    """The PID in the pidfile is stopped only when its command line names
    ``campaign``; a recycled PID running something else is left alone."""
    proc = _sleeper(tmp_path, name)
    try:
        os.makedirs(os.path.dirname(campaign.pidfile()), exist_ok=True)
        with open(campaign.pidfile(), "w") as fp:
            fp.write(f"campaign:{proc.pid}\n")
        time.sleep(0.2)  # the child's command line is in /proc
        headline._quiesce_campaign(max_wait_s=0)
        if stopped:
            assert proc.wait(timeout=30) != 0
        else:
            time.sleep(0.5)
            assert proc.poll() is None
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_quiesce_ignores_a_stale_pidfile(tmp_path):
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait(timeout=30)
    os.makedirs(os.path.dirname(campaign.pidfile()), exist_ok=True)
    with open(campaign.pidfile(), "w") as fp:
        fp.write(f"campaign:{proc.pid}\n")
    headline._quiesce_campaign(max_wait_s=0)  # nothing to stop: returns
    os.remove(campaign.pidfile())
    headline._quiesce_campaign(max_wait_s=0)  # no pidfile: returns


def test_quiesce_waits_for_the_campaign_run_only(tmp_path):
    """The wait ends when the stopped driver's own child has ended, and an
    unrelated ``-m gnnadvisor_osdi21_tpu_torch`` process (another
    checkout's run, say) does not hold it."""
    other = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)",
                              "-m gnnadvisor_osdi21_tpu_torch"])
    script = tmp_path / "campaign.py"
    script.write_text(
        "import subprocess, sys, time\n"
        "kid = subprocess.Popen([sys.executable, '-c',"
        " 'import time; time.sleep(2)'])\n"
        "print(kid.pid, flush=True)\n"
        "time.sleep(60)\n")
    proc = subprocess.Popen([sys.executable, str(script)],
                            stdout=subprocess.PIPE, text=True)
    try:
        kid = int(proc.stdout.readline())
        os.makedirs(os.path.dirname(campaign.pidfile()), exist_ok=True)
        with open(campaign.pidfile(), "w") as fp:
            fp.write(f"campaign:{proc.pid}\n")
        start = time.perf_counter()
        headline._quiesce_campaign(max_wait_s=30)
        assert time.perf_counter() - start < 20
        assert proc.wait(timeout=30) != 0
        fields = headline._stat(kid)
        assert fields is None or fields[0] == "Z"  # the child has ended
        assert other.poll() is None
    finally:
        os.remove(campaign.pidfile())
        for p in (proc, other):
            p.kill()
            p.wait(timeout=30)


# --- the baselines -----------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    return (synthesize_graph(500, 4000, num_features=12, num_classes=4,
                             kind="powerlaw", seed=9),
            jax_synthesize_graph(500, 4000, num_features=12, num_classes=4,
                                 kind="powerlaw", seed=9))


def _weights(model, dim, hidden, classes, seed=0) -> list[np.ndarray]:
    """The baselines' seeded init (``torch_baseline._init_weights``), as
    numpy arrays."""
    return [w.detach().numpy() for w in
            torch_baseline._init_weights(model, dim, hidden, classes, seed)]


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_torch_baseline_forward_matches_jax(graphs, model):
    """``forward_numpy`` equals the JAX package's torch baseline exactly
    (one torch program), and the JAX models on the ELL path within rtol
    1e-5 (of each output, plus 1e-5 of the largest)."""
    g, jg = graphs
    x = np.random.default_rng(0).standard_normal((g.num_nodes, 12),
                                                 dtype=np.float32)
    ws = _weights(model, 12, 8, 4, seed=1)
    mine = torch_baseline.forward_numpy(g, x, ws, model)
    np.testing.assert_array_equal(mine, jax_tb.forward_numpy(jg, x, ws, model))
    gt = jax_build_graph_tensors(jg, method="ell", part_size=4)
    params = {f"conv{i + 1}": jnp.asarray(w) for i, w in enumerate(ws)}
    apply = gcn_apply if model == "gcn" else gin_apply
    want = np.asarray(apply(params, jnp.asarray(x), (gt, gt)))
    np.testing.assert_allclose(mine, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_naive_forward_and_gradients_match_jax(graphs, model):
    """The naive baseline's loss and one step's gradients against the JAX
    baseline's layers (``jax_naive.gcn_layer``/``gin_layer``) under
    ``jax.grad``: rtol 1e-5 (gradients: plus 1e-5 of the largest)."""
    g, jg = graphs
    x = g.init_embedding(12)
    y = g.init_labels(4).astype(np.int64)
    ws = _weights(model, 12, 8, 4, seed=2)
    tensors = naive.graph_tensors(g, "cpu")
    wt = [torch.tensor(w, requires_grad=True) for w in ws]
    loss = naive.loss_fn(wt, torch.from_numpy(x), torch.from_numpy(y),
                         tensors, model)
    loss.backward()

    src = jnp.asarray(np.repeat(np.arange(jg.num_nodes),
                                np.diff(jg.row_pointers)))
    dst, deg, n = jnp.asarray(jg.column_index), jnp.asarray(jg.degrees), jg.num_nodes

    def jax_loss(p):
        if model == "gcn":
            h = jax.nn.relu(jax_naive.gcn_layer(jnp.asarray(x), p[0], src, dst,
                                                deg, n))
            lp = jax.nn.log_softmax(jax_naive.gcn_layer(h, p[1], src, dst,
                                                        deg, n), 1)
        else:
            h = jnp.asarray(x)
            for i, w in enumerate(p):
                h = jax_naive.gin_layer(h, w, src, dst, n)
                if i < len(p) - 1:
                    h = jax.nn.relu(h)
            lp = jax.nn.log_softmax(h, 1)
        return -jnp.take_along_axis(lp, jnp.asarray(y)[:, None], 1).mean()

    want, grads = jax.value_and_grad(jax_loss)([jnp.asarray(w) for w in ws])
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=1e-5)
    for got, ref in zip(wt, grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("stack", [naive, torch_baseline])
def test_baseline_runs_and_prints_the_contract(stack, tmp_path, monkeypatch):
    """``main`` on the host on one small roster graph: a device line, the
    Namespace echo and a ``Time (ms):`` line; ``run``'s first loss is the
    loss of the weights it was given, which it does not change."""
    small = synthesize_graph(300, 2000, num_features=1433, num_classes=7,
                             seed=2)
    monkeypatch.setattr("gnnadvisor_osdi21_tpu_torch.bench.datasets."
                        "get_dataset", lambda name, *a, **k: small)
    rc, out = _out(stack.main, ["gin", "--dataset", "cora", "--epochs", "2",
                                "--device", "cpu"])
    lines = out.splitlines()
    assert rc == 0 and lines[0] == "# device: cpu"
    assert lines[1].startswith("Namespace(dataset='cora', baseline=")
    assert float(lines[2].split("Time (ms):")[1]) > 0
    ws = _weights("gcn", 1433, 16, 7)
    kept = [w.copy() for w in ws]
    stats = {}
    stack.run("cora", "gcn", 1, "cpu", ws, stats)
    tensors = naive.graph_tensors(small, "cpu")
    want = naive.loss_fn([torch.from_numpy(w) for w in kept],
                         torch.from_numpy(small.init_embedding(1433)),
                         torch.ones(small.num_nodes, dtype=torch.int64),
                         tensors, "gcn")
    assert stats["first_loss"] == pytest.approx(float(want), rel=1e-5)
    # the first forward's log-probabilities, per node: f32 rtol 1e-5
    lp = naive.forward([torch.from_numpy(w) for w in kept],
                       torch.from_numpy(small.init_embedding(1433)), tensors,
                       "gcn").numpy()
    assert stats["log_probs"].shape == (small.num_nodes, 7)
    np.testing.assert_allclose(stats["log_probs"].numpy(), lp, rtol=1e-5,
                               atol=1e-5 * np.abs(lp).max())
    assert all(np.array_equal(a, b) for a, b in zip(ws, kept))
