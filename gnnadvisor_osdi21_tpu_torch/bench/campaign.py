"""Full measurement campaign: the 30-row roster + the 4 parameter studies;
the port of ``gnnadvisor_osdi21_tpu/bench/campaign.py``.

Drives every measurement the reference's evaluation protocol produces —
the 15-dataset × {GCN, GIN} roster (0_bench_GNNA_GCN.py / 0_bench_GNNA_GIN.py)
and the four studies (s7-4_1 partsize, s7-4_2 dimtile, s7-4_3 reorder,
s7-5_1 hidden) — as one **resumable** sequential run of the port's CLI
(``python -m gnnadvisor_osdi21_tpu_torch``, on the card): each config gets
its own log under ``<log_dir>/runs/<tag>.log`` and is skipped when that
log already contains a ``Time (ms):`` line, so an interrupted campaign
continues where it stopped.  After the sweep, the per-run logs are
assembled into the protocol logs (``gcn.log``, ``gin.log``,
``study_*.log``) and pivoted to CSV with the log2csv/study2csv scrapers,
with the JAX campaign's tags, study headers and CSV schemas.

It writes only under git-ignored paths: ``<log_dir>`` is
``chiprun_out/campaign`` by default (the JAX campaign writes the tracked
``logs/``), ``chiprun_out/campaign/smoke`` with ``--smoke`` (the whole
sweep and assembly on the host, ``--platform cpu``, 3 epochs), and its
pidfile is ``campaign.pid`` in the port's cache directory
(``graphs/hybrid.cache_dir``), which ``bench/headline.py`` reads to stop
the campaign before it takes the card.  The exit code is 1 when a config
of the sweep did not finish (a failed or timed-out run), naming each.

Usage: python -m gnnadvisor_osdi21_tpu_torch.bench.campaign [--quick]
           [--smoke] [--only roster|studies[:name,name]] [--assemble-only]
           [--log_dir DIR]
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time

from gnnadvisor_osdi21_tpu_torch.bench.datasets import DATASETS, QUICK, TYPE_III
from gnnadvisor_osdi21_tpu_torch.bench.studies import DIM_TILES, HIDDEN, PARTSIZES
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import cache_dir

LOG_DIR = os.path.join("chiprun_out", "campaign")
TIMEOUT_S = 2400
USAGE = ("usage: campaign [--quick] [--smoke] [--only roster|"
         "studies[:name,name]] [--assemble-only] [--log_dir DIR]")
# appended to every config with --smoke (host run, 3 epochs: it overrides
# the per-config epoch count, so it comes last)
SMOKE_ARGS = ("--platform", "cpu", "--num_epoches", "3")


def pidfile() -> str:
    """Where a running campaign records its PID (``bench/headline.py``'s
    ``_quiesce_campaign`` reads it)."""
    return os.path.join(cache_dir(), "campaign.pid")


@contextlib.contextmanager
def recorded_pid():
    """This process's PID in ``pidfile()`` for the block, so that the
    headline bench can stop exactly this driver (never a pattern match)
    before it takes the card."""
    os.makedirs(cache_dir(), exist_ok=True)
    with open(pidfile(), "w") as fp:
        fp.write(f"campaign:{os.getpid()}\n")
    try:
        yield
    finally:
        try:
            os.remove(pidfile())
        except OSError:
            pass


def _config_cmd(dataset: str, extra: list[str], epochs: int,
                tail=()) -> list[str]:
    _, _, dim, classes, _, _ = DATASETS[dataset]
    return [
        sys.executable, "-m", "gnnadvisor_osdi21_tpu_torch",
        "--dataset", dataset, "--dim", str(dim), "--classes", str(classes),
        "--num_epoches", str(epochs),
    ] + extra + list(tail)


def roster_configs(quick: bool, tail=()):
    """15 datasets × GCN(h16)/GIN(h64), auto decider + rabbit (reference
    0_bench_GNNA_GCN.py:44-53 grid); ``tail`` is appended to each
    command."""
    epochs = 50 if quick else 200
    names = QUICK if quick else list(DATASETS)
    for model, hidden in (("gcn", 16), ("gin", 64)):
        for name in names:
            tag = f"roster_{model}_{name}"
            yield tag, model, _config_cmd(name, [
                "--model", model, "--hidden", str(hidden),
                "--manual_mode", "False", "--enable_rabbit", "True",
            ], epochs, tail)


def study_configs(quick: bool, tail=()):
    """The four reference studies, on the step-by-step loop (the JAX
    campaign's ``--use_scan False``); ``tail`` is appended to each
    command.

    Protocol deviation kept from the JAX campaign: study arms run 50
    timed epochs, not the roster's 200 (reference: 200 everywhere,
    GNNA_main.py:197), and the partSize >= 256 arms 10.  Studies measure
    relative curves across a parameter grid, and the grids hold
    deliberately slow arms."""
    epochs = 50
    graphs = TYPE_III[:1] if quick else TYPE_III

    # s7-4_3 first: the reordering thesis is the headline claim, so its
    # data lands even if the sweep is interrupted.
    for flag in ("False", "True"):
        for ds in TYPE_III[:1] if quick else TYPE_III[:3]:
            yield f"reorder_{flag}_{ds}", "reorder", _config_cmd(ds, [
                "--manual_mode", "True", "--method", "hybrid",
                "--model", "gin", "--hidden", "64",
                "--enable_rabbit", flag, "--use_scan", "False",
            ], epochs, tail), f"++ rabbit: {flag}\n{ds}---rabbit: {flag}"

    for ps in PARTSIZES[:3] if quick else PARTSIZES:
        arm_epochs = 10 if ps >= 256 else epochs
        for ds in graphs:
            yield f"partsize_{ps}_{ds}", "partsize", _config_cmd(ds, [
                "--manual_mode", "True", "--method", "ell",
                "--partSize", str(ps), "--hidden", "16",
                "--use_scan", "False",
            ], arm_epochs, tail), f"++ Part-size: {ps}\n{ds}---partsize: {ps}"

    for dw in DIM_TILES[:3] if quick else DIM_TILES:
        for ds in graphs:
            yield f"dimtile_{dw}_{ds}", "dimtile", _config_cmd(ds, [
                "--manual_mode", "True", "--method", "hybrid",
                "--dimWorker", str(dw), "--hidden", "16",
                "--use_scan", "False",
            ], epochs, tail), f"++ dimWorker: {dw}\n{ds}---dimWorker: {dw}"

    for h in HIDDEN[:3] if quick else HIDDEN:
        for ds in graphs:
            yield f"hidden_{h}_{ds}", "hidden", _config_cmd(ds, [
                "--manual_mode", "False", "--hidden", str(h),
                "--use_scan", "False",
            ], epochs, tail), f"++ hidden: {h}\n{ds}---hidden: {h}"


def done(path: str) -> bool:
    if not os.path.exists(path):
        return False
    with open(path) as fp:
        return "Time (ms):" in fp.read()


def run_one(run_dir: str, tag: str, cmd: list[str]) -> bool:
    """Run one config into its log unless the log is complete; True when
    the log is complete afterwards."""
    path = os.path.join(run_dir, f"{tag}.log")
    if done(path):
        print(f"[skip] {tag}", flush=True)
        return True
    t0 = time.time()
    print(f"[run ] {tag}", flush=True)
    with open(path, "w") as fp:
        try:
            subprocess.run(cmd, stdout=fp, stderr=subprocess.STDOUT,
                           timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fp.write(f"\nCAMPAIGN: timeout after {TIMEOUT_S}s\n")
    ok = done(path)
    print(f"[{'ok' if ok else 'FAILED':4}] {tag} ({time.time() - t0:.0f}s)",
          flush=True)
    return ok


def _assemble(quick: bool, log_dir: str) -> None:
    """Per-run logs -> protocol logs -> CSVs (the stock scrapers)."""
    from gnnadvisor_osdi21_tpu_torch.bench import log2csv, study2csv

    run_dir = os.path.join(log_dir, "runs")

    def cat(paths, out, headers=None):
        with open(out, "w") as fp:
            for i, p in enumerate(paths):
                if headers:
                    fp.write(headers[i] + "\n")
                # only splice in *completed* runs: log2csv pairs dataset
                # names with "Time (ms)" lines by order, so a failed log
                # (Namespace echo, no timing) would shift every subsequent
                # time onto the wrong dataset
                if done(p):
                    with open(p) as rp:
                        fp.write(rp.read())
                elif os.path.exists(p):
                    print(f"[assemble] skipping incomplete {p}", flush=True)
        return out

    for model in ("gcn", "gin"):
        tags = [t for t, m, _ in roster_configs(quick) if m == model]
        paths = [os.path.join(run_dir, f"{t}.log") for t in tags]
        log2csv.main([cat(paths, os.path.join(log_dir, f"{model}.log"))])

    by_study: dict[str, list[tuple[str, str]]] = {}
    for tag, study, _, header in study_configs(quick):
        by_study.setdefault(study, []).append(
            (os.path.join(run_dir, f"{tag}.log"), header)
        )
    for study, entries in by_study.items():
        if not any(done(p) for p, _ in entries):
            # no completed runs for this grid in the current sweep: keep
            # whatever assembled artifact already exists (a filtered
            # campaign must not clobber a previous grid)
            print(f"[assemble] no runs for study '{study}', keeping "
                  "existing artifacts", flush=True)
            continue
        out = os.path.join(log_dir, f"study_{study}.log")
        cat([p for p, _ in entries], out, headers=[h for _, h in entries])
        study2csv.main([out])

    # roster.csv: model,dataset,Avg.Epoch (ms)
    with open(os.path.join(log_dir, "roster.csv"), "w") as fp:
        fp.write("model,dataset,Avg.Epoch (ms)\n")
        for model in ("gcn", "gin"):
            csv = os.path.join(log_dir, f"{model}.csv")
            if os.path.exists(csv):
                with open(csv) as rp:
                    next(rp)
                    for line in rp:
                        fp.write(f"{model},{line}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    quick = "--quick" in argv
    log_dir = LOG_DIR
    if "--log_dir" in argv:
        idx = argv.index("--log_dir") + 1
        if idx >= len(argv):
            print(USAGE)
            return 2
        log_dir = argv[idx]
    tail: tuple[str, ...] = ()
    if "--smoke" in argv:
        # the whole sweep and assembly on the host, in logs of its own
        quick = True
        log_dir = os.path.join(log_dir, "smoke")
        tail = SMOKE_ARGS
    run_dir = os.path.join(log_dir, "runs")
    os.makedirs(run_dir, exist_ok=True)
    if "--assemble-only" in argv:
        # rebuild the CSVs from whatever per-run logs exist (idempotent;
        # lets an interrupted sweep still publish its completed points)
        _assemble(quick, log_dir)
        return 0
    only = None
    study_filter = None
    if "--only" in argv:
        idx = argv.index("--only") + 1
        ok = idx < len(argv) and (
            argv[idx] in ("roster", "studies")
            or argv[idx].startswith("studies:")
        )
        if not ok:
            print(USAGE)
            return 2
        only = argv[idx]
        if only.startswith("studies:"):
            # e.g. --only studies:partsize,reorder — a subset of the grids
            study_filter = set(only.split(":", 1)[1].split(","))
            only = "studies"
    failed = []
    with recorded_pid():
        if only in (None, "roster"):
            for tag, _model, cmd in roster_configs(quick, tail):
                if not run_one(run_dir, tag, cmd):
                    failed.append(tag)
        if only in (None, "studies"):
            for tag, study, cmd, _hdr in study_configs(quick, tail):
                if study_filter and study not in study_filter:
                    continue
                if not run_one(run_dir, tag, cmd):
                    failed.append(tag)
    _assemble(quick, log_dir)
    if failed:
        print(f"campaign FAILED: {failed}", flush=True)
        return 1
    print("campaign done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
