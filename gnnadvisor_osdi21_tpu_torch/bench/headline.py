"""Headline benchmark: one SpMM (neighbour aggregation) through the whole
tuned pipeline on an amazon0505-scale graph at feature width 16; the
port of the JAX package's root ``bench.py:76-158``.

    python -m gnnadvisor_osdi21_tpu_torch.bench.headline
    python -m gnnadvisor_osdi21_tpu_torch.bench.headline --device cpu --nodes 4096 --iters 2

Pipeline: ``bench_graph(16)`` (synthetic web topology, 410,236 nodes /
4,878,874 edges, seed 0), rabbit reordering (native C++), the auto hybrid
layout (``build_hybrid`` with the tier probe left at its default, as
``bench.py:92`` leaves it: it runs on the card when the cost model's top
candidates are close, and replays a cached verdict), transposed tensors
with bf16 tier operands, all-ones x [16, R], and ``sag`` timed by
``chained_marginal_time(iters=200, reps=3)``: the slope between runs of
200 and 800 calls, which removes what every run pays once.

Protocol of the reference's SpMM bench (unitest.py:65-80,
3_single_spmm_bench.py, 0_bench_Gunrock.py): all-ones features, dim 16,
amazon0505 scale.  Baseline: Gunrock SpMM on amazon0505 = 4.065 ms on the
artifact's RTX3090 (Gunrock/bench_gunrock.csv:2); ``vs_baseline`` is the
speedup over it.  ``gather_ceiling_ms``: ``index_select`` of a bf16 [16,
R] table over every edge's column, one row gather per edge, what a
per-edge formulation costs at least on this card.

Before it builds anything, ``main`` stops a running measurement campaign
(``_quiesce_campaign``, by the campaign's pidfile) and waits for its
in-flight run, so that the card is the headline's alone.

Prints ONE JSON line with the reference's keys, except ``modeled_ms`` and
``fraction_of_achievable``: they divide by the JAX package's cost model,
fitted to a TPU v5e (ROADMAP.md: they return with an H100 fit, A.7c).  It
adds the card's name and power limit, the reordered graph's fingerprint
(the native reorder is not repeatable at this scale, so each run may get
another permutation and other tiers), the tiers and what the tier probe
did.  ``--device cpu --nodes N`` rehearses the pipeline off the card on
an N-node web graph of the same mean degree, with the plain versions: its
times are the host's, and its ``metric`` says so.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.bench.datasets import (
    BENCH_EDGES, BENCH_NODES, bench_graph,
)
from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import (
    build_hybrid, graph_fingerprint,
)
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.graphs.reorder import rabbit_reorder_graph
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import sag
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import build_hybrid_tensors
from gnnadvisor_osdi21_tpu_torch.utils.profiling import spmm_roofline
from gnnadvisor_osdi21_tpu_torch.utils.timing import chained_marginal_time

DIM = 16
GUNROCK_AMAZON0505_MS = 4.065
METRIC = "spmm_amazon0505_scale_dim16_ms"


def power_limit_w() -> float | None:
    """The card's power limit in watts, as ``nvidia-smi`` reads it; None
    where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _stat(pid: int) -> list[str] | None:
    """The fields of ``/proc/<pid>/stat`` after the command name (state,
    parent PID, ..., start time at index 19); None once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as fp:
            return fp.read().rsplit(")", 1)[1].split()
    except (OSError, IndexError):
        return None


def _running(pid: int, start: str) -> bool:
    """Whether the process with ``pid`` and start time ``start`` still runs
    (a zombie has ended; another start time is a recycled PID)."""
    fields = _stat(pid)
    return fields is not None and fields[0] != "Z" and fields[19] == start


def _quiesce_campaign(max_wait_s: float = 900.0) -> None:
    """If a measurement campaign is running (``bench/campaign.py`` or
    ``bench/baseline_campaign.py``), stop it and wait for its in-flight
    config to drain, so that the headline has the card to itself (the JAX
    package's root ``bench.py:27-60``).  Kills only the PID recorded in
    the campaign's pidfile, and only when that process's command line
    names ``campaign``: a stale pidfile or a recycled PID is left alone.
    The running config is left to finish (its log stays valid for the
    campaign's resume); the wait is for that driver and its own children
    only, never for other processes on the machine."""
    from gnnadvisor_osdi21_tpu_torch.bench.campaign import pidfile

    try:
        with open(pidfile()) as fp:
            pid = int(fp.read().split(":")[-1].strip())
    except (OSError, ValueError):
        return
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fp:
            cmdline = fp.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return  # stale pidfile: the campaign is gone
    if "campaign" not in cmdline:
        return  # the PID was recycled by an unrelated process
    # the driver and its children, each with its start time, taken before
    # the signal: once the driver ends, its children get another parent
    procs = []
    for ent in os.listdir("/proc"):
        fields = _stat(int(ent)) if ent.isdigit() else None
        if fields is not None and (int(ent) == pid or int(fields[1]) == pid):
            procs.append((int(ent), fields[19]))
    try:
        os.kill(pid, signal.SIGTERM)
        print(f"headline: stopped campaign driver pid {pid}", file=sys.stderr)
    except ProcessLookupError:
        pass
    deadline = time.time() + max_wait_s
    while time.time() < deadline and any(_running(*p) for p in procs):
        time.sleep(1.0)


def run(device=None, nodes: int = 0, iters: int = 200) -> dict:
    """Build the pipeline on ``device`` (None: the card) and time it;
    returns the JSON line's fields.  ``nodes`` > 0: an N-node web graph
    (seed 0, the headline graph's mean degree) in place of the headline
    graph."""
    dev = resolve_device(device)
    if nodes:
        graph = synthesize_graph(
            nodes, round(nodes * BENCH_EDGES / BENCH_NODES),
            num_features=DIM, kind="web", seed=0)
    else:
        graph = bench_graph(DIM)
    graph = rabbit_reorder_graph(graph)
    hg = build_hybrid(graph, device=dev)
    # transposed features, bf16 tier operands with f32 accumulation: exact
    # on this all-ones protocol (0/1 adjacency times 1.0)
    ht = build_hybrid_tensors(hg, device=dev, agg_dtype="bfloat16",
                              transposed=True)
    x = torch.ones((DIM, hg.num_rows), dtype=torch.float32, device=dev)
    ids = torch.from_numpy(np.asarray(graph.column_index, np.int64)).to(dev)
    table = torch.ones((DIM, hg.num_rows), dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        sec, fixed_s = chained_marginal_time(
            lambda a, h: sag(a, h), x, ht, iters=iters, reps=3)
        ceil_sec, _ = chained_marginal_time(
            lambda a, i: a.index_select(1, i), table, ids,
            iters=min(5, iters), reps=2)
    if sec <= 0 or ceil_sec <= 0:
        raise RuntimeError(
            f"the two-point fit gave no positive time per call (SpMM {sec} "
            f"s, gather {ceil_sec} s): too few iterations for the noise")
    ms = sec * 1e3
    rl = spmm_roofline(sec, graph.nnz, DIM, graph.num_nodes)
    on_card = dev.type == "cuda"
    return {
        "metric": METRIC if on_card else "cpu_rehearsal_spmm_dim16_host_ms",
        "value": round(ms, 4),
        "unit": "ms",
        "vs_baseline": round(GUNROCK_AMAZON0505_MS / ms, 4),
        "edges_per_s": round(graph.nnz / sec / 1e9, 3),
        "edges_per_s_unit": "Gedge/s",
        # what every timed run paid once, removed from `value` by the fit
        "dispatch_fixed_ms": round(fixed_s * 1e3, 4),
        "hbm_floor_fraction": round(rl.hbm_fraction, 4),
        "gather_ceiling_ms": round(ceil_sec * 1e3, 4),
        "vs_gather_ceiling": round(ceil_sec / sec, 2),
        "graph": (
            "synthetic web topology at amazon0505 scale, rabbit-reordered"
            if not nodes else
            f"synthetic {nodes}-node web topology, rabbit-reordered"),
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "power_limit_w": power_limit_w() if on_card else None,
        "fingerprint": graph_fingerprint(graph),
        "diag_b": hg.diag_b,
        "hot_k": hg.hot_k,
        "res_ob": hg.res_ob,
        "res_tile": hg.res_tile,
        # the probe timed its candidates, replayed a cached verdict, or
        # did not run (the cost model's pick stands)
        "tier_probe": hg.tier_probe,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cpu to rehearse off the card (default: the card)")
    p.add_argument("--nodes", type=int, default=0,
                   help="an N-node web graph in place of the headline graph")
    p.add_argument("--iters", type=int, default=200,
                   help="chained SpMM calls of the fit's first point")
    args = p.parse_args(argv)
    _quiesce_campaign()
    print(json.dumps(run(args.device, args.nodes, args.iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
