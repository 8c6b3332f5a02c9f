#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``gnnadvisor_osdi21_tpu_torch`` (and nothing of the JAX package)
through its main path and holds every CUDA kernel against its plain
PyTorch version on the card:

- phase 0: the card, its power limit and the toolchain;
- phase 1: build ``csrc/*.cu`` with nvcc (into the package's ``_build/``);
- layouts: an amazon0505-scale web graph through the auto decider, the
  same graph with fixed tiers (diag 512, hot 512), and a 10k power-law
  graph;
- phase 2: each transposed kernel against its plain version at the
  layouts' shapes, for D in {16, 22, 5} and f32/bf16, x_t given as the
  view of a row-major table, as the aggregation hands it over (the
  residual combine gathering from x by its slot ids, without and with an
  addend, and stopping, in a process of its own, on a slot id past x),
  with its time at D = 16 and 22, its byte
  bound and the time of ``torch.sparse.mm`` over the same edges (the
  residual's over its edges read from x, and ``torch.addmm`` with the
  addend), and the whole transposed aggregation against
  ``torch.sparse.mm`` over all of the graph's edges; then each row-major
  kernel the same way, for D in {96, 64, 22, 16, 5}
  (the slab kernels also at 500 and 1433, wider than one 256-column
  chunk, with integer features exactly and random f32 features within
  their summation bound; the residual combine gathering from x by its
  slot ids and over gathered rows, each without and with an addend,
  timed against ``torch.sparse.mm`` over its edges read from x, and
  stopping, in a process of its own, on a slot id past x), and the whole
  row-major aggregation against ``torch.sparse.mm`` over all of the
  graph's edges;
- phase 3: GCN 96 -> 16 -> 22 training on the auto layout (transposed):
  the first step's loss and gradients against the plain path, launch
  counts and ``index_select`` gathers (the hot table's alone),
  ``epoch_ms`` over timed epochs through the captured step (a CUDA graph
  replayed, ``train_and_time``'s default), and the device time of three
  replays by kernel (``torch.profiler``);
- phase 4: the other transposed wirings (fused diag+hot; diag 4096 with a
  residual that does not cover every block) for a few steps each;
- phase 5: GIN 96 -> 64 x4 -> 22 training on the auto layout, row-major:
  the first step against the plain path at f32 and at bf16 aggregation,
  launch counts and ``index_select`` gathers (the hot table's alone),
  ``gin_epoch_ms`` over timed epochs through the captured step, and the
  device time of three replays by kernel (``torch.profiler``);
- phase 6: GCN on the row-major fused and 10k layouts for a few steps;
- phase 7: the probe kernels (``ops/probe_cuda.py``) against their plain
  versions at every dtype pair, block size and K of their path, at a
  reduced and at the full R, with their time, bound, plain time and
  library times, and with equal results for every block size the scripts
  pass; the dense ring kernels also on int8 slabs of every value in
  [-128, 127], at R = 8,200 (a multiple of 8, not of their 256-row tile)
  and K = 32 and 80 (not a multiple of their stage); the set-bit walk
  (``bit_slab_t``) also on the slabs it could get wrong (every bit set,
  bit 31 in every word, empty rows and tiles) at R = 8,200 and W32 = 4, 8
  and 128;
- phase 8: the probe scripts ``bench.fixprobe``, ``bench.stepprobe`` and
  ``bench.fmtprobe``, run unmodified in this process (their launches are
  the probe kernels' path);
- phase 9: the measured-probe tier autotune at amazon0505 scale, in the
  layout build of the CLI's GCN run on the same graph (200 epochs,
  through the captured step), in a cache directory of its own;
- phase 10: the format probe's kernels (``ops/fmtprobe_cuda.py``) against
  their plain versions for every dtype, variant and block of their path,
  at a reduced and at fmtprobe's full shape, with their time, bound,
  plain time and library time; the set-bit walk (``bit_slab``, both
  variants) also on the slabs of phase 7 and with equal results for both
  blocks; the dense int8 slab (``i8_slab``) also on a slab of every int8
  value, exactly on dyadic features, and with equal results for both
  blocks at the full shape; the segment reduce also with three tiles a
  block and a restart (at both shapes) and with its ids shuffled within
  each tile (at the reduced shape), and, as information, one
  ``torch.sparse.mm`` over the unfolded values;
- phase 10b: the segment reduce and the D = 16 residual kernels chained,
  per edge;
- phase 11: the native graph tools (``native/graphtools.cpp``, built with
  g++): the 10k graph's edges as a text file through the native parser
  and ``np.loadtxt`` against the ``.npz`` path; the native reorder of the
  10k graph (a permutation, its edge span beside the NumPy path's) and,
  twice, of the amazon0505-scale graph (seconds, edge span, fingerprints,
  whether the two permutations agree, the tiers each gives); then GCN 96
  -> 16 -> 22 on the decider's reordered auto layout (transposed): the
  first step against the plain path, launch counts, and ``epoch_ms`` by
  a short plan as information;
- phase 12: the ELL, dense and COO paths (PyTorch ops, no kernel): GCN
  and GIN (and GCN with bf16 GEMMs) on a 4,000-node graph the auto
  decider gives the dense path, each first step against the same step on
  the CPU, then 3 steps; at amazon0505 scale, ELL (auto part size) and
  COO: ``sag`` and the GCN aggregation against the ``index_add_`` oracle
  and bitwise equal over two runs, GCN and GIN first steps against the
  CPU, and ``epoch_ms``/``gin_epoch_ms`` by a short plan as information;
  one manual-mode step (ELL, part size 32);
- phase 13: the entry points.  ``train_and_time``'s captured step
  (``use_scan=True``) against its step-by-step loop (``use_scan=False``)
  from the same weights, 10 steps (GCN transposed and GIN row-major at
  amazon0505 scale, GCN on the dense, ELL and COO tensors of phase 12):
  losses and final weights within CAPTURE_RTOL, the captured step
  launching what an eager step launches; ``epoch_ms``/``gin_epoch_ms``
  step by step, with the windows' spread and the idle share, beside
  phases 3 and 5's captured ones; the headline bench
  (``bench/headline.py``) twice, each JSON line printed with its
  fingerprint and tiers; the CLI in this process (its GCN run at
  amazon0505 scale is phase 9's), on the 10k graph: ``--verify_spmm`` on
  the hybrid and ELL paths (PASSED), ``--single_spmm`` (its build times
  the tier candidates), GIN for the reference's 200 epochs (its build
  replays that verdict from the cache), and ``--save_ckpt``/``--resume``
  against a straight run;
- phase 14: the multi-device path (``parallel/``) at amazon0505 scale.
  (a) One NCCL rank through ``tools/dist_check.py`` (GCN 96 -> 16 -> 22
  on ``shard_graph_hybrid(g, 1)``): the aggregate (norm, overlap, f32 and
  bf16), the loss and gradients against the single-card path, 10 Adam
  steps against the single-card step's, the dist step's ms, and its
  ``slab_matmul_t``/``residual_combine_t`` launches per step (4 a slab
  tier, 4), the counts set to 0 just before the steps; the ELL twin; and
  each path's step captured as one CUDA graph on NCCL
  (``dist_ops.make_captured_dist_step``) against the same step run step
  by step, 10 Adam steps, losses and final weights within CAPTURE_RTOL,
  with the captured step's ms and idle share beside the step-by-step
  one's before capture existed (5.9094 ms at 60.6% idle).
  (b) ``shard_graph_hybrid(g, 4)`` shard by shard: each rank's table as
  the exchange would deliver it, its tiers on the kernels against their
  plain composition, and the four shards against the single-card
  aggregation (dyadic features, exact).  (c) the CLI's ``--num_devices``
  one more than the cards exits non-zero, naming both counts.  One card
  cannot host two NCCL ranks, so several ranks run only in the CPU tests
  (gloo).
- phase 15: the one-card measurement drivers, unmodified, in this
  process: ``bench.breakdown`` (every section, three tier configs, then
  ``--rowmajor --only hybrid``, then the three tiers apart at diag 512 +
  hot 512), ``bench.levers --quick``,
  ``bench.splitprobe`` and ``bench.bench_spmm --quick``, each on the
  amazon0505-scale graph reordered anew (each prints its fingerprint and
  tiers).  Each exits 0 and checks itself: breakdown's tiers (diag + hot
  + residual) add up to its whole aggregation exactly on all-ones x,
  splitprobe's 2- and 4-way residual launches give the stock ``sag``
  bitwise, and bench_spmm's hybrid arm equals its COO arm.  Their hybrid
  kernel launches go to the ``kernels`` line as ``driver_launches``, apart
  from the main path's ``launches``, and each of the six hybrid kernels
  must have some;
- phase 16: the roster drivers and the baselines.  (a) Every hybrid
  kernel against its plain version at the roster GIN's input widths D in
  {50, 128, 500, 1323}, on the 10k graph at (diag 512, hot 512) with a
  residual, f32 and bf16: integer features exactly (the residual also
  with an addend), random f32 features within 1e-4 + n·2^-24·(A·|x|).
  (b) ``bench.verify_all --quick`` (3 graphs x 2 dtypes, CLI processes).
  (c) ``bench.campaign --quick --only roster`` into a scratch log
  directory under ``chiprun_out/``: 6 rows in ``roster.csv``, and
  ``bench.roster2md`` prints them.  (d) ``baselines.naive`` and
  ``baselines.torch_baseline`` on pubmed, GCN and GIN, from the tuned
  model's weights: their first-step loss equals the tuned model's (f32
  aggregation) within BASELINE_RTOL, and their first forward's
  log-probabilities equal its, node by node and class by class, within
  1e-4 + n·2^-24 of the row's scale (``log_prob_tol``); then 5 timed
  epochs;
- phase 17: the tools and the multi-device drivers, each checking
  itself: ``tools.overlap_ablation`` on one NCCL rank (a reduced graph, a
  diagonal tier forced; both arms through the captured step, their
  losses equal), ``bench.bench_scaling --devices 1``,
  ``tools.multihost_demo --hosts 1 --local_devices 1``,
  ``tools.ogb_scale_demo`` at amazon0505 scale with ``--shard_devices 4``
  (on all-ones x each row's SpMM sum equals its degree), and
  ``tools.reorder`` on the 10k graph as a text edge list (a permutation;
  a community per node and a modularity).  Their hybrid kernel launches
  go to the ``kernels`` line as ``tool_launches``; ``slab_matmul_t`` and
  ``residual_combine_t`` must have some.

In every training run through the captured step the hybrid kernels'
wrappers count their launches once per eager step and once at capture; a
replay runs the captured kernels without passing a wrapper.  The checks
count kernel runs (the wrappers' counts plus the captured step's launches
for each further replay); the ``kernels`` line reports the wrappers'
counts of the main path's run (phases 3-6; phase 8 for the probe
kernels) as ``launches``, those of the measurement drivers (phase 15)
as ``driver_launches``, and those of the tools (phase 17) as
``tool_launches``.

The layouts of phases 2-6 are built with the probe off, so that they are
the cost model's.  Every check raises on failure, so the exit code is
non-zero.  The last two lines are a JSON ``kernels`` record and the
``{"ok": true, ...}`` line.  Without a CUDA card it exits 1 before
printing either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch import cli
from gnnadvisor_osdi21_tpu_torch.baselines import naive, torch_baseline
from gnnadvisor_osdi21_tpu_torch.bench import (
    bench_scaling, bench_spmm, breakdown, campaign, fixprobe, fmtprobe,
    headline, levers, roster2md, splitprobe, stepprobe, verify_all,
)
from gnnadvisor_osdi21_tpu_torch.bench.datasets import DATASETS, get_dataset
from gnnadvisor_osdi21_tpu_torch.graphs import hybrid
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import (
    build_residual_stream, pack_slab_bits, pack_slab_bits_t,
)
from gnnadvisor_osdi21_tpu_torch.graphs.loader import (
    load_graph, synthesize_graph,
)
from gnnadvisor_osdi21_tpu_torch.graphs.reorder import rabbit_permutation
from gnnadvisor_osdi21_tpu_torch.native import graphtools
from gnnadvisor_osdi21_tpu_torch.ops import (
    _build, fmtprobe_cuda, probe_cuda, reference, spmm_cuda,
)
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import (
    aggregate, exact_f32_matmul, is_transposed,
)
from gnnadvisor_osdi21_tpu_torch.train import (
    MODELS, build_model, make_captured_step, make_optimizer, make_train_step,
    nll_loss, train_and_time,
)
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
    build_hybrid_tensors, build_layer_tensors, hybrid_aggregate,
)
from gnnadvisor_osdi21_tpu_torch.parallel import dist_hybrid
from gnnadvisor_osdi21_tpu_torch.parallel.dist_hybrid import local_tensors
from gnnadvisor_osdi21_tpu_torch.parallel.hybrid_partition import (
    shard_graph_hybrid,
)
from gnnadvisor_osdi21_tpu_torch.tools import (
    dist_check, multihost_demo, ogb_scale_demo, overlap_ablation, reorder,
)
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty
from gnnadvisor_osdi21_tpu_torch.utils import profiling
from gnnadvisor_osdi21_tpu_torch.utils.checkpoint import load_checkpoint
from gnnadvisor_osdi21_tpu_torch.utils.timing import chained_device_time

# H100 SXM data sheet (dense, no sparsity): memory rate, f32 rate outside
# the tensor cores, dense bf16 tensor-core rate (utils/profiling.py)
HBM_BYTES_PER_S = profiling.HBM_BYTES_PER_S
F32_OPS_PER_S = profiling.F32_FLOPS
BF16_TC_OPS_PER_S = profiling.BF16_FLOPS
# kernel vs plain version on the card: both sum exact f32 products in f32,
# in different orders; sums of up to a few hundred terms stay well inside
ATOL, RTOL = 1e-4, 1e-5
# first training step, kernel path vs plain path (same weights): loss and
# gradients differ by summation order (and the rare bf16 rounding flip it
# causes in the aggregation operand)
STEP_RTOL = 1e-4
# GIN's first step at bf16 aggregation: every layer casts its input to
# bf16, so a summation-order difference in one layer's f32 output can flip
# a rounding of the next layer's operand, by one bf16 unit in the last
# place (2^-8 of its value).  The bound is that unit, relative to the
# largest value: what every operand of a same-signed sum flipping the
# same way would give.  A flip needs an f32 difference that straddles a
# bf16 rounding boundary, so flips are rare and the error stays far below
GIN_BF16_RTOL = 2.0 ** -8
REPS = 20  # CUDA-event-timed launches per median
DIMS = (16, 22, 5)
ROW_DIMS = (96, 64, 22, 16, 5)  # the row-major kernels' widths
# GIN's first aggregation runs at the input width: pubmed's and cora's,
# tables the row-major slab kernel covers in chunks of 256 columns.  Their
# checks use integer features in [-4, 4], whose every partial sum is exact
# in f32, and require the kernel to equal its plain version exactly; and
# random f32 features, within 1e-4 + n·2^-24·(A·|x|), n the row's set bits
# (rows of the diag B=4096 slab sum hundreds of terms: the two summation
# orders differ past 1e-4 + 1e-5·|plain| somewhere in [R, 1433]).
WIDE_DIMS = (500, 1433)
DTYPES = (torch.float32, torch.bfloat16)
GIN_HIDDEN = 64
# timed epochs of phases 3 and 5: 8 windows of 8 epochs, fit against 8
# windows of 1 (train_and_time's protocol), after 5 dry-run epochs
TIMED_EPOCHS = 64
DEVICE = "cuda"  # the card; every tensor of the checks is put there

SOURCES = {
    "slab_matmul_t": "gnnadvisor_osdi21_tpu_torch/csrc/slab.cu",
    "fused_slab_matmul_t": "gnnadvisor_osdi21_tpu_torch/csrc/slab.cu",
    "residual_combine_t": "gnnadvisor_osdi21_tpu_torch/csrc/residual_t.cu",
    "slab_matmul": "gnnadvisor_osdi21_tpu_torch/csrc/slab.cu",
    "fused_slab_matmul": "gnnadvisor_osdi21_tpu_torch/csrc/slab.cu",
    "residual_combine": "gnnadvisor_osdi21_tpu_torch/csrc/residual.cu",
    "bit_slab_t": "gnnadvisor_osdi21_tpu_torch/csrc/bit_walk.cu",
    "i8_slab_t": "gnnadvisor_osdi21_tpu_torch/csrc/dense_slab.cu",
    "dense_slab": "gnnadvisor_osdi21_tpu_torch/csrc/dense_slab.cu",
    "stream_sum": "gnnadvisor_osdi21_tpu_torch/csrc/fmt_probe.cu",
    "i8_slab": "gnnadvisor_osdi21_tpu_torch/csrc/dense_slab.cu",
    "bit_slab": "gnnadvisor_osdi21_tpu_torch/csrc/bit_walk.cu",
    fmtprobe_cuda.BIT_SLAB_F32: "gnnadvisor_osdi21_tpu_torch/csrc/bit_walk.cu",
    "seg_reduce": "gnnadvisor_osdi21_tpu_torch/csrc/fmt_probe.cu",
}
REPLACES = {
    "slab_matmul_t": "gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:469",
    "fused_slab_matmul_t": "gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:556",
    "residual_combine_t": "gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:649",
    "slab_matmul": "gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:143",
    "fused_slab_matmul": "gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:259",
    "residual_combine": "gnnadvisor_osdi21_tpu/ops/spmm_pallas.py:354",
    "bit_slab_t": "gnnadvisor_osdi21_tpu/bench/fixprobe.py:63",
    "i8_slab_t": "gnnadvisor_osdi21_tpu/bench/fixprobe.py:94",
    "dense_slab": "gnnadvisor_osdi21_tpu/bench/stepprobe.py:69",
    "stream_sum": "gnnadvisor_osdi21_tpu/bench/fmtprobe.py:53",
    "i8_slab": "gnnadvisor_osdi21_tpu/bench/fmtprobe.py:118",
    "bit_slab": "gnnadvisor_osdi21_tpu/bench/fmtprobe.py:216",
    fmtprobe_cuda.BIT_SLAB_F32: "gnnadvisor_osdi21_tpu/bench/fmtprobe.py:216",
    "seg_reduce": "gnnadvisor_osdi21_tpu/bench/fmtprobe.py:287",
}
# the amazon0505-scale graph's (edge count, fingerprint) by numpy version:
# the generator draws one edge fewer under numpy 2.3.5 than under 2.0.2,
# the version the CPU parity tests ran with (the generator stays as it is)
EXPECTED_GRAPH = {"2.0.2": (3_395_067, "5d8a7ec0"),
                  "2.3.5": (3_395_066, "12727dd5")}
PROBE_R = 409_600  # the probe scripts' graph rows
PROBE_R_SMALL = 8_192  # the reduced R of the probe kernels' checks
FMT_R, FMT_K = 410_624, 4096  # fmtprobe's default rows and slab columns
FMT_SMALL = (8_192, 256)  # the reduced (R, K) of its kernels' checks
# fmtprobe's (TILE, OB) pairs of the segment reduce
SEG_PAIRS = ((256, 256), (512, 512), (256, 512), (512, 256), (1024, 512))
# the slabs a walk over set bits could get wrong (bit_slab, bit_slab_t), at
# R = 8,200 (a last tile of 8 rows: the walk's tiles are 128 rows) and W32
# = 4, 8 (a stage of 16 words only partly filled) and 128
HARD_KINDS = ("every bit set", "bit 31 in every word", "empty rows and tiles")
HARD_R, HARD_KS = 8_200, (128, 256, 4096)
# phases 11-12: the dense path's power-law graph (the 10k graph's mean
# degree), the widths of the ELL and COO paths' oracle checks (GCN's
# hidden width, the input width GIN's first layer aggregates at), and the
# information epoch_ms: 8 windows of 1 epoch, no fit
DENSE_NODES, DENSE_EDGES = 4_000, 48_000
PATH_DIMS = (16, 96)
SHORT_EPOCHS = 8
# phase 9: the CLI at amazon0505 scale (the layouts' graph, seed 0), the
# decider's choice, the reference's default 200 epochs
AMAZON_CLI = ["--synthetic", "410236:4878874:web", "--manual_mode", "False",
              "--num_epoches", "200"]
# phase 13: a captured step against the same step run eagerly with the
# same Adam: the same kernels on the same inputs, so f32 rounding at most
# (the kernels and reductions are deterministic)
CAPTURE_RTOL = 1e-6
# phase 15: breakdown's (diag_b, hot_k) sweep (the headline's diagonal
# block alone, the cost model's hot-4096 layout, both slabs fused)
BREAKDOWN_TIERS = "512:0,0:4096,512:512"
# phase 16: the roster GIN's input widths that no earlier phase runs (ppi,
# soc-BlogCatalog, pubmed, TWITTER-Real-Graph-Partial): GIN aggregates
# before its GEMM, so its first layer aggregates at the input width
ROSTER_DIMS = (50, 128, 500, 1323)
# the baselines' first-step loss against the tuned model's, f32
# aggregation: the same sums in other orders
BASELINE_RTOL = 1e-4
# phase 14: one NCCL rank's hybrid step run step by step, before the step
# was captured (NVIDIA H100 80GB HBM3 at 700 W), logged beside the
# captured step
STEPWISE_DIST_MS, STEPWISE_DIST_IDLE = 5.9094, 0.606
# phase 17: the ablation's community graph cut to a quarter of its nodes
# (the same degree), with a diagonal tier forced (the cost model's layout
# of it may have none); ogb_scale_demo at amazon0505's node count, with
# ogbn-products' edges per node
ABLATION = dict(nodes=50_000, edges=600_000, epochs=20, diag_b=512)
OGB_ARGS = ["--nodes", "410236", "--edges", "10361000", "--shard_devices",
            "4"]
BASELINE_DATASET = "pubmed"

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, reps: int = REPS) -> float:
    """Median of ``reps`` single launches, each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bit_coords(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Set bits of a bit-major uint16 [W16, N] array as (column j, minor n):
    bit b of word w is column b·W16 + w."""
    w16 = words.shape[0]
    js, ns = [], []
    for b in range(16):
        w, n = np.nonzero((words >> np.uint16(b)) & np.uint16(1))
        js.append(b * w16 + w)
        ns.append(n)
    return np.concatenate(js), np.concatenate(ns)


def mask32_coords(mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Set bits of an out-row-major uint32 [W, M] mask as (out row o, slot
    m): bit k of word w is row k·W + w."""
    w = mask.shape[0]
    os_, ms = [], []
    for k in range(32):
        ww, m = np.nonzero((mask >> np.uint32(k)) & np.uint32(1))
        os_.append(k * w + ww)
        ms.append(m)
    return np.concatenate(os_), np.concatenate(ms)


def csr(rows: np.ndarray, cols: np.ndarray, shape) -> torch.Tensor:
    """0/1 CSR matrix on the card (the library yardstick's operand)."""
    idx = torch.from_numpy(np.stack([rows, cols]).astype(np.int64))
    vals = torch.ones(idx.shape[1], dtype=torch.float32)
    coo = torch.sparse_coo_tensor(idx, vals, shape).coalesce()
    return coo.to_sparse_csr().to(DEVICE)


class Record:
    """What the ``kernels`` line reports for one kernel."""

    def __init__(self, name: str):
        self.name = name
        self.max_abs_err = 0.0
        self.launches = 0  # the main path's (phases 3-6, and 8 for probes)
        self.driver_launches = 0  # the measurement drivers' (phase 15)
        self.tool_launches = 0  # the tools' (phase 17)
        self.ms = self.plain_ms = self.bound_ms = self.library_ms = None
        self.bound_by = "bytes"

    def as_dict(self) -> dict:
        return {
            "name": self.name, "route": "cuda", "source": SOURCES[self.name],
            "replaces": REPLACES[self.name], "launches": self.launches,
            "driver_launches": self.driver_launches,
            "tool_launches": self.tool_launches,
            "max_abs_err": self.max_abs_err, "ms": self.ms,
            "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
            "bound_by": self.bound_by, "library_ms": self.library_ms,
        }


def bound(rec: Record, nbytes: int, adds: int,
          ops_per_s: float = F32_OPS_PER_S) -> None:
    """Least time: bytes over the memory rate vs the operations over their
    rate (f32 adds on the CUDA cores unless ``ops_per_s`` says otherwise)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = adds / ops_per_s * 1e3
    rec.bound_ms = max(t_bytes, t_ops)
    rec.bound_by = "bytes" if t_bytes >= t_ops else "operations"


def compare(rec: Record, label: str, kernel, plain, tol=None,
            tol_text: str = "") -> None:
    """Kernel against plain within ATOL + RTOL·|plain|, or within the
    per-element ``tol`` (described by ``tol_text``) where given."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == torch.float32,
            f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    err = (got - want).abs()
    if tol is None:
        tol, tol_text = ATOL + RTOL * want.abs(), f"{ATOL:g} + {RTOL:g}·|plain|"
    ok = bool((err <= tol).all())
    max_err = float(err.max()) if err.numel() else 0.0
    rec.max_abs_err = max(rec.max_abs_err, max_err)
    log(f"  {label}: max_abs_err {max_err:.3e} "
        f"(tolerance {tol_text}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{label} disagrees with its plain version")


def features(d: int, cols: int, dtype, gen: torch.Generator) -> torch.Tensor:
    return torch.randn((d, cols), generator=gen, device=DEVICE).to(dtype)


def row_features(n: int, d: int, dtype, gen: torch.Generator) -> torch.Tensor:
    return torch.randn((n, d), generator=gen, device=DEVICE).to(dtype)


def as_table(x_t: torch.Tensor) -> torch.Tensor:
    """x_t [D, X] as the transposed aggregation hands it to the kernels:
    the transposed view of a padded row-major table."""
    return spmm_cuda.row_table_t(x_t).t()[: x_t.shape[0]]


def int_features(shape, dtype, gen: torch.Generator) -> torch.Tensor:
    """Integer features in [-4, 4]: every partial sum exact in f32."""
    return torch.randint(-4, 5, shape, generator=gen, device=DEVICE).to(dtype)


def slab_case(n: int, d: int, dtype, gen: torch.Generator):
    """Features of a row-major slab check at width ``d`` and its tolerance
    (None: ATOL + RTOL·|plain|): integers and an exact match at the wide
    widths (see WIDE_DIMS)."""
    if d not in WIDE_DIMS:
        return row_features(n, d, dtype, gen), None, ""
    return int_features((n, d), dtype, gen), 0.0, "exact, integer features"


ORDER_TOL_TEXT = "1e-4 + n·2^-24·(A·|x|), n the row's set bits"


def order_tol(plain, x: torch.Tensor) -> torch.Tensor:
    """The bound of two f32 summation orders over a row's n set bits,
    1e-4 + n·2^-24·(A·|x|), where ``plain(y)`` is the plain version's A·y
    for row-major y [R, D] (in either output orientation)."""
    count = plain(torch.ones((x.shape[0], 1), device=DEVICE))
    return ATOL + count * 2.0 ** -24 * plain(x.abs())


def hard_words(kind: str, r: int, w32: int, rng) -> np.ndarray:
    """A row-major uint32 bit slab [R, W32] of ``HARD_KINDS``: every bit
    set, bit 31 in every word, or the probes' 6 set bits a row with every
    third row empty and rows 256-1023 (six whole tiles) empty."""
    if kind == "every bit set":
        return np.full((r, w32), 0xFFFFFFFF, np.uint32)
    if kind == "bit 31 in every word":
        return np.full((r, w32), 1 << 31, np.uint32)
    k = 32 * w32
    words = pack_slab_bits(rng.integers(0, r, 6 * r), rng.integers(0, k, 6 * r),
                           r, k)
    words[::3] = 0
    words[256:1024] = 0
    return words


def dyadic(shape, dtype, gen: torch.Generator) -> torch.Tensor:
    """Features k/4, |k| <= 8: exact in bf16, every partial sum exact."""
    return (torch.randint(-8, 9, shape, generator=gen, device=DEVICE,
                          dtype=torch.float32) / 4).to(dtype)


def walk_tol(count: torch.Tensor, abs_sum: torch.Tensor, exact: bool):
    """A walk's tolerance against its plain version: exact for dyadic
    features; else 1e-4 + 2·n·2^-24·(A·|x|), n the row's set bits (at most
    K): each side's f32 sum of n exact products is within (n - 1)·2^-24 of
    the sum of their magnitudes."""
    if exact:
        return torch.zeros_like(abs_sum), "exact, dyadic features"
    return (ATOL + 2.0 * count * 2.0 ** -24 * abs_sum,
            "1e-4 + 2·n·2^-24·(A·|x|), n the row's set bits")


# every kernel's launch count at 0: a path's expected counts start here
NO_LAUNCHES = dict.fromkeys(spmm_cuda.KERNELS, 0)



# ---------------------------------------------------------------------------


def phase0() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    log(f"phase 0: card {smi}; {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, numpy {np.__version__}, nvcc: {nvcc}")
    return smi


def phase1() -> None:
    start = time.perf_counter()
    path, output = _build.build()
    _build.library()
    log(f"phase 1: built {path.rsplit('/', 1)[-1]} in "
        f"{time.perf_counter() - start:.1f} s")
    for line in output.splitlines():
        if "registers" in line or "spill" in line or "properties" in line:
            log(f"  ptxas: {line.strip()}")


def build_layouts():
    start = time.perf_counter()
    g = synthesize_graph(410236, 4878874, num_features=96, num_classes=22,
                         kind="web", seed=0)
    want = EXPECTED_GRAPH.get(np.__version__)
    got = (g.nnz, hybrid.graph_fingerprint(g))
    log(f"graph amazon0505-scale: numpy {np.__version__}, {got[0]} edges, "
        f"fingerprint {got[1]} (expected "
        f"{want if want else 'unknown for this numpy'})")
    require(want is None or got == want,
            f"the amazon0505-scale graph is {want} (edges, fingerprint) "
            f"under numpy {np.__version__}")
    head = InputProperty(g, hidden_dim=16, probe=False).decider()
    hts = head.build_tensors()
    hg = head.hybrid_graph
    log(f"layout amazon0505-scale (auto): {g.num_nodes} nodes, {g.nnz} edges, "
        f"diag_b={hg.diag_b} hot_k={hg.hot_k} res_ob={hg.res_ob} "
        f"res_tile={hg.res_tile} slots={hg.num_res_slots} "
        f"tiles={len(hg.res_t2b)} covers_all={hg.res_covers_all} "
        f"rows={hg.num_rows} ({time.perf_counter() - start:.1f} s)")
    start = time.perf_counter()
    fixed = InputProperty(g, hidden_dim=16, diag_b=512, hot_k=512,
                          probe=False).decider()
    fts = fixed.build_tensors()
    fg = fixed.hybrid_graph
    log(f"layout amazon0505-scale (diag 512, hot 512): res_ob={fg.res_ob} "
        f"res_tile={fg.res_tile} covers_all={fg.res_covers_all} "
        f"({time.perf_counter() - start:.1f} s)")
    start = time.perf_counter()
    g10 = synthesize_graph(10000, 120000, num_features=96, num_classes=22,
                           kind="powerlaw")
    small = InputProperty(g10, hidden_dim=16, probe=False).decider()
    sts = small.build_tensors()
    sg = small.hybrid_graph
    log(f"layout 10k power-law (auto): diag_b={sg.diag_b} hot_k={sg.hot_k} "
        f"res_ob={sg.res_ob} res_tile={sg.res_tile} "
        f"covers_all={sg.res_covers_all} ({time.perf_counter() - start:.1f} s)")
    per_block = np.bincount(hg.res_t2b, minlength=hg.num_rows // hg.res_ob)
    log(f"  residual tiles per output block (auto layout): mean "
        f"{per_block.mean():.2f}, p99 {np.percentile(per_block, 99):.0f}, "
        f"max {per_block.max()}")
    require((hg.diag_b, hg.hot_k, hg.res_ob, hg.res_tile) == (0, 4096, 512, 256)
            and hg.res_covers_all, "headline layout is hot-4096 + residual "
            "(512, 256) covering every block")
    require(sg.diag_b == 4096 and sg.hot_k == 0 and not sg.res_covers_all,
            "10k layout is diag-4096 with a residual that leaves blocks empty")
    return (g, head, hts), (g, fixed, fts), (g10, small, sts)


def uncovered(hg):
    """The headline residual stream with the tiles of odd blocks dropped:
    a stream at the same geometry in which half the blocks have no tile.
    Returns both masks (transposed, row-major), t2b, block_ptr, the slot
    count and the kept slots' rows of x (``res_gather[res_dst]``)."""
    keep = (hg.res_t2b % 2) == 0
    tiles = np.nonzero(keep)[0]
    ob, s = hg.res_ob, hg.res_tile
    lanes = (tiles[:, None] * ob + np.arange(ob)[None, :]).reshape(-1)
    mask_s = np.ascontiguousarray(hg.res_mask_s[:, lanes])
    slots = (tiles[:, None] * s + np.arange(s)[None, :]).reshape(-1)
    mask = np.ascontiguousarray(hg.res_mask[:, slots])
    t2b = hg.res_t2b[keep]
    ptr = np.searchsorted(t2b, np.arange(hg.num_rows // ob + 1))
    src = hg.res_gather[hg.res_dst[slots]].astype(np.int32)
    return mask_s, mask, t2b, ptr.astype(np.int32), len(tiles) * s, src


def rowmajor_tensors(layouts) -> dict:
    """The row-major tensors of the three layouts, from the host layouts
    already built (GIN's path on the auto layout, GCN's on the other
    two)."""
    start = time.perf_counter()
    (_, head, _), (_, fixed, _), (_, small, _) = layouts
    kw = dict(agg_dtype="bfloat16", transposed=False, device=DEVICE)
    rm = {
        "gin": build_layer_tensors(head.hybrid_graph, **kw),
        "fixed": build_layer_tensors(fixed.hybrid_graph, **kw),
        "small": build_layer_tensors(small.hybrid_graph, **kw),
    }
    slots = {k: hts[0].res_src.numel() for k, hts in rm.items()
             if hts[0].res_t2b is not None}
    log(f"layouts row-major: residual slots (one id each, both layers) "
        f"{slots} "
        f"({time.perf_counter() - start:.1f} s)")
    require(all(hts[0] is hts[1] for hts in rm.values())
            and all(h.res_mask is not None and h.res_mask_s is None
                    and h.res_src is not None
                    for hts in rm.values() for h in hts
                    if h.res_t2b is not None),
            "row-major tensors are one set for both layers, and keep the "
            "row-major mask and each slot's row of x only")
    return rm


def phase2(layouts, recs) -> None:
    (_, head, hts), (_, fixed, fts), (_, small, sts) = layouts
    hg, fg, sg = head.hybrid_graph, fixed.hybrid_graph, small.hybrid_graph
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    log("phase 2: kernels against their plain versions on the card")

    # --- slab_matmul_t: hot K=4096, diag B=512 and B=4096 ---------------
    # x_t as the aggregation hands it over: the view of a row-major table
    rec = recs["slab_matmul_t"]
    cases = [("hot K=4096", hts[0].hot_bits, None, hg.hot_k),
             ("diag B=512", fts[0].diag_bits, 512, fg.num_rows),
             ("diag B=4096", sts[0].diag_bits, 4096, sg.num_rows)]
    for label, bits, block, cols in cases:
        for d in DIMS:
            for dt in DTYPES:
                x = features(d, cols, dt, gen)
                xv = as_table(x)
                compare(rec, f"slab_matmul_t {label} D={d} {dt}",
                        lambda: spmm_cuda.slab_matmul_t(bits, xv, block),
                        lambda: spmm_cuda.slab_matmul_t_plain(bits, x, block))
    # timed at the main path's aggregations: hot, D=16 and 22, bf16
    bits = hts[0].hot_bits
    j, r = bit_coords(hg.hot_bits)
    a = csr(r, j, (hg.num_rows, hg.hot_k))
    for d in (16, 22):
        x = features(d, hg.hot_k, torch.bfloat16, gen)
        xv = as_table(x)
        xr = x.float().t().contiguous()
        timed(rec, f"hot K=4096 D={d} bf16 ({len(j)} nnz)",
              lambda: spmm_cuda.slab_matmul_t(bits, xv),
              lambda: spmm_cuda.slab_matmul_t_plain(bits, x),
              lambda: torch.sparse.mm(a, xr),
              bits.numel() * 2 + x.numel() * 2 + d * hg.num_rows * 4,
              len(j) * d, record=d == 16)

    # --- fused_slab_matmul_t at (512, 512) ------------------------------
    rec = recs["fused_slab_matmul_t"]
    dbits, hbits = fts[0].diag_bits, fts[0].hot_bits
    for d in DIMS:
        for dt in DTYPES:
            x = features(d, fg.num_rows, dt, gen)
            xh = features(d, fg.hot_k, dt, gen)
            xv, xhv = as_table(x), as_table(xh)
            compare(rec, f"fused_slab_matmul_t (512, 512) D={d} {dt}",
                    lambda: spmm_cuda.fused_slab_matmul_t(
                        dbits, hbits, xv, xhv, 512),
                    lambda: spmm_cuda.fused_slab_matmul_t_plain(
                        dbits, hbits, x, xh, 512))
    jd, rd = bit_coords(fg.diag_bits)
    jh, rh = bit_coords(fg.hot_bits)
    a = csr(np.concatenate([rd, rh]),
            np.concatenate([(rd // 512) * 512 + jd, fg.num_rows + jh]),
            (fg.num_rows, fg.num_rows + fg.hot_k))
    nnz = len(jd) + len(jh)
    for d in (16, 22):
        x = features(d, fg.num_rows, torch.bfloat16, gen)
        xh = features(d, fg.hot_k, torch.bfloat16, gen)
        xv, xhv = as_table(x), as_table(xh)
        xr = torch.cat([x, xh], dim=1).float().t().contiguous()
        timed(rec, f"(512, 512) D={d} bf16 ({nnz} nnz)",
              lambda: spmm_cuda.fused_slab_matmul_t(dbits, hbits, xv, xhv, 512),
              lambda: spmm_cuda.fused_slab_matmul_t_plain(
                  dbits, hbits, x, xh, 512),
              lambda: torch.sparse.mm(a, xr),
              dbits.numel() * 2 + hbits.numel() * 2 + x.numel() * 2
              + xh.numel() * 2 + d * fg.num_rows * 4, nnz * d,
              record=d == 16)

    # --- residual_combine_t at (OB 512, S 256): covering or not ---------
    # every stream gathering its slot rows from x by res_src, without and
    # with an addend
    rec = recs["residual_combine_t"]
    ht, st = hts[0], sts[0]
    m_pad = hg.num_res_slots
    mask_u, _, t2b_u, ptr_u, _, src_u = uncovered(hg)
    mask_u, t2b_u, ptr_u, src_u = (torch.from_numpy(a).to(DEVICE)
                                   for a in (mask_u, t2b_u, ptr_u, src_u))
    streams = [
        ("(512, 256) covering", ht.res_src, ht.res_mask_s, ht.res_t2b,
         ht.res_block_ptr, hg.num_rows, hg.res_ob),
        ("(512, 256) half the blocks empty", src_u, mask_u, t2b_u, ptr_u,
         hg.num_rows, hg.res_ob),
        (f"10k ({sg.res_ob}, {sg.res_tile}) not covering", st.res_src,
         st.res_mask_s, st.res_t2b, st.res_block_ptr, sg.num_rows, sg.res_ob),
    ]
    for label, src, mask_s, t2b, ptr, rows, ob in streams:
        for d in DIMS:
            for dt in DTYPES:
                x = features(d, rows, dt, gen)
                xv = as_table(x)
                h = features(d, rows, torch.float32, gen)
                for add in (None, h):
                    compare(rec, f"residual_combine_t {label} D={d} {dt}"
                            f"{'' if add is None else ' + addend'}",
                            lambda: spmm_cuda.residual_combine_t(
                                xv, src, mask_s, t2b, ptr, rows, ob, add),
                            lambda: spmm_cuda.residual_combine_t_plain(
                                x, src, mask_s, t2b, ptr, rows, ob, add))
    residual_rejects_bad_ids("residual_combine_t", BAD_ID_RUN_T)
    # the library calls: the same function, a CSR of the residual's edges
    # over x (and the addend with torch.addmm)
    s, lane = bit_coords(hg.res_mask_s)
    tile = lane // hg.res_ob
    src_h = ht.res_src.cpu().numpy()
    a_x = csr(hg.res_t2b[tile].astype(np.int64) * hg.res_ob
              + lane % hg.res_ob, src_h[tile * hg.res_tile + s],
              (hg.num_rows, hg.num_rows))
    args = (ht.res_src, ht.res_mask_s, ht.res_t2b, ht.res_block_ptr,
            hg.num_rows, hg.res_ob)
    fixed_bytes = (ht.res_mask_s.numel() * 2 + ht.res_src.numel() * 4
                   + ht.res_t2b.numel() * 4 + ht.res_block_ptr.numel() * 4)
    for d in (16, 22):
        x = features(d, hg.num_rows, torch.bfloat16, gen)
        xv = as_table(x)
        xr = x.float().t().contiguous()
        h = features(d, hg.num_rows, torch.float32, gen)
        hr = h.t().contiguous()
        x_bytes = x.numel() * 2 + d * hg.num_rows * 4
        timed(rec, f"(512, 256) D={d} bf16 ({len(s)} nnz), from x",
              lambda: spmm_cuda.residual_combine_t(xv, *args),
              lambda: spmm_cuda.residual_combine_t_plain(x, *args),
              lambda: torch.sparse.mm(a_x, xr), fixed_bytes + x_bytes,
              len(s) * d, record=d == 16)
        timed(rec, f"(512, 256) D={d} bf16, from x + addend",
              lambda: spmm_cuda.residual_combine_t(xv, *args, h),
              lambda: spmm_cuda.residual_combine_t_plain(x, *args, h),
              lambda: torch.addmm(hr, a_x, xr),
              fixed_bytes + x_bytes + h.numel() * 4, len(s) * d,
              record=False, lib_name="torch.addmm (f32 CSR)")

    # --- the whole transposed aggregation against one library call -------
    g = layouts[0][0]
    a_all = all_edges(g)
    n = g.num_nodes
    for d in (16, 22):
        # f32 features of bf16 values, as the model hands them over: the
        # aggregation casts them to bf16 exactly and returns f32
        x = features(d, hg.num_rows, torch.bfloat16, gen).float()
        x[:, n:] = 0  # padding rows carry no features
        xf = x[:, :n].t().contiguous()
        got = hybrid_aggregate(x, ht, False)[:, :n]
        want = torch.sparse.mm(a_all, xf).t()
        tol = ATOL + 2.0 ** -16 * torch.sparse.mm(a_all, xf.abs()).t()
        err = float((got - want).abs().max())
        require(bool(((got - want).abs() <= tol).all()),
                f"transposed aggregation D={d} disagrees with the edges")
        ms = time_ms(lambda: hybrid_aggregate(x, ht, False))
        lib = time_ms(lambda: torch.sparse.mm(a_all, xf))
        log(f"  transposed aggregation (table, hot gather, hot slab, "
            f"residual + addend) D={d}, bf16 aggregation of f32 x: "
            f"{ms:.4f} ms, torch.sparse.mm (f32 CSR, all {g.nnz} edges) "
            f"{lib:.4f} ms; max_abs_err against it {err:.3e} "
            "(tolerance 1e-4 + 2^-16·(A·|x|))")
        del got, want, tol


def all_edges(g) -> torch.Tensor:
    """The graph's adjacency as a 0/1 CSR on the card."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(np.asarray(g.row_pointers, dtype=np.int64)),
        torch.from_numpy(np.asarray(g.column_index, dtype=np.int64)),
        torch.ones(g.nnz, dtype=torch.float32),
        (g.num_nodes, g.num_nodes)).to(DEVICE)


def timed(rec: Record, label: str, kernel, plain, library, nbytes: int,
          adds: int, record: bool, lib_name: str = "torch.sparse.mm (f32 CSR)",
          rate: float = F32_OPS_PER_S) -> None:
    """Time a kernel at one shape beside one library call (``lib_name``)
    and, where given, its plain version; with ``record``, keep the three
    times with the bound (``adds`` operations at ``rate``) in ``rec``."""
    ms = time_ms(kernel)
    lib_ms = time_ms(library)
    plain_ms = None if plain is None else time_ms(plain)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = adds / rate * 1e3
    extra = "" if plain_ms is None else f", plain {plain_ms:.4f} ms"
    if record:
        rec.ms, rec.library_ms, rec.plain_ms = ms, lib_ms, plain_ms
        bound(rec, nbytes, adds, rate)
    log(f"  {rec.name} {label}: {ms:.4f} ms{extra}, {lib_name} "
        f"{lib_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")


# A residual combine whose slot ids name a row past x, run in a process of
# its own: the kernel's device-side assert ends that process's use of the
# card.  One for each orientation.
BAD_ID_RUN = '''
import torch
from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda
x = torch.ones((64, 8), device="cuda")
src = torch.zeros(128, dtype=torch.int32, device="cuda")
src[77] = 64
mask = torch.zeros((4, 128), dtype=torch.int32, device="cuda").view(
    torch.uint32)
t2b = torch.zeros(1, dtype=torch.int32, device="cuda")
ptr = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
spmm_cuda.residual_combine(x, src, mask, t2b, ptr, 128, 128)
torch.cuda.synchronize()
print("no error")
'''
BAD_ID_RUN_T = '''
import torch
from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda
x_t = spmm_cuda.row_table_t(torch.ones((8, 64), device="cuda")).t()
src = torch.zeros(128, dtype=torch.int32, device="cuda")
src[77] = 64
mask_s = torch.zeros((8, 128), dtype=torch.int16, device="cuda").view(
    torch.uint16)
t2b = torch.zeros(1, dtype=torch.int32, device="cuda")
ptr = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
spmm_cuda.residual_combine_t(x_t, src, mask_s, t2b, ptr, 128, 128)
torch.cuda.synchronize()
print("no error")
'''


def residual_rejects_bad_ids(name: str, run: str) -> None:
    """The residual kernel ``name`` on the card stops on a slot id outside
    x (one row past it) rather than reading past x."""
    proc = subprocess.run(
        [sys.executable, "-c", run], capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    said = (proc.stdout + proc.stderr).strip().splitlines()
    log(f"  {name} with a slot id past x: exit {proc.returncode}, "
        f"{said[-1] if said else 'no output'}")
    require(proc.returncode != 0 and "no error" not in proc.stdout
            and "assert" in proc.stderr.lower(),
            f"{name} read a slot id outside x without an error")


def phase2_rowmajor(layouts, rm, recs) -> None:
    """The row-major kernels against their plain versions, at the shapes of
    the row-major paths (GIN's widths 96 and 64, GCN's 16 and 22, and 5)."""
    (_, head, _), (_, fixed, _), (_, small, _) = layouts
    hg, fg, sg = head.hybrid_graph, fixed.hybrid_graph, small.hybrid_graph
    ht, ft, st = rm["gin"][0], rm["fixed"][0], rm["small"][0]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    log("phase 2 (row-major): kernels against their plain versions on the "
        "card")

    # --- slab_matmul: hot K=4096, diag B=512 and B=4096 -----------------
    rec = recs["slab_matmul"]
    # plus a slab whose rows end inside the kernel's last 128-row tile
    rng = np.random.default_rng(2)
    odd_r = 8_200
    odd = torch.from_numpy(pack_slab_bits_t(
        rng.integers(0, odd_r, 40_000), rng.integers(0, 512, 40_000), odd_r,
        512)).to(DEVICE)
    cases = [("hot K=4096", ht.hot_bits, None, hg.hot_k),
             ("diag B=512", ft.diag_bits, 512, fg.num_rows),
             ("diag B=4096", st.diag_bits, 4096, sg.num_rows),
             (f"hot K=512 R={odd_r} random", odd, None, 512)]
    for label, bits, block, n in cases:
        for d in ROW_DIMS + WIDE_DIMS:
            for dt in DTYPES:
                x, tol, tol_text = slab_case(n, d, dt, gen)
                compare(rec, f"slab_matmul {label} D={d} {dt}",
                        lambda: spmm_cuda.slab_matmul(bits, x, block),
                        lambda: spmm_cuda.slab_matmul_plain(bits, x, block),
                        tol, tol_text)
        # the wide tables with random f32 features too, within the bound of
        # two f32 summation orders over the row's n set bits
        for d in WIDE_DIMS:
            x = row_features(n, d, torch.float32, gen)
            tol = order_tol(
                lambda y: spmm_cuda.slab_matmul_plain(bits, y, block), x)
            compare(rec, f"slab_matmul {label} D={d} float32 random",
                    lambda: spmm_cuda.slab_matmul(bits, x, block),
                    lambda: spmm_cuda.slab_matmul_plain(bits, x, block), tol,
                    ORDER_TOL_TEXT)
            del tol
    # timed at the main path's hidden aggregations (hot, D=64, bf16)
    bits = ht.hot_bits
    j, r = bit_coords(hg.hot_bits)
    a = csr(r, j, (hg.num_rows, hg.hot_k))
    for d in (GIN_HIDDEN, 96, 16, WIDE_DIMS[0]):
        x = row_features(hg.hot_k, d, torch.bfloat16, gen)
        xf = x.float()
        timed(rec, f"hot K=4096 D={d} bf16 ({len(j)} nnz)",
              lambda: spmm_cuda.slab_matmul(bits, x),
              lambda: spmm_cuda.slab_matmul_plain(bits, x),
              lambda: torch.sparse.mm(a, xf),
              bits.numel() * 2 + x.numel() * 2 + d * hg.num_rows * 4,
              len(j) * d, record=d == GIN_HIDDEN)

    # --- fused_slab_matmul at (512, 512) --------------------------------
    rec = recs["fused_slab_matmul"]
    dbits, hbits = ft.diag_bits, ft.hot_bits
    for d in ROW_DIMS + WIDE_DIMS:
        for dt in DTYPES:
            x, tol, tol_text = slab_case(fg.num_rows, d, dt, gen)
            xh, _, _ = slab_case(fg.hot_k, d, dt, gen)
            compare(rec, f"fused_slab_matmul (512, 512) D={d} {dt}",
                    lambda: spmm_cuda.fused_slab_matmul(
                        dbits, hbits, x, xh, 512),
                    lambda: spmm_cuda.fused_slab_matmul_plain(
                        dbits, hbits, x, xh, 512), tol, tol_text)
    jd, rd = bit_coords(fg.diag_bits)
    jh, rh = bit_coords(fg.hot_bits)
    a = csr(np.concatenate([rd, rh]),
            np.concatenate([(rd // 512) * 512 + jd, fg.num_rows + jh]),
            (fg.num_rows, fg.num_rows + fg.hot_k))
    nnz = len(jd) + len(jh)
    # timed at the path that launches it: GCN's first aggregation, D=16
    for d in (16, GIN_HIDDEN):
        x = row_features(fg.num_rows, d, torch.bfloat16, gen)
        xh = row_features(fg.hot_k, d, torch.bfloat16, gen)
        xr = torch.cat([x, xh], dim=0).float()
        timed(rec, f"(512, 512) D={d} bf16 ({nnz} nnz)",
              lambda: spmm_cuda.fused_slab_matmul(dbits, hbits, x, xh, 512),
              lambda: spmm_cuda.fused_slab_matmul_plain(
                  dbits, hbits, x, xh, 512),
              lambda: torch.sparse.mm(a, xr),
              dbits.numel() * 2 + hbits.numel() * 2 + x.numel() * 2
              + xh.numel() * 2 + d * fg.num_rows * 4, nnz * d,
              record=d == 16)

    # --- residual_combine at (OB 512, S 256): covering or not -----------
    # every stream through its slots' rows of x (res_src) and over gathered
    # rows (res_src = arange), each without and with an addend
    rec = recs["residual_combine"]
    m_pad = hg.num_res_slots
    _, mask_u, t2b_u, ptr_u, m_u, src_u = uncovered(hg)
    mask_u, t2b_u, ptr_u, src_u = (torch.from_numpy(a).to(DEVICE)
                                   for a in (mask_u, t2b_u, ptr_u, src_u))
    streams = [
        ("(512, 256) covering", ht.res_src, ht.res_mask, ht.res_t2b,
         ht.res_block_ptr, hg.num_rows, hg.res_ob),
        ("(512, 256) half the blocks empty", src_u, mask_u, t2b_u, ptr_u,
         hg.num_rows, hg.res_ob),
        (f"10k ({sg.res_ob}, {sg.res_tile}) not covering", st.res_src,
         st.res_mask, st.res_t2b, st.res_block_ptr, sg.num_rows, sg.res_ob),
    ]
    # and random streams at other geometries: blocks of 4 mask words
    # (OB 128, S 64) and of 32, split over two blocks of threads (OB 1024,
    # S 32)
    for ob, tile in ((128, 64), (1024, 32)):
        n_rows = 16_384
        rs = rng.integers(0, n_rows, 60_000)
        rd = rng.integers(0, n_rows, 60_000)
        rs, rd = np.unique(np.stack([rs, rd]), axis=1)
        gather, dst, mask, _, t2b, _ = build_residual_stream(
            rs, rd, n_rows, n_rows, tile, ob)
        ptr = np.searchsorted(t2b, np.arange(n_rows // ob + 1))
        streams.append((f"random ({ob}, {tile})", *(
            torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE) for a in (
                gather[dst].astype(np.int32), mask, t2b,
                ptr.astype(np.int32))), n_rows, ob))
    for label, src, mask, t2b, ptr, n_rows, ob in streams:
        arange = torch.arange(src.shape[0], dtype=torch.int32, device=DEVICE)
        for d in ROW_DIMS:
            for dt in DTYPES:
                x = row_features(n_rows, d, dt, gen)
                rows = row_features(src.shape[0], d, dt, gen)
                h = row_features(n_rows, d, torch.float32, gen)
                for via, xs, ids in (("res_src", x, src),
                                     ("arange", rows, arange)):
                    for add in (None, h):
                        compare(
                            rec, f"residual_combine {label} D={d} {dt} "
                            f"{via}{'' if add is None else ' + addend'}",
                            lambda: spmm_cuda.residual_combine(
                                xs, ids, mask, t2b, ptr, n_rows, ob, add),
                            lambda: spmm_cuda.residual_combine_plain(
                                xs, ids, mask, t2b, ptr, n_rows, ob, add))
    residual_rejects_bad_ids("residual_combine", BAD_ID_RUN)
    # the library calls: the same function (edges over x), and the old
    # one over the gathered slot rows
    o, slot = mask32_coords(hg.res_mask)
    out_row = hg.res_t2b[slot // hg.res_tile].astype(np.int64) * hg.res_ob + o
    res_src = ht.res_src.cpu().numpy()
    a_x = csr(out_row, res_src[slot], (hg.num_rows, hg.num_rows))
    a_rows = csr(out_row, slot, (hg.num_rows, m_pad))
    args = (ht.res_src, ht.res_mask, ht.res_t2b, ht.res_block_ptr,
            hg.num_rows, hg.res_ob)
    fixed_bytes = (ht.res_mask.numel() * 4 + ht.res_src.numel() * 4
                   + ht.res_t2b.numel() * 4 + ht.res_block_ptr.numel() * 4)
    for d in (GIN_HIDDEN, 96, 16):
        x = row_features(hg.num_rows, d, torch.bfloat16, gen)
        xf = x.float()
        h = row_features(hg.num_rows, d, torch.float32, gen)
        x_bytes = x.numel() * 2 + d * hg.num_rows * 4
        timed(rec, f"(512, 256) D={d} bf16 ({len(o)} nnz), from x",
              lambda: spmm_cuda.residual_combine(x, *args),
              lambda: spmm_cuda.residual_combine_plain(x, *args),
              lambda: torch.sparse.mm(a_x, xf), fixed_bytes + x_bytes,
              len(o) * d, record=d == GIN_HIDDEN)
        timed(rec, f"(512, 256) D={d} bf16, from x + addend",
              lambda: spmm_cuda.residual_combine(x, *args, h),
              None, lambda: torch.addmm(h, a_x, xf),
              fixed_bytes + x_bytes + h.numel() * 4, len(o) * d,
              record=False, lib_name="torch.addmm (f32 CSR)")
        rows = x.index_select(0, ht.res_src)
        rows_f = rows.float()
        log(f"  residual_combine (512, 256) D={d} bf16: the old yardstick, "
            "torch.sparse.mm over the gathered slot rows: "
            f"{time_ms(lambda: torch.sparse.mm(a_rows, rows_f)):.4f} ms")
        del rows, rows_f

    # --- the whole row-major aggregation against one library call --------
    g = layouts[0][0]
    a_all = all_edges(g)
    n = g.num_nodes
    for d in (GIN_HIDDEN, 96):
        # f32 features of bf16 values, as the model hands them over: the
        # aggregation casts them to bf16 exactly and returns f32
        x = row_features(hg.num_rows, d, torch.bfloat16, gen).float()
        x[n:] = 0  # padding rows carry no features
        xf = x[:n]
        got = hybrid_aggregate(x, ht, False)[:n]
        want = torch.sparse.mm(a_all, xf)
        tol = ATOL + 2.0 ** -16 * torch.sparse.mm(a_all, xf.abs())
        err = float((got - want).abs().max())
        require(bool(((got - want).abs() <= tol).all()),
                f"row-major aggregation D={d} disagrees with the edges")
        ms = time_ms(lambda: hybrid_aggregate(x, ht, False))
        lib = time_ms(lambda: torch.sparse.mm(a_all, xf))
        log(f"  row-major aggregation (hot slab + residual) D={d}, bf16 "
            "aggregation of f32 x: "
            f"{ms:.4f} ms, torch.sparse.mm (f32 CSR, all {g.nnz} edges) "
            f"{lib:.4f} ms; max_abs_err against it {err:.3e} "
            "(tolerance 1e-4 + 2^-16·(A·|x|))")
        del got, want, tol


@contextlib.contextmanager
def plain_kernels():
    """Route the hybrid path through the plain versions (for comparison)."""
    saved = {n: getattr(spmm_cuda, n) for n in spmm_cuda.KERNELS}
    plain = {
        "slab_matmul_t": spmm_cuda.slab_matmul_t_plain,
        "fused_slab_matmul_t": spmm_cuda.fused_slab_matmul_t_plain,
        "residual_combine_t": spmm_cuda.residual_combine_t_plain,
        "slab_matmul": spmm_cuda.slab_matmul_plain,
        "fused_slab_matmul": spmm_cuda.fused_slab_matmul_plain,
        "residual_combine": spmm_cuda.residual_combine_plain,
    }
    try:
        for n, fn in plain.items():
            setattr(spmm_cuda, n, fn)
        yield
    finally:
        for n, fn in saved.items():
            setattr(spmm_cuda, n, fn)


def model_inputs(graph, prop, hts, model: str, hidden: int):
    """Features in the layout's orientation, labels, row mask and a fresh
    model on the card."""
    x = prop.pad_features(graph.init_embedding(graph.num_features))
    x = torch.from_numpy(x.T.copy() if is_transposed(hts[0]) else x).to(DEVICE)
    y = torch.from_numpy(prop.pad_features(graph.init_labels(22))).to(DEVICE)
    mask = row_mask(prop)
    if mask is not None:
        mask = torch.from_numpy(mask).to(DEVICE)
    net = MODELS[model](graph.num_features, hidden, 22, device=DEVICE)
    return x, y, mask, net


def row_mask(prop):
    """The hybrid layout's row mask; None for the ELL, dense and COO
    tensors, which have no padding rows."""
    return None if prop.hybrid_graph is None else prop.hybrid_graph.row_mask


@contextlib.contextmanager
def counted_gathers():
    """Count ``Tensor.index_select`` calls (each one gather launch on the
    card) in the block; yields a list that gets one entry per call."""
    calls = []
    select = torch.Tensor.index_select

    def counting(t, *args, **kwargs):
        calls.append(tuple(t.shape))
        return select(t, *args, **kwargs)

    torch.Tensor.index_select = counting
    try:
        yield calls
    finally:
        torch.Tensor.index_select = select


def first_step(graph, prop, hts, label: str, model: str = "gcn",
               hidden: int = 16, rtol: float = STEP_RTOL):
    """One forward/backward on the kernels and on the plain versions, same
    weights: loss and gradients must agree.  Returns the kernel run's
    launch counts and its number of ``index_select`` gathers."""
    x, y, mask, net = model_inputs(graph, prop, hts, model, hidden)
    run = step_run(net, x, y, mask, hts)
    spmm_cuda.reset_launches()
    with counted_gathers() as gathers:
        loss_k, grads_k = run()
    counts = dict(spmm_cuda.launches)
    with plain_kernels():
        loss_p, grads_p = run()
    agree(label, net, (loss_k, grads_k), (loss_p, grads_p), rtol,
          f"launches { {k: v for k, v in counts.items() if v} }, "
          f"index_select gathers {len(gathers)}")
    return counts, len(gathers)


def step_run(net, x, y, mask, hts):
    """One forward/backward of ``net``: returns (loss, gradients)."""
    transposed = is_transposed(hts[0])

    def run():
        net.zero_grad(set_to_none=True)
        loss = nll_loss(net(x, hts), y, mask, transposed)
        loss.backward()
        return loss.detach(), [p.grad.detach().clone() for p in net.parameters()]

    return run


def agree(label: str, net, got, want, rtol: float, note: str = "",
          against: str = "plain") -> None:
    """A step's (loss, gradients) against another path's, within ``rtol``
    relative (gradients: of the largest value)."""
    (loss_k, grads_k), (loss_p, grads_p) = got, want
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    log(f"  {label} first step: loss {float(loss_k):.6f} ({against} "
        f"{float(loss_p):.6f}, rel {rel:.2e}, bound {rtol:.2e}); {note}")
    require(math.isfinite(float(loss_k)) and rel <= rtol,
            f"{label}: first-step loss disagrees with the {against} path")
    names = [n for n, _ in net.named_parameters()]
    for name, gk, gp in zip(names, grads_k, grads_p):
        gk = gk.to(gp.device)
        grel = float((gk - gp).abs().max() / gp.abs().max())
        log(f"  {label} grad {name}: max rel err {grel:.2e}")
        require(bool(torch.isfinite(gk).all()) and grel <= rtol,
                f"{label}: gradient {name} disagrees with the {against} path")


def train(graph, prop, hts, epochs: int, dry: int, model: str = "gcn",
          hidden: int = 16, use_scan: bool = True):
    """Reset the launch counts, train (``use_scan``: through the captured
    step, train_and_time's default), and return (result, kernel runs).
    A captured step's kernels pass their wrappers once, at capture, and
    run once per replay, which passes no wrapper: the runs are the
    wrappers' counts plus the captured step's launches for every replay
    after the first.  The capture must have launched what each eager step
    launched."""
    x = prop.pad_features(graph.init_embedding(graph.num_features))
    y = prop.pad_features(graph.init_labels(22))
    spmm_cuda.reset_launches()
    res = train_and_time(model, hts, x, y, hidden, 22, num_epochs=epochs,
                         dry_run=dry, mask=row_mask(prop), device=DEVICE,
                         use_scan=use_scan)
    counts = dict(spmm_cuda.launches)
    per_graph = res["graph_launches"]
    on_card = torch.device(DEVICE).type == "cuda"
    require((per_graph is not None) == (use_scan and epochs > 0 and on_card),
            "train_and_time captured the step exactly when asked to")
    if per_graph is not None:
        eager = res["step"] - res["replays"]
        require(counts == {k: v * (eager + 1) for k, v in per_graph.items()},
                f"the captured step launched what each of the {eager} eager "
                f"steps launched ({per_graph} a step; wrappers {counts})")
        counts = {k: counts[k] + per_graph[k] * (res["replays"] - 1)
                  for k in counts}
    losses = res["losses"]
    require(len(losses) == res["step"] >= epochs + dry
            and all(map(math.isfinite, losses)), "every loss is finite")
    require(len(losses) == 1 or losses[-1] < losses[0],
            "training lowers the loss")
    return res, counts


def log_windows(name: str, res: dict) -> None:
    """The timing protocol's result: the fit and its windows' spread."""
    per = [w / res["chunk"] for w in res["window_ms"]]
    log(f"  {name} {res['epoch_ms']:.4f} (two-point fit: {len(per)} windows "
        f"of {res['chunk']} epochs against "
        f"{len(res['window2_ms'])} of {res['chunk2']}; exec_fixed_ms "
        f"{res['exec_fixed_ms']:.4f}); per-epoch ms of the {res['chunk']}-"
        f"epoch windows: median {statistics.median(per):.4f}, min "
        f"{min(per):.4f}, max {max(per):.4f}")


def phase3(layouts, recs) -> float:
    g, head, hts = layouts[0]
    log("phase 3: GCN 96 -> 16 -> 22 on the amazon0505-scale auto layout")
    counts, gathers = first_step(g, head, hts, "auto layout")
    require(counts == {**NO_LAUNCHES, "slab_matmul_t": 4,
                       "residual_combine_t": 4},
            "one GCN step launches 4 hot slab and 4 residual kernels")
    require(gathers == 4, "one GCN step gathers 4 times (the hot table of "
            "each aggregation; the residual kernel gathers its slot rows "
            "itself)")
    res, counts = train(g, head, hts, epochs=TIMED_EPOCHS, dry=5)
    steps = res["step"]
    log(f"  trained {steps} steps ({res['replays']} replays of the captured "
        f"step): loss {res['losses'][0]:.5f} -> {res['losses'][-1]:.5f}; "
        f"kernel runs {counts}; wrapper launches "
        f"{ {k: v for k, v in spmm_cuda.launches.items() if v} }, "
        f"{ {k: v for k, v in res['graph_launches'].items() if v} } a replay")
    require(counts == {**NO_LAUNCHES, "slab_matmul_t": 4 * steps,
                       "residual_combine_t": 4 * steps},
            "hot and residual kernels run exactly 4 times per step")
    recs["slab_matmul_t"].launches = spmm_cuda.launches["slab_matmul_t"]
    recs["residual_combine_t"].launches = spmm_cuda.launches[
        "residual_combine_t"]
    log_windows("epoch_ms (captured)", res)
    log_profile("epoch_ms (captured)", res["epoch_ms"],
                profile_steps(g, head, hts, "gcn", 16, use_scan=True))
    return res["epoch_ms"]


def log_profile(name: str, epoch_ms: float, busy: float) -> None:
    """The device's idle share of the unprofiled step time ``epoch_ms``."""
    if busy:
        log(f"  device idle share of {name}: {1 - busy / epoch_ms:.3f} "
            "(profiled busy time against the unprofiled step)")
    else:
        log(f"  device busy time of {name} not measured: the profiler saw "
            "no device activity, or lost kernel runs")


def phase4(layouts, recs) -> None:
    log("phase 4: the other wirings")
    g, fixed, fts = layouts[1]
    _, gathers = first_step(g, fixed, fts, "diag 512 + hot 512")
    require(gathers == 4, "one GCN step gathers the hot table 4 times")
    _, counts = train(g, fixed, fts, epochs=0, dry=3)
    log(f"  diag 512 + hot 512, 3 steps: launches {counts}")
    require(counts == {**NO_LAUNCHES, "fused_slab_matmul_t": 12,
                       "residual_combine_t": (
                           12 if fixed.hybrid_graph.num_res_slots else 0)},
            "both slab tiers run as one fused launch per aggregation")
    recs["fused_slab_matmul_t"].launches = counts["fused_slab_matmul_t"]
    g10, small, sts = layouts[2]
    _, gathers = first_step(g10, small, sts, "10k power-law")
    require(gathers == 0, "a layout without a hot tier gathers nothing")
    _, counts = train(g10, small, sts, epochs=0, dry=3)
    log(f"  10k power-law (diag 4096, residual not covering), 3 steps: "
        f"launches {counts}")
    require(counts == {**NO_LAUNCHES, "slab_matmul_t": 12,
                       "residual_combine_t": 12},
            "diag-4096 and residual kernels launch 4 times per step")


def profile_steps(graph, prop, hts, model: str, hidden: int,
                  steps: int = 3, use_scan: bool = False) -> float:
    """Device time by kernel over a few training steps (torch.profiler),
    step by step or (``use_scan``) replays of the captured step; logs the
    largest entries and returns the device's busy ms per step: 0 when the
    profiler saw no device activity, or saw fewer runs of the hybrid
    kernels than the steps ran (it lost events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    x, y, mask, net = model_inputs(graph, prop, hts, model, hidden)
    opt = make_optimizer(net)
    train_step = make_train_step(net, hts, opt, mask)

    def step():
        train_step(x, y)

    if use_scan:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        # replays: one before the profiler, its warm-up step, ``steps``
        captured = make_captured_step(net, hts, opt, x, y, mask,
                                      capacity=steps + 2)
        step = captured.replay
    step()
    torch.cuda.synchronize()
    # one warm-up step inside the profiler before the recorded ones (its
    # events are dropped), each step finished before the next begins; the
    # last step ends with the block, which keeps the recorded cycle
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps)) as prof:
        for i in range(steps + 1):
            if i == 1:
                spmm_cuda.reset_launches()
            step()
            torch.cuda.synchronize()
            if i < steps:
                prof.step()
    runs = sum((captured.launches if use_scan else spmm_cuda.launches)
               .values()) * (steps if use_scan else 1)
    # device-side entries only: an operator's entry repeats its kernels'
    # time, and so does a user annotation's device range (the optimizer's)
    events = [(e.key, e.count, e.self_device_time_total)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.self_device_time_total > 0]
    busy = sum(t for *_, t in events) / steps / 1e3
    seen = sum(n for key, n, _ in events if "gnna::" in key)
    log(f"  profile of {steps} {model} "
        f"{'replays of the captured step' if use_scan else 'steps'}: "
        f"device busy {busy:.4f} ms per "
        f"step in {len(events)} kinds of kernel or copy; it saw {seen} of "
        f"the {runs} hybrid kernel runs")
    for key, n, t in sorted(events, key=lambda e: -e[2])[:12]:
        log(f"    {t / steps / 1e3:8.4f} ms/step  x{n // steps:<3d} {key[:100]}")
    return busy if seen == runs else 0.0


def phase5(layouts, rm, recs) -> float:
    g, head, _ = layouts[0]
    hts = rm["gin"]
    log(f"phase 5: GIN 96 -> {GIN_HIDDEN} x4 -> 22 on the amazon0505-scale "
        "auto layout, row-major")
    per_step = {**NO_LAUNCHES, "slab_matmul": 9, "residual_combine": 9}
    for agg, rtol in (("float32", STEP_RTOL), ("bfloat16", GIN_BF16_RTOL)):
        counts, gathers = first_step(
            g, head, tuple(dataclasses.replace(h, agg_dtype=agg) for h in hts),
            f"GIN {agg} aggregation", model="gin", hidden=GIN_HIDDEN,
            rtol=rtol)
        require(counts == per_step, "one GIN step launches 9 hot slab and 9 "
                "residual kernels (layer 1 has no backward aggregation)")
        require(gathers == 9, "one GIN step gathers 9 times (the hot table "
                "of each aggregation; the residual kernel gathers its slot "
                "rows itself)")
    res, counts = train(g, head, hts, epochs=TIMED_EPOCHS, dry=5, model="gin",
                        hidden=GIN_HIDDEN)
    steps = res["step"]
    log(f"  trained {steps} steps ({res['replays']} replays of the captured "
        f"step): loss {res['losses'][0]:.5f} -> {res['losses'][-1]:.5f}; "
        f"kernel runs { {k: v for k, v in counts.items() if v} }; wrapper "
        f"launches { {k: v for k, v in spmm_cuda.launches.items() if v} }, "
        f"{ {k: v for k, v in res['graph_launches'].items() if v} } a replay")
    require(counts == {k: v * steps for k, v in per_step.items()},
            "hot and residual kernels run exactly 9 times per step")
    recs["slab_matmul"].launches = spmm_cuda.launches["slab_matmul"]
    recs["residual_combine"].launches = spmm_cuda.launches["residual_combine"]
    log_windows("gin_epoch_ms (captured)", res)
    log_profile("gin_epoch_ms (captured)", res["epoch_ms"],
                profile_steps(g, head, hts, "gin", GIN_HIDDEN, use_scan=True))
    return res["epoch_ms"]


def phase6(layouts, rm, recs) -> None:
    log("phase 6: GCN 96 -> 16 -> 22 on the row-major layouts")
    g, fixed, _ = layouts[1]
    hts = rm["fixed"]
    first_step(g, fixed, hts, "row-major diag 512 + hot 512")
    _, counts = train(g, fixed, hts, epochs=0, dry=3)
    log(f"  row-major diag 512 + hot 512, 3 steps: launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    require(counts == {**NO_LAUNCHES, "fused_slab_matmul": 12,
                       "residual_combine": (
                           12 if fixed.hybrid_graph.num_res_slots else 0)},
            "both slab tiers run as one fused launch per aggregation")
    recs["fused_slab_matmul"].launches = counts["fused_slab_matmul"]
    g10, small, _ = layouts[2]
    hts = rm["small"]
    first_step(g10, small, hts, "row-major 10k power-law")
    _, counts = train(g10, small, hts, epochs=0, dry=3)
    log(f"  row-major 10k power-law (diag 4096, residual not covering), 3 "
        f"steps: launches {counts}")
    require(counts == {**NO_LAUNCHES, "slab_matmul": 12,
                       "residual_combine": 12},
            "diag-4096 and residual kernels launch 4 times per step")


def probe_slab(k: int, r: int, seed: int):
    """The probes' slab: 8·R random (row, column) edges over [R, K], as the
    legacy uint32 bit slab [K/32, R] and as the int8 0/1 [K, R], on the
    card; also the edges, deduplicated, for the CSR yardstick."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, r, size=8 * r)
    cols = rng.integers(0, k, size=8 * r)
    bits = torch.from_numpy(
        np.ascontiguousarray(pack_slab_bits(rows, cols, r, k).T)).to(DEVICE)
    a8 = torch.zeros((k, r), dtype=torch.int8, device=DEVICE)
    a8[torch.from_numpy(cols).to(DEVICE), torch.from_numpy(rows).to(DEVICE)] = 1
    key = np.unique(rows.astype(np.int64) * k + cols)
    return bits, a8, (key // k, key % k)


def blocks_agree(label: str, run, blocks) -> None:
    """The dense ring kernels and the set-bit walks size their own tiles:
    every ``block_rows`` the scripts pass launches the same kernel, so the
    results are equal."""
    first = run(blocks[0])
    for bm in blocks[1:]:
        require(torch.equal(run(bm), first),
                f"{label}: block {bm} differs from block {blocks[0]}")
    log(f"  {label}: blocks {blocks} give equal results")


def phase7(recs) -> None:
    """Each probe kernel against its plain version: every dtype pair,
    block size and K of its path at a reduced R, the path's largest K at
    the full R; the dense ring kernels also at the edges of their ring and
    on every int8 value, the set-bit walk on ``HARD_KINDS``; timed at the
    full R with its bound, its plain version and the library calls."""
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    bf16 = torch.bfloat16
    log("phase 7: the probe kernels against their plain versions on the card")
    bit_blocks = (128, 256, 512)  # fixprobe's br 2048, 4096, 8192
    i8_blocks = (128, 256)  # br 2048, 4096
    dense_blocks = (32, 64, 128)  # stepprobe's br 512, 1024, 2048

    def abs_tol(plain, a, x):
        """Dense sums over K terms of any int8 value: 2^-16 of the terms'
        magnitudes (phase 10's dense form with |A| for A); the products
        are exact, only the order of the f32 sums differs."""
        t = plain(a.float().abs(), x.float().abs())
        return ATOL + 2.0 ** -16 * t, "1e-4 + 2^-16·(|A|·|x|)"
    checks = [(PROBE_R_SMALL, k) for k in (128, 512, 1024, 2048, 4096)]
    checks.append((PROBE_R, 4096))
    for r, k in checks:
        bits, a8, _ = probe_slab(k, r, seed=k)
        x_t = features(16, k, bf16, gen)
        want = probe_cuda.bit_slab_t_plain(bits, x_t)
        for bm in bit_blocks:
            compare(recs["bit_slab_t"], f"bit_slab_t R={r} K={k} block {bm}",
                    lambda: probe_cuda.bit_slab_t(bits, x_t, bm), lambda: want)
        if r == PROBE_R:
            blocks_agree(f"bit_slab_t R={r} K={k}",
                         lambda bm: probe_cuda.bit_slab_t(bits, x_t, bm),
                         bit_blocks)
        want = probe_cuda.i8_slab_t_plain(a8, x_t)
        for bm in i8_blocks:
            compare(recs["i8_slab_t"], f"i8_slab_t R={r} K={k} block {bm}",
                    lambda: probe_cuda.i8_slab_t(a8, x_t, bm), lambda: want)
        if r == PROBE_R:
            blocks_agree(f"i8_slab_t R={r} K={k}",
                         lambda bm: probe_cuda.i8_slab_t(a8, x_t, bm),
                         i8_blocks)
        del bits, want
        if k not in (512, 1024, 2048) and r == PROBE_R_SMALL:
            continue
        k_dense = min(k, 2048)  # stepprobe's K reaches 2048
        a8 = a8[:k_dense].contiguous()
        for sdt, xdt in probe_cuda.DENSE_DTYPES:
            a = a8.to(sdt)
            x = row_features(k_dense, 16, xdt, gen)
            want = probe_cuda.dense_slab_plain(a, x)
            for bm in dense_blocks:
                compare(recs["dense_slab"],
                        f"dense_slab R={r} K={k_dense} {sdt}/{xdt} block {bm}",
                        lambda: probe_cuda.dense_slab(a, x, bm), lambda: want)
            if r == PROBE_R:
                blocks_agree(f"dense_slab R={r} K={k_dense} {sdt}/{xdt}",
                             lambda bm: probe_cuda.dense_slab(a, x, bm),
                             dense_blocks)
        del a8, a, want

    # --- the set-bit walk on the slabs it could get wrong ----------------
    rng = np.random.default_rng(7)
    for kind in HARD_KINDS:
        for k in HARD_KS:
            bits = torch.from_numpy(np.ascontiguousarray(
                hard_words(kind, HARD_R, k // 32, rng).T)).to(DEVICE)
            count = probe_cuda.bit_slab_t_plain(
                bits, torch.ones((1, k), device=DEVICE))
            for feat in ("dyadic", "normal"):
                x_t = (dyadic((16, k), bf16, gen) if feat == "dyadic"
                       else features(16, k, bf16, gen))
                want = probe_cuda.bit_slab_t_plain(bits, x_t)
                tol = walk_tol(count, probe_cuda.bit_slab_t_plain(
                    bits, x_t.abs()), feat == "dyadic")
                compare(recs["bit_slab_t"],
                        f"bit_slab_t R={HARD_R} K={k} {kind} x {feat} "
                        "block 128",
                        lambda: probe_cuda.bit_slab_t(bits, x_t, 128),
                        lambda: want, *tol)
                del want, tol
            del bits, count

    # --- the dense ring kernels at the ring's edges, on every int8 value --
    # R = 8,200: not a multiple of the 256-row tile, and int8 rows that
    # start 8 bytes off a 16-byte boundary; K = 32 and 80: one partial
    # stage, and a whole stage and a part (64 int8 or 32 bf16 columns)
    for r, k in ((8_200, 32), (8_200, 80), (PROBE_R_SMALL, 4096),
                 (PROBE_R, 4096)):
        for kind in ("0/1", "int8"):
            if kind == "int8":
                a8 = torch.randint(-128, 128, (k, r), generator=gen,
                                   device=DEVICE, dtype=torch.int8)
            elif r != PROBE_R:
                a8 = torch.randint(0, 2, (k, r), generator=gen,
                                   device=DEVICE, dtype=torch.int8)
            else:
                continue  # the full R's 0/1 slabs are checked above
            x_t = features(16, k, bf16, gen)
            want = probe_cuda.i8_slab_t_plain(a8, x_t)
            tol = abs_tol(probe_cuda.i8_slab_t_plain, a8, x_t)
            for bm in i8_blocks:
                compare(recs["i8_slab_t"],
                        f"i8_slab_t R={r} K={k} {kind} block {bm}",
                        lambda: probe_cuda.i8_slab_t(a8, x_t, bm),
                        lambda: want, *tol)
            if r == PROBE_R:
                blocks_agree(f"i8_slab_t R={r} K={k} {kind}",
                             lambda bm: probe_cuda.i8_slab_t(a8, x_t, bm),
                             i8_blocks)
            del want, tol
            k_dense = min(k, 2048)
            a8 = a8[:k_dense].contiguous()
            for sdt, xdt in probe_cuda.DENSE_DTYPES:
                a = a8.to(sdt)  # every int8 value is exact in bf16
                x = row_features(k_dense, 16, xdt, gen)
                want = probe_cuda.dense_slab_plain(a, x)
                tol = abs_tol(probe_cuda.dense_slab_plain, a, x)
                label = f"dense_slab R={r} K={k_dense} {sdt}/{xdt} {kind}"
                for bm in dense_blocks:
                    compare(recs["dense_slab"], f"{label} block {bm}",
                            lambda: probe_cuda.dense_slab(a, x, bm),
                            lambda: want, *tol)
                if r == PROBE_R:
                    blocks_agree(label,
                                 lambda bm: probe_cuda.dense_slab(a, x, bm),
                                 dense_blocks)
                del a, want, tol
            del a8

    # --- timed at the full R: each kernel at its path's widest K ---------
    def yardsticks(label, kernel, plain, sparse, dense_bf16, nbytes, flops,
                   rate, rec=None):
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
        sparse_ms = time_ms(sparse)
        mm_ms = time_ms(dense_bf16) if dense_bf16 is not None else None
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / rate * 1e3
        if rec is not None:
            rec.ms, rec.plain_ms, rec.library_ms = ms, plain_ms, sparse_ms
            bound(rec, nbytes, flops, rate)
        mm = f", torch.matmul (bf16 dense) {mm_ms:.4f} ms" if mm_ms else ""
        log(f"  {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.sparse.mm (f32 CSR) {sparse_ms:.4f} ms{mm}, bound "
            f"{max(t_bytes, t_ops):.4f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'})")

    r = PROBE_R
    for k in (2048, 4096):
        bits, a8, (er, ec) = probe_slab(k, r, seed=100 + k)
        x_t = features(16, k, bf16, gen)
        xf = x_t.float().t().contiguous()
        a_csr = csr(er, ec, (r, k))
        out_bytes = 16 * r * 4
        flops = 2 * 16 * k * r
        # the walk's work: 16 f32 adds per set bit (the deduplicated edges)
        yardsticks(
            f"bit_slab_t R={r} K={k} block 128 ({len(er)} set bits)",
            lambda: probe_cuda.bit_slab_t(bits, x_t, 128),
            lambda: probe_cuda.bit_slab_t_plain(bits, x_t),
            lambda: torch.sparse.mm(a_csr, xf), None,
            bits.numel() * 4 + x_t.numel() * 2 + out_bytes, 16 * len(er),
            F32_OPS_PER_S, recs["bit_slab_t"] if k == 2048 else None)
        del bits
        a16 = a8.to(bf16)
        yardsticks(
            f"i8_slab_t R={r} K={k} block 128",
            lambda: probe_cuda.i8_slab_t(a8, x_t, 128),
            lambda: probe_cuda.i8_slab_t_plain(a8, x_t),
            lambda: torch.sparse.mm(a_csr, xf), lambda: x_t @ a16,
            a8.numel() + x_t.numel() * 2 + out_bytes, flops,
            BF16_TC_OPS_PER_S, recs["i8_slab_t"] if k == 4096 else None)
        if k == 2048:
            for sdt, xdt in probe_cuda.DENSE_DTYPES:
                a = a8.to(sdt)
                x = row_features(k, 16, xdt, gen)
                xb, x32 = x.to(bf16), x.float()
                # f32 features: the same contraction, exact on the bf16
                # tensor cores as three bf16 terms of x (the kernel's
                # split), so three times the bf16 flops bound it
                terms = 3 if xdt == torch.float32 else 1
                yardsticks(
                    f"dense_slab R={r} K={k} {sdt}/{xdt} block 128",
                    lambda: probe_cuda.dense_slab(a, x, 128),
                    lambda: probe_cuda.dense_slab_plain(a, x),
                    lambda: torch.sparse.mm(a_csr, x32),
                    lambda: a16.t() @ xb,
                    a.numel() * a.element_size() + x.numel() * x.element_size()
                    + out_bytes, terms * flops, BF16_TC_OPS_PER_S,
                    recs["dense_slab"] if sdt == torch.int8
                    and xdt == bf16 else None)
                del a
        del a8, a16, a_csr


def phase8(recs) -> None:
    """The probe scripts, unmodified: their kernel launches are the path
    the probe kernels' counts come from."""
    for name, script in (("fixprobe", fixprobe), ("stepprobe", stepprobe),
                         ("fmtprobe", fmtprobe)):
        log(f"phase 8: {name}.main([])")
        spmm_cuda.reset_launches()
        probe_cuda.reset_launches()
        fmtprobe_cuda.reset_launches()
        start = time.perf_counter()
        require(script.main([]) == 0, f"{name} ran to its end")
        probes = {**probe_cuda.launches, **fmtprobe_cuda.launches}
        counts = {k: v for k, v in {**spmm_cuda.launches,
                                    **probes}.items() if v}
        log(f"  {name}: {time.perf_counter() - start:.1f} s; launches {counts}")
        for kname, n in probes.items():
            if n:
                recs[kname].launches += n


def phase9(layouts) -> None:
    """The measured-probe tier autotune at amazon0505 scale, through the
    CLI: GCN auto on the same graph for the reference's 200 epochs builds
    its layout with the probe (the decider's ``probe=None`` on the card:
    the model's top candidates are close), in an empty cache directory.
    Logs the model's candidates, each probed ms and the verdict."""
    g, head, _ = layouts[0]
    base = head.hybrid_graph
    log("phase 9: tier probe at amazon0505 scale, through the CLI's GCN run")
    src = np.repeat(np.arange(g.num_nodes, dtype=np.int64),
                    np.diff(np.asarray(g.row_pointers, dtype=np.int64)))
    ranked = hybrid.rank_tiers(src, np.asarray(g.column_index, np.int64),
                               g.num_nodes, res_ob=base.res_ob)
    for cost, b, k in ranked[:hybrid.PROBE_TOP]:
        log(f"  model candidate (diag_b {b}, hot_k {k}): {cost / 1e6:.4f} ms "
            "modelled (TPU constants)")
    probed = []
    timer = hybrid._probe_spmm_time

    def recording(hg, device):
        sec = timer(hg, device)
        probed.append((hg.diag_b, hg.hot_k, sec))
        log(f"  probed (diag_b {hg.diag_b}, hot_k {hg.hot_k}): "
            f"{sec * 1e3:.4f} ms per SpMM")
        return sec

    # an empty directory under the port's ignored cache directory
    cache_dir = os.path.join(hybrid._DEFAULT_CACHE_DIR,
                             f"chip_smoke-{os.getpid()}")
    shutil.rmtree(cache_dir, ignore_errors=True)
    hybrid._probe_spmm_time = recording
    try:
        with cache_dir_env(cache_dir):
            run_cli("GCN auto, amazon0505 scale, 200 epochs", AMAZON_CLI)
        with open(os.path.join(cache_dir, "probe_cache.json")) as fp:
            verdicts = list(json.load(fp).values())
    finally:
        hybrid._probe_spmm_time = timer
        shutil.rmtree(cache_dir, ignore_errors=True)
    require(len(probed) >= 2 and len(verdicts) == 1,
            "the build probed its candidates and cached one verdict")
    verdict = tuple(verdicts[0])
    best = min(probed, key=lambda p: p[2])
    kept = verdict == (base.diag_b, base.hot_k)
    log(f"  verdict (diag_b {verdict[0]}, hot_k {verdict[1]}): the model's "
        f"pick (diag_b {base.diag_b}, hot_k {base.hot_k}) "
        f"{'kept' if kept else 'overridden'}: fastest probed (diag_b "
        f"{best[0]}, hot_k {best[1]}) {best[2] * 1e3:.4f} ms; a challenger "
        f"must win by {hybrid.PROBE_MARGIN:.0%}")


def fmt_seg_inputs(r: int, tile: int, ob: int, rng, gen, several: bool,
                   ones: bool, shuffled: bool = False):
    """Segment-reduce inputs at R rows: fmtprobe's (its 393,216 slots
    spread evenly over the blocks, tile-aligned) or, with ``several``,
    three tiles per block, a restart (``first``) inside block 1 and the
    last block without a tile.  Values unit normal, or ones as fmtprobe's;
    segment ids sorted within each tile, or with ``shuffled`` in a random
    order within it.  Returns the kernel's arguments before ``s`` and
    ``n_blocks``."""
    n_blocks = r // ob
    if several:
        t2b = np.repeat(np.arange(n_blocks - 1, dtype=np.int32), 3)
    else:
        per_block = max(((393_216 // n_blocks) // tile) * tile, tile)
        t2b = np.repeat(np.arange(n_blocks, dtype=np.int32), per_block // tile)
    first = np.ones(len(t2b), dtype=np.int32)
    first[1:] = t2b[1:] != t2b[:-1]
    if several:
        first[4] = 1
    m = len(t2b) * tile
    segs = np.sort(rng.integers(0, ob, (len(t2b), tile))).astype(np.int32)
    if shuffled:
        segs = rng.permuted(segs, axis=1)
    masks = rng.integers(1, 255, (m, 1)).astype(np.uint32)
    vals = (torch.ones((m, 128), device=DEVICE) if ones else
            torch.randn((m, 128), generator=gen, device=DEVICE))
    dev = [torch.from_numpy(a).to(DEVICE)
           for a in (masks, segs.reshape(-1, 1), t2b, first)]
    return (vals, *dev), n_blocks


def seg_library(rec: Record, args, s, tile: int, ob: int,
                n_blocks: int) -> None:
    """Time the segment reduce at fmtprobe's inputs beside its yardstick,
    ``torch.sparse.mm`` over the folded v (a CSR of (output row, slot));
    and log, as information only, one ``torch.sparse.mm`` that computes
    the whole function from the unfolded values: a CSR of (output row,
    slot·8 + group), one entry per set mask bit, times ``vals.view(8m,
    16)`` (no bf16 roundings, no ``s``)."""
    vals, masks, segs, t2b, first = args
    m = vals.shape[0]
    v = fmtprobe_cuda.seg_fold(vals, masks)
    t2b_h = t2b.cpu().numpy()
    seg_h = segs.cpu().numpy().ravel()
    slot = np.arange(m)
    out_row = t2b_h[slot // tile].astype(np.int64) * ob + seg_h
    a_csr = csr(out_row, slot, (n_blocks * ob, m))
    nbytes = (m * 128 * 4 + m * 8 + len(t2b_h) * 8
              + n_blocks * ob * 16 * 4)
    timed(rec, f"TILE={tile} OB={ob} m={m}",
          lambda: fmtprobe_cuda.seg_reduce(*args, s, tile, ob, n_blocks),
          lambda: fmtprobe_cuda.seg_reduce_plain(*args, s, tile, ob,
                                                 n_blocks),
          lambda: torch.sparse.mm(a_csr, v), nbytes, 2 * ob * 16 * m,
          record=(tile, ob) == (512, 512),
          lib_name="torch.sparse.mm (f32 CSR, folded v)",
          rate=BF16_TC_OPS_PER_S)
    mask_h = masks.view(torch.int32).cpu().numpy().ravel()
    hot = [np.nonzero((mask_h >> c) & 1)[0] for c in range(8)]
    a_all = csr(np.concatenate([out_row[sl] for sl in hot]),
                np.concatenate([sl * 8 + c for c, sl in enumerate(hot)]),
                (n_blocks * ob, 8 * m))
    v8 = vals.view(8 * m, 16)
    log(f"  seg_reduce TILE={tile} OB={ob} m={m}: torch.sparse.mm over the "
        f"unfolded values (f32 CSR, {sum(map(len, hot))} set mask groups) "
        f"{time_ms(lambda: torch.sparse.mm(a_all, v8)):.4f} ms "
        "(information only)")


def seg_vs_residual(layouts, rm) -> None:
    """The segment reduce against the residual kernels at D = 16, each
    chained on the current stream in this process (PERF.md §7 q.6), per
    edge: a set mask group of a slot for the segment reduce (fmtprobe's
    inputs), a residual nnz for the residual kernels (the amazon0505-scale
    auto layout, gathering from x)."""
    (_, head, hts), _, _ = layouts
    hg = head.hybrid_graph
    ht, hr = hts[0], rm["gin"][0]
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    rng = np.random.default_rng(12)
    log("phase 10b: seg_reduce against the D=16 residual kernels, chained, "
        "per edge")
    nnz = int(np.unpackbits(hg.res_mask.view(np.uint8)).sum())
    x_t = features(16, hg.num_rows, torch.bfloat16, gen)
    xv, x = as_table(x_t), x_t.t().contiguous()
    runs = [
        ("residual_combine D=16 bf16, from x", nnz,
         lambda x_, a: spmm_cuda.residual_combine(x_, *a), x,
         (hr.res_src, hr.res_mask, hr.res_t2b, hr.res_block_ptr,
          hg.num_rows, hg.res_ob)),
        ("residual_combine_t D=16 bf16, from x", nnz,
         lambda x_, a: spmm_cuda.residual_combine_t(x_, *a), xv,
         (ht.res_src, ht.res_mask_s, ht.res_t2b, ht.res_block_ptr,
          hg.num_rows, hg.res_ob)),
    ]
    s = torch.zeros((8, 128), device=DEVICE)
    for tile, ob in SEG_PAIRS:
        args, n_blocks = fmt_seg_inputs(FMT_R, tile, ob, rng, gen, False,
                                        True)
        mask8 = args[1].view(torch.int32) & 0xFF
        groups = sum(int(((mask8 >> c) & 1).sum()) for c in range(8))
        runs.append((f"seg_reduce TILE={tile} OB={ob} m={args[0].shape[0]}",
                     groups,
                     lambda x_, a, tile=tile, ob=ob, n=n_blocks:
                     fmtprobe_cuda.seg_reduce(*a, x_, tile, ob, n), s, args))
    for label, edges, op, x_, aux in runs:
        sec = chained_device_time(op, x_, aux, iters=30)
        log(f"  {label}: {sec * 1e3:.4f} ms chained, {edges} edges, "
            f"{edges / sec / 1e9:.3f} G edges/s, "
            f"{sec / edges * 1e12:.1f} ps an edge")


def phase10(recs) -> None:
    """Each format-probe kernel against its plain version: every dtype,
    variant and block of fmtprobe's path at a reduced (R, K) and at its
    full shape; timed at the full shape with its bound, its plain version
    and a library call."""
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    rng = np.random.default_rng(10)
    bf16, f32 = torch.bfloat16, torch.float32
    log("phase 10: the format probe kernels against their plain versions "
        "on the card")
    torch.cuda.reset_peak_memory_stats()
    s = torch.randn((8, 128), generator=gen, device=DEVICE)

    def dense_tol(a01, x):
        """Dense contractions of a 0/1 slab over K terms (random features):
        2^-16 of the terms' magnitudes, 16 times below the worst case of f32
        summation over 4096 terms and far above its random walk."""
        t = fmtprobe_cuda.i8_slab_plain(a01, x.abs())
        return ATOL + 2.0 ** -16 * t, "1e-4 + 2^-16·(A·|x|)"

    for r, k in (FMT_SMALL, (FMT_R, FMT_K)):
        full = r == FMT_R
        # --- stream_sum: int8, f32, uint32 words read as int32 ------------
        rec = recs["stream_sum"]
        makers = (
            ("int8", lambda: torch.randint(-128, 128, (r, k), generator=gen,
                                           device=DEVICE, dtype=torch.int8)),
            ("f32 uniform", lambda: torch.rand((r, k), generator=gen,
                                               device=DEVICE)),
            ("f32 integers", lambda: torch.randint(
                -1000, 1001, (r, k), generator=gen, device=DEVICE, dtype=f32)),
            ("u32", lambda: torch.randint(
                -2 ** 31, 2 ** 31, (r, k), generator=gen, device=DEVICE,
                dtype=torch.int32).view(torch.uint32)),
        )
        for kind, make in makers:
            a = make()
            compare(rec, f"stream_sum R={r} K={k} {kind} block 512",
                    lambda: fmtprobe_cuda.stream_sum(a, s, 512),
                    lambda: fmtprobe_cuda.stream_sum_plain(a, s, 512))
            if full and kind != "f32 integers":
                g = r // 512
                words = a.view(torch.int32) if a.dtype == torch.uint32 else a
                nbytes = a.numel() * a.element_size() + s.numel() * 4 \
                    + g * 8 * 128 * 4
                timed(rec, f"R={r} K={k} {kind}",
                      lambda: fmtprobe_cuda.stream_sum(a, s, 512),
                      lambda: fmtprobe_cuda.stream_sum_plain(a, s, 512),
                      lambda: torch.sum(words.view(g, 512 * k), dim=1,
                                        dtype=f32),
                      nbytes, a.numel(), record=kind == "f32 uniform",
                      lib_name="torch.sum")
            del a

        # --- i8_slab: random 0/1, all ones and every int8 value, blocks 512
        # and 1024 ----------------------------------------------------------
        rec = recs["i8_slab"]
        x_dy = torch.randint(-8, 9, (k, 16), generator=gen, device=DEVICE,
                             dtype=f32) / 4
        x_n = torch.randn((k, 16), generator=gen, device=DEVICE)
        for kind in ("random 0/1", "all ones", "every int8 value"):
            if kind == "all ones":
                a = torch.ones((r, k), dtype=torch.int8, device=DEVICE)
            else:
                a = torch.randint(0 if kind == "random 0/1" else -128,
                                  2 if kind == "random 0/1" else 128, (r, k),
                                  generator=gen, device=DEVICE,
                                  dtype=torch.int8)
            if kind == "every int8 value":  # in every row, at random beside
                a[:, :256] = torch.arange(-128, 128, device=DEVICE).to(
                    torch.int8)
            feats = (("dyadic", x_dy),) if kind == "every int8 value" else (
                ("dyadic", x_dy), ("normal", x_n))
            for feat, x in feats:
                want = fmtprobe_cuda.i8_slab_plain(a, x)
                tol, text = ((torch.zeros_like(want), "exact")
                             if feat == "dyadic" else dense_tol(a, x))
                for blk in (512, 1024):
                    compare(rec, f"i8_slab R={r} K={k} {kind} x {feat} "
                            f"block {blk}",
                            lambda: fmtprobe_cuda.i8_slab(a, x, blk),
                            lambda: want, tol, text)
                if full:
                    blocks_agree(f"i8_slab R={r} K={k} {kind} x {feat}",
                                 lambda blk: fmtprobe_cuda.i8_slab(a, x, blk),
                                 (512, 1024))
                del want, tol
            if kind == "random 0/1" and not full:
                idx = a.nonzero().t()
                csr_a = torch.sparse_coo_tensor(
                    idx, torch.ones(idx.shape[1], device=DEVICE),
                    (r, k)).coalesce().to_sparse_csr()
                xb = x_n.to(bf16)
                sp_ms = time_ms(lambda: torch.sparse.mm(csr_a, x_n))
                log(f"  i8_slab R={r} K={k} random 0/1: "
                    f"{time_ms(lambda: fmtprobe_cuda.i8_slab(a, xb)):.4f} "
                    f"ms, torch.sparse.mm (f32 CSR, {idx.shape[1]} nnz) "
                    f"{sp_ms:.4f} ms")
                del idx, csr_a
            if full and kind == "all ones":
                xb = x_n.to(bf16)
                a16 = a.to(bf16)
                for blk in (512, 1024):
                    timed(rec, f"R={r} K={k} all ones block {blk}",
                          lambda: fmtprobe_cuda.i8_slab(a, xb, blk),
                          lambda: fmtprobe_cuda.i8_slab_plain(a, xb),
                          lambda: a16 @ xb,
                          a.numel() + xb.numel() * 2 + r * 16 * 4,
                          2 * r * k * 16, record=blk == 512,
                          lib_name="torch.matmul (bf16 dense)",
                          rate=BF16_TC_OPS_PER_S)
                del a16
            del a

        # --- bit_slab: bf16 and f32, blocks 512 and 1024 ------------------
        # each variant has its own record: bf16 (base_bf16) is "bit_slab"
        variants = (("bf16", bf16, recs["bit_slab"]),
                    ("f32", f32, recs[fmtprobe_cuda.BIT_SLAB_F32]))
        rows_e, cols_e = rng.integers(0, r, 6 * r), rng.integers(0, k, 6 * r)
        bits = torch.from_numpy(pack_slab_bits(rows_e, cols_e, r, k)).to(DEVICE)
        for feat, x in (("dyadic", x_dy), ("normal", x_n)):
            for variant, dt, vrec in variants:
                xv = x.to(dt)
                want = fmtprobe_cuda.bit_slab_plain(bits, xv)
                exact = feat == "dyadic"
                for blk in (512, 1024):
                    compare(vrec, f"bit_slab R={r} K={k} {variant} x {feat} "
                            f"block {blk}",
                            lambda: fmtprobe_cuda.bit_slab(bits, xv, blk),
                            lambda: want,
                            torch.zeros_like(want) if exact else None,
                            "exact" if exact else "")
                if full:
                    blocks_agree(f"bit_slab R={r} K={k} {variant} x {feat}",
                                 lambda blk: fmtprobe_cuda.bit_slab(
                                     bits, xv, blk), (512, 1024))
                del want
        if not full:
            # the set-bit walk on the slabs it could get wrong
            for kind in HARD_KINDS:
                for kh in HARD_KS:
                    hbits = torch.from_numpy(
                        hard_words(kind, HARD_R, kh // 32, rng)).to(DEVICE)
                    count = fmtprobe_cuda.bit_slab_plain(
                        hbits, torch.ones((kh, 1), device=DEVICE))
                    for feat in ("dyadic", "normal"):
                        xh = (dyadic((kh, 16), f32, gen) if feat == "dyadic"
                              else torch.randn((kh, 16), generator=gen,
                                               device=DEVICE))
                        for variant, dt, vrec in variants:
                            xv = xh.to(dt)
                            want = fmtprobe_cuda.bit_slab_plain(hbits, xv)
                            tol = walk_tol(count, fmtprobe_cuda.bit_slab_plain(
                                hbits, xv.abs()), feat == "dyadic")
                            compare(vrec, f"bit_slab R={HARD_R} K={kh} "
                                    f"{variant} {kind} x {feat} block 512",
                                    lambda: fmtprobe_cuda.bit_slab(
                                        hbits, xv, 512),
                                    lambda: want, *tol)
                            del want, tol
                    del hbits, count
        if full:
            key = np.unique(rows_e.astype(np.int64) * k + cols_e)
            a_csr = csr(key // k, key % k, (r, k))
            bits16 = torch.from_numpy(
                pack_slab_bits_t(rows_e, cols_e, r, k)).to(DEVICE)
            xb = x_n.to(bf16)
            # the walk's work: 16 f32 adds per set bit (the deduplicated
            # edges), whatever the table's dtype
            for variant, dt, vrec in variants:
                xv = x_n.to(dt)
                timed(vrec, f"R={r} K={k} {variant} block 512 ({len(key)} "
                      "set bits)",
                      lambda: fmtprobe_cuda.bit_slab(bits, xv, 512),
                      lambda: fmtprobe_cuda.bit_slab_plain(bits, xv),
                      lambda: torch.sparse.mm(a_csr, x_n),
                      bits.numel() * 4 + xv.numel() * xv.element_size()
                      + r * 16 * 4, 16 * len(key), record=True)
            log(f"  slab_matmul (the bit walk, bf16) over the same edges: "
                f"{time_ms(lambda: spmm_cuda.slab_matmul(bits16, xb)):.4f} ms")
            del a_csr, bits16
        del bits

        # --- seg_reduce: fmtprobe's five (TILE, OB) pairs -----------------
        # fmtprobe's inputs, and three tiles a block with a restart (ids
        # also shuffled within each tile at the reduced R), ones and normal
        rec = recs["seg_reduce"]
        cases = [(False, False), (True, False)] + ([] if full else
                                                   [(True, True)])
        for tile, ob in SEG_PAIRS:
            for (several, shuffled), ones in itertools.product(
                    cases, (True, False)):
                args, n_blocks = fmt_seg_inputs(r, tile, ob, rng, gen,
                                                several, ones, shuffled)
                want = fmtprobe_cuda.seg_reduce_plain(*args, s, tile, ob,
                                                      n_blocks)
                if ones:
                    tol, text = torch.zeros_like(want), "exact"
                else:
                    s_abs = fmtprobe_cuda.seg_reduce_plain(
                        args[0].abs(), *args[1:], torch.zeros_like(s), tile,
                        ob, n_blocks)
                    tol = ATOL + RTOL * want.abs() + 2.0 ** -7 * s_abs
                    text = "1e-4 + 1e-5·|plain| + 2^-7·(segment sum of |v|)"
                    del s_abs
                label = (f"seg_reduce R={r} TILE={tile} OB={ob} m="
                         f"{args[0].shape[0]} "
                         f"{'3 tiles a block' if several else 'fmtprobe'}"
                         f"{', ids shuffled' if shuffled else ''} "
                         f"{'ones' if ones else 'normal'}")
                compare(rec, label,
                        lambda: fmtprobe_cuda.seg_reduce(*args, s, tile, ob,
                                                         n_blocks),
                        lambda: want, tol, text)
                if full and ones and not several:
                    seg_library(rec, args, s, tile, ob, n_blocks)
                del args, want, tol
    log(f"  peak device memory of phase 10: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")


def hybrid_step_counts(hg, transposed: bool, per_step: int) -> dict:
    """Launches of ``per_step`` aggregations on a hybrid layout: one slab
    launch each (fused where both slab tiers exist) and one residual."""
    sfx = "_t" if transposed else ""
    counts = dict(NO_LAUNCHES)
    if hg.diag_b and hg.hot_k:
        counts["fused_slab_matmul" + sfx] = per_step
    elif hg.diag_b or hg.hot_k:
        counts["slab_matmul" + sfx] = per_step
    if hg.num_res_slots:
        counts["residual_combine" + sfx] = per_step
    return counts


def text_edge_lists(g10) -> None:
    """The 10k graph's edges as a text file (with a comment line) in the
    port's git-ignored cache directory: the native parser and np.loadtxt
    must both read the graph the .npz path reads."""
    out = hybrid._DEFAULT_CACHE_DIR
    os.makedirs(out, exist_ok=True)
    txt = os.path.join(out, f"smoke_10k_edges_{os.getpid()}.txt")
    npz = txt[:-len(".txt")] + ".npz"
    ei = g10.edge_index
    try:
        np.savetxt(txt, ei.T, fmt="%d",
                   header="src dst of the 10k power-law graph, seed 0")
        np.savez(npz, src_li=ei[0], dst_li=ei[1], num_nodes=int(ei.max()) + 1)
        want = load_graph(npz, 96, 22)
        for native in (True, False):
            start = time.perf_counter()
            got = load_graph(txt, 96, 22, use_native_parser=native)
            same = got.num_nodes == want.num_nodes and all(
                np.array_equal(getattr(got, f), getattr(want, f))
                for f in ("edge_index", "row_pointers", "column_index",
                          "degrees"))
            log(f"  text edge list ({ei.shape[1]} lines) through "
                f"{'the native parser' if native else 'np.loadtxt'}: "
                f"{time.perf_counter() - start:.3f} s, "
                f"{'the .npz graph' if same else 'DIFFERS from the .npz graph'}")
            require(same, "a text edge list loads as the .npz graph")
    finally:
        for f in (txt, npz):
            if os.path.exists(f):
                os.remove(f)


def phase11(layouts, epoch_ms: float) -> None:
    """Text edge lists and the rabbit reordering through the native
    library; GCN on the reordered graph's auto layout."""
    g, head, _ = layouts[0]
    g10 = layouts[2][0]
    log("phase 11: reordering and text edge lists")
    require(graphtools.available(), "g++ builds the native graph tools")
    found = os.path.exists(graphtools.library_path())
    start = time.perf_counter()
    so = graphtools.build()
    graphtools.get_lib()
    log(f"  {'found' if found else 'built'} {os.path.basename(so)} in "
        f"{time.perf_counter() - start:.1f} s")
    text_edge_lists(g10)

    start = time.perf_counter()
    perm = graphtools.rabbit_permutation(g10.edge_index, g10.num_nodes)
    native_s = time.perf_counter() - start
    require(np.array_equal(np.sort(perm), np.arange(g10.num_nodes)),
            "the native permutation of the 10k graph is a permutation")
    start = time.perf_counter()
    perm_np = rabbit_permutation(g10.edge_index, g10.num_nodes)
    log(f"  10k power-law (sequential merge): avg_edgeSpan "
        f"{g10.avg_edgeSpan:.1f} -> native "
        f"{g10.apply_permutation(perm).avg_edgeSpan:.1f} in {native_s:.3f} s, "
        f"NumPy path {g10.apply_permutation(perm_np).avg_edgeSpan:.1f} in "
        f"{time.perf_counter() - start:.2f} s")

    verdict = InputProperty(g, hidden_dim=16,
                            enable_reorder=True)._should_reorder()
    perms = []
    for run in (1, 2):
        start = time.perf_counter()
        perm = graphtools.rabbit_permutation(g.edge_index, g.num_nodes)
        sec = time.perf_counter() - start
        require(np.array_equal(np.sort(perm), np.arange(g.num_nodes)),
                "the native permutation is a permutation")
        rg = g.apply_permutation(perm)
        src = np.repeat(np.arange(rg.num_nodes, dtype=np.int64),
                        np.diff(np.asarray(rg.row_pointers, np.int64)))
        tiers = hybrid.choose_tiers(src, np.asarray(rg.column_index, np.int64),
                                    rg.num_nodes)
        log(f"  amazon0505-scale native reorder, run {run}: {sec:.3f} s, "
            f"avg_edgeSpan {g.avg_edgeSpan:.1f} -> {rg.avg_edgeSpan:.1f}, "
            f"fingerprint {hybrid.graph_fingerprint(rg)}, tiers "
            f"(diag_b, hot_k) {tiers}")
        perms.append(perm)
    moved = int((perms[0] != perms[1]).sum())
    log(f"  the two permutations {'agree' if not moved else 'differ'} "
        f"({moved} of {g.num_nodes} nodes placed differently); "
        f"_should_reorder: {verdict}; unreordered tiers "
        f"({head.diag_b}, {head.hot_k})")

    start = time.perf_counter()
    prop = InputProperty(g, hidden_dim=16, probe=False,
                         enable_reorder=True).decider()
    hts = prop.build_tensors(device=DEVICE)
    rg, hg = prop.graph, prop.hybrid_graph
    require(prop.reorder_status and rg.reordered and is_transposed(hts[0]),
            "the decider reorders and builds the transposed layout")
    log(f"  decider (enable_reorder): fingerprint "
        f"{hybrid.graph_fingerprint(rg)}, diag_b={hg.diag_b} "
        f"hot_k={hg.hot_k} res_ob={hg.res_ob} res_tile={hg.res_tile} "
        f"covers_all={hg.res_covers_all} rows={hg.num_rows} "
        f"({time.perf_counter() - start:.1f} s)")
    counts, _ = first_step(rg, prop, hts, "reordered auto layout")
    require(counts == hybrid_step_counts(hg, True, 4),
            "one GCN step on the reordered layout launches its tiers' "
            "kernels 4 times each")
    res, counts = train(rg, prop, hts, epochs=SHORT_EPOCHS, dry=2)
    require(counts == hybrid_step_counts(hg, True, 4 * res["step"]),
            "the tiers' kernels launch 4 times per step")
    log(f"  trained {res['step']} steps: launches "
        f"{ {k: v for k, v in counts.items() if v} }; information: epoch_ms "
        f"{res['epoch_ms']:.4f} over {len(res['window_ms'])} windows of "
        f"{res['chunk']} epoch (no fit), phase 3's unreordered layout "
        f"{epoch_ms:.4f}")


def vs_cpu(graph, prop, hts, cpu_hts, label: str, model: str, hidden: int,
           rtol: float = STEP_RTOL) -> None:
    """One step on the card against the same step on the CPU (same
    weights, the same method's tensors built for the CPU): no kernel
    launches on the card, loss and gradients within ``rtol``."""
    x, y, mask, net = model_inputs(graph, prop, hts, model, hidden)
    spmm_cuda.reset_launches()
    start = time.perf_counter()
    got = step_run(net, x, y, mask, hts)()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - start
    require(spmm_cuda.launches == NO_LAUNCHES,
            f"{label}: the path launches no hybrid kernel")
    cpu_net = MODELS[model](graph.num_features, hidden, 22, device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    start = time.perf_counter()
    want = step_run(cpu_net, x.cpu(), y.cpu(),
                    None if mask is None else mask.cpu(), cpu_hts)()
    agree(label, net, got, want, rtol,
          f"card {card_s:.3f} s (first call), CPU "
          f"{time.perf_counter() - start:.2f} s", against="CPU")


def against_oracle(graph, gt, label: str) -> None:
    """``aggregate`` with and without the GCN weighting against the plain
    oracle (``index_add_``) on the card, within (2n + 4)·2^-24·(|A|·|x|) +
    1e-6, n the row's degree (both sides sum n rounded products in f32),
    and two runs bitwise equal; its time at each width, as information."""
    n = graph.num_nodes
    src = torch.from_numpy(
        reference.csr_to_coo(graph.row_pointers, graph.column_index)
    ).to(DEVICE)
    dst = torch.from_numpy(graph.column_index).to(DEVICE)
    count = torch.from_numpy(np.diff(graph.row_pointers)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    for d in PATH_DIMS:
        x = torch.randn((n, d), generator=gen, device=DEVICE)
        for norm in (False, True):
            def oracle(v):
                if norm:
                    return reference.gcn_aggregate(v, src, dst, gt.degrees, n)
                return reference.sag(v, src, dst, n)

            got = aggregate(x, gt, norm)
            again = aggregate(x, gt, norm)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    f"{label} D={d} norm={norm}: two runs are bitwise equal")
            err = (got - oracle(x)).abs()
            tol = 1e-6 + (2 * count[:, None] + 4) * 2.0 ** -24 * oracle(
                x.abs())
            ok = bool((err <= tol).all())
            ms = time_ms(lambda: aggregate(x, gt, norm))
            log(f"  {label} {'GCN aggregation' if norm else 'sag'} D={d}: "
                f"max_abs_err {float(err.max()):.3e} against the oracle "
                f"(tolerance (2n+4)·2^-24·(|A|·|x|) + 1e-6) "
                f"{'ok' if ok else 'FAIL'}; bitwise repeatable; "
                f"{ms:.4f} ms (information)")
            require(ok, f"{label}: the aggregation disagrees with the oracle")


def phase12(layouts, epoch_ms: float, gin_epoch_ms: float) -> dict:
    """The ELL, dense and COO paths: the dense one on a 4,000-node graph
    the auto decider gives it, ELL and COO at amazon0505 scale.  Returns
    each path's (graph, GCN decider, tensors) for phase 13."""
    log("phase 12: the ELL, dense and COO paths")
    paths = {}
    g4 = synthesize_graph(DENSE_NODES, DENSE_EDGES, num_features=96,
                          num_classes=22, kind="powerlaw")
    for model, hidden, gemm in (("gcn", 16, "float32"),
                                ("gin", GIN_HIDDEN, "float32"),
                                ("gcn", 16, "bfloat16")):
        prop = InputProperty(g4, hidden_dim=hidden, model=model,
                             gemm_dtype=gemm).decider()
        require(prop.layer_input.method == "dense",
                "the auto decider picks dense at 4,000 nodes")
        hts = prop.build_tensors(device=DEVICE)
        if (model, gemm) == ("gcn", "float32"):
            paths["dense"] = (g4, prop, hts)
        label = f"dense 4k {model} {gemm} GEMMs"
        # bf16 GEMMs: a summation-order difference can flip the rounding
        # of the next GEMM's bf16 operand, as GIN_BF16_RTOL says
        vs_cpu(g4, prop, hts, prop.build_tensors(device="cpu"), label, model,
               hidden, STEP_RTOL if gemm == "float32" else GIN_BF16_RTOL)
        res, counts = train(g4, prop, hts, epochs=0, dry=3, model=model,
                            hidden=hidden)
        require(counts == NO_LAUNCHES, "the dense path launches no kernel")
        log(f"  {label}, 3 steps: losses "
            f"{', '.join(f'{v:.5f}' for v in res['losses'])}")

    g, _, _ = layouts[0]
    for method in ("ell", "coo"):
        start = time.perf_counter()
        prop = InputProperty(g, hidden_dim=16, method=method).decider()
        gin = InputProperty(g, hidden_dim=GIN_HIDDEN, model="gin",
                            method=method).decider()
        require(gin.layer_input.part_size == prop.layer_input.part_size,
                "GCN and GIN share the graph's tensors")
        hts = prop.build_tensors(device=DEVICE)
        paths[method] = (g, prop, hts)
        gt = hts[0]
        note = f"{gt.coo_src.numel()} edges" if method == "coo" else (
            f"auto part_size {gt.part_size}, {gt.part_cols.shape[0]} parts, "
            f"padding waste "
            f"{1 - float(gt.part_lens.sum()) / gt.part_cols.numel():.3f}")
        log(f"  {method} amazon0505-scale: {note} "
            f"({time.perf_counter() - start:.1f} s)")
        against_oracle(g, gt, method)
        cpu_hts = prop.build_tensors(device="cpu")
        vs_cpu(g, prop, hts, cpu_hts, f"{method} GCN", "gcn", 16)
        vs_cpu(g, gin, hts, cpu_hts, f"{method} GIN", "gin", GIN_HIDDEN)
        del cpu_hts
        res, counts = train(g, prop, hts, epochs=SHORT_EPOCHS, dry=2)
        gres, gcounts = train(g, gin, hts, epochs=SHORT_EPOCHS, dry=2,
                              model="gin", hidden=GIN_HIDDEN)
        require(counts == gcounts == NO_LAUNCHES,
                f"the {method} path launches no kernel")
        log(f"  {method}, information (no fit, {len(res['window_ms'])} "
            f"windows of 1 epoch): epoch_ms {res['epoch_ms']:.4f} (hybrid, "
            f"phase 3: {epoch_ms:.4f}), gin_epoch_ms {gres['epoch_ms']:.4f} "
            f"(hybrid, phase 5: {gin_epoch_ms:.4f})")

    prop = InputProperty(g, hidden_dim=16, manual_mode=True).decider()
    require((prop.layer_input.method, prop.layer_input.part_size) == (
        "ell", 32), "manual mode runs ELL at part_size 32")
    res, counts = train(g, prop, prop.build_tensors(device=DEVICE), epochs=0,
                        dry=1)
    require(counts == NO_LAUNCHES, "the ELL path launches no kernel")
    log(f"  manual mode (ell, part_size 32), one step: loss "
        f"{res['losses'][0]:.5f}")
    return paths


def captured_vs_eager(label: str, graph, prop, hts, model: str,
                      hidden: int) -> None:
    """train_and_time's two paths over the same 10 steps from the same
    weights: step by step (``use_scan=False``), and 2 eager steps then 8
    replays of the captured step (``use_scan=True``).  Both run one Adam
    (capturable on the card) and the same kernels, so every loss within
    CAPTURE_RTOL of the largest loss and every final weight within
    CAPTURE_RTOL of its tensor's largest value; the captured step
    launches what an eager step launches."""
    (eager, e_counts), (cap, c_counts) = (
        train(graph, prop, hts, epochs=SHORT_EPOCHS, dry=2, model=model,
              hidden=hidden, use_scan=use_scan) for use_scan in (False, True))
    steps = eager["step"]
    per_step = {k: v // steps for k, v in e_counts.items()}
    require(e_counts == {k: v * steps for k, v in per_step.items()},
            f"{label}: every step launches the same kernels")
    require(cap["graph_launches"] == per_step and c_counts == e_counts,
            f"{label}: the captured step launches what an eager step "
            f"launches ({cap['graph_launches']} against {per_step})")
    le, lc = np.array(eager["losses"]), np.array(cap["losses"])
    pe, pc = eager["params"], cap["params"]
    loss_err = float(np.abs(le - lc).max() / np.abs(le).max())
    w_err = max(float(np.abs(pe[k] - pc[k]).max() / np.abs(pe[k]).max())
                for k in pe)
    log(f"  {label}: 10 steps, train_and_time captured (use_scan True, "
        f"{cap['replays']} replays) against step by step: losses "
        f"{le[0]:.5f} -> {le[-1]:.6g}, max error {loss_err:.2e} of the "
        f"largest loss, weights max error {w_err:.2e} of the largest (bound "
        f"{CAPTURE_RTOL:.0e}); launches a step "
        f"{ {k: v for k, v in per_step.items() if v} }")
    require(len(le) == len(lc) == steps == cap["step"] == SHORT_EPOCHS + 2
            and cap["replays"] == SHORT_EPOCHS
            and loss_err <= CAPTURE_RTOL and w_err <= CAPTURE_RTOL,
            f"{label}: the captured step's losses and weights agree with "
            "the step-by-step loop's")


@contextlib.contextmanager
def cache_dir_env(path: str):
    """The port's cache directory set to ``path`` in the block."""
    saved = os.environ.get(hybrid.CACHE_DIR_ENV)
    os.environ[hybrid.CACHE_DIR_ENV] = path
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(hybrid.CACHE_DIR_ENV, None)
        else:
            os.environ[hybrid.CACHE_DIR_ENV] = saved


def run_cli(label: str, argv: list[str]) -> list[str]:
    """``python -m gnnadvisor_osdi21_tpu_torch`` in this process: exit 0,
    and a last line ``Time (ms): <finite, positive>`` unless it verifies.
    Returns its output lines."""
    buf = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    log(f"  CLI {label} ({time.perf_counter() - start:.1f} s, exit {rc}): "
        f"{' | '.join(lines[1:])}")
    require(rc == 0, f"CLI {label} exits 0")
    if "--verify_spmm" not in argv:
        ms = float(lines[-1].split("Time (ms):")[1])
        require(math.isfinite(ms) and ms > 0,
                f"CLI {label} ends with a time")
    return lines


def cli_resume(workdir: str) -> None:
    """--save_ckpt/--resume on the 10k graph: 10 dry-run + 10 timed steps,
    saved, then resumed for 20 more, against 10 dry-run + 30 timed steps
    straight (both 40 steps: the timing plan runs 10 epochs as 10 windows
    of 1, 30 as 10 of 3).  Every step runs the same kernels on the same
    captured Adam, so the weights must agree within 1e-6 of each tensor's
    largest value."""
    base = ["--synthetic", "10000:120000:powerlaw", "--manual_mode", "False"]
    ck = {n: os.path.join(workdir, f"{n}.npz")
          for n in ("straight", "half", "resumed")}
    run_cli("save, 30 epochs straight",
            base + ["--num_epoches", "30", "--save_ckpt", ck["straight"]])
    run_cli("save, 10 epochs",
            base + ["--num_epoches", "10", "--save_ckpt", ck["half"]])
    run_cli("resume, 10 epochs more",
            base + ["--num_epoches", "10", "--resume", ck["half"],
                    "--save_ckpt", ck["resumed"]])
    tmpl = {"conv1": None, "conv2": None}
    got = {n: load_checkpoint(p, tmpl, {"mu": tmpl, "nu": tmpl})
           for n, p in ck.items()}
    (p_s, o_s, step_s), (p_r, o_r, step_r) = got["straight"], got["resumed"]
    err = max(float(np.abs(p_s[k] - p_r[k]).max() / np.abs(p_s[k]).max())
              for k in tmpl)
    log(f"  checkpoints: half at step {got['half'][2]}, resumed at "
        f"{step_r} (Adam count {int(o_r['count'])}), straight at {step_s}; "
        f"weights max error {err:.2e} of the largest (bound 1e-6)")
    require(got["half"][2] == 20 and step_r == step_s == 40
            and int(o_r["count"]) == int(o_s["count"]) == 40,
            "the resumed run carries the step on to the straight run's")
    require(err <= 1e-6, "the resumed weights equal the straight run's")


def phase13(layouts, rm, paths) -> None:
    """The entry points: the captured step against the step-by-step loop
    on every path, both paths' epoch times, the headline bench twice, and
    the CLI."""
    log("phase 13: the captured step, the headline bench and the CLI")
    g, head, hts = layouts[0]
    captured_vs_eager("GCN transposed, amazon0505 scale", g, head, hts,
                      "gcn", 16)
    captured_vs_eager("GIN row-major, amazon0505 scale", g, head, rm["gin"],
                      "gin", GIN_HIDDEN)
    for method, (pg, prop, phts) in paths.items():
        captured_vs_eager(f"GCN {method}", pg, prop, phts, "gcn", 16)
    for name, model, hidden, tensors in (
            ("epoch_ms", "gcn", 16, hts),
            ("gin_epoch_ms", "gin", GIN_HIDDEN, rm["gin"])):
        res, _ = train(g, head, tensors, epochs=TIMED_EPOCHS, dry=5,
                       model=model, hidden=hidden, use_scan=False)
        log_windows(f"{name} (step by step)", res)
        log_profile(f"{name} (step by step)", res["epoch_ms"],
                    profile_steps(g, head, tensors, model, hidden))

    for run in (1, 2):
        start = time.perf_counter()
        rec = headline.run()
        log(f"  headline run {run} ({time.perf_counter() - start:.1f} s): "
            f"value {rec['value']} ms, fingerprint {rec['fingerprint']}, "
            f"tiers diag_b {rec['diag_b']} hot_k {rec['hot_k']} res_ob "
            f"{rec['res_ob']} res_tile {rec['res_tile']}, tier probe "
            f"{rec['tier_probe']}; its JSON line:")
        print(json.dumps(rec), flush=True)
        require(rec["metric"] == headline.METRIC
                and math.isfinite(rec["value"]) and rec["value"] > 0,
                "the headline measures a positive time on the card")

    # the CLI: GCN at amazon0505 scale is phase 9's run; the rest on the
    # 10k graph, in an empty cache directory
    workdir = os.path.join(hybrid._DEFAULT_CACHE_DIR,
                           f"chip_smoke-cli-{os.getpid()}")
    shutil.rmtree(workdir, ignore_errors=True)
    small = ["--synthetic", "10000:120000:powerlaw", "--manual_mode", "False"]
    try:
        with cache_dir_env(workdir):
            for method in ("auto", "ell"):
                out = run_cli(f"--verify_spmm, method {method}",
                              small + ["--verify_spmm", "True", "--method",
                                       method])
                require(any("Verification PASSED" in ln for ln in out),
                        f"verification passes on the {method} path")
            # the first decider build with the probe at its default times
            # the candidates; GIN's build on the same graph replays the
            # verdict from the cache
            probes = []
            for label, extra in (
                    ("--single_spmm", ["--single_spmm", "True"]),
                    ("GIN auto, 200 epochs",
                     ["--model", "gin", "--hidden", str(GIN_HIDDEN),
                      "--num_epoches", "200"])):
                out = run_cli(label, small + extra + ["--verbose_mode",
                                                      "True"])
                probes += [ln for ln in out if ln.startswith("# tier probe:")]
            log(f"  tier probe of the two builds: {probes}")
            require(len(probes) == 2
                    and probes[0].startswith("# tier probe: timed")
                    and probes[1] == "# tier probe: cached;"
                    + probes[0].split(";", 1)[1],
                    "the second build replays the first one's verdict from "
                    "the cache (no probe)")
            cli_resume(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def shard_table(sg, r: int, x: torch.Tensor) -> torch.Tensor:
    """Rank ``r``'s halo table [block + recv_max, ld] as the exchange
    delivers it, built from the global rows x [ndev·block, D] by the plan
    alone: the rank's rows, then from each sender in turn the rows that
    the sender ships it (``send_flat``), at the receiver's offsets
    (``halo_out_off``); the padding rows zero."""
    block, d = sg.block, x.shape[1]
    table = torch.zeros((block + sg.recv_max, -(-d // 8) * 8),
                        dtype=x.dtype, device=x.device)
    table[:block, :d] = x[r * block:(r + 1) * block]
    for s in range(sg.num_devices):
        n = int(sg.halo_sizes[r, s])
        if not n:
            continue
        lo = int(sg.halo_in_off[s, r])
        ids = torch.from_numpy(
            sg.send_flat[s, lo:lo + n].astype(np.int64) + s * block)
        out = block + int(sg.halo_out_off[s, r])
        table[out:out + n, :d] = x[ids.to(x.device)]
    return table


def phase14(layouts) -> None:
    """The multi-device path: (a) one NCCL rank through
    ``tools.dist_check`` at amazon0505 scale, GCN 96 -> 16 -> 22; (b) the
    4-way layout shard by shard, each rank's tiers on the halo table the
    plan delivers, kernels against plain and the four shards against the
    single-card aggregation; (c) the CLI's ``--num_devices 2`` on one
    card."""
    g, head, hts = layouts[0]
    log("phase 14: the multi-device path (parallel/)")
    checks, info = dist_check.run(g, dim=96, hidden=16, classes=22,
                                  device=DEVICE, single=head.hybrid_graph,
                                  log=log)
    require(checks.ok, "every one-rank check holds")
    require(info["launches_per_step"].get("slab_matmul_t", 0) > 0
            and info["launches_per_step"].get("residual_combine_t", 0) > 0,
            "the dist path launched slab_matmul_t and residual_combine_t")
    log(f"  one rank, 10 Adam steps (bf16 tiers): ms per step "
        f"{info['dist_ms']} (median, CUDA events), single-card eager step "
        f"{info['single_ms']}; losses {info['dist_losses'][0]:.6f} -> "
        f"{info['dist_losses'][-1]:.6f}; launches per step "
        f"{info['launches_per_step']}")
    if info.get("busy_ms"):
        log(f"  profile of 3 dist steps: device busy {info['busy_ms']:.4f} "
            f"ms per step, idle share {1 - info['busy_ms'] / info['dist_ms']:.3f}"
            f" of the median step")
        for key, ms, n in info["profile"]:
            log(f"    {ms:8.4f} ms/step  x{n:<3d} {key[:100]}")
    else:
        log("  device busy time of the dist step: not measured (the "
            "profiler saw no device time)")
    for key, label in (("capture", "hybrid (bf16 tiers)"),
                       ("capture_ell", "ELL")):
        cap = info[key]
        require(bool(cap), f"the {label} step was captured on NCCL")
        busy = cap["captured_busy_ms"]
        idle = (f"{1 - busy / cap['captured_ms']:.3f}" if busy
                else "not measured (the profiler saw no device time)")
        before = (f" (before capture: {STEPWISE_DIST_MS} ms at "
                  f"{STEPWISE_DIST_IDLE:.1%} idle)" if key == "capture"
                  else "")
        log(f"  {label} step captured as one CUDA graph, one NCCL rank: "
            f"{cap['captured_ms']:.4f} ms per step (median, CUDA events), "
            f"device busy {busy:.4f} ms, idle share {idle}; step by step "
            f"{cap['eager_ms']:.4f} ms{before}")
        for name, ms, n in cap["captured_profile"][:6]:
            log(f"    {ms:8.4f} ms/step  x{n:<3d} {name[:100]}")

    # (b) a 4-way layout, shard by shard
    start = time.perf_counter()
    sg = shard_graph_hybrid(g, 4)
    log(f"  shard_graph_hybrid(g, 4): diag_b={sg.diag_b} hot_k={sg.hot_k} "
        f"res_ob={sg.res_ob} res_tile={sg.res_tile} block={sg.block} "
        f"recv_max={sg.recv_max} halo rows by receiver "
        f"{sg.halo_sizes.sum(axis=1).tolist()} "
        f"({time.perf_counter() - start:.1f} s)")
    require(int(sg.halo_sizes.sum()) > 0, "the 4-way layout has halo rows")
    d = 16
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    n_pad = 4 * sg.block
    x = torch.zeros((n_pad, d), device=DEVICE)
    x[: g.num_nodes] = dyadic((g.num_nodes, d), torch.float32, gen)
    # the errors' bookkeeping only: the kernels' records keep their own
    comp = Record("residual_combine_t")
    for dt in DTYPES:
        name = str(dt).split(".")[-1]
        outs = []
        for r in range(4):
            ht = local_tensors(sg, r, DEVICE, name)
            table = shard_table(sg, r, x.to(dt))
            got = dist_hybrid.shard_tiers_t(table, d, ht)
            with plain_kernels():
                want = dist_hybrid.shard_tiers_t(table, d, ht)
            compare(comp, f"shard {r}/4 {name} tiers ("
                    f"{int(sg.halo_sizes[r].sum())} halo rows) against "
                    "their plain composition", lambda: got, lambda: want,
                    tol=torch.zeros_like(want), tol_text="exact, dyadic "
                    "features")
            outs.append(got)
        whole = hybrid_aggregate(x[: head.hybrid_graph.num_rows].t()
                                 .contiguous().to(dt),
                                 build_layer_tensors(head.hybrid_graph,
                                                     device=DEVICE,
                                                     agg_dtype=name)[0],
                                 False)
        joined = torch.cat(outs, dim=1)[:, : g.num_nodes]
        compare(comp, f"the 4 shards put together ({name}) against the "
                "single-card aggregation of the whole graph",
                lambda: joined, lambda: whole[:, : g.num_nodes].float(),
                tol=torch.zeros_like(joined), tol_text="exact, dyadic "
                "features")
        del outs, whole, joined

    # (c) more ranks than cards
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(have + 1, 2)
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--synthetic", "4000:40000:powerlaw", "--num_devices",
                       str(n), "--num_epoches", "2"])
    log(f"  CLI --num_devices {n} on {have} card(s): exit {rc}: "
        f"{err.getvalue().strip()}")
    require(rc != 0 and f"need {n} CUDA cards (one per rank), have {have}"
            in err.getvalue(),
            "the CLI refuses more ranks than cards, naming both counts")


def run_driver(label: str, main_fn, argv: list[str], recs,
               into: str = "driver_launches") -> list[str]:
    """A driver's or tool's ``main(argv)`` in this process: exit 0.  Its
    hybrid kernel launches (counts set to 0 just before it, read just
    after) go to the kernels' ``into`` count (``driver_launches``, or the
    tools' ``tool_launches``), apart from the main path's ``launches``.
    Returns its output lines, which are also printed."""
    spmm_cuda.reset_launches()
    buf = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    lines = buf.getvalue().splitlines()
    counts = {k: v for k, v in spmm_cuda.launches.items() if v}
    log(f"  {label} ({time.perf_counter() - start:.1f} s, exit {rc}), "
        f"launches {counts}:")
    for line in lines:
        print(f"    | {line}", flush=True)
    require(rc == 0, f"{label} exits 0")
    for name, n in counts.items():
        setattr(recs[name], into, getattr(recs[name], into) + n)
    return lines


def phase15(recs) -> None:
    """The one-card measurement drivers, unmodified, in this process:
    breakdown (every section, the row-major pipeline, the three tiers
    apart at diag 512 + hot 512), levers --quick, splitprobe and
    bench_spmm --quick.  Each checks itself
    (exit 1 on a mismatch): breakdown's tiers add up to its whole
    aggregation, splitprobe's splits equal the stock ``sag`` bitwise, and
    bench_spmm's hybrid arm equals its COO arm; here the lines that say
    so must be there."""
    log("phase 15: the one-card measurement drivers")
    out = run_driver("breakdown", breakdown.main,
                     ["--iters", "10", "--tiers", BREAKDOWN_TIERS], recs)
    require(any("against the whole: exact" in ln for ln in out),
            "breakdown's tiers add up to its whole aggregation")
    require(sum(ln.startswith("diag_b=") for ln in out) == 3,
            "breakdown timed its three tier configs")
    run_driver("breakdown --rowmajor --only hybrid", breakdown.main,
               ["--iters", "10", "--rowmajor", "--only", "hybrid"], recs)
    # the probed layout has had no hot tier so far: each of the three
    # tiers timed apart at fixed tiers
    out = run_driver("breakdown, diag 512 + hot 512", breakdown.main,
                     ["--iters", "10", "--diagb", "512", "--hotk", "512",
                      "--only", "hybrid,diag,hot,res"], recs)
    require("tiers diag+hot+res against the whole: exact" in out,
            "breakdown's three tiers add up to its whole aggregation")
    out = run_driver("levers --quick", levers.main, ["--quick"], recs)
    require(any(ln.startswith("# BEST:") for ln in out),
            "levers reports its best config")
    out = run_driver("splitprobe", splitprobe.main, [], recs)
    require(sum("bitwise equal to the stock sag" in ln for ln in out) == 2,
            "splitprobe's 2- and 4-way splits equal the stock sag")
    out = run_driver("bench_spmm --quick", bench_spmm.main, ["--quick"], recs)
    rows = [ln for ln in out if ln and not ln.startswith(("#", "dataset,"))]
    require(len(rows) == 1 and rows[0].startswith("amazon0505,"),
            "bench_spmm prints its quick row")
    for name in spmm_cuda.KERNELS:
        require(recs[name].driver_launches > 0,
                f"{name} launched by the measurement drivers")


def phase17(layouts, recs) -> None:
    """The tools and the multi-device drivers, each checking itself:
    ``overlap_ablation`` (one NCCL rank), ``bench_scaling --devices 1``,
    ``multihost_demo --hosts 1 --local_devices 1``, ``ogb_scale_demo`` at
    amazon0505 scale with ``--shard_devices 4``, ``tools.reorder`` on the
    10k graph as a text edge list."""
    log("phase 17: the tools and the multi-device drivers")

    def printed(line: str) -> None:
        print(f"    | {line}", flush=True)

    start = time.perf_counter()
    res = overlap_ablation.run(devices=1, log=printed, **ABLATION)
    arms = res["losses"]
    err = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(arms[True][0], arms[False][0]))
    log(f"  overlap_ablation ({time.perf_counter() - start:.1f} s), diag_b "
        f"{res['diag_b']} hot_k {res['hot_k']}; the rank's launches "
        f"{res['launches']}; the arms' {len(arms[True][0])} losses differ "
        f"by at most {err:.3e} relative (bitwise: {arms[True] == arms[False]})")
    require(res["diag_b"] > 0 and err <= CAPTURE_RTOL
            and all(math.isfinite(v) for v in arms[True][0]),
            "the ablation's two arms train alike, with a diagonal tier")
    require(all(math.isfinite(v) and v > 0 for v in res["ms"].values()),
            "the ablation timed both arms")
    for name, n in res["launches"].items():
        recs[name].tool_launches += n

    start = time.perf_counter()
    lines = []
    rows = bench_scaling.run([1], log=lines.append)
    for line in lines:
        printed(line)
    log(f"  bench_scaling --devices 1 ({time.perf_counter() - start:.1f} s)")
    require(len(rows) == 1 and math.isfinite(rows[0]["epoch_ms"])
            and rows[0]["epoch_ms"] > 0 and math.isfinite(rows[0]["loss"][0])
            and any("NVLink data-sheet rate" in ln for ln in lines),
            "bench_scaling times one rank, with the data-sheet link rate")

    start = time.perf_counter()
    res = multihost_demo.run(1, 1, log=printed)
    log(f"  multihost_demo --hosts 1 --local_devices 1 "
        f"({time.perf_counter() - start:.1f} s): {res}")
    require(res["ok"], "the multi-host demo's rank ran and printed its loss")

    out = run_driver("ogb_scale_demo " + " ".join(OGB_ARGS),
                     ogb_scale_demo.main, OGB_ARGS, recs, "tool_launches")
    require(any(ln.endswith("equals its degree: exact") for ln in out)
            and any(ln.startswith("shard plan nd=4") for ln in out),
            "ogb_scale_demo's SpMM sums and its 4-way plan")

    g10 = layouts[2][0]
    path = os.path.join("chiprun_out", f"chip_smoke-reorder-{os.getpid()}.txt")
    os.makedirs("chiprun_out", exist_ok=True)
    np.savetxt(path, g10.edge_index.T, fmt="%d")
    start = time.perf_counter()
    outs, rcs = [], []
    try:
        for argv in ([path], ["-c", path]):  # a line a node: not echoed
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rcs.append(reorder.main(argv))
            outs.append(out.getvalue().splitlines())
    finally:
        os.remove(path)
    require(rcs == [0, 0], "the reorder tool exits 0")
    (perm, comm), n = outs, g10.num_nodes
    q = float(err.getvalue().split("modularity:")[1])
    log(f"  tools.reorder on the 10k graph: {len(perm)} ids, "
        f"{len(set(comm))} communities, modularity {q:.6f} "
        f"({time.perf_counter() - start:.1f} s)")
    require(sorted(int(v) for v in perm) == list(range(n))
            and len(comm) == n and -0.5 <= q <= 1.0,
            "the reorder tool prints a permutation, and a community per "
            "node with a modularity")
    for name in ("slab_matmul_t", "residual_combine_t"):
        require(recs[name].tool_launches > 0, f"{name} launched by the tools")


class _Plain:
    """The hybrid kernels' plain versions under the wrappers' names."""

    def __getattr__(self, name):
        return getattr(spmm_cuda, f"{name}_plain")


PLAIN = _Plain()


def wide_kernels(g10, recs) -> None:
    """Every hybrid kernel against its plain version at the roster's GIN
    input widths, on the 10k graph with all three tiers (diag 512, hot
    512, residual), at f32 and bf16: integer features exactly (with and
    without the residual's addend), and random f32 features within
    ``order_tol``.  Phase 2's checks at amazon0505 scale cannot take these
    widths: the residual's plain version holds a [tiles, OB·D] product."""
    hg = hybrid.build_hybrid(g10, diag_b=512, hot_k=512)
    require(hg.num_res_slots > 0, "the 10k (512, 512) layout has a residual")
    tt = build_hybrid_tensors(hg, device=DEVICE, transposed=True)
    tr = build_hybrid_tensors(hg, device=DEVICE, transposed=False)
    r, b = hg.num_rows, hg.diag_b
    res_t = (tt.res_src, tt.res_mask_s, tt.res_t2b, tt.res_block_ptr, r,
             hg.res_ob)
    res_r = (tr.res_src, tr.res_mask, tr.res_t2b, tr.res_block_ptr, r,
             hg.res_ob)

    def views(x):
        """x [R, D] as each pipeline hands it over: (x, x_hot, x_t,
        x_hot_t), the transposed ones as views of padded tables."""
        xh = x.index_select(0, tr.hot_ids)
        return (x, xh, as_table(x.t().contiguous()),
                as_table(xh.t().contiguous()))

    def t(a):  # a row-major addend in the transposed orientation
        return None if a is None else a.t().contiguous()

    # (kernel, label, call(m, x, addend)) on row-major x [R, D], through
    # ``m``: ``spmm_cuda`` (the kernels) or ``PLAIN`` (their plain versions)
    kernels = [
        ("slab_matmul_t", "diag", lambda m, x, a: m.slab_matmul_t(
            tt.diag_bits, views(x)[2], b)),
        ("slab_matmul_t", "hot", lambda m, x, a: m.slab_matmul_t(
            tt.hot_bits, views(x)[3])),
        ("fused_slab_matmul_t", "diag+hot", lambda m, x, a:
            m.fused_slab_matmul_t(tt.diag_bits, tt.hot_bits,
                                  *views(x)[2:], b)),
        ("residual_combine_t", "", lambda m, x, a: m.residual_combine_t(
            views(x)[2], *res_t, addend=t(a))),
        ("slab_matmul", "diag", lambda m, x, a: m.slab_matmul(
            tr.diag_bits, x, b)),
        ("slab_matmul", "hot", lambda m, x, a: m.slab_matmul(
            tr.hot_bits, views(x)[1])),
        ("fused_slab_matmul", "diag+hot", lambda m, x, a:
            m.fused_slab_matmul(tr.diag_bits, tr.hot_bits,
                                *views(x)[:2], b)),
        ("residual_combine", "", lambda m, x, a: m.residual_combine(
            x, *res_r, addend=a)),
    ]
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    for d in ROSTER_DIMS:
        for dt in DTYPES:
            x = int_features((r, d), dt, gen)
            h = int_features((r, d), torch.float32, gen)
            for name, label, call in kernels:
                for add in ((None, h) if name.startswith("residual")
                            else (None,)):
                    compare(recs[name], f"{name} {label} D={d} {dt} integer"
                            f"{'' if add is None else ' + addend'}",
                            lambda: call(spmm_cuda, x, add),
                            lambda: call(PLAIN, x, add),
                            0.0, "exact, integer features")
        x = torch.randn((r, d), generator=gen, device=DEVICE)
        for name, label, call in kernels:
            tol = order_tol(lambda y: call(PLAIN, y, None), x)
            compare(recs[name], f"{name} {label} D={d} float32 random",
                    lambda: call(spmm_cuda, x, None),
                    lambda: call(PLAIN, x, None), tol, ORDER_TOL_TEXT)
            del tol


def first_forward(prop, g, model: str, hidden: int):
    """The tuned model's first-step loss on ``g`` (f32 aggregation), its
    log-probabilities [N, classes] on the card, and its initial weights
    (numpy, one per layer)."""
    hts = prop.build_tensors(device=DEVICE)
    transposed = is_transposed(hts[0])
    dim, classes = g.num_features, g.num_classes
    net = build_model(model, torch.Generator().manual_seed(0), dim, hidden,
                      classes, device=DEVICE)
    x = prop.pad_features(g.init_embedding(dim))
    x = torch.from_numpy(x.T.copy() if transposed else x).to(DEVICE)
    y = torch.from_numpy(prop.pad_features(g.init_labels(classes))).to(DEVICE)
    mask = torch.from_numpy(row_mask(prop)).to(DEVICE)
    with torch.no_grad():
        lp = net(x, hts)
        loss = float(nll_loss(lp, y, mask, transposed))
    lp = (lp.t() if transposed else lp)[: g.num_nodes]
    return loss, lp, [p.detach().cpu().numpy() for p in net.parameters()]


def log_prob_tol(g, model: str, weights, lp: torch.Tensor) -> torch.Tensor:
    """Per-node bound [N, 1] on the gap between two f32 evaluations of the
    first forward's log-probabilities that sum in other orders: 1e-4 +
    n·2^-24·s, n = Σ over layers of k_in + dmax + 4 (a GEMM's k_in
    products, at most dmax edge terms, each scaled and split over up to
    three tiers) and s the row's largest |logit| or |log-probability|
    (``lp``): the kernels' bound (``order_tol``) with the row's scale for
    the magnitudes.  The worst-case form, n·2^-24 times the forward on |x|
    and |W|, grows with the weights' cancellation to hundreds on pubmed
    and would hold nothing."""
    src, dst, deg, offsets = naive.graph_tensors(g, DEVICE)
    dmax = int(np.diff(np.asarray(g.row_pointers)).max())
    z = torch.from_numpy(g.init_embedding(g.num_features)).to(DEVICE)
    n = 0
    for i, w in enumerate(weights):
        w = torch.from_numpy(np.asarray(w, np.float32)).to(DEVICE)
        n += w.shape[0] + dmax + 4
        z = (naive.gcn_layer(z, w, src, dst, deg, offsets) if model == "gcn"
             else naive.gin_layer(z, w, dst, offsets))
        if i < len(weights) - 1:
            z = torch.relu(z)
    scale = torch.maximum(z.abs().amax(1, keepdim=True),
                          lp.abs().amax(1, keepdim=True))
    return ATOL + n * 2.0 ** -24 * scale


def baseline_oracle() -> None:
    """Phase 16(d): ``baselines.naive`` and ``baselines.torch_baseline`` on
    pubmed, GCN and GIN, from the tuned model's weights: the first-step
    loss within BASELINE_RTOL of the tuned model's, and the first
    forward's log-probabilities within ``log_prob_tol`` of its, node by
    node; then each baseline's ms a step over 5 epochs."""
    start = time.perf_counter()
    name = BASELINE_DATASET
    _, _, dim, classes, _, _ = DATASETS[name]
    g = get_dataset(name, dim=dim, classes=classes)
    for model, hidden in (("gcn", 16), ("gin", GIN_HIDDEN)):
        prop = InputProperty(g, hidden_dim=hidden, model=model,
                             agg_dtype="float32", probe=False).decider()
        want, want_lp, weights = first_forward(prop, g, model, hidden)
        require(not prop.reorder_status, "the tuned model keeps node order")
        for label, stack in (("naive", naive), ("torch", torch_baseline)):
            stats = {}
            ms = stack.run(name, model, 5, DEVICE, weights, stats)
            rel = abs(stats["first_loss"] - want) / abs(want)
            got_lp = stats["log_probs"]
            gap = (got_lp - want_lp).abs()
            tol = log_prob_tol(g, model, weights, want_lp)
            ok = (got_lp.shape == want_lp.shape
                  and bool(torch.isfinite(want_lp).all())
                  and bool((gap <= tol).all()))
            log(f"  (d) {label} {model.upper()} on {name}: first loss "
                f"{stats['first_loss']:.6f} against the tuned "
                f"{prop.layer_input.method} model's {want:.6f} (rel "
                f"{rel:.2e}, bound {BASELINE_RTOL:g}); per-node "
                f"log-probabilities {tuple(got_lp.shape)}: max gap "
                f"{float(gap.max()):.3e}, at most "
                f"{float((gap / tol).max()):.3e} of its bound, 1e-4 + "
                "n·2^-24 of the row's scale (largest bound "
                f"{float(tol.max()):.3e}); {ms:.3f} ms a step (5 epochs)")
            require(math.isfinite(want) and rel <= BASELINE_RTOL,
                    f"the {label} baseline's first {model} loss equals the "
                    "tuned model's")
            require(ok, f"the {label} baseline's first {model} "
                    "log-probabilities equal the tuned model's, node by "
                    "node, within 1e-4 + n·2^-24 of the row's scale")
    log(f"  (d) baselines: {time.perf_counter() - start:.1f} s")


def phase16(layouts, recs) -> None:
    """The roster drivers and the baselines: (a) the hybrid kernels at the
    roster GIN's input widths; (b) ``verify_all --quick``; (c) the quick
    roster campaign into a scratch log directory, its assembly and
    ``roster2md``; (d) ``baseline_oracle``."""
    log("phase 16: the roster drivers and the baselines")
    start = time.perf_counter()
    wide_kernels(layouts[2][0], recs)
    log(f"  (a) the kernels at D in {ROSTER_DIMS}: "
        f"{time.perf_counter() - start:.1f} s")

    start = time.perf_counter()
    rc = verify_all.main(["--quick"])
    log(f"  (b) verify_all --quick: exit {rc} "
        f"({time.perf_counter() - start:.1f} s)")
    require(rc == 0, "verify_all --quick passes on every graph and dtype")

    start = time.perf_counter()
    log_dir = os.path.join("chiprun_out", f"chip_smoke-campaign-{os.getpid()}")
    shutil.rmtree(log_dir, ignore_errors=True)
    try:
        rc = campaign.main(["--quick", "--only", "roster", "--log_dir",
                            log_dir])
        with open(os.path.join(log_dir, "roster.csv")) as fp:
            roster = fp.read().splitlines()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            roster2md.main([log_dir])
        table = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("| GCN") or ln.startswith("| GIN")]
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    log(f"  (c) campaign --quick --only roster: exit {rc} "
        f"({time.perf_counter() - start:.1f} s); roster.csv:")
    for line in roster:
        print(f"    | {line}", flush=True)
    for line in table:
        print(f"    | {line}", flush=True)
    require(rc == 0 and len(roster) == 7 and len(table) == 6,
            "the quick roster assembles 6 rows, and roster2md prints them")

    baseline_oracle()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    smi = phase0()
    exact_f32_matmul()
    phase1()
    layouts = build_layouts()
    rm = rowmajor_tensors(layouts)
    recs = {n: Record(n) for n in spmm_cuda.KERNELS + probe_cuda.KERNELS
            + tuple(fmtprobe_cuda.launches)}
    phase2(layouts, recs)
    phase2_rowmajor(layouts, rm, recs)
    epoch_ms = phase3(layouts, recs)
    phase4(layouts, recs)
    gin_epoch_ms = phase5(layouts, rm, recs)
    phase6(layouts, rm, recs)
    done = {}
    for name, phase in (
            ("7", lambda: phase7(recs)), ("8", lambda: phase8(recs)),
            ("9", lambda: phase9(layouts)), ("10", lambda: phase10(recs)),
            ("10b", lambda: seg_vs_residual(layouts, rm)),
            ("11", lambda: phase11(layouts, epoch_ms)),
            ("12", lambda: phase12(layouts, epoch_ms, gin_epoch_ms)),
            ("13", lambda: phase13(layouts, rm, done["12"])),
            ("14", lambda: phase14(layouts)),
            ("15", lambda: phase15(recs)),
            ("16", lambda: phase16(layouts, recs)),
            ("17", lambda: phase17(layouts, recs))):
        start = time.perf_counter()
        done[name] = phase()
        log(f"  phase took {time.perf_counter() - start:.1f} s")
    for rec in recs.values():
        require(rec.launches > 0, f"{rec.name} launched on its path")
    log(f"done: epoch_ms {epoch_ms:.4f} (GCN, transposed), gin_epoch_ms "
        f"{gin_epoch_ms:.4f} (GIN, row-major), both through the captured "
        f"step, on {smi}")
    print(smi)
    print(json.dumps({"kernels": [r.as_dict() for r in recs.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
