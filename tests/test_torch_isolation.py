"""The torch port stands alone: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU, and a kernel
wrapper given a CUDA tensor never reaches its plain version."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import build_hybrid
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.graphs.gat import build_gat_layout
from gnnadvisor_osdi21_tpu_torch.models.gat import GAT
from gnnadvisor_osdi21_tpu_torch.models.gcn import GCN
from gnnadvisor_osdi21_tpu_torch.models.gin import GIN
from gnnadvisor_osdi21_tpu_torch.ops import gat_cuda, hybrid_agg, spmm_cuda
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import build_graph_tensors
from gnnadvisor_osdi21_tpu_torch.train import train_and_time
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "gnnadvisor_osdi21_tpu_torch",
    "gnnadvisor_osdi21_tpu_torch.device",
    "gnnadvisor_osdi21_tpu_torch.graphs.loader",
    "gnnadvisor_osdi21_tpu_torch.graphs.hybrid",
    "gnnadvisor_osdi21_tpu_torch.tuner.decider",
    "gnnadvisor_osdi21_tpu_torch.ops._build",
    "gnnadvisor_osdi21_tpu_torch.ops.spmm_cuda",
    "gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg",
    "gnnadvisor_osdi21_tpu_torch.ops.aggregate",
    "gnnadvisor_osdi21_tpu_torch.models",
    "gnnadvisor_osdi21_tpu_torch.models.gcn",
    "gnnadvisor_osdi21_tpu_torch.models.gin",
    "gnnadvisor_osdi21_tpu_torch.models.gat",
    "gnnadvisor_osdi21_tpu_torch.graphs.gat",
    "gnnadvisor_osdi21_tpu_torch.ops.gat",
    "gnnadvisor_osdi21_tpu_torch.ops.gat_cuda",
    "gnnadvisor_osdi21_tpu_torch.train",
    "gnnadvisor_osdi21_tpu_torch.ops.probe_cuda",
    "gnnadvisor_osdi21_tpu_torch.utils",
    "gnnadvisor_osdi21_tpu_torch.utils.timing",
    "gnnadvisor_osdi21_tpu_torch.bench",
    "gnnadvisor_osdi21_tpu_torch.bench.fixprobe",
    "gnnadvisor_osdi21_tpu_torch.bench.stepprobe",
    "gnnadvisor_osdi21_tpu_torch.bench.fmtprobe",
    "gnnadvisor_osdi21_tpu_torch.ops.fmtprobe_cuda",
    "gnnadvisor_osdi21_tpu_torch.native",
    "gnnadvisor_osdi21_tpu_torch.native.graphtools",
    "gnnadvisor_osdi21_tpu_torch.graphs.partition",
    "gnnadvisor_osdi21_tpu_torch.graphs.reorder",
    "gnnadvisor_osdi21_tpu_torch.ops.reference",
    "gnnadvisor_osdi21_tpu_torch.ops.graph_tensors",
    "gnnadvisor_osdi21_tpu_torch.utils.profiling",
    "gnnadvisor_osdi21_tpu_torch.utils.checkpoint",
    "gnnadvisor_osdi21_tpu_torch.bench.datasets",
    "gnnadvisor_osdi21_tpu_torch.bench.headline",
    "gnnadvisor_osdi21_tpu_torch.verification",
    "gnnadvisor_osdi21_tpu_torch.cli",
    "gnnadvisor_osdi21_tpu_torch.__main__",
    "gnnadvisor_osdi21_tpu_torch.parallel",
    "gnnadvisor_osdi21_tpu_torch.parallel.mesh",
    "gnnadvisor_osdi21_tpu_torch.parallel.partition",
    "gnnadvisor_osdi21_tpu_torch.parallel.hybrid_partition",
    "gnnadvisor_osdi21_tpu_torch.parallel.dist_ops",
    "gnnadvisor_osdi21_tpu_torch.parallel.dist_hybrid",
    "gnnadvisor_osdi21_tpu_torch.tools",
    "gnnadvisor_osdi21_tpu_torch.tools.dist_check",
    "gnnadvisor_osdi21_tpu_torch.tools.overlap_ablation",
    "gnnadvisor_osdi21_tpu_torch.tools.multihost_demo",
    "gnnadvisor_osdi21_tpu_torch.tools.ogb_scale_demo",
    "gnnadvisor_osdi21_tpu_torch.tools.reorder",
    "gnnadvisor_osdi21_tpu_torch.bench.bench_scaling",
    "gnnadvisor_osdi21_tpu_torch.bench.breakdown",
    "gnnadvisor_osdi21_tpu_torch.bench.levers",
    "gnnadvisor_osdi21_tpu_torch.bench.bench_spmm",
    "gnnadvisor_osdi21_tpu_torch.bench.splitprobe",
    "gnnadvisor_osdi21_tpu_torch.bench.log2csv",
    "gnnadvisor_osdi21_tpu_torch.bench.study2csv",
    "gnnadvisor_osdi21_tpu_torch.bench.bench_models",
    "gnnadvisor_osdi21_tpu_torch.bench.verify_all",
    "gnnadvisor_osdi21_tpu_torch.bench.studies",
    "gnnadvisor_osdi21_tpu_torch.bench.campaign",
    "gnnadvisor_osdi21_tpu_torch.bench.roster2md",
    "gnnadvisor_osdi21_tpu_torch.bench.baseline_campaign",
    "gnnadvisor_osdi21_tpu_torch.baselines",
    "gnnadvisor_osdi21_tpu_torch.baselines.naive",
    "gnnadvisor_osdi21_tpu_torch.baselines.torch_baseline",
    "chip_smoke",
    "chip_pair",
]

_CHECK = """
import importlib, sys
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "gnnadvisor_osdi21_tpu"
             or m.startswith("gnnadvisor_osdi21_tpu."))
assert not bad, bad
print("isolated", len({modules!r}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK.format(modules=PORT_MODULES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"isolated {len(PORT_MODULES)}"


def test_every_port_module_is_listed():
    pkg = os.path.join(ROOT, "gnnadvisor_osdi21_tpu_torch")
    found = set()
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                found.add(mod[: -len(".__init__")] if mod.endswith(
                    ".__init__") else mod)
    assert found <= set(PORT_MODULES) | {
        "gnnadvisor_osdi21_tpu_torch.graphs",
        "gnnadvisor_osdi21_tpu_torch.ops",
        "gnnadvisor_osdi21_tpu_torch.tuner",
    }, sorted(found - set(PORT_MODULES))


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")


def test_entry_points_refuse_cpu_fallback(no_card, skewed_graph):
    g = synthesize_graph(5000, 30000, num_features=8, num_classes=3, seed=1)
    prop = InputProperty(g, hidden_dim=4).decider()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prop.build_tensors()
    for method in ("ell", "dense", "coo"):
        prop = InputProperty(g, hidden_dim=4, method=method).decider()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prop.build_tensors()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_graph_tensors(g, method=method)
    hg = build_hybrid(skewed_graph, diag_b=512, hot_k=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hybrid_agg.build_hybrid_tensors(hg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GCN(8, 4, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GIN(8, 4, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GAT(8, 4, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InputProperty(g, hidden_dim=4, model="gat").decider().build_tensors()
    hts = (hybrid_agg.build_hybrid_tensors(hg, device="cpu"),) * 2
    x = np.zeros((hg.num_rows, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_and_time("gcn", hts, x, np.zeros(hg.num_rows, np.int32), 4, 3)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device: enough to steer dispatch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_typed(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_CudaTyped, t)


def _cuda_view(x_t: torch.Tensor) -> torch.Tensor:
    """x_t as the transposed kernels take it (the transposed view of a
    row-major table), reporting a CUDA device."""
    return _cuda_typed(spmm_cuda.row_table_t(x_t).t()[: x_t.shape[0]])


@pytest.mark.parametrize("kernel", spmm_cuda.KERNELS)
def test_cuda_tensors_never_reach_the_plain_version(kernel, monkeypatch):
    """Stub the plain versions to fail and the launchers to record: a
    wrapper given CUDA tensors must reach the launcher."""
    launched = []

    def plain(*args, **kwargs):
        raise AssertionError(f"{kernel}: CUDA operands reached the plain version")

    for name in spmm_cuda.KERNELS:
        monkeypatch.setattr(spmm_cuda, f"{name}_plain", plain)
        monkeypatch.setattr(
            spmm_cuda, f"_{name}_cuda",
            lambda *a, _n=name: launched.append(_n) or "launched",
        )
    bits = _cuda_typed(torch.zeros((4, 512), dtype=torch.uint16))
    x_hot = _cuda_view(torch.zeros((8, 64)))
    x = _cuda_view(torch.zeros((8, 512)))
    t2b = _cuda_typed(torch.tensor([0, 1], dtype=torch.int32))
    ptr = _cuda_typed(torch.tensor([0, 1, 2], dtype=torch.int32))
    if kernel == "slab_matmul_t":
        got = spmm_cuda.slab_matmul_t(bits, x_hot)
    elif kernel == "fused_slab_matmul_t":
        got = spmm_cuda.fused_slab_matmul_t(bits, bits, x, x_hot, 64)
    elif kernel == "residual_combine_t":
        mask = _cuda_typed(torch.zeros((2, 2 * 256), dtype=torch.uint16))
        src = _cuda_typed(torch.arange(2 * 32, dtype=torch.int32))
        got = spmm_cuda.residual_combine_t(
            _cuda_view(torch.zeros((8, 100))), src, mask, t2b, ptr, 512, 256,
            addend=_cuda_typed(torch.zeros((8, 512))))
    elif kernel == "hot_list_t":
        src = _cuda_typed(torch.tensor([3, 99], dtype=torch.int32))
        got = spmm_cuda.hot_list_t(
            _cuda_view(torch.zeros((8, 100))), ptr, src,
            addend=_cuda_typed(torch.zeros((8, 2))))
    elif kernel == "slab_matmul":
        got = spmm_cuda.slab_matmul(bits, _cuda_typed(torch.zeros((64, 8))))
    elif kernel == "fused_slab_matmul":
        got = spmm_cuda.fused_slab_matmul(
            bits, bits, _cuda_typed(torch.zeros((512, 8))),
            _cuda_typed(torch.zeros((64, 8))), 64)
    else:
        mask = _cuda_typed(torch.zeros((8, 2 * 32), dtype=torch.uint32))
        src = _cuda_typed(torch.arange(2 * 32, dtype=torch.int32))
        got = spmm_cuda.residual_combine(
            _cuda_typed(torch.zeros((100, 8))), src, mask, t2b, ptr, 512, 256,
            addend=_cuda_typed(torch.zeros((512, 8))))
    assert got == "launched" and launched == [kernel]


@pytest.mark.parametrize("kernel", gat_cuda.KERNELS)
def test_cuda_tensors_never_reach_the_attention_plain_version(kernel,
                                                             monkeypatch):
    """The attention kernels' wrappers, as above: CUDA operands reach the
    launcher, never the plain version."""
    launched = []

    def plain(*args, **kwargs):
        raise AssertionError(f"{kernel}: CUDA operands reached the plain version")

    for name in ("edge_softmax", "aggregate", "sddmm", "col_reduce"):
        monkeypatch.setattr(gat_cuda, f"{name}_plain", plain)
        monkeypatch.setattr(
            gat_cuda, f"_{name}_cuda",
            lambda *a, _n=name: launched.append(_n) or "launched")
    lay = build_gat_layout(synthesize_graph(50, 300, num_features=8,
                                            num_classes=3, seed=2))
    rows, cols = (gat_cuda.Walk(*(_cuda_typed(t) if isinstance(
        t, torch.Tensor) else t for t in dataclasses.astuple(
            gat_cuda.Walk.of(w, "cpu")))) for w in (lay.rows, lay.cols))
    n, e, k, f = 50, lay.num_edges, 8, 8

    def zeros(*shape, dtype=torch.float32):
        return _cuda_typed(torch.zeros(shape, dtype=dtype))

    if kernel == "gat_softmax":
        got = gat_cuda.edge_softmax(rows.ptr, rows.idx, zeros(n, k),
                                    zeros(n, k), 0.2)
    elif kernel == "gat_aggregate":
        got = gat_cuda.aggregate(zeros(n, k * f, dtype=torch.bfloat16), k, f,
                                 cols, zeros(e, k))
    elif kernel == "gat_sddmm":
        got = gat_cuda.sddmm(rows.ptr, rows.idx,
                             zeros(n, k * f, dtype=torch.bfloat16), k, f,
                             zeros(n, k * f), zeros(n, k * f), zeros(e, k),
                             zeros(n, k), zeros(n, k), 0.2)
    else:
        got = gat_cuda.col_reduce(zeros(e, k), cols)
    assert got == "launched" and launched == [kernel[len("gat_"):].replace(
        "softmax", "edge_softmax")]


def test_mixed_devices_are_refused():
    bits = torch.zeros((4, 512), dtype=torch.uint16)
    with pytest.raises(ValueError, match="one CUDA device"):
        spmm_cuda.slab_matmul_t(bits, _cuda_view(torch.zeros((8, 64))))
