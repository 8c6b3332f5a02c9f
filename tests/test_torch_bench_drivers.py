"""The one-card measurement drivers (``bench/breakdown.py``, ``levers.py``,
``splitprobe.py``, ``bench_spmm.py``) and the row-major per-tier helpers
they time, rehearsed on the CPU against the JAX package's: the same
inputs through both, with the tolerance stated at each comparison.  Times
are masked: on the CPU they are the host's."""

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu.bench import bench_spmm as jax_bench_spmm
from gnnadvisor_osdi21_tpu.bench import breakdown as jax_breakdown
from gnnadvisor_osdi21_tpu.bench import levers as jax_levers
from gnnadvisor_osdi21_tpu.graphs.hybrid import build_hybrid as jax_build_hybrid
from gnnadvisor_osdi21_tpu.graphs.loader import (
    synthesize_graph as jax_synthesize_graph,
)
from gnnadvisor_osdi21_tpu.ops import hybrid_agg as jax_hybrid_agg
from gnnadvisor_osdi21_tpu.ops.aggregate import sag as jax_sag
from gnnadvisor_osdi21_tpu_torch.bench import (
    bench_spmm, breakdown, datasets, levers, splitprobe,
)
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import (
    CACHE_DIR_ENV, build_hybrid,
)
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.graphs.reorder import rabbit_reorder_graph
from gnnadvisor_osdi21_tpu_torch.ops import hybrid_agg
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import sag

# a graph with all three tiers at (diag 512, hot 512), and a residual that
# the auto layout keeps too: 4 output blocks, 13 residual tiles
NODES, EDGES, SEED = 3000, 30000, 1
BF16_RTOL = 2.0 ** -8


@pytest.fixture(autouse=True)
def _port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_DIR_ENV, str(tmp_path / "port_cache"))
    # the JAX drivers turn on XLA's persistent compile cache in the repo
    monkeypatch.setattr("gnnadvisor_osdi21_tpu.utils.cache."
                        "enable_compile_cache", lambda *a, **k: None)


@pytest.fixture(scope="module")
def graphs():
    """The same graph from both packages (one generator, one seed)."""
    return (synthesize_graph(NODES, EDGES, num_features=16, kind="powerlaw",
                             seed=SEED),
            jax_synthesize_graph(NODES, EDGES, num_features=16,
                                 kind="powerlaw", seed=SEED))


def _fast_timer(calls: bool):
    """A stand-in for ``chained_device_time``: one call of the op (when
    ``calls``), and a fixed time."""
    def timer(op, x, aux=None, iters=50, reps=3, warmup=1, stats=None):
        if calls:
            op(x, aux)
        return 1e-3
    return timer


def _lines(fn, argv) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue().splitlines()


# --- the per-tier helpers ----------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tier", ["diag", "hot", "res"])
def test_tier_helpers_match_jax(graphs, tier, dtype):
    """``diag_tier``/``hot_tier``/``residual_tier`` against the JAX
    ``_diag_aggregate``/``_hot_aggregate``/``_residual_aggregate`` (their
    reference branches on the CPU) on one layout, x [R, 24] seeded: f32
    within rtol 1e-5, bf16 features within 2^-8 of the largest value."""
    g, jg = graphs
    hg = build_hybrid(g, diag_b=512, hot_k=512)
    jhg = jax_build_hybrid(jg, diag_b=512, hot_k=512, probe=False)
    assert hg.num_res_slots and hg.num_res_slots == jhg.num_res_slots
    ht = hybrid_agg.build_hybrid_tensors(hg, device="cpu", agg_dtype=dtype,
                                         transposed=False)
    jht = jax_hybrid_agg.build_hybrid_tensors(jhg, agg_dtype=dtype)
    x = np.random.default_rng(3).standard_normal(
        (hg.num_rows, 24)).astype(np.float32)
    x[hg.real_nodes:] = 0
    port = {"diag": hybrid_agg.diag_tier, "hot": hybrid_agg.hot_tier,
            "res": hybrid_agg.residual_tier}[tier]
    ref = {"diag": jax_hybrid_agg._diag_aggregate,
           "hot": jax_hybrid_agg._hot_aggregate,
           "res": jax_hybrid_agg._residual_aggregate}[tier]
    tdt = hybrid_agg.AGG_DTYPES[dtype]
    got = port(torch.from_numpy(x).to(tdt), ht).numpy()
    want = np.asarray(ref(jnp.asarray(x).astype(dtype), jht), np.float32)
    assert got.shape == want.shape and np.abs(want).max() > 0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_RTOL * np.abs(want).max())


def test_tiers_add_up_to_the_whole(graphs):
    """On all-ones x the three tiers are integer counts: their sum equals
    the whole row-major aggregation, exactly."""
    hg = build_hybrid(graphs[0], diag_b=512, hot_k=512)
    ht = hybrid_agg.build_hybrid_tensors(hg, device="cpu", agg_dtype="bfloat16",
                                         transposed=False)
    x = torch.ones((hg.num_rows, 16), dtype=torch.bfloat16)
    parts = (hybrid_agg.diag_tier(x, ht) + hybrid_agg.hot_tier(x, ht)
             + hybrid_agg.residual_tier(x, ht))
    assert torch.equal(parts, sag(x.float(), ht))


# --- breakdown ---------------------------------------------------------


def test_breakdown_census_and_layout_match_jax(graphs, tmp_path):
    """``--only census,hybrid --iters 1`` on one .npz file (3,000 nodes:
    below 200,000 the reorder repeats): the graph, census and ``layout:``
    lines equal the JAX script's (JAX on the CPU, where ``sag`` takes its
    reference path)."""
    path = str(tmp_path / "g.npz")
    datasets._save_edges(path, graphs[0])
    argv = ["--graph", path, "--only", "census,hybrid", "--iters", "1"]
    mine = _lines(breakdown.main, argv + ["--device", "cpu"])
    theirs = _lines(jax_breakdown.main, argv)

    def kept(lines):
        return [ln for ln in lines
                if ln.startswith(("graph:", "layout:", "  hot coverage",
                                  "  diag cov"))]

    assert kept(mine) == kept(theirs) and len(kept(mine)) >= 8
    # the timed line is there, its numbers (and their padding) masked
    mask = re.compile(r"\s*[0-9.]+")
    assert [mask.sub(" #", ln) for ln in mine if ln.startswith("hybrid")] == \
        [mask.sub(" #", ln) for ln in theirs if ln.startswith("hybrid")]


def test_breakdown_every_section(graphs, tmp_path, monkeypatch):
    """Every section on the CPU at fixed tiers (diag 512, hot 512, so that
    each tier runs): the per-tier outputs add up to the whole, the tier
    sweep prints a line per entry, and ``geom`` one line."""
    monkeypatch.setattr("gnnadvisor_osdi21_tpu_torch.utils.timing."
                        "chained_device_time", _fast_timer(calls=True))
    path = str(tmp_path / "g.npz")
    datasets._save_edges(path, graphs[0])
    out = _lines(breakdown.main, [
        "--graph", path, "--iters", "1", "--diagb", "512", "--hotk", "512",
        "--tiers", "0:0,512:0", "--device", "cpu"])
    names = [ln.split("  ")[0] for ln in out if " ms | " in ln]
    assert names == ["hybrid total (sag)", "diag slab only (rowmajor)",
                     "hot slab only (rowmajor)", "residual only (rowmajor)",
                     "residual only (transposed)",
                     "fused slab only (transposed)"]
    assert "tiers diag+hot+res against the whole: exact" in out
    assert sum(ln.startswith("diag_b=") for ln in out) == 2
    assert out[-1].startswith("block_rows: not swept")


# --- levers ------------------------------------------------------------


def test_levers_quick_matches_jax(graphs, monkeypatch):
    """``--quick`` with both packages' ``_bench_graph`` on one small graph
    and the timers stubbed (the port's calls each config once): the same
    cost-model choice and the same config tags in order, less the JAX
    ``block_rows=`` sweep, a note line here."""
    g, jg = graphs
    monkeypatch.setattr(levers, "_bench_graph",
                        lambda dim=16: rabbit_reorder_graph(g))
    from gnnadvisor_osdi21_tpu.graphs.reorder import (
        rabbit_reorder_graph as jax_reorder,
    )
    monkeypatch.setattr(jax_levers, "_bench_graph",
                        lambda dim=16: jax_reorder(jg))
    monkeypatch.setattr("gnnadvisor_osdi21_tpu_torch.utils.timing."
                        "chained_device_time", _fast_timer(calls=True))
    monkeypatch.setattr("gnnadvisor_osdi21_tpu.utils.timing."
                        "chained_device_time", _fast_timer(calls=False))
    mine = _lines(levers.main, ["--quick", "--device", "cpu"])
    theirs = _lines(jax_levers.main, ["--quick"])

    def choice(lines):
        return [ln for ln in lines if ln.startswith("# cost-model choice")]

    def tags(lines):
        return [ln[:58].strip() for ln in lines
                if not ln.startswith("#") and " ms " in ln]

    assert choice(mine) == choice(theirs) and len(choice(mine)) == 1
    assert tags(mine) == [t for t in tags(theirs)
                          if not t.startswith("block_rows=")]
    assert any("hot_k=8192" in t for t in tags(mine))
    assert "# block_rows: not swept; the CUDA kernels size their own " \
           "launches" in mine


def test_levers_names_the_tile_the_kernels_refuse(graphs, monkeypatch):
    """The full grid's 512-slot residual tile is named, not run, and every
    other config runs (there is no catch-all)."""
    monkeypatch.setattr(levers, "_bench_graph",
                        lambda dim=16: rabbit_reorder_graph(graphs[0]))
    monkeypatch.setattr("gnnadvisor_osdi21_tpu_torch.utils.timing."
                        "chained_device_time", _fast_timer(calls=False))
    out = _lines(levers.main, ["--device", "cpu"])
    assert any(ln.startswith("# res_tile=512 res_ob=256: not run") for ln in out)
    assert [ln[:58].strip() for ln in out if ln.startswith("res_tile=")] == [
        "res_tile=128 res_ob=256", "res_tile=256 res_ob=256",
        "res_tile=256 res_ob=512"]
    assert not any("FAILED" in ln for ln in out)


# --- splitprobe --------------------------------------------------------


@pytest.mark.parametrize("n_split", [2, 4])
def test_split_equals_stock_and_jax(graphs, n_split):
    """The H-way split residual's ``sag`` equals the stock ``sag``
    exactly, and the JAX ``sag`` on the same layout within f32 rtol 1e-5
    (bf16 tiers, all-ones and random x)."""
    g, jg = graphs
    hg = build_hybrid(g)
    jhg = jax_build_hybrid(jg, probe=False)
    ht = hybrid_agg.build_hybrid_tensors(hg, device="cpu", transposed=True,
                                         agg_dtype="bfloat16")
    jht = jax_hybrid_agg.build_hybrid_tensors(jhg, transposed=True,
                                              agg_dtype="bfloat16")
    parts = splitprobe.split_parts(ht, n_split)
    assert len([p for p in parts if p["launch"]]) >= 2
    assert sum(p["rows"] for p in parts) == hg.num_rows
    rng = np.random.default_rng(4)
    for x in (np.ones((16, hg.num_rows), np.float32),
              rng.standard_normal((16, hg.num_rows)).astype(np.float32)):
        x[:, hg.real_nodes:] = 0
        xt = torch.from_numpy(x)
        got = splitprobe.split_sag(xt, ht, parts, None)
        assert torch.equal(got, sag(xt, ht))
        want = np.asarray(jax_sag(jnp.asarray(x), jht))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_splitprobe_main(graphs, monkeypatch):
    """The script on the CPU: the stock line, then each split bitwise
    equal to the stock ``sag``, with the rows its parts read."""
    monkeypatch.setattr(datasets, "bench_graph",
                        lambda dim=16, data_dir=None: graphs[0])
    monkeypatch.setattr("gnnadvisor_osdi21_tpu_torch.utils.timing."
                        "chained_device_time", _fast_timer(calls=True))
    out = _lines(splitprobe.main, ["--device", "cpu"])
    assert out[0].startswith("# graph: N=3000") and "fingerprint" in out[0]
    assert out[1].startswith("stock pipeline:")
    assert [ln.split(":")[0] for ln in out[2:]] == [
        "2-way split residual", "4-way split residual"]
    assert all("bitwise equal to the stock sag" in ln for ln in out[2:])


# --- bench_spmm --------------------------------------------------------


def test_bench_spmm_quick_matches_jax(graphs, monkeypatch):
    """``--quick`` with both packages' ``get_dataset`` giving one small
    graph: the same header and the same rows' datasets (and Gunrock
    column); the port's hybrid arm equals its COO arm."""
    g, jg = graphs
    monkeypatch.setattr(datasets, "get_dataset",
                        lambda name, data_dir="data", dim=None, classes=None: g)
    monkeypatch.setattr("gnnadvisor_osdi21_tpu.bench.datasets.get_dataset",
                        lambda name, data_dir="data", dim=None, classes=None: jg)
    stub = lambda op, x, aux=None, iters=200, reps=3, quad=4, stats=None: (
        1e-3, 0.0)
    monkeypatch.setattr("gnnadvisor_osdi21_tpu_torch.utils.timing."
                        "chained_marginal_time", stub)
    monkeypatch.setattr("gnnadvisor_osdi21_tpu.utils.timing."
                        "chained_marginal_time", stub)
    mine = _lines(bench_spmm.main, ["--quick", "--device", "cpu"])
    theirs = _lines(jax_bench_spmm.main, ["--quick"])

    def rows(lines):
        return [(ln.split(",")[0], ln.split(",")[-1]) for ln in lines
                if not ln.startswith("#")]

    assert mine[0] == theirs[0] == (
        "dataset,hybrid_ms,naive_coo_ms,speedup,gunrock_rtx3090_ms")
    assert rows(mine) == rows(theirs) == [
        ("dataset", "gunrock_rtx3090_ms"), ("amazon0505", "4.065")]
    assert any(ln.startswith("# amazon0505: fingerprint") for ln in mine)
