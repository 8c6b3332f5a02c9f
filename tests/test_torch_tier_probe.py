"""The port's measured-probe tier autotune (``graphs/hybrid.py``
``_maybe_probe_tiers``): the counterparts of the JAX package's probe tests
(tests/test_hybrid.py:331, :361, :417) with a fake ``_probe_spmm_time``,
and the same pick as the JAX ``build_hybrid(..., probe=True)`` under the
same fake times.

The JAX package's verdict cache goes to ``GNNADVISOR_CACHE_DIR`` and the
port's to ``GNNADVISOR_TORCH_CACHE_DIR``, both pointed at ``tmp_path``
here, so that no test writes the tracked ``data/.probe_cache.json`` or the
port's default cache directory.  The picks are exact (no tolerance)."""

import json
import os

import numpy as np
import pytest
import torch

import gnnadvisor_osdi21_tpu.graphs.hybrid as JH
import gnnadvisor_osdi21_tpu_torch.graphs.hybrid as H
from gnnadvisor_osdi21_tpu.graphs.loader import synthesize_graph as jax_graph
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import build_hybrid
from gnnadvisor_osdi21_tpu_torch.graphs.loader import synthesize_graph
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty


@pytest.fixture(autouse=True)
def caches(tmp_path, monkeypatch):
    """Both packages' verdict caches under this test's tmp_path."""
    monkeypatch.setenv("GNNADVISOR_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv(H.CACHE_DIR_ENV, str(tmp_path / "port"))
    return tmp_path


def _ranked(g, res_ob):
    return H.rank_tiers(
        np.repeat(np.arange(g.num_nodes, dtype=np.int64),
                  np.diff(g.row_pointers)),
        np.asarray(g.column_index, dtype=np.int64),
        g.num_nodes, res_ob=res_ob,
    )


def _graph(seed=7):
    return synthesize_graph(3000, 40000, num_features=8, kind="powerlaw",
                            seed=seed)


def test_probe_autotune_picks_measured_winner(monkeypatch):
    """Pin a fake timer that inverts the model's order: the probed build
    returns the 'measured' winner (tests/test_hybrid.py:331)."""
    g = _graph()
    base = build_hybrid(g, probe=False)
    ranked = _ranked(g, base.res_ob)
    assert ranked[0][1:] == (base.diag_b, base.hot_k)
    assert len(ranked) >= 2
    want = ranked[1][1:]
    times = {c[1:]: 1.0 for c in ranked}
    times[want] = 0.1
    monkeypatch.setattr(
        H, "_probe_spmm_time", lambda hg, dev: times[(hg.diag_b, hg.hot_k)]
    )
    probed = build_hybrid(g, probe=True, device="cpu")
    assert (probed.diag_b, probed.hot_k) == want
    # probe=False trusts the model
    assert (base.diag_b, base.hot_k) == ranked[0][1:]


@pytest.mark.parametrize("device", (None, "cpu"))
def test_probe_autotune_skipped_off_the_card(device, monkeypatch):
    """Default (probe=None) never probes a layout that is not built for a
    CUDA device: it equals the pure-model build
    (tests/test_hybrid.py:361)."""
    monkeypatch.setattr(H, "_probe_spmm_time",
                        lambda hg, dev: pytest.fail("probed off the card"))
    g = synthesize_graph(2000, 20000, num_features=8, kind="community", seed=9)
    a = build_hybrid(g, device=device)
    b = build_hybrid(g, probe=False)
    assert (a.diag_b, a.hot_k, a.res_ob, a.res_tile) == (
        b.diag_b, b.hot_k, b.res_ob, b.res_tile
    )
    assert a.tier_probe == b.tier_probe == "not run"


def test_probe_gate_opens_for_the_card():
    """probe=None on a small graph built for a CUDA device probes, and the
    probe runs on the card: without one it refuses."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the probe would run on it")
    g = _graph()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_hybrid(g, device="cuda")


def test_probe_cache_roundtrip(monkeypatch, caches):
    """Verdicts persist: the second build with the same graph and candidate
    set does not call the timer again and returns the cached winner
    (tests/test_hybrid.py:417); the cache lies in the port's own
    directory, keyed by the device's name."""
    g = _graph()
    base = build_hybrid(g, probe=False)
    ranked = _ranked(g, base.res_ob)
    want = ranked[1][1:]
    times = {c[1:]: 1.0 for c in ranked}
    times[want] = 0.1
    calls = []

    def timer(hg, dev):
        calls.append((hg.diag_b, hg.hot_k))
        return times[(hg.diag_b, hg.hot_k)]

    monkeypatch.setattr(H, "_probe_spmm_time", timer)
    first = build_hybrid(g, probe=True, device="cpu")
    assert (first.diag_b, first.hot_k) == want
    n_calls = len(calls)
    assert n_calls >= 2
    assert first.tier_probe == f"timed {n_calls} layouts"
    second = build_hybrid(g, probe=True, device="cpu")
    assert (second.diag_b, second.hot_k) == want
    assert len(calls) == n_calls  # cache hit: no new probe timings
    assert second.tier_probe == "cached" and base.tier_probe == "not run"
    path = H._probe_cache_path()
    assert path == os.path.join(str(caches / "port"), "probe_cache.json")
    with open(path) as fp:
        (key, value), = json.load(fp).items()
    assert key.startswith("cpu|v1-") and value == list(want)
    assert not os.path.exists(caches / "jax")


def test_cache_key_carries_the_device_name():
    g = _graph()
    cands = [(1.0, 0, 512), (1.1, 512, 0)]
    key = H._probe_cache_key(g, cands, torch.device("cpu"))
    ref = JH._probe_cache_key(jax_graph(3000, 40000, num_features=8,
                                        kind="powerlaw", seed=7), cands)
    assert key == "cpu|" + ref  # the reference key behind the device name


def test_default_cache_is_the_ports_ignored_directory(monkeypatch):
    monkeypatch.delenv(H.CACHE_DIR_ENV)
    path = H._probe_cache_path()
    assert path.endswith(os.path.join("gnnadvisor_osdi21_tpu_torch", "_cache",
                                      "probe_cache.json"))


@pytest.mark.parametrize("winner", (0, 1, 2, "near"))
@pytest.mark.parametrize("seed", (7, 11))
def test_probed_pick_matches_jax(winner, seed, monkeypatch):
    """The JAX build_hybrid(probe=True) and the port's pick the same
    (diag_b, hot_k) under the same fake times: the model's pick when it
    measures fastest, a challenger that wins by more than PROBE_MARGIN,
    and the model's pick again when the challenger wins by less."""
    g = _graph(seed)
    gj = jax_graph(3000, 40000, num_features=8, kind="powerlaw", seed=seed)
    base = build_hybrid(g, probe=False)
    ranked = _ranked(g, base.res_ob)[:H.PROBE_TOP]
    times = {c[1:]: 1.0 for c in ranked}
    if winner == "near":
        times[ranked[1][1:]] = 1.0 - H.PROBE_MARGIN / 2
    else:
        times[ranked[winner][1:]] = 0.5
    monkeypatch.setattr(
        H, "_probe_spmm_time", lambda hg, dev: times[(hg.diag_b, hg.hot_k)])
    monkeypatch.setattr(
        JH, "_probe_spmm_time", lambda hg: times[(hg.diag_b, hg.hot_k)])
    port = build_hybrid(g, probe=True, device="cpu")
    ref = JH.build_hybrid(gj, probe=True)
    assert (port.diag_b, port.hot_k) == (ref.diag_b, ref.hot_k)
    want = ranked[0 if winner == "near" else winner][1:]
    assert (port.diag_b, port.hot_k) == want


def test_decider_applies_the_probed_tiers(monkeypatch, capsys):
    """InputProperty(probe=True) builds the measured winner and refreshes
    its tiers (tuner/decider.py:321-345 in the JAX package)."""
    g = synthesize_graph(5000, 60000, num_features=8, num_classes=3,
                         kind="powerlaw", seed=7)
    prop = InputProperty(g, hidden_dim=4, probe=True, verbose=True).decider()
    model = (prop.diag_b, prop.hot_k)
    base = build_hybrid(g, probe=False)
    ranked = _ranked(g, base.res_ob)
    want = next(c[1:] for c in ranked[1:H.PROBE_TOP] if c[1:] != model)
    monkeypatch.setattr(
        H, "_probe_spmm_time",
        lambda hg, dev: 0.1 if (hg.diag_b, hg.hot_k) == want else 1.0)
    hts = prop.build_tensors(device="cpu")
    assert (prop.diag_b, prop.hot_k) == want
    assert (prop.hybrid_graph.diag_b, prop.hybrid_graph.hot_k) == want
    assert hts[0].diag_b == want[0] and hts[0].hot_k == want[1]
    assert "probe autotune: measured" in capsys.readouterr().out
    # probe=False keeps the model's pick
    off = InputProperty(g, hidden_dim=4, probe=False).decider()
    off.build_tensors(device="cpu")
    assert (off.diag_b, off.hot_k) == model


def test_decider_says_how_the_tiers_were_chosen(monkeypatch, capsys):
    """The verbose decider prints the layout's ``tier_probe`` and tiers:
    timed on the first build, replayed from the cache on the second (the
    line the card check reads from the CLI's output)."""
    g = _graph()
    monkeypatch.setattr(H, "_probe_spmm_time", lambda hg, dev: 1.0)
    lines = []
    for _ in range(2):
        prop = InputProperty(g, hidden_dim=4, method="hybrid", probe=True,
                             verbose=True)
        prop.decider().build_tensors(device="cpu")
        lines += [ln for ln in capsys.readouterr().out.splitlines()
                  if ln.startswith("# tier probe:")]
    n = min(len(_ranked(g, prop.hybrid_graph.res_ob)), H.PROBE_TOP)
    tiers = f"; built tiers diag_b={prop.diag_b} hot_k={prop.hot_k}"
    assert lines == [f"# tier probe: timed {n} layouts" + tiers,
                     "# tier probe: cached" + tiers]


def test_amazon_scale_graph_is_the_one_the_card_check_expects():
    """chip_smoke.py requires the amazon0505-scale graph's edge count and
    fingerprint for the numpy it runs under; the pair recorded for this
    numpy is the one the generator gives here."""
    import chip_smoke

    g = synthesize_graph(410236, 4878874, num_features=96, num_classes=22,
                         kind="web", seed=0)
    got = (g.nnz, H.graph_fingerprint(g))
    want = chip_smoke.EXPECTED_GRAPH.get(np.__version__)
    assert want is None or got == want
    assert len(got[1]) == 8 and int(got[1], 16) >= 0
