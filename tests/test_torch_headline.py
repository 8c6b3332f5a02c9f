"""The headline bench (``bench/headline.py``) rehearsed on the CPU: the
same pipeline on a small web graph prints one JSON line with the
reference's keys."""

import json

import pytest
import torch

from gnnadvisor_osdi21_tpu_torch.bench import headline
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import CACHE_DIR_ENV

# bench.py's keys, less modeled_ms and fraction_of_achievable (TPU fits)
REFERENCE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "edges_per_s",
    "edges_per_s_unit", "dispatch_fixed_ms", "hbm_floor_fraction",
    "gather_ceiling_ms", "vs_gather_ceiling", "graph",
}
ADDED_KEYS = {"device", "power_limit_w", "fingerprint", "diag_b", "hot_k",
              "res_ob", "res_tile", "tier_probe"}


def test_cpu_rehearsal_prints_one_json_line(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(CACHE_DIR_ENV, str(tmp_path))
    assert headline.main(["--device", "cpu", "--nodes", "4096",
                          "--iters", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == REFERENCE_KEYS | ADDED_KEYS
    assert rec["metric"] != headline.METRIC  # host times, not the card's
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None
    assert "4096-node" in rec["graph"] and rec["value"] > 0
    # both fields are rounded to 4 decimals
    assert rec["vs_baseline"] == pytest.approx(
        headline.GUNROCK_AMAZON0505_MS / rec["value"], abs=1e-4)
    assert rec["tier_probe"] == "not run"  # the probe runs on the card only
    assert len(rec["fingerprint"]) == 8


def test_headline_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headline.run(nodes=512, iters=1)
