"""The port's CLI (``python -m gnnadvisor_osdi21_tpu_torch``) against the
JAX package's: the same options, defaults and choices, and the cases of
tests/test_cli.py on ``--platform cpu``."""

import os
import subprocess
import sys

import pytest
import torch

from gnnadvisor_osdi21_tpu.cli import build_parser as jax_parser
from gnnadvisor_osdi21_tpu_torch.cli import build_parser, main
from gnnadvisor_osdi21_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--platform", "cpu"]


def _options(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                 a.nargs)
        for a in parser._actions if a.dest != "help"
    }


# the port's own model, which the JAX package lacks: ``--model gat`` and
# its two options
GAT_OPTIONS = {"heads": (("--heads",), 8, None, int, None),
               "out_heads": (("--out_heads",), 8, None, int, None)}


def test_parser_matches_the_jax_parser():
    """Every option of the JAX parser with its default and choices; beyond
    them the port has GAT alone: one more ``--model`` choice and
    ``GAT_OPTIONS``."""
    port, jax = _options(build_parser()), _options(jax_parser())
    assert {k: port.pop(k, None) for k in GAT_OPTIONS} == GAT_OPTIONS
    flags, default, choices, kind, nargs = port["model"]
    assert choices == jax["model"][2] + ["gat"]
    port["model"] = (flags, default, jax["model"][2], kind, nargs)
    assert port == jax


@pytest.mark.parametrize("argv", [
    # tests/test_cli.py's training cases
    ["--synthetic", "800:6000:community", "--dim", "16", "--hidden", "8",
     "--classes", "4", "--num_epoches", "5", "--manual_mode", "False"],
    ["--synthetic", "500:4000:powerlaw", "--dim", "16", "--hidden", "8",
     "--classes", "4", "--model", "gin", "--num_epoches", "3",
     "--manual_mode", "True", "--method", "ell", "--partSize", "8"],
    ["--synthetic", "900:9000:powerlaw", "--dim", "16", "--hidden", "8",
     "--classes", "4", "--num_epoches", "3", "--manual_mode", "False",
     "--method", "hybrid"],
    ["--synthetic", "800:8000:community", "--dim", "16", "--hidden", "8",
     "--classes", "4", "--num_epoches", "3", "--manual_mode", "False",
     "--enable_rabbit", "True"],
    # the per-step loop and the single-SpMM profile
    ["--synthetic", "900:9000:powerlaw", "--dim", "16", "--hidden", "8",
     "--classes", "4", "--num_epoches", "3", "--manual_mode", "False",
     "--method", "hybrid", "--use_scan", "False"],
    ["--synthetic", "600:5000:community", "--dim", "16", "--hidden", "16",
     "--classes", "4", "--manual_mode", "False", "--single_spmm", "True",
     "--num_epoches", "5"],
    # GAT on its attention layout, in either mode
    ["--synthetic", "700:6000:web", "--dim", "16", "--hidden", "8",
     "--classes", "4", "--num_epoches", "3", "--manual_mode", "False",
     "--model", "gat"],
    ["--synthetic", "700:6000:web", "--dim", "16", "--hidden", "4",
     "--classes", "3", "--num_epoches", "2", "--model", "gat", "--heads",
     "4", "--out_heads", "2", "--use_scan", "False"],
], ids=["gcn_auto", "gin_manual_ell", "forced_hybrid", "rabbit",
        "per_step_loop", "single_spmm", "gat_auto", "gat_manual_heads"])
def test_cli_runs_on_the_cpu(argv, capsys):
    rc = main(argv + CPU)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert out[-1].startswith("Time (ms): ")
    assert float(out[-1].split(":")[1]) > 0
    assert "host's wall milliseconds" in out[-2]


@pytest.mark.parametrize("method", ["auto", "hybrid", "ell", "coo"])
def test_cli_verify_spmm(method, capsys):
    rc = main(["--synthetic", "600:5000:community", "--dim", "16",
               "--hidden", "16", "--classes", "4", "--manual_mode", "False",
               "--verify_spmm", "True", "--method", method] + CPU)
    assert rc == 0
    assert "Verification PASSED" in capsys.readouterr().out


def test_cli_save_and_resume(tmp_path, capsys):
    """--save_ckpt writes the step reached (10 dry-run + 5 epochs);
    --resume carries it on."""
    base = ["--synthetic", "900:9000:powerlaw", "--dim", "16", "--hidden",
            "8", "--classes", "4", "--num_epoches", "5", "--manual_mode",
            "False", "--method", "hybrid"] + CPU
    first, second = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert main(base + ["--save_ckpt", first]) == 0
    assert main(base + ["--resume", first, "--save_ckpt", second]) == 0
    tmpl = {"conv1": None, "conv2": None}
    _, opt, step = load_checkpoint(first, tmpl, {"mu": tmpl, "nu": tmpl})
    assert step == 15 and int(opt["count"]) == 15
    _, opt, step = load_checkpoint(second, tmpl, {"mu": tmpl, "nu": tmpl})
    assert step == 30 and int(opt["count"]) == 30


SEVERAL = ["--synthetic", "400:3000:community", "--num_devices", "2",
           "--dim", "16", "--hidden", "8", "--classes", "4", "--num_epoches",
           "3", "--manual_mode", "False"]


def _time_lines(out: str) -> list[str]:
    return [line for line in out.splitlines() if line.startswith("Time (ms): ")]


@pytest.mark.parametrize("extra", [
    ["--num_devices", "2"], ["--verify_spmm", "True"],
    ["--single_spmm", "True"], ["--method", "hybrid"]],
    ids=["several_devices", "verify_spmm", "single_spmm", "hybrid"])
def test_cli_refuses_what_gat_does_not_run(extra, capsys):
    argv = ["--synthetic", "300:2000:web", "--dim", "8", "--hidden", "4",
            "--classes", "3", "--model", "gat", "--manual_mode", "False"]
    if extra[0] == "--method":
        with pytest.raises(ValueError, match="method gat"):
            main(argv + extra + CPU)
        return
    assert main(argv + extra + CPU) == 2
    assert "--model gat" in capsys.readouterr().err


def test_cli_refuses_several_devices(capfd):
    """Once a refusal, now the multi-device path: ``--num_devices 2
    --platform cpu`` trains GCN on two gloo ranks (the hybrid shards under
    ``--method auto``), and rank 0 alone prints the time."""
    assert main(SEVERAL + CPU) == 0
    out = capfd.readouterr().out
    assert len(_time_lines(out)) == 1
    assert "2 gloo ranks" in out
    assert "the ranks ran step by step (gloo collectives cannot be " \
        "captured)" in out


def test_cli_several_devices_ell(capfd):
    """Any method but auto and hybrid shards the ELL layout (dist_ops)."""
    assert main(SEVERAL + ["--method", "ell", "--model", "gin"] + CPU) == 0
    assert len(_time_lines(capfd.readouterr().out)) == 1


def test_cli_needs_a_card_per_rank(capsys):
    """On the default platform, more ranks than cards exits non-zero and
    names both counts."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(have + 1, 2)
    argv = SEVERAL[:3] + [str(n)] + SEVERAL[4:]
    assert main(argv) == 2
    assert f"need {n} CUDA cards (one per rank), have {have}" in (
        capsys.readouterr().err)


def test_cli_needs_a_card_without_platform_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default platform runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--synthetic", "400:3000:community", "--num_epoches", "1"])


def test_python_dash_m_entry_point():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "gnnadvisor_osdi21_tpu_torch", "--synthetic",
         "300:2000:powerlaw", "--dim", "8", "--hidden", "4", "--classes",
         "3", "--num_epoches", "2", "--manual_mode", "False"] + CPU,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("Time (ms): ")
