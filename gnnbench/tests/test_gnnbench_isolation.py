"""What the harness loads: never JAX nor the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference and the model modules nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest
from conftest import REPO

HARNESS = os.path.join(REPO, "gnnbench")
JAX_TOPS = {"jax", "jaxlib", "flax", "gnnadvisor_osdi21_tpu"}
PORT = "gnnadvisor_osdi21_tpu_torch"


def loaded_tops(code: str, root: str = REPO) -> set[str]:
    probe = code + (
        "\nimport sys\nprint(sorted({m.split('.', 1)[0] "
        "for m in sys.modules}))")
    res = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                             [root, REPO])))
    assert res.returncode == 0, res.stderr[-3000:]
    return set(eval(res.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(harness):
    tops = loaded_tops(
        "from gnnbench import run, calibrate\n"
        "rc = run.main(['--workload', 'gcn.tiny', '--seed', '7', "
        "'--seconds', '0.2', '--trace', '1'], device='cpu')\n"
        "assert rc == 0, rc\n"
        "assert run.forbidden_modules() == []", root=harness)
    assert PORT in tops
    assert not tops & JAX_TOPS


# the reference and every model module, which it runs
REFERENCE_FILES = ["reference.py"] + sorted(
    f"models/{f}" for f in os.listdir(os.path.join(HARNESS, "models"))
    if f.endswith(".py"))


@pytest.mark.parametrize("path", REFERENCE_FILES)
def test_the_reference_loads_nothing_of_the_program(path):
    full = os.path.join(HARNESS, path)
    tops = loaded_tops(
        "import importlib.util\n"
        f"s = importlib.util.spec_from_file_location('probe', {full!r})\n"
        "s.loader.exec_module(importlib.util.module_from_spec(s))")
    assert PORT not in tops
    assert not tops & JAX_TOPS
    with open(full) as fp:
        tree = ast.parse(fp.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add((node.module or "").split(".", 1)[0])
    assert imported <= {"__future__", "numpy", "torch"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from gnnbench import run

    monkeypatch.setitem(sys.modules, PORT + ".fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gnnadvisor_osdi21_tpu.fake", object())
    assert run.forbidden_modules() == ["gnnadvisor_osdi21_tpu"]


def test_the_jax_packages_records_are_not_read():
    names = ("bench" + ".py", "BENCH" + "_", "MULTICHIP" + "_",
             "run_bench" + ".sh")
    for d, dirs, files in os.walk(HARNESS):
        dirs[:] = [x for x in dirs if x not in ("tests", "_cache",
                                                "__pycache__")]
        for f in files:
            with open(os.path.join(d, f), errors="replace") as fp:
                text = fp.read()
            assert not [n for n in names if n in text], f
