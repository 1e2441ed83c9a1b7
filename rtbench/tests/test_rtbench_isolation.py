"""The benchmark imports neither JAX nor the JAX package, its reference
nothing of the port, and a run without a card, or without the port,
fails without a result."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest

from rtbench.tests.conftest import ROOT

BENCH = ROOT / "rtbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "raytpu"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(imported_tops(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "raytpu_torch" not in set(imported_tops(path)), path


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from rtbench import run

    monkeypatch.setitem(sys.modules, "raytpu_torch.fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "raytpu.fake", object())
    assert run.forbidden_modules() == ["raytpu"]


def test_loading_the_harness_and_the_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import rtbench.run as r, rtbench.readings, rtbench.profiling\n"
            "import raytpu_torch.render, raytpu_torch.camera, raytpu_torch.scene\n"
            "print(r.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, timeout=300):
    return subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "config4.closeup",
         "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=timeout, cwd=cwd)


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_a_run_without_a_card_fails_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0 and _no_result(out)
    assert "no CUDA device" in out.stderr


def test_a_run_without_the_port_fails_without_a_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and _no_result(out)
    assert "raytpu_torch is not in" in out.stderr


def test_the_manifest_command_is_the_harness():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert m["command"] == ["python3", "rtbench/run.py"]
    assert m["paths"] == ["rtbench"]
