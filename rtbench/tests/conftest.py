"""Tiny cells for the benchmark's CPU tests: a temporary copy of the
benchmark folder whose configurations, paths and limits are cut to a
size the CPU renders in seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"width": 32, "height": 18}


def make_tiny_bench(dest: Path, loop: int = 4, src: Path = ROOT) -> Path:
    """A copy of ``src``'s ``rtbench/`` and ``BENCHMARK.json`` under
    ``dest`` with every configuration at 32x18, each mesh that takes a
    ``depth`` at depth 1 (the first object) or 2 (any other), an 8x8
    sky, loops of ``loop`` frames (12 for the wander) and 200 pixels
    compared a frame; returns the copy's benchmark folder."""
    bench = dest / "rtbench"
    shutil.copytree(src / "rtbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(src / "BENCHMARK.json", dest / "BENCHMARK.json")
    for f in (bench / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update(TINY)
        for i, obj in enumerate(cfg["objects"]):
            if "depth" in obj["mesh"]:
                obj["mesh"]["depth"] = 1 if i == 0 else 2
        cfg["skybox"]["size"] = 8
        f.write_text(json.dumps(cfg))
    for f in (bench / "traffic").glob("*.json"):
        tr = json.loads(f.read_text())
        if tr["kind"] == "wander":
            tr["segment_frames"] = 1
            tr["loop_frames"] = 2 * len(tr["segments"])
        else:
            tr["loop_frames"] = loop
        f.write_text(json.dumps(tr))
    for f in (bench / "limits").glob("*.json"):
        lim = json.loads(f.read_text())
        lim["pixels"] = 200
        f.write_text(json.dumps(lim))
    return bench


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    return make_tiny_bench(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def tiny_cell(tiny_bench):
    from rtbench import manifest

    def cell(workload: str):
        return manifest.Cell(manifest.load(tiny_bench.parent / "BENCHMARK.json"),
                             workload, tiny_bench)
    return cell


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
