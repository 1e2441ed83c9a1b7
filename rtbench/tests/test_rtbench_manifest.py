"""The manifest keeps the naming rules, every cell resolves to its files,
and a cell, a traffic mix and a per-layer metric are added as files and
entries alone."""

from __future__ import annotations

import json
import shutil

import pytest

from rtbench import manifest
from rtbench.tests.conftest import ROOT

KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_manifest_keeps_the_naming_rules():
    m = manifest.load()
    assert set(m) == KEYS
    assert manifest.problems(m) == []
    for metric in m["end_to_end"] + m["per_layer"]:
        assert 1 <= len(metric["unit"]) <= 16
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert {e["name"] for e in m["end_to_end"]} == {"frame_ms", "frame_p95_ms", "setup_s"}
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert len(json.dumps(m)) < 64 * 1024


def test_problems_finds_a_bad_name_and_unit():
    m = manifest.load()
    m["per_layer"] = m["per_layer"] + [dict(m["per_layer"][0], name="bad name",
                                            unit="tokens per second")]
    found = manifest.problems(m)
    assert any("bad name" in f for f in found)
    assert any("tokens per second" in f for f in found)


@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load()["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    m = manifest.load()
    cell = manifest.Cell(m, workload)
    assert cell.chips == 1
    assert cell.config["width"] > 0 and cell.traffic["loop_frames"] > 0
    assert set(cell.limits["limits"]) == {"over_share", "gap_mean"}
    for obj in cell.config["objects"]:
        assert (ROOT / "rtbench" / "meshes" / f"{obj['mesh']['generator']}.py").exists()
    assert (ROOT / "rtbench" / "skies" / f"{cell.config['skybox']['generator']}.py").exists()
    assert {e["name"] for e in cell.end_to_end()} >= {"setup_s", "frame_ms"}
    assert cell.per_layer()
    for metric in cell.per_layer():
        assert callable(cell.reader(metric["name"]))
    cfg_entry = next(c for c in m["configs"] if c["name"] == cell.config_name)
    for key in cfg_entry["reduced"]:
        assert key in cell.config and key in cell.config["assumed"]


def test_a_cell_mix_and_metric_are_added_as_files_alone(tmp_path):
    bench = tmp_path / "rtbench"
    shutil.copytree(ROOT / "rtbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest.load()
    traffic = json.loads((bench / "traffic" / "closeup.json").read_text())
    traffic["distance"] = [6.0, 9.0]
    (bench / "traffic" / "far.json").write_text(json.dumps(traffic))
    (bench / "limits" / "config4.far.json").write_text(
        (bench / "limits" / "config4.closeup.json").read_text())
    (bench / "metrics" / "loop.frames.py").write_text(
        "def read(ctx):\n    return float(ctx.stats['frames'])\n")
    m["workloads"].append({"name": "config4.far", "config": "config4",
                           "traffic": "far", "chips": 1, "why": "a throwaway cell"})
    m["per_layer"].append({"name": "loop.frames", "unit": "count", "better": "lower",
                           "source": "program_counter", "layer": "device",
                           "moves": "frame_ms", "workloads": ["config4.far"]})
    assert manifest.problems(m) == []
    cell = manifest.Cell(m, "config4.far", bench)
    assert cell.traffic["distance"] == [6.0, 9.0]
    assert [x["name"] for x in cell.per_layer()][-1] == "loop.frames"

    class Ctx:
        stats = {"frames": 120}
    assert cell.reader("loop.frames")(Ctx) == 120.0
    from rtbench import camerapath
    poses, times, _ = camerapath.make(cell.traffic, cell.config, 5)
    assert len(poses) == len(times) == traffic["loop_frames"]


def test_a_missing_file_is_named():
    m = manifest.load()
    m["workloads"] = m["workloads"] + [{"name": "config4.none", "config": "config4",
                                        "traffic": "none", "chips": 1, "why": "x"}]
    with pytest.raises(manifest.ManifestError, match="none.json"):
        manifest.Cell(m, "config4.none")
