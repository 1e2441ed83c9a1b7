"""The tiny bench cuts each object of a configuration by the keys its mesh
takes: the two-object scenes come out as they always have, and a
one-object scene whose mesh generator takes no ``depth`` goes through
and runs correct."""

from __future__ import annotations

import json
import shutil

import pytest

from rtbench import manifest, run
from rtbench.tests.conftest import ROOT, make_tiny_bench

# a tilted box of six quads, flat-shaded; it refuses any parameter but
# ``half``, so a ``depth`` written into its parameters fails the run
QUADS = '''
import numpy as np


def make(params):
    if set(params) != {"generator", "half"}:
        raise ValueError(f"quads takes half alone, not {sorted(params)}")
    h = float(params["half"])
    corners = np.array([[x, y, z] for x in (-h, h) for y in (-h, h) for z in (-h, h)])
    faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    a, b = 0.5, 0.4
    turn = (np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
            @ np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]]))
    pos, nrm, tri = [], [], []
    for f in faces:
        quad = corners[list(f)] @ turn.T
        n = np.cross(quad[1] - quad[0], quad[2] - quad[0])
        base = len(pos)
        pos += list(quad)
        nrm += [n / np.linalg.norm(n)] * 4
        tri += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    return (np.asarray(pos, np.float32), np.asarray(nrm, np.float32),
            np.asarray(tri, np.int32))
'''


@pytest.mark.parametrize("name", ["config4", "reference"])
def test_the_tiny_two_object_configurations_are_unchanged(tiny_bench, name):
    want = json.loads((ROOT / "rtbench" / "configs" / f"{name}.json").read_text())
    want.update(width=32, height=18)
    want["skybox"]["size"] = 8
    want["objects"][0]["mesh"] = {"generator": "highpoly", "depth": 1, "radius": 3.0}
    want["objects"][1]["mesh"] = {"generator": "highpoly", "depth": 2, "radius": 1.0}
    got = json.loads((tiny_bench / "configs" / f"{name}.json").read_text())
    assert got == want


def test_a_one_object_scene_without_a_depth_runs_correct(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(ROOT / "rtbench", src / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (src / "rtbench" / "meshes" / "quads.py").write_text(QUADS)
    cfg = json.loads((ROOT / "rtbench" / "configs" / "reference.json").read_text())
    cfg.update(name="box", max_bounce_count=3,
               objects=[{"mesh": {"generator": "quads", "half": 4.0},
                         "material": "diffuse", "animation": "static"}])
    (src / "rtbench" / "configs" / "box.json").write_text(json.dumps(cfg))
    shutil.copy(ROOT / "rtbench" / "limits" / "reference.wide.json",
                src / "rtbench" / "limits" / "box.wide.json")
    m = manifest.load()
    m["configs"].append(dict(m["configs"][1], name="box", file="rtbench/configs/box.json"))
    m["workloads"].append({"name": "box.wide", "config": "box", "traffic": "wide",
                           "chips": 1, "why": "one static box of six quads"})
    assert manifest.problems(m) == []
    (src / "BENCHMARK.json").write_text(json.dumps(m))

    bench = make_tiny_bench(tmp_path / "tiny", src=src)
    tiny = json.loads((bench / "configs" / "box.json").read_text())
    assert tiny["objects"][0]["mesh"] == {"generator": "quads", "half": 4.0}
    assert (tiny["width"], tiny["height"], tiny["skybox"]["size"]) == (32, 18, 8)

    cell = manifest.Cell(manifest.load(bench.parent / "BENCHMARK.json"), "box.wide", bench)
    lines = []
    out = run.run_cell(cell, 2**32 + 13, 0.0, False, "cpu", log=lines.append)
    result = out["result"]
    assert result["correct"], result["check"]
    assert result["attempted"] == cell.traffic["loop_frames"]
    shares = next(line for line in lines if line.startswith("reference:"))
    shares = json.loads(shares.split("samples ")[1].split("]")[0] + "]")
    assert all(0.05 < s < 1.0 for s in shares), shares    # the box and the sky in view
