"""The camera paths: closed, the same for the same seed, and the same
frames in another order for another seed."""

from __future__ import annotations

import numpy as np
import pytest

from rtbench import camerapath, manifest


def cells():
    m = manifest.load()
    return [manifest.Cell(m, w["name"]) for w in m["workloads"]]


@pytest.mark.parametrize("cell", cells(), ids=lambda c: c.name)
def test_a_path_is_closed(cell):
    poses, times, _ = camerapath.make(cell.traffic, cell.config, 77)
    loop = cell.traffic["loop_frames"]
    assert len(poses) == len(times) == loop
    # frame i of a run is pose i % loop: frame `loop` is frame 0
    assert poses[loop % loop] == poses[0] and times[loop % loop] == times[0]
    if cell.traffic["kind"] == "wander":
        _, _, start = camerapath.make(cell.traffic, cell.config, 77)
        path = [poses[(k - start) % loop] for k in range(loop)]
        for k in range(1, loop // 2):
            assert path[k] == path[loop - k]   # the second half retraces the first


@pytest.mark.parametrize("cell", cells(), ids=lambda c: c.name)
def test_the_same_seed_gives_the_same_path(cell):
    assert camerapath.make(cell.traffic, cell.config, 2**31 + 5) == \
        camerapath.make(cell.traffic, cell.config, 2**31 + 5)


@pytest.mark.parametrize("cell", cells(), ids=lambda c: c.name)
def test_every_seed_renders_the_same_frames(cell):
    a = camerapath.make(cell.traffic, cell.config, 1)
    b = camerapath.make(cell.traffic, cell.config, 2**40 + 3)
    key = lambda pose, t: (tuple(pose["position"]), pose["yaw"], pose["pitch"], t)
    assert sorted(map(key, a[0], a[1])) == sorted(map(key, b[0], b[1]))


def test_the_closeup_keeps_its_distance_and_looks_at_the_armadillo():
    from rtbench.reference import scene_math

    cell = next(c for c in cells() if c.name == "config4.closeup")
    poses, times, _ = camerapath.make(cell.traffic, cell.config, 9)
    lo, hi = cell.traffic["distance"]
    wobble = np.radians(cell.traffic["wobble_deg"])
    for pose, t in zip(poses, times):
        to = scene_math.orbit_center(t) - np.asarray(pose["position"])
        dist = np.linalg.norm(to)
        assert lo - 1e-9 <= dist <= hi + 1e-9
        front = scene_math.front_of(pose["yaw"], pose["pitch"])
        assert np.degrees(np.arccos(front @ to / dist)) <= np.degrees(np.sqrt(2) * wobble) + 1e-6


def _hashes(folder):
    import hashlib

    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def test_a_path_kind_and_a_static_closeup_are_added_as_files_alone(tmp_path):
    import json
    import shutil

    from rtbench.reference import scene_math
    from rtbench.tests.conftest import ROOT

    bench = tmp_path / "rtbench"
    shutil.copytree(ROOT / "rtbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _hashes(bench)
    # a kind of path that does not exist yet: a circle about the origin
    (bench / "paths" / "circle.py").write_text(
        "import math\n"
        "def make(traffic, config, seed):\n"
        "    n, r = traffic['loop_frames'], traffic['radius']\n"
        "    return [{'position': [r * math.cos(2 * math.pi * k / n), 1.0,\n"
        "                          r * math.sin(2 * math.pi * k / n)],\n"
        "             'yaw': 2 * math.pi * k / n + math.pi, 'pitch': 0.0}\n"
        "            for k in range(n)]\n")
    common = {"path_seed": 3, "loop_frames": 8, "fps": 60, "time_scale": 0.1}
    (bench / "traffic" / "circle.json").write_text(
        json.dumps(dict(common, kind="circle", radius=12.0)))
    # a configuration whose one object is static, as config2's and config3's are
    cfg = json.loads((bench / "configs" / "reference.json").read_text())
    cfg["objects"] = [dict(cfg["objects"][0], animation="static")]
    (bench / "configs" / "statics.json").write_text(json.dumps(cfg))
    near = dict(common, kind="track", anchor_object=0, facing="camera",
                distance=[5.0, 7.0], elevation_deg=[5.0, 25.0], wobble_deg=0.0,
                wobble_harmonics=[2, 3])
    (bench / "traffic" / "near.json").write_text(json.dumps(near))
    m = manifest.load()
    m["configs"].append(dict(m["configs"][1], name="statics",
                             file="rtbench/configs/statics.json"))
    for mix in ("circle", "near"):
        (bench / "limits" / f"statics.{mix}.json").write_text(
            (bench / "limits" / "reference.wide.json").read_text())
        m["workloads"].append({"name": f"statics.{mix}", "config": "statics",
                               "traffic": mix, "chips": 1, "why": "a throwaway cell"})
    assert manifest.problems(m) == []

    circle = manifest.Cell(m, "statics.circle", bench)
    poses, times, _ = camerapath.make(circle.traffic, circle.config, 2**31 + 1, bench)
    assert len(poses) == len(times) == 8
    assert sorted(round(p["position"][0], 9) for p in poses)[-1] == 12.0

    closeup = manifest.Cell(m, "statics.near", bench)
    poses, _, _ = camerapath.make(closeup.traffic, closeup.config, 5, bench)
    assert len(poses) == 8
    for pose in poses:
        to = -np.asarray(pose["position"])      # the static teapot's origin
        dist = np.linalg.norm(to)
        assert 5.0 - 1e-9 <= dist <= 7.0 + 1e-9
        assert pose["position"][2] > 0           # on the viewer's side, z = 20
        front = scene_math.front_of(pose["yaw"], pose["pitch"])
        assert front @ to / dist == pytest.approx(1.0)
    # facing outward from an object at the world origin has no direction
    with pytest.raises(ValueError, match="camera"):
        camerapath.make(dict(near, facing="outward"), closeup.config, 5, bench)
    # nothing that was there has changed
    after = _hashes(bench)
    assert {k: after[k] for k in before} == before


def test_a_track_follows_a_spinning_anchor():
    cell = next(c for c in cells() if c.name == "config4.closeup")
    traffic = dict(cell.traffic, anchor_object=0, facing="camera",
                   distance=[8.0, 8.0], elevation_deg=[10.0, 10.0])
    poses, _, _ = camerapath.make(traffic, cell.config, 4)
    for pose in poses:
        assert np.linalg.norm(pose["position"]) == pytest.approx(8.0)
