"""The reference against the port's frame on the CPU, at a tiny size with
a shallow armadillo: the whole frame, and a sound run of each cell."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtbench import camerapath, check, run
from rtbench.reference import scene_math
from rtbench.reference.whitted import Reference

CELLS = ("config4.closeup", "reference.wide", "config4.wide", "reference.closeup")


@pytest.mark.parametrize("workload", CELLS)
def test_the_reference_renders_the_ports_frame(tiny_cell, workload):
    cell = tiny_cell(workload)
    cfg = cell.config
    meshes = [run.make_mesh(cell.bench_dir, o["mesh"]) for o in cfg["objects"]]
    sky = run.make_sky(cfg, 11, "cpu", cell.bench_dir)
    viewer = run.Viewer(run.port_renderer(cfg, meshes, sky, "cpu"))
    poses, times, _ = camerapath.make(cell.traffic, cfg, 11)
    for k in range(3):
        img = viewer.frame(poses[k], times[k])
    ref = Reference(cfg, meshes, torch.as_tensor(sky), "cpu")
    ref.set_history(viewer.history)
    pixels = np.stack(np.meshgrid(np.arange(cfg["width"]), np.arange(cfg["height"])),
                      -1).reshape(-1, 2)
    pose = poses[2]
    stats = {}
    want = ref.render(scene_math.basis(pose["position"], pose["yaw"], pose["pitch"]),
                      pixels, stats).numpy()
    gaps = check.gaps(img[pixels[:, 1], pixels[:, 0]], want)
    assert 0.05 < stats["primary_hit_share"] < 1.0     # meshes and sky in view
    assert (gaps > 1 / 255).mean() <= 0.01
    assert gaps.mean() < 1e-4


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(tiny_cell, workload):
    out = run.run_cell(tiny_cell(workload), 2**32 + 9, 0.0, False, "cpu",
                       log=lambda m: None)
    result = out["result"]
    assert result["correct"], result["check"]
    assert list(result)[-1] == "check"      # the contract: the compared numbers last
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert set(result["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert result["attempted"] == tiny_cell(workload).traffic["loop_frames"]
