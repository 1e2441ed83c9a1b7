"""The port's bench (``raytpu_torch/bench.py``) against raytpu's
(``raytpu/bench.py``): the same ray count, the same guard rails as
``tests/test_bench.py`` pins for raytpu's harness (plausibility guard,
completeness, budget admission), and ``python -m raytpu_torch.bench``'s
one JSON line."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytpu.bench import count_rays_frame as jax_count_rays_frame
from raytpu.render import Renderer as JaxRenderer
from raytpu_torch import bench, scenes
from raytpu_torch.render import Renderer
from tests.torch_twin import one_thread, twin

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("make", [
    lambda: scenes.mixed_scene(64, 48, spp=2, bounces=3),
    lambda: scenes.config1_standin(width=64, height=64),
], ids=["mixed_scene", "config1_standin"])
def test_count_rays_frame_equals_raytpus(make):
    """raytpu counts in a replay of its bounce loop; the port reads one
    frame's counters. Same scene, pose and camera: the same count."""
    jscene, scene = twin(make())
    jr, r = JaxRenderer(jscene), Renderer(scene, "cpu")
    for x in (jr, r):
        x.set_transforms(0.1)
    want = jax_count_rays_frame(jr.device_scene, jr.static, jr.render_static,
                                jr.camera.basis())
    with one_thread():
        got = bench.count_rays_frame(r.tscene, r.render_static, r.camera_tensor())
    rs = r.render_static
    assert got == want > rs.width * rs.height * rs.samples_per_pixel // 2


def _frame():
    return torch.zeros((4, 4, 3))


def test_plausibility_guard_flags_impossible_rows():
    # 1920x1080x4spp at 0.21 ms implies ~39,500 Mrays/s of primary rays
    out = {"width": 1920, "height": 1080, "spp": 4,
           "frame_ms": 0.21, "fps": 4761.9, "mrays_per_s": None}
    bench._plausibility_guard(out, _frame, frames=8)
    assert out["suspect"] is True
    assert out["suspect_pipelined_ms"] == 0.21
    assert out["suspect_implied_mrays"] > bench.PLAUSIBLE_MRAYS
    assert out["frame_ms"] > 0
    np.testing.assert_allclose(out["fps"], 1e3 / out["frame_ms"])


def test_plausibility_guard_flags_the_jax_packages_artifact_row():
    # the corrupted row the JAX package's guard was set for implied about
    # 9,100 Mrays/s: 1920x1080x4spp in 0.9115 ms
    out = {"width": 1920, "height": 1080, "spp": 4,
           "frame_ms": 0.9115, "fps": 1097.1, "mrays_per_s": None}
    bench._plausibility_guard(out, _frame, frames=8)
    assert out["suspect"] is True
    np.testing.assert_allclose(out["suspect_implied_mrays"], 9099.75, rtol=1e-4)


def test_plausibility_guard_leaves_sane_rows_alone():
    # the fastest frame on record: config4 stand-in, pallas tier, 7.412 ms
    out = {"width": 1920, "height": 1080, "spp": 4, "frame_ms": 7.412,
           "fps": 134.9, "mrays_per_s": 1278.7, "rays_per_frame": 9477760}
    before = dict(out)
    bench._plausibility_guard(out, _frame, frames=8)
    assert out == before


def test_plausibility_guard_rescales_mrays():
    out = {"width": 800, "height": 600, "spp": 4, "frame_ms": 0.02,
           "fps": 50000.0, "mrays_per_s": 90000.0, "rays_per_frame": 1800000}
    bench._plausibility_guard(out, _frame, frames=8)
    assert out["suspect"] is True
    np.testing.assert_allclose(out["mrays_per_s"],
                               out["rays_per_frame"] / out["frame_ms"] / 1e3)


def test_matrix_complete():
    ok_row = {"frame_ms": 10.0, "fps": 100.0}
    configs = {f"c{i}": dict(ok_row) for i in range(5)}
    assert bench.matrix_complete(configs, need=5)
    configs["c4"] = {"skipped": "budget exhausted (10s)"}
    assert not bench.matrix_complete(configs, need=5)
    configs["c4"] = {"error": "RuntimeError('x')"}
    assert not bench.matrix_complete(configs, need=5)
    configs["c4"] = {**ok_row, "suspect": True}
    assert not bench.matrix_complete(configs, need=5)
    assert bench.matrix_complete(configs, need=4)


def test_run_matrix_budget_admission():
    """With a zero budget every stand-in is skipped with a reason, and no
    renderer is built."""
    renderers = {}
    out = bench.run_matrix(budget_s=0.0, renderers=renderers)
    assert list(out) == list(bench.STANDINS) and not renderers
    assert all("skipped" in row for row in out.values())


def test_run_benchmark_refuses_devices():
    with pytest.raises(bench.log.RaytpuError, match="devices=0"):
        bench.run_benchmark(devices=0)


def test_run_benchmark_sharded_over_cpu_slots():
    """``devices=2`` on the CPU times the frame sharded over two CPU slots
    and says so; the rays are one device's frame's, as the JAX package
    counts them."""
    scene = scenes.config1_standin(width=16, height=16)
    with one_thread():
        out = bench.run_benchmark(preset=scene, frames=2, devices=2, device="cpu")
        one = bench.run_benchmark(preset=scene, frames=2, device="cpu")
    assert out["devices"] == 2 and "devices" not in one
    assert out["rays_per_frame"] == one["rays_per_frame"] > 0
    assert out["frame_ms"] > 0 and out["tier"] == one["tier"]


def test_bench_cli_prints_one_json_line():
    """``python -m raytpu_torch.bench --cpu`` on the config1 stand-in: one
    JSON line with the bench's keys; a budget below the matrix's first
    estimate skips the other stand-ins, which the line says."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "raytpu_torch.bench", "--cpu", "--preset",
         "config1_standin", "--frames", "2", "--budget", "45"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["unit"] == "Mrays/s" and out["value"] > 0
    assert "config1_standin" in out["metric"] and "vs_baseline" not in out
    assert sorted(out["configs"]) == sorted(bench.STANDINS)
    assert out["configs"]["config1_standin"]["tier"] == "mega"
    assert out["artifact_incomplete"] is True
    assert all("skipped" in out["configs"][n] for n in bench.STANDINS
               if n != "config1_standin")
    assert out["bit_identical"] is True and out["tie_check"]["ok"] is True
    assert "stage_ms" not in out and "stage_error" not in out
    assert out["device"]["name"] == "cpu" and out["device"]["torch"] == torch.__version__
    assert set(out["cache"]) == {"dir", "entries_before", "entries_after"}
