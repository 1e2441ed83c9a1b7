"""The port's frontends, timing and CLI (``raytpu_torch/frontend``,
``utils/timing.py``, ``cli.py``) against raytpu's and as
``tests/test_frontend.py`` holds raytpu's."""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytpu.frontend.flythrough import Flythrough as JaxFlythrough
from raytpu.frontend.flythrough import ScriptSegment as JaxSegment
from raytpu_torch import bench, cli, render, scenes
from raytpu_torch.frontend import flythrough, headless
from raytpu_torch.frontend.flythrough import DEFAULT_SCRIPT, Flythrough, ScriptSegment
from raytpu_torch.io.image import _to_uint8, read_png
from raytpu_torch.render import Renderer
from raytpu_torch.utils import timing
from raytpu_torch.utils.log import RaytpuError
from tests.torch_twin import twin

REPO = Path(__file__).resolve().parent.parent


def _tiny(**config):
    return scenes.two_box_scene(24, 16, 1, 2, **config)


def test_render_still_writes_the_frame(tmp_path):
    out = str(tmp_path / "x.png")
    scene = _tiny()
    img = headless.render_still(scene, out, time_param=0.3, device="cpu")
    want = Renderer(scene, "cpu").step(0.3)
    np.testing.assert_array_equal(img, want)
    np.testing.assert_array_equal(read_png(out), _to_uint8(want))
    assert img.shape == (16, 24, 3) and img.std() > 0.01


def test_render_sequence_writes_frames(tmp_path):
    headless.render_sequence(_tiny(), str(tmp_path), 3, device="cpu")
    assert sorted(os.listdir(tmp_path)) == [f"frame_{i:05d}.png" for i in range(3)]


@pytest.mark.parametrize("fn", [headless.render_still, headless.render_sequence,
                                Flythrough, bench.build_preset_renderer,
                                bench.run_benchmark, bench.run_matrix,
                                bench.bit_identity_check, Renderer])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def _poses(fly, n):
    """The time parameters and camera bases of the first ``n`` frames, the
    render replaced by a stub (the script's conventions, not the image)."""
    fly.renderer.step = lambda time_param: time_param
    out = []
    for (_, t), _ in zip(fly.frames(), range(n)):
        out.append((t, np.asarray(fly.renderer.camera.basis(), np.float64)))
    return out


def test_flythrough_camera_equals_raytpus():
    """The default script and one with every key and both mouse axes: the
    same time parameter and camera basis as raytpu's, frame by frame."""
    jscene, scene = twin(_tiny())
    segs = [(0.1, "wasdeq", 50.0, -30.0), (0.2, "", -80.0, 20.0)]
    for ours, theirs, n in (
            (Flythrough(scene, device="cpu"), JaxFlythrough(jscene), 300),
            (Flythrough(scene, [ScriptSegment(*s) for s in segs], fps=30, device="cpu"),
             JaxFlythrough(jscene, [JaxSegment(*s) for s in segs], fps=30), 100)):
        got, want = _poses(ours, n), _poses(theirs, n)
        assert len(got) == len(want) > 5
        for (t, b), (tj, bj) in zip(got, want):
            assert t == tj
            np.testing.assert_array_equal(b, bj)
    assert sum(round(s.duration * 60) for s in DEFAULT_SCRIPT) == 300


def test_flythrough_camera_actually_moves():
    fly = Flythrough(_tiny(), script=[ScriptSegment(0.5, "w")], fps=30, device="cpu")
    start = fly.renderer.camera.position.copy()
    imgs = [img for _, img in fly.frames()]
    assert len(imgs) == 15 and imgs[0].shape == (16, 24, 3)
    # 0.5 s * timeParam scale 0.1 * speed 50 = 2.5 units
    assert abs(np.linalg.norm(fly.renderer.camera.position - start) - 2.5) < 0.1


def test_flythrough_benchmark_keeps_frames_on_the_device(monkeypatch):
    fly = Flythrough(_tiny(), script=[ScriptSegment(0.1, "w")], fps=30, device="cpu")
    seen = []
    monkeypatch.setattr(flythrough, "block_until_ready", seen.append)
    stats = fly.run_benchmark()
    assert stats["frames"] == 2 and stats["fps"] > 0
    assert len(seen) == 3 and all(isinstance(x, torch.Tensor) for x in seen)


def test_fps_counter_window(monkeypatch):
    times = iter([0.0, 0.3, 0.6, 1.2])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(times))
    printed = []
    c = timing.FpsCounter(print_fn=printed.append)
    assert c.frame() is None  # t=0.0 opens the window
    assert c.frame() is None  # t=0.3
    assert c.frame() is None  # t=0.6
    fps = c.frame()           # t=1.2 closes the 1s window
    assert fps == pytest.approx(4 / 1.2) and printed == ["FPS: 3.3"]


def test_mrays():
    assert timing.mrays_per_sec(2_000_000, 2.0) == pytest.approx(1.0)


def test_measure_frame_pipelined(monkeypatch):
    """Pipelined: every iteration enqueued, one drain at the end (after the
    warm-up's); ``pipelined=False`` drains every call."""
    calls = {"fn": 0, "sync": 0}

    def sync(out):
        calls["sync"] += 1
        return out

    def fn():
        calls["fn"] += 1
        return torch.zeros(1)

    monkeypatch.setattr(timing, "block_until_ready", sync)
    mean, times = timing.measure_frame(fn, warmup=1, iters=5)
    assert calls == {"fn": 6, "sync": 2} and mean >= 0 and len(times) == 1
    calls.update(fn=0, sync=0)
    mean, times = timing.measure_frame(fn, warmup=1, iters=3, pipelined=False)
    assert calls == {"fn": 4, "sync": 4} and len(times) == 3


def test_block_until_ready_needs_no_card_for_cpu_tensors(monkeypatch):
    def no_card(*args):
        raise AssertionError("synchronized a card for a CPU tensor")

    monkeypatch.setattr(torch.cuda, "synchronize", no_card)
    x = torch.ones(3)
    assert timing.block_until_ready(x) is x
    with timing.StageTimes().stage("trace", block=lambda: x):
        pass


def test_cli_render_writes_a_file(tmp_path):
    out = tmp_path / "cli.png"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "raytpu_torch.cli", "render", "--preset",
         "config1_standin", "--width", "48", "--height", "32", "--cpu", "-o", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    img = read_png(str(out))
    assert img.shape == (32, 48, 3) and img.std() > 1.0


def test_cli_interactive_raises(monkeypatch):
    """The CLI reaches the viewer, which raises without cv2."""
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    with pytest.raises(RaytpuError, match="interactive frontend needs OpenCV"):
        cli.main(["interactive", "--preset", "config1_standin", "--width", "16",
                  "--height", "16", "--cpu"])


@pytest.mark.parametrize("flags,match", [
    (["--ray-chunk", "-1"], "ray_chunk"),
    (["--chunk-tris", "-1"], "chunk_tris"),
    (["--devices", "0"], "devices"),
], ids=("flags0-ray_chunk", "flags1-chunk_tris", "flags3-devices"))
def test_cli_rejects_what_the_port_lacks(tmp_path, flags, match):
    """Negative counts raise, naming the field (the ids are kept from when
    the cases between them were values the port lacked)."""
    with pytest.raises(ValueError, match=match):
        cli.main(["render", "--preset", "config1_standin", "--width", "16",
                  "--height", "16", "--cpu", "-o", str(tmp_path / "x.png"), *flags])


@pytest.mark.parametrize("preset,flags,entries", [
    ("config1_standin", ["--traversal", "brute"], None),
    ("config2_standin", ["--chunk-tris", "2048"], 3),
], ids=("brute", "chunk_tris"))
def test_cli_renders_the_knobs(tmp_path, monkeypatch, preset, flags, entries):
    """``render --cpu`` writes the frame under the brute tracer (no tree
    attached) and with chunked trees (config2's 5,120 triangles in chunks
    of at most 2,048: three trees, three entries)."""
    built = []

    def spy(*args, **kwargs):
        ts = attach_bvh(*args, **kwargs)
        built.append(len(ts.entry_rows))
        return ts

    attach_bvh = render.attach_bvh
    monkeypatch.setattr(render, "attach_bvh", spy)
    out = tmp_path / "x.png"
    cli.main(["render", "--preset", preset, "--width", "16", "--height", "16",
              "--cpu", "-o", str(out), *flags])
    img = read_png(str(out))
    assert img.shape == (16, 16, 3) and img.std() > 0.0
    assert built == ([] if entries is None else [entries])


def test_cli_render_devices_writes_the_same_png(tmp_path):
    """``render --devices 2 --cpu`` shards the frame over two CPU slots and
    writes the bytes of ``--devices 1``."""
    paths = []
    for n in (1, 2):
        paths.append(tmp_path / f"d{n}.png")
        cli.main(["render", "--preset", "config1_standin", "--width", "48",
                  "--height", "40", "--cpu", "--devices", str(n), "-o",
                  str(paths[-1])])
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert read_png(str(paths[1])).std() > 1.0


def test_cli_rejects_bad_material_and_preset(tmp_path):
    for argv in (["--mesh", "cube.obj:shiny"], ["--preset", "config9"]):
        with pytest.raises(SystemExit):
            cli.main(["render", *argv, "--cpu", "-o", str(tmp_path / "x.png")])
