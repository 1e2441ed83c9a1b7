"""The port's interactive viewer (``raytpu_torch/frontend/interactive.py``)
against raytpu's, on the CPU: the key map, the mouse-look convention and
the held-key emulation behave alike in both packages (the checks of
``tests/test_frontend.py:174-209``, run on each); ``run_interactive`` under
a recording stand-in for ``cv2`` shows raytpu's bytes of the Renderer's
frames and leaves on ESC (``chip_smoke.viewer_loop``, the same loop the
card runs); without a display or without cv2 it raises ``RaytpuError``;
and ``python -m raytpu_torch.cli interactive`` reaches it.
"""

import sys

import numpy as np
import pytest

import chip_smoke
from raytpu.frontend import interactive as jinteractive
from raytpu_torch import cli, scenes
from raytpu_torch.camera import Camera
from raytpu_torch.frontend import interactive
from raytpu_torch.utils.log import RaytpuError
from tests.torch_twin import one_thread

MODULES = {"raytpu": jinteractive, "raytpu_torch": interactive}


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.mark.parametrize("package", list(MODULES))
def test_key_map(package):
    mod = MODULES[package]
    assert {chr(k): d.name for k, d in mod.KEY_TO_DIR.items()} == {
        chr(k): d.name for k, d in jinteractive.KEY_TO_DIR.items()}
    assert {chr(k): int(d) for k, d in mod.KEY_TO_DIR.items()} == {
        "w": 4, "s": 5, "a": 1, "d": 0, "e": 2, "q": 3}


@pytest.mark.parametrize("package", list(MODULES))
def test_mouse_look_offsets_reference_convention(package):
    """src/main.cpp:2863-2877: dragging right (+dx) yaws right, dragging
    down (+dy) pitches down."""
    mouse_look_offsets = MODULES[package].mouse_look_offsets
    sens = 0.25
    assert mouse_look_offsets(8.0, 0.0, sens) == (8.0 * sens, 0.0)
    assert mouse_look_offsets(0.0, 6.0, sens) == (0.0, -6.0 * sens)
    cam = Camera()
    p0 = cam.pitch
    cam.process_mouse_movement(*mouse_look_offsets(0.0, 10.0, sens))
    assert cam.pitch < p0


@pytest.mark.parametrize("package", list(MODULES))
def test_held_keys_chords(package):
    hk = MODULES[package].HeldKeys(hold_frames=3)
    w, d = ord("w"), ord("d")
    assert hk.poll(w) == {w}
    assert hk.poll(d) == {w, d}       # both held
    assert hk.poll(-1) == {w, d}      # no event: still held
    assert hk.poll(-1) == {d}         # w expires first, d outlives it
    assert hk.poll(-1) == set()       # all expired


def test_display_bytes_are_raytpus():
    """The viewer's conversion truncates, as raytpu's; rounding (the
    Renderer's render_u8) would differ."""
    img = np.random.default_rng(0).uniform(-0.2, 1.2, (8, 8, 3)).astype(np.float32)
    want = (np.clip(img, 0, 1)[..., ::-1] * 255).astype(np.uint8)
    got = interactive.display_bytes(img)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[..., ::-1], np.clip(img * 255 + 0.5, 0, 255)
                              .astype(np.uint8))


def test_viewer_loop_shows_the_frames():
    rec = chip_smoke.viewer_loop(scenes.config1_standin(width=32, height=32), "cpu")
    assert rec == {"frames": 2, "shape": [32, 32, 3]}
    assert "cv2" not in sys.modules or sys.modules["cv2"] is not None


def test_no_display_raises(monkeypatch):
    cv2 = chip_smoke.RecordingCv2([27], display=False)
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    with pytest.raises(RaytpuError, match="no display"):
        interactive.run_interactive(scenes.config1_standin(width=16, height=16),
                                    device="cpu")
    assert not cv2.shown


def test_no_cv2_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 fails
    with pytest.raises(RaytpuError, match="needs OpenCV"):
        interactive.run_interactive(scenes.config1_standin(width=16, height=16),
                                    device="cpu")


def test_cli_interactive_runs_the_viewer(monkeypatch):
    cv2 = chip_smoke.RecordingCv2([ord("d"), 27])
    monkeypatch.setitem(sys.modules, "cv2", cv2)
    assert cli.main(["interactive", "--preset", "config1_standin", "--width", "16",
                     "--height", "16", "--cpu"]) == 0
    assert len(cv2.shown) == 1 and cv2.shown[0].shape == (16, 16, 3)
    assert cv2.closed
