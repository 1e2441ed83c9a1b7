"""Interactive windowed frontend of the port (WASD + mouse fly camera;
counterpart of ``raytpu/frontend/interactive.py``).

The analog of the reference's GLFW loop (``src/main.cpp:2795-2972``,
callbacks ``:83-110``): poll input, move the camera, animate the
instances, render, present. Presentation uses OpenCV's HighGUI, imported
when the viewer starts; without cv2, or without a display, the viewer
raises ``RaytpuError`` and points at the headless and flythrough
frontends.

Controls (the reference key map, ``src/main.cpp:2804-2830``): W/A/S/D move,
E up, Q down, right-drag to look, ESC quits.
"""

from __future__ import annotations

import time

import numpy as np

from raytpu_torch.camera import MoveDirection
from raytpu_torch.render import Renderer
from raytpu_torch.scene import Scene
from raytpu_torch.utils import log
from raytpu_torch.utils.timing import FpsCounter

KEY_TO_DIR = {
    ord("w"): MoveDirection.FORWARD,
    ord("s"): MoveDirection.BACKWARD,
    ord("a"): MoveDirection.LEFT,
    ord("d"): MoveDirection.RIGHT,
    ord("e"): MoveDirection.UP,
    ord("q"): MoveDirection.DOWN,
}


def mouse_look_offsets(dx: float, dy: float, sensitivity: float):
    """Cursor delta -> (xoffset, yoffset) for
    ``Camera.process_mouse_movement``, the reference's convention
    (``src/main.cpp:2863-2877``): dragging right looks right (+dx) and
    dragging down pitches down (-dy)."""
    return dx * sensitivity, -dy * sensitivity


class HeldKeys:
    """Key-state tracking over cv2's one-key-per-frame events.

    The reference keeps a GLFW key-state array so W+D+Q all apply each
    frame (``src/main.cpp:28,83-93,2804-2827``). cv2.waitKey delivers one
    keycode per poll and no key-up events, so each seen key stays active
    for ``hold_frames`` polls: OS key-repeat alternating between held keys
    then applies all of them nearly every frame."""

    def __init__(self, hold_frames: int = 6):
        self.hold_frames = hold_frames
        self._until = {}
        self._frame = 0

    def poll(self, key: int):
        """Record this frame's key event (-1/255 = none); returns the set
        of currently held keycodes."""
        self._frame += 1
        if key in KEY_TO_DIR:
            self._until[key] = self._frame + self.hold_frames
        return {k for k, f in self._until.items() if f > self._frame}


def display_bytes(img: np.ndarray) -> np.ndarray:
    """The BGR uint8 image the viewer shows of an (H, W, 3) f32 frame, as
    raytpu's viewer converts it: clip, flip the channels, scale by 255 and
    truncate (``Renderer.render_u8`` rounds, so its bytes differ)."""
    return (np.clip(img, 0, 1)[..., ::-1] * 255).astype(np.uint8)


def run_interactive(scene: Scene, device="cuda",
                    window_name: str = "raytpu_torch") -> None:
    """Open a window and render ``scene`` on ``device`` frame after frame,
    the camera driven by the keys and the right mouse button, until ESC."""
    try:
        import cv2
    except ImportError:
        log.fail(
            "interactive frontend needs OpenCV (cv2); use "
            "`python -m raytpu_torch.cli flythrough` or `render` for "
            "headless output"
        )

    renderer = Renderer(scene, device)
    cfg = scene.config
    cam = renderer.camera
    fps = FpsCounter(print_fn=log.info)

    mouse_state = {"down": False, "last": None}
    keys = HeldKeys()

    def on_mouse(event, x, y, flags, param):
        # RMB-drag look, like mouseButtonCallback (src/main.cpp:95-110)
        if event == cv2.EVENT_RBUTTONDOWN:
            mouse_state["down"] = True
            mouse_state["last"] = (x, y)
        elif event == cv2.EVENT_RBUTTONUP:
            mouse_state["down"] = False
        elif event == cv2.EVENT_MOUSEMOVE and mouse_state["down"]:
            lx, ly = mouse_state["last"]
            dx, dy = x - lx, y - ly
            mouse_state["last"] = (x, y)
            cam.process_mouse_movement(
                *mouse_look_offsets(dx, dy, cfg.camera_mouse_sensitivity)
            )

    try:
        cv2.namedWindow(window_name)
        cv2.setMouseCallback(window_name, on_mouse)
    except cv2.error as e:
        log.fail(
            f"no display available ({e}); use the headless or flythrough "
            "frontend instead"
        )

    t_start = time.perf_counter()
    last_time_param = 0.0
    log.info("interactive: WASD move, E/Q up/down, right-drag look, ESC quit")
    while True:
        elapsed = time.perf_counter() - t_start
        time_param = elapsed * 0.1  # src/main.cpp:2799
        dtp = time_param - last_time_param
        last_time_param = time_param

        key = cv2.waitKey(1) & 0xFF
        if key == 27:  # ESC (src/main.cpp:2828-2830)
            break
        for held in keys.poll(key):
            cam.move(KEY_TO_DIR[held], cfg.camera_speed * dtp)

        cv2.imshow(window_name, display_bytes(renderer.step(time_param)))
        if cfg.test_fps:
            fps.frame()
    cv2.destroyAllWindows()
