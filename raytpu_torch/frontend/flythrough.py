"""Scripted flythrough of the port (counterpart of
``raytpu/frontend/flythrough.py``): replay a WASD/mouse camera trace
(BASELINE config 5).

A deterministic re-creation of the reference's interactive loop
(``src/main.cpp:2795-2972``) with input from a script instead of GLFW:

* time: ``timeParam = elapsed * 0.1`` (``src/main.cpp:2799``), movement per
  frame = ``CAMERA_SPEED * timeParamDiff`` per held key
  (``src/main.cpp:2805-2827``);
* mouse deltas are pre-scaled by ``CAMERA_MOUSE_SENSITIVITY`` exactly like
  ``src/main.cpp:2866-2871`` (x negated relative to raw cursor delta);
* per frame: input, animation step (the "TLAS refit"), render.

The same loop serves as the config-5 benchmark: uncapped, wall-clock FPS
with the card drained after every frame.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

from raytpu_torch.camera import MoveDirection
from raytpu_torch.render import Renderer
from raytpu_torch.scene import Scene
from raytpu_torch.utils import log
from raytpu_torch.utils.timing import FpsCounter, block_until_ready, synchronize

KEYMAP = {
    "w": MoveDirection.FORWARD,
    "s": MoveDirection.BACKWARD,
    "a": MoveDirection.LEFT,
    "d": MoveDirection.RIGHT,
    "e": MoveDirection.UP,
    "q": MoveDirection.DOWN,
}


@dataclasses.dataclass
class ScriptSegment:
    """``duration`` seconds of held ``keys`` + constant mouse velocity
    (raw cursor px/s, scaled by sensitivity like the reference)."""

    duration: float
    keys: str = ""
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0


DEFAULT_SCRIPT: Tuple[ScriptSegment, ...] = (
    ScriptSegment(1.0, "w"),
    ScriptSegment(0.8, "wd", mouse_dx=-120.0),
    ScriptSegment(0.8, "a", mouse_dy=60.0),
    ScriptSegment(0.6, "we"),
    ScriptSegment(0.8, "s", mouse_dx=150.0, mouse_dy=-40.0),
    ScriptSegment(1.0, "wq"),
)


class Flythrough:
    def __init__(
        self,
        scene: Scene,
        script: Sequence[ScriptSegment] = DEFAULT_SCRIPT,
        fps: float = 60.0,
        device="cuda",
    ):
        self.scene = scene
        self.script = list(script)
        self.frame_dt = 1.0 / fps
        self.renderer = Renderer(scene, device)
        self.config = scene.config

    def frames(self, device: bool = False):
        """Yield (frame_index, image) replaying the script at fixed virtual
        time steps (deterministic regardless of wall clock).

        ``device=True`` yields the frame as a tensor on the renderer's
        device (no host readback); the default yields a numpy image for
        file IO."""
        cam = self.renderer.camera
        sens = self.config.camera_mouse_sensitivity
        speed = self.config.camera_speed
        elapsed = 0.0
        last_time_param = 0.0
        idx = 0
        for seg in self.script:
            n = max(1, int(round(seg.duration / self.frame_dt)))
            for _ in range(n):
                elapsed += self.frame_dt
                time_param = elapsed * 0.1              # src/main.cpp:2799
                dtp = time_param - last_time_param
                last_time_param = time_param
                for key in seg.keys:
                    cam.move(KEYMAP[key], speed * dtp)  # src/main.cpp:2805-2827
                if seg.mouse_dx or seg.mouse_dy:
                    # raw cursor delta this frame -> scaled offsets
                    # (sign convention of src/main.cpp:2866-2871)
                    dx = seg.mouse_dx * self.frame_dt
                    dy = seg.mouse_dy * self.frame_dt
                    cam.process_mouse_movement(dx * sens, dy * sens)
                if device:
                    self.renderer.set_transforms(time_param)
                    img = self.renderer.render()
                else:
                    img = self.renderer.step(time_param)
                yield idx, img
                idx += 1

    def run_benchmark(self, max_frames: Optional[int] = None):
        """Replay the script as fast as the device allows; return stats.

        The first frame is excluded (steady state, like the reference's
        uncapped TEST_FPS counter after warm-up). Each frame stays on the
        card and is drained with ``torch.cuda.synchronize`` (of every card
        a sharded frame used) before the next, so the wall clock measures
        frame completion, not host
        readback (a display path would consume the device buffer)."""
        counter = FpsCounter(print_fn=log.verbose)
        t_start = None
        frame_count = 0
        for _, img in self.frames(device=True):
            block_until_ready(img)
            synchronize(self.renderer.devices)
            if t_start is None:
                t_start = time.perf_counter()  # exclude the first frame
                continue
            counter.frame()
            frame_count += 1
            if max_frames is not None and frame_count >= max_frames:
                break
        wall = time.perf_counter() - t_start
        fps = frame_count / wall if wall > 0 else 0.0
        rays = (
            frame_count
            * self.config.num_pixels
            * self.config.samples_per_pixel
        )
        return {
            "frames": frame_count,
            "wall_s": wall,
            "fps": fps,
            "primary_mrays_per_s": rays / wall / 1e6 if wall > 0 else 0.0,
        }
