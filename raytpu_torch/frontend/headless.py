"""Headless (offline) rendering frontend of the port (counterpart of
``raytpu/frontend/headless.py``): frames go to image files instead of the
reference's swapchain (``src/main.cpp:2905-2965``)."""

from __future__ import annotations

import os

import numpy as np

from raytpu_torch.io.image import write_image
from raytpu_torch.presets import load_preset_scene
from raytpu_torch.render import Renderer
from raytpu_torch.utils import log
from raytpu_torch.utils.timing import FpsCounter


def render_still(
    preset_or_config,
    out_path: str,
    time_param: float = 0.0,
    camera=None,
    highpoly_depth: int = 7,
    device="cuda",
) -> np.ndarray:
    """Render one frame of a preset (a name, a RenderConfig or a Scene) on
    ``device`` and write it to ``out_path`` (PNG or PPM by the suffix)."""
    scene = load_preset_scene(preset_or_config, highpoly_depth=highpoly_depth)
    renderer = Renderer(scene, device, camera=camera)
    img = renderer.step(time_param)
    write_image(out_path, img)
    log.info(f"wrote {out_path} ({img.shape[1]}x{img.shape[0]})")
    return img


def render_sequence(
    preset_or_config,
    out_dir: str,
    num_frames: int,
    dt: float = 1.0 / 60.0,
    camera=None,
    highpoly_depth: int = 7,
    device="cuda",
) -> None:
    """Render an animation sequence at fixed virtual time steps into
    ``out_dir/frame_NNNNN.png``. The time parameter is the reference main
    loop's ``timeParam = elapsed_seconds * 0.1`` (``src/main.cpp:2799``)."""
    os.makedirs(out_dir, exist_ok=True)
    scene = load_preset_scene(preset_or_config, highpoly_depth=highpoly_depth)
    renderer = Renderer(scene, device, camera=camera)
    fps_counter = FpsCounter(print_fn=log.info)
    for i in range(num_frames):
        time_param = (i * dt) * 0.1
        img = renderer.step(time_param)
        write_image(os.path.join(out_dir, f"frame_{i:05d}.png"), img)
        if scene.config.test_fps:  # TEST_FPS analog (config.h:21-22)
            fps_counter.frame()
    log.info(f"wrote {num_frames} frames to {out_dir}")
