"""High-level render API of the PyTorch port (counterpart of
``raytpu/render.py``): host Scene -> images on a torch device, the card
unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raytpu_torch.camera import Camera
from raytpu_torch.scene import AnimationState, Scene
from raytpu_torch.accel import attach_bvh
from raytpu_torch.device_scene import build_device_scene
from raytpu_torch.integrator import RenderStatic, render_frame
from raytpu_torch.utils import validation


class Renderer:
    """Owns the device scene, the animation state and the camera;
    ``step(t)`` advances the animation and renders one frame."""

    def __init__(self, scene: Scene, device="cuda",
                 camera: Optional[Camera] = None):
        self.scene = scene
        self.device = torch.device(device)
        self.camera = camera or Camera(scene.config.camera_position)
        # validate the config before the (slow) BVH build
        self.render_static = RenderStatic.from_config(scene.config)
        self.tscene = attach_bvh(build_device_scene(scene, self.device), scene,
                                 leaf_size=scene.config.leaf_size)
        self.animation = AnimationState(scene.instances)
        self.time_param = 0.0
        if scene.config.validation:
            validation.check_scene(self.tscene)

    def set_transforms(self, time_param: float) -> None:
        """Advance instance animation to ``time_param`` (the refit analog,
        ``src/main.cpp:2836-2861``)."""
        self.time_param = time_param
        self.animation.step(time_param)
        self.tscene = self.tscene.with_transforms(
            self.animation.transforms_3x4(),
            self.animation.inverse_transforms_3x4(),
        )

    def camera_tensor(self) -> torch.Tensor:
        return torch.as_tensor(self.camera.basis(), device=self.device)

    def render(self, stats: Optional[dict] = None) -> torch.Tensor:
        """One frame -> (H, W, 3) f32 tensor on the device (checked by
        ``validation.check_frame`` when the config asks for validation)."""
        img = render_frame(self.tscene, self.render_static,
                           self.camera_tensor(), stats=stats)
        if self.scene.config.validation:
            validation.check_frame(img)
        return img

    def render_u8(self) -> torch.Tensor:
        """Render and quantize to uint8 on the device."""
        img = self.render()
        return torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)

    def render_np(self) -> np.ndarray:
        return self.render().cpu().numpy()

    def step(self, time_param: float) -> np.ndarray:
        self.set_transforms(time_param)
        return self.render_np()
