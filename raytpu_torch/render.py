"""High-level render API of the PyTorch port (counterpart of
``raytpu/render.py``): host Scene -> images on a torch device, the card
unless the caller asks for the CPU. With ``config.devices > 1`` every
frame is sharded by tile rows over a mesh of that many devices
(``raytpu/render.py:65-83``, ``parallel/dist.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raytpu_torch.camera import Camera
from raytpu_torch.scene import AnimationState, Scene
from raytpu_torch.accel import attach_bvh
from raytpu_torch.device_scene import brute_scene, build_device_scene
from raytpu_torch.graphs import FramePlans
from raytpu_torch.integrator import RenderStatic
from raytpu_torch.parallel import make_mesh, render_sharded, replicate
from raytpu_torch.utils import validation
from raytpu_torch.utils.spans import span


class Renderer:
    """Owns the device scene, the animation state and the camera;
    ``step(t)`` advances the animation and renders one frame.

    With ``scene.config.devices > 1`` it builds the mesh once
    (``make_mesh(devices, device)``, which raises when fewer devices of
    that type exist) and keeps one scene replica per slot (``replicas``),
    made from ``tscene`` at the first frame and again whenever ``tscene``
    is replaced; ``set_transforms`` moves every replica.

    Under ``traversal="brute"`` or ``bvh_builder="brute"`` it attaches no
    BVH (``raytpu/render.py:32``): every sweep is then the brute tracers'
    per-(instance, mesh) loop (``device_scene.brute_scene``).

    Frames on one card replay the CUDA graphs of their shape's plan
    (``graphs.FramePlans``: the fused loop, no ``stats``); the first frame
    of a shape renders eagerly and captures them."""

    def __init__(self, scene: Scene, device="cuda",
                 camera: Optional[Camera] = None):
        self.scene = scene
        self.device = torch.device(device)
        self.camera = camera or Camera(scene.config.camera_position)
        # validate the config and the mesh before the (slow) BVH build
        self.render_static = RenderStatic.from_config(scene.config)
        self.mesh = (make_mesh(scene.config.devices, self.device)
                     if scene.config.devices > 1 else None)
        cfg = scene.config
        tscene = build_device_scene(scene, self.device)
        if "brute" in (cfg.bvh_builder, cfg.traversal):
            self.tscene = dataclasses.replace(brute_scene(tscene),
                                              traversal=cfg.traversal)
        else:
            self.tscene = attach_bvh(tscene, scene, leaf_size=cfg.leaf_size)
        self._replicas = None          # (the tscene they came from, replicas)
        self._plans = FramePlans()
        self.animation = AnimationState(scene.instances)
        self.time_param = 0.0
        if scene.config.validation:
            validation.check_scene(self.tscene)

    def set_transforms(self, time_param: float) -> None:
        """Advance instance animation to ``time_param`` (the refit analog,
        ``src/main.cpp:2836-2861``)."""
        with span("rt.set_transforms"):
            self.time_param = time_param
            self.animation.step(time_param)
            o2w = self.animation.transforms_3x4()
            w2o = self.animation.inverse_transforms_3x4()
            self.tscene = self.tscene.with_transforms(o2w, w2o)
            if self._replicas is not None:
                self._replicas = (self.tscene, [ts.with_transforms(o2w, w2o)
                                                for ts in self._replicas[1]])

    @property
    def replicas(self) -> list:
        """The scene replica of each mesh slot (sharded renderers only)."""
        if self._replicas is None or self._replicas[0] is not self.tscene:
            self._replicas = (self.tscene, replicate(self.tscene, self.mesh))
        return self._replicas[1]

    @property
    def devices(self) -> tuple:
        """The devices a frame runs on: the mesh's, each once, or the one."""
        return self.mesh.distinct() if self.mesh is not None else (self.device,)

    def camera_tensor(self) -> torch.Tensor:
        return torch.as_tensor(self.camera.basis(), device=self.device)

    def render(self, stats: Optional[dict] = None) -> torch.Tensor:
        """One frame -> (H, W, 3) f32 tensor on the device, sharded over the
        mesh onto its first slot's device where there is one (checked by
        ``validation.check_frame`` when the config asks for validation)."""
        with span("rt.render"):
            if self.mesh is not None:
                img = render_sharded(self.replicas, self.render_static,
                                     self.camera_tensor(), self.mesh, stats=stats)
            else:
                img = self._plans.render(self.tscene, self.render_static,
                                         self.camera_tensor(), stats=stats)
            if self.scene.config.validation:
                validation.check_frame(img)
            return img

    def render_u8(self) -> torch.Tensor:
        """Render and quantize to uint8 on the device."""
        img = self.render()
        return torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)

    def render_np(self) -> np.ndarray:
        """One frame -> (H, W, 3) f32 C-contiguous array on the host.

        A frame on the card is copied once, device to host, into a fresh
        page-locked block from PyTorch's caching host allocator (a DMA
        with no staging through pageable memory); the array is a view of
        that block and keeps it alive. Each live frame so pins one block,
        which the allocator may round up in size, and hands back to its
        cache for a later frame once the array is dropped. A frame on the
        CPU is returned as it is, with nothing pinned."""
        img = self.render()
        with span("rt.readback"):
            if not img.is_cuda:
                return img.cpu().numpy()
            host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
            host.copy_(img)
            return host.numpy()

    def step(self, time_param: float) -> np.ndarray:
        with span("rt.step"):
            self.set_transforms(time_param)
            return self.render_np()
