"""raytpu_torch: the Whitted frame of raytpu on PyTorch and hand-written
CUDA kernels for NVIDIA Hopper (H100, ``sm_90a``).

A port beside the JAX package ``raytpu``, which stays the reference it is
tested against. This package imports ``torch`` and never ``jax``, and
nothing of ``raytpu``: it keeps its own copies of the host modules it needs
(``config``, ``camera``, ``scene``, ``io``, ``utils.ssim``).

The frame: raygen, then per bounce a closest-hit sweep, the fused shade
pass, a shadow any-hit sweep and the fused accumulate pass, over packets
sorted live-first once after the first bounce; then a deferred sky fetch
and detile. Each of these six kernels is hand-written CUDA (``csrc/``),
built with nvcc at first use; each has a plain PyTorch version beside it,
which CPU tensors take.

The entry points keep the JAX package's module names: ``presets``
(raytpu's presets and their asset-free stand-ins), ``bench``
(``python -m raytpu_torch.bench``), ``cli`` (``python -m
raytpu_torch.cli``), ``frontend`` (headless and flythrough),
``io.image``, ``utils.timing`` and ``utils.log``. They render on the card
unless the caller asks for the CPU.
"""

from raytpu_torch._build import launch_counts, reset_launch_counts
from raytpu_torch.accel import attach_bvh
from raytpu_torch.device_scene import TorchScene, build_device_scene, from_raytpu
from raytpu_torch.integrator import RenderStatic, render_frame, render_packets
from raytpu_torch.render import Renderer
from raytpu_torch.scene import Scene, load_scene, scene_from_raytpu

__all__ = [
    "Renderer",
    "RenderStatic",
    "Scene",
    "TorchScene",
    "attach_bvh",
    "build_device_scene",
    "from_raytpu",
    "launch_counts",
    "load_scene",
    "render_frame",
    "render_packets",
    "reset_launch_counts",
    "scene_from_raytpu",
]
