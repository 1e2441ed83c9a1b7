"""raytpu_torch: the Whitted frame of raytpu on PyTorch and hand-written
CUDA kernels for NVIDIA Hopper (H100, ``sm_90a``).

A port beside the JAX package ``raytpu``, which stays the reference it is
tested against. This package imports ``torch`` and never ``jax``; of
``raytpu`` it reads only the numpy host modules (config, camera, scene,
io, utils.ssim).

The frame: raygen, then per bounce a closest-hit sweep, shading, a shadow
any-hit sweep and accumulation, then a deferred sky fetch and detile. The
raygen, both sweeps and the sky are hand-written CUDA kernels
(``csrc/``), built with nvcc at first use; each has a plain PyTorch
version beside it, which CPU tensors take.
"""

from raytpu_torch._build import launch_counts, reset_launch_counts
from raytpu_torch.accel import attach_bvh
from raytpu_torch.device_scene import TorchScene, build_device_scene, from_raytpu
from raytpu_torch.integrator import RenderStatic, render_frame, render_packets
from raytpu_torch.render import Renderer

__all__ = [
    "Renderer",
    "RenderStatic",
    "TorchScene",
    "attach_bvh",
    "build_device_scene",
    "from_raytpu",
    "launch_counts",
    "render_frame",
    "render_packets",
    "reset_launch_counts",
]
