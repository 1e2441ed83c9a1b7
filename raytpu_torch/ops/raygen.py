"""Jittered primary rays in the packed (6, P, K) layout (counterpart of
``raytpu/ops/raygen.py``).

``raygen_packed`` is the kernel wrapper (CPU tensors take the plain
version, CUDA tensors launch ``csrc/raygen.cu``); ``raygen_packed_ref`` is
``primary_rays_soa`` + ``pack_rays``, exactly as the JAX package's XLA
raygen.
"""

from __future__ import annotations

import torch

from raytpu_torch.config import FOCAL_LENGTH
from raytpu_torch import _build
from raytpu_torch.ops import vec3 as v3
from raytpu_torch.ops.traverse import pack_rays


# jitter_error's bound for a raygen with the right hash: the float64
# inversion of f32 directions costs up to ~3e-4 px at 1920x1080, and one ulp
# of sin moves a jitter by ~3e-3 px; another hash, seed or sine is ~0.3 px off
JITTER_TOL = 5e-3


def hash_jitter(px, py, sample_idx, spp: int):
    """Sub-pixel jitter ``(jx, jy)`` in [0, 1) of the shader hash
    ``fract(sin(px*12.9898 + py*78.233 + 1113.1*seed) * 43758.5453)``,
    seeds ``spp + s`` and ``spp + s + 0.5`` (``shader.rgen:69``)."""
    seed0 = float(spp) + sample_idx.to(torch.float32)

    def rnd(seed):
        x = torch.sin(px * 12.9898 + py * 78.233 + 1113.1 * seed) * 43758.5453
        return x - torch.floor(x)

    return rnd(seed0), rnd(seed0 + 0.5)


def jitter_error(rays, camera, s_row, px, py, spp, width, height) -> float:
    """Largest difference, in pixels, between the jitter that the
    directions of ``rays`` (6, P, K) encode and :func:`hash_jitter` on the
    same lanes. Inverts ``d ~ ux*right + uy*up + FOCAL_LENGTH*fwd`` in
    float64 (bound: :data:`JITTER_TOL`)."""
    basis = camera[1:4].to("cpu", torch.float64).T   # columns right, up, fwd
    c = torch.linalg.inv(basis).to(rays.device) @ rays[3:].reshape(3, -1).to(
        torch.float64)
    ux = (c[0] / c[2] * FOCAL_LENGTH).reshape(px.shape)
    uy = (c[1] / c[2] * FOCAL_LENGTH).reshape(px.shape)
    jx, jy = hash_jitter(px, py, s_row[:, None], spp)
    ex = (ux + 1.0) * 0.5 * width - px.to(torch.float64) - jx.to(torch.float64)
    ey = (1.0 - uy) * 0.5 * height - py.to(torch.float64) - jy.to(torch.float64)
    return max(ex.abs().max().item(), ey.abs().max().item())


def primary_rays_soa(pix, camera: torch.Tensor, sample_idx: torch.Tensor,
                     spp: int, width: int, height: int):
    """Component-SoA jittered primary rays (``integrator.py:317``):
    ``pix`` is (px, py), ``camera`` (4, 3) rows position/right/up/forward,
    ``sample_idx`` broadcasts against px."""
    px, py = pix
    jx, jy = hash_jitter(px, py, sample_idx, spp)
    ux = ((px + jx) / width) * 2.0 - 1.0
    uy = -(((py + jy) / height) * 2.0 - 1.0)   # y-flip (:75)
    right, up, fwd = camera[1], camera[2], camera[3]
    d = tuple(
        ux * right[c] + uy * up[c] + FOCAL_LENGTH * fwd[c] for c in range(3)
    )
    d = v3.normalize(d)
    o = tuple(camera[0, c].expand(d[0].shape) for c in range(3))
    return o, d


def raygen_packed_ref(camera, s_row, px, py, spp, width, height) -> torch.Tensor:
    """Plain :func:`raygen_packed`: ``primary_rays_soa`` + ``pack_rays``."""
    o, d = primary_rays_soa((px, py), camera, s_row[:, None], spp, width,
                            height)
    return pack_rays(o, d)


def raygen_packed(camera: torch.Tensor, s_row: torch.Tensor, px: torch.Tensor,
                  py: torch.Tensor, spp: int, width: int,
                  height: int) -> torch.Tensor:
    """Primary rays (6, P, K) for pixel planes ``px``/``py`` (P, K) and the
    per-packet sample index ``s_row`` (P,)."""
    if px.device.type == "cpu":
        return raygen_packed_ref(camera, s_row, px, py, spp, width, height)
    k = "raygen"
    p, kk = px.shape
    cam = torch.cat([camera.reshape(12).to(torch.float32),
                     torch.full((1,), float(spp), device=camera.device)])
    rays = torch.empty((6, p, kk), dtype=torch.float32, device=px.device)
    _build.launch(
        k,
        _build.check_operand(k, "cam", cam, (13,)),
        _build.check_operand(k, "s_row", s_row, (p,)),
        _build.check_operand(k, "px", px, (p, kk)),
        _build.check_operand(k, "py", py, (p, kk)),
        _build.check_operand(k, "rays", rays),
        p * kk, kk, int(width), int(height),
    )
    return rays
