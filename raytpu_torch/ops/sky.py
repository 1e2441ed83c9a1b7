"""Cube-map sky sampling (counterpart of ``raytpu/ops/sky.py:21-140`` and
of the MXU sampler ``raytpu/ops/sky_mxu.py``, whose functions are
``sample_cubemap_u32`` in its bilinear mode and
``sample_cubemap_u32_nearest`` in its single-tap mode).

``sample_cubemap_u32`` and ``sample_cubemap_u32_nearest`` are the kernel
wrappers (CPU tensors take the plain versions, CUDA tensors launch
``csrc/sky.cu``'s ``sky_kernel`` and ``sky_nearest_kernel``);
``sample_cubemap_u32_ref`` is ``sky.py:113-140`` and
``sample_cubemap_u32_nearest_ref`` ``sky.py:99-110``, op for op. Faces are
+X, -X, +Y, -Y, +Z, -Z; the z-flip of the reference's lookup is applied by
the caller.
"""

from __future__ import annotations

import torch

from raytpu_torch import _build


def face_st(x, y, z):
    """GL cube-map major-axis table -> ``(face int32, s, t)``."""
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    def pick(c, a, b):
        return torch.where(c, torch.full_like(x, a, dtype=torch.int32),
                           torch.full_like(x, b, dtype=torch.int32))

    face = torch.where(
        is_x, pick(x >= 0, 0, 1),
        torch.where(is_y, pick(y >= 0, 2, 3), pick(z >= 0, 4, 5)),
    )
    ma = torch.clamp_min(torch.where(is_x, ax, torch.where(is_y, ay, az)), 1e-30)
    sc = torch.where(
        is_x,
        torch.where(x >= 0, -z, z),
        torch.where(is_y, x, torch.where(z >= 0, x, -x)),
    )
    tc = torch.where(is_y, torch.where(y >= 0, z, -z), -y)
    s = 0.5 * (sc / ma + 1.0)
    t = 0.5 * (tc / ma + 1.0)
    return face, s, t


def _bilinear_coords(s, t, h: int, w: int):
    """Half-texel bilinear taps, clamp-to-edge (``sky.py:70-86``)."""
    fx = s * w - 0.5
    fy = t * h - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = fx - x0
    wy = fy - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    return (torch.clamp(x0i, 0, w - 1), torch.clamp(x0i + 1, 0, w - 1),
            torch.clamp(y0i, 0, h - 1), torch.clamp(y0i + 1, 0, h - 1), wx, wy)


def _unpack_rgb8(word):
    """int32 bits of (R | G<<8 | B<<16) -> float RGB in [0, 1]."""
    inv = 1.0 / 255.0
    return tuple(((word >> sh) & 0xFF).to(torch.float32) * inv
                 for sh in (0, 8, 16))


def sample_cubemap_u32_ref(sky_u32: torch.Tensor, h: int, w: int, dirs):
    """Plain bilinear cube-map lookup; ``sky_u32`` (6*h*w,) int32 words,
    ``dirs`` a Vec3; returns a Vec3 of RGB."""
    face, s, t = face_st(*dirs)
    x0c, x1c, y0c, y1c, wx, wy = _bilinear_coords(s, t, h, w)
    base = face.long() * (h * w)

    def tap(yc, xc):
        return _unpack_rgb8(sky_u32[base + yc.long() * w + xc.long()])

    c00, c01 = tap(y0c, x0c), tap(y0c, x1c)
    c10, c11 = tap(y1c, x0c), tap(y1c, x1c)
    out = []
    for c in range(3):
        top = c00[c] * (1 - wx) + c01[c] * wx
        bot = c10[c] * (1 - wx) + c11[c] * wx
        out.append(top * (1 - wy) + bot * wy)
    return tuple(out)


def nearest_index(h: int, w: int, dirs) -> torch.Tensor:
    """The word each lane of ``dirs`` takes in a single-tap lookup
    (``sky.py:104-107``): ``floor(s*w)`` truncated to int32 and clamped,
    likewise for t, on its face."""
    face, s, t = face_st(*dirs)
    xc = torch.clamp(torch.floor(s * w).to(torch.int32), 0, w - 1)
    yc = torch.clamp(torch.floor(t * h).to(torch.int32), 0, h - 1)
    return face.long() * (h * w) + yc.long() * w + xc.long()


def sample_cubemap_u32_nearest_ref(sky_u32: torch.Tensor, h: int, w: int,
                                   dirs):
    """Plain single-tap cube-map lookup, one word a lane; on the 2x
    prefiltered map (``device_scene.pack_skybox_2x``) it is the
    "bilinear2x" filter."""
    return _unpack_rgb8(sky_u32[nearest_index(h, w, dirs)])


def sample_cubemap_u32(sky_u32: torch.Tensor, h: int, w: int, dirs):
    """Bilinear cube-map lookup for every lane of ``dirs``."""
    if dirs[0].device.type == "cpu":
        return sample_cubemap_u32_ref(sky_u32, h, w, dirs)
    return _launch("sky", sky_u32, h, w, dirs)


def sample_cubemap_u32_nearest(sky_u32: torch.Tensor, h: int, w: int, dirs):
    """Single-tap cube-map lookup for every lane of ``dirs``."""
    if dirs[0].device.type == "cpu":
        return sample_cubemap_u32_nearest_ref(sky_u32, h, w, dirs)
    return _launch("sky_nearest", sky_u32, h, w, dirs)


def _launch(k: str, sky_u32: torch.Tensor, h: int, w: int, dirs):
    """Launch sky kernel ``k`` over every lane of ``dirs`` -> Vec3."""
    shape = dirs[0].shape
    n = dirs[0].numel()
    dirs = [x.contiguous() for x in dirs]  # held until the launch is queued
    out = torch.empty((3, *shape), dtype=torch.float32, device=dirs[0].device)
    _build.launch(
        k,
        _build.check_operand(k, "sky_u32", sky_u32, (6 * h * w,), torch.int32),
        int(h), int(w),
        *(_build.check_operand(k, f"dirs[{c}]", dirs[c], shape)
          for c in range(3)),
        _build.check_operand(k, "out", out),
        n,
    )
    return (out[0], out[1], out[2])
