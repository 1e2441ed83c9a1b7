"""A seeded procedural cube map in [0, 1], made on the device in a few
large calls: a colour per face, smooth waves and texel noise, so that
bilinear taps differ and a shifted view changes the sky's pixels."""

from __future__ import annotations

import math

import torch


def make(params: dict, seed: int, device) -> torch.Tensor:
    """``params["size"]`` -> (6, size, size, 3) f32 on ``device``, the
    same for the same ``seed`` on the same kind of device."""
    size = int(params["size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    base = 0.15 + 0.7 * torch.rand((6, 1, 1, 3), **kw)
    phase = 2.0 * math.pi * torch.rand((6, 1, 1, 3), **kw)
    g = torch.linspace(0.0, 1.0, size, device=device, dtype=torch.float32)
    wave = torch.sin(9.0 * g)[:, None, None] * torch.cos(7.0 * g)[None, :, None]
    noise = 0.1 * torch.rand((6, size, size, 3), **kw) - 0.05
    sky = base + 0.1 * torch.sin(wave[None] * 3.0 + phase) + noise
    return sky.clamp_(0.0, 1.0)
