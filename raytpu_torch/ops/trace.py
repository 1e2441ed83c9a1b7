"""Scene-level closest hit and occlusion for a packet wave (counterpart of
``raytpu/ops/trace.py:127-459``, the chained packed-ABI tier): pack the
rays, sweep every (instance, mesh) entry, unpack.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytpu_torch.device_scene import TorchScene
from raytpu_torch.ops import vec3 as v3
from raytpu_torch.ops.intersect import BIG_T
from raytpu_torch.ops.traverse import (
    anyhit_sweep,
    closest_sweep,
    make_trace_state,
    pack_rays,
    unpack_state,
)


class HitWave(NamedTuple):
    """Shading-ready closest hit of a wave, each field (P, K)."""

    t: torch.Tensor      # f32, BIG_T on miss
    valid: torch.Tensor  # bool
    mat: torch.Tensor    # int32 material of the hit instance
    n: tuple             # Vec3 world-space unit shading normal
    inst: torch.Tensor   # int32 instance id, -1 on miss
    u: torch.Tensor
    v: torch.Tensor


def closest_hit_wave(ts: TorchScene, o, d, tmin: float, tmax: torch.Tensor,
                     sweep=closest_sweep) -> HitWave:
    """Closest hit of the wave ``(o, d)`` (Vec3 of (P, K)) within the
    per-lane window ``(tmin, tmax)``, through ``sweep`` (the kernel wrapper,
    or its plain version)."""
    state = make_trace_state(tmax.expand(o[0].shape).contiguous())
    rays = pack_rays(o, d)
    state = sweep(ts, rays, tmin, state)
    t, valid, mat, inst, n, u, v = unpack_state(state)
    return HitWave(
        t=torch.where(valid, t, torch.full_like(t, BIG_T)),
        valid=valid, mat=mat, n=v3.normalize(n), inst=inst, u=u, v=v,
    )


def any_hit_wave(ts: TorchScene, o, d, tmin: float, tmax: torch.Tensor,
                 sweep=anyhit_sweep) -> torch.Tensor:
    """Occlusion of the wave within ``(tmin, tmax)`` per lane -> bool (P, K)."""
    rays = pack_rays(o, d)
    occ = torch.zeros(o[0].shape, dtype=torch.int32, device=o[0].device)
    tmax = tmax.expand(o[0].shape).contiguous()
    occ = sweep(ts, rays, tmin, tmax, occ)
    return occ != 0
