"""Scene-level closest hit and occlusion for a packet wave (counterpart of
``raytpu/ops/trace.py:127-459``).

``closest_hit_wave`` / ``any_hit_wave`` run a packed-ABI sweep on a wave of
unpacked rays: pack the rays, sweep every (instance, mesh) entry in one
call, unpack.
``closest_hit_loop`` / ``any_hit_loop`` are the JAX package's unpacked
per-(instance, mesh) loop (:256-322, :429-459), which ``traversal="xla"``
takes: per entry in ``traversal_list`` order, the rays move to the
instance's object space, one mesh's walk runs (K11a / K11b,
``ops/traverse.mesh_closest`` / ``mesh_anyhit``), and the results merge
outside it. A scene with no BVH takes the same loop with the brute
walks (:func:`brute_mesh_closest` / :func:`brute_mesh_anyhit`, the
``brute_closest`` / ``brute_anyhit`` branch of :286 and :449), its
normals by primitive (``_normals_by_prim`` :325).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytpu_torch.device_scene import TorchScene
from raytpu_torch.ops import vec3 as v3
from raytpu_torch.ops.intersect import BIG_T, brute_anyhit, brute_closest
from raytpu_torch.ops.traverse import (
    anyhit_sweep,
    closest_sweep,
    make_trace_state,
    mesh_anyhit,
    mesh_closest,
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
    state = sweep(ts, pack_rays(o, d), tmin, state)
    t, valid, mat, inst, n, u, v = unpack_state(state)
    return HitWave(
        t=torch.where(valid, t, torch.full_like(t, BIG_T)),
        valid=valid, mat=mat, n=v3.normalize(n), inst=inst, u=u, v=v,
    )


def any_hit_wave(ts: TorchScene, o, d, tmin: float, tmax: torch.Tensor,
                 sweep=anyhit_sweep) -> torch.Tensor:
    """Occlusion of the wave within ``(tmin, tmax)`` per lane -> bool (P, K),
    through ``sweep`` as in :func:`closest_hit_wave`."""
    occ = torch.zeros(o[0].shape, dtype=torch.int32, device=o[0].device)
    occ = sweep(ts, pack_rays(o, d), tmin,
                tmax.expand(o[0].shape).contiguous(), occ)
    return occ != 0


def object_space(ts: TorchScene, inst: int, o, d) -> torch.Tensor:
    """World rays -> instance ``inst``'s object space, packed (6, P, K)."""
    w2o = ts.w2o[inst]
    return pack_rays(v3.affine_rows(w2o, o), v3.linear_rows(w2o, d))


def closest_hit_loop(ts: TorchScene, o, d, tmin: float, tmax: torch.Tensor,
                     walk=mesh_closest, slots=None) -> HitWave:
    """Closest hit of the wave ``(o, d)`` within ``(tmin, tmax)`` per lane,
    one entry at a time through ``walk`` (K11a's wrapper, or its plain
    version): the hit of each entry's mesh, its normal to world space by
    ``v3.linear_cols``, merged where ``t < best_t``; ``best_t`` narrows the
    next entry's window. The normal is normalized once, at the end.
    ``slots`` (P, K) int64, if given, receives each hit lane's BVH slot in
    the concatenated tables (as ``traverse.closest_sweep_ref``'s)."""
    shape = o[0].shape
    zero = torch.zeros(shape, dtype=torch.float32, device=o[0].device)
    best_t = tmax.expand(shape).contiguous()
    best_valid = torch.zeros(shape, dtype=torch.bool, device=zero.device)
    best_mat = torch.zeros(shape, dtype=torch.int32, device=zero.device)
    best_inst = torch.full(shape, -1, dtype=torch.int32, device=zero.device)
    best_n, best_u, best_v = (zero, zero, zero + 1.0), zero, zero
    for inst, mat, nb, nc, tb in ts.entry_rows:
        t, slot, u, v, n_obj = walk(ts, (nb, nc, tb),
                                    object_space(ts, inst, o, d), tmin, best_t)
        n_world = v3.linear_cols(ts.w2o[inst], n_obj)
        better = (slot >= 0) & (t < best_t)
        if slots is not None:
            slots.copy_(torch.where(better, slot.long() + tb, slots))
        best_valid = best_valid | better
        best_mat = torch.where(better, mat, best_mat)
        best_inst = torch.where(better, inst, best_inst)
        best_n = v3.where(better, n_world, best_n)
        best_u = torch.where(better, u, best_u)
        best_v = torch.where(better, v, best_v)
        best_t = torch.where(better, t, best_t)
    return HitWave(
        t=torch.where(best_valid, best_t, torch.full_like(best_t, BIG_T)),
        valid=best_valid, mat=best_mat, n=v3.normalize(best_n),
        inst=best_inst, u=best_u, v=best_v,
    )


def any_hit_loop(ts: TorchScene, o, d, tmin: float, tmax: torch.Tensor,
                 walk=mesh_anyhit) -> torch.Tensor:
    """Occlusion of the wave within ``(tmin, tmax)`` per lane, one entry at
    a time through ``walk`` (K11b's wrapper, or its plain version); a lane
    already occluded enters the next entry with a window of 0 -> bool
    (P, K)."""
    tmax = tmax.expand(o[0].shape)
    occluded = torch.zeros(o[0].shape, dtype=torch.bool, device=o[0].device)
    for inst, _mat, nb, nc, tb in ts.entry_rows:
        lane_tmax = torch.where(occluded, 0.0, tmax)
        occluded = occluded | walk(ts, (nb, nc, tb),
                                   object_space(ts, inst, o, d), tmin,
                                   lane_tmax)
    return occluded


def _normals_by_prim(ts: TorchScene, prim: torch.Tensor, u, v):
    """Object normals interpolated from the primitive-ordered corner
    normals ``tri_n_soa`` at global prims ``prim`` (-1 reads prim 0) as
    ``w*N0 + u*N1 + v*N2``, ``w = 1 - u - v`` (``raytpu/ops/trace.py:325``)."""
    p = prim.clamp_min(0).long()
    w = 1.0 - u - v
    n_soa = ts.tri_n_soa
    return tuple(w * n_soa[c][p] + u * n_soa[3 + c][p] + v * n_soa[6 + c][p]
                 for c in range(3))


def _brute_tris(ts: TorchScene, mesh) -> torch.Tensor:
    """The packed triangles of the brute entry ``mesh = (0, count,
    first_prim)`` (``device_scene.brute_scene``), a view of ``tri_packed``."""
    _, count, start = (int(x) for x in mesh)
    return ts.tri_packed[start:start + count]


def brute_mesh_closest(ts: TorchScene, mesh, rays: torch.Tensor, tmin: float,
                       tmax: torch.Tensor, closest=brute_closest):
    """The walk of a brute entry ``mesh`` for :func:`closest_hit_loop`, with
    ``mesh_closest``'s outputs: ``(t, slot, u, v, n)``, the slot the
    mesh-local prim (-1 on a miss) and ``n`` the object normal by prim.
    ``closest`` is the brute kernel's wrapper or its plain version."""
    t, prim, u, v = closest(rays, tmax, _brute_tris(ts, mesh), tmin)
    n = _normals_by_prim(ts, torch.where(prim >= 0, prim + int(mesh[2]), 0),
                         u, v)
    return t, prim, u, v, n


def brute_mesh_anyhit(ts: TorchScene, mesh, rays: torch.Tensor, tmin: float,
                      tmax: torch.Tensor, anyhit=brute_anyhit) -> torch.Tensor:
    """The occlusion walk of a brute entry for :func:`any_hit_loop`."""
    return anyhit(rays, tmax, _brute_tris(ts, mesh), tmin)
