"""Ray-primitive tests (counterpart of ``raytpu/ops/intersect.py``), in the
per-lane form the traversal walk uses: each lane carries its own triangle
or node, so every operand is a same-shape tensor, and the operations follow
``raytpu/ops/traverse_pallas.py::_mt`` (:83-112) and ``::_slab`` (:70-80)
in order. The CUDA helpers in ``csrc/common.cuh`` are the same functions.
"""

from __future__ import annotations

import torch

DET_EPS = 1e-9
BIG_T = 3.0e38  # "no hit" distance


def safe_inverse(d: torch.Tensor) -> torch.Tensor:
    """1/d with +-inf for zero components (slab-test convention)."""
    inf = torch.full_like(d, float("inf"))
    return torch.where(d != 0.0, 1.0 / d, torch.where(d >= 0, inf, -inf))


def moller_trumbore(o, d, v0, e1, e2, tmin: float, best_t: torch.Tensor):
    """Double-sided Moller-Trumbore with a strict ``t < best_t``; all
    operands per lane (Vec3 tuples of (L,) tensors). Returns
    ``(t, u, v, hit)``."""
    px = d[1] * e2[2] - d[2] * e2[1]
    py = d[2] * e2[0] - d[0] * e2[2]
    pz = d[0] * e2[1] - d[1] * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    ok = torch.abs(det) > DET_EPS
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvx = o[0] - v0[0]
    tvy = o[1] - v0[1]
    tvz = o[2] - v0[2]
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1[2] - tvz * e1[1]
    qy = tvz * e1[0] - tvx * e1[2]
    qz = tvx * e1[1] - tvy * e1[0]
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin) & (t < best_t)
    return t, u, v, hit


def slab(o, d_inv, bmin, bmax, tmin: float, tfar_cap: torch.Tensor) -> torch.Tensor:
    """Slab test per lane. ``torch.minimum``/``maximum`` propagate NaN, as
    ``jnp.minimum``/``maximum`` do in ``_slab``: a 0*inf NaN makes the test
    false and the node is skipped (``intersect.ray_aabb`` differs on
    purpose; the packed kernels and this walk share the ``_slab`` rule)."""
    tmin_t = torch.full_like(tfar_cap, tmin)
    tns, tfs = [], []
    for a in range(3):
        lo = (bmin[a] - o[a]) * d_inv[a]
        hi = (bmax[a] - o[a]) * d_inv[a]
        tns.append(torch.minimum(lo, hi))
        tfs.append(torch.maximum(lo, hi))
    t_near = torch.maximum(torch.maximum(tns[0], tns[1]), torch.maximum(tns[2], tmin_t))
    t_far = torch.minimum(torch.minimum(tfs[0], tfs[1]), torch.minimum(tfs[2], tfar_cap))
    return t_near <= t_far
