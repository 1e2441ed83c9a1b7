"""The port's own copy of ``raytpu/io/genmesh.py`` (the port imports nothing of
``raytpu``).

Procedural high-poly stand-in meshes.

``armadillo.obj`` (the reference's default orbiting mesh,
``include/config.h:7``) is not among the reference's shipped assets.
BASELINE config 4 needs a
high-poly mesh to stress LBVH build quality and divergent traversal, so we
generate one deterministically: a subdivided icosphere displaced by a sum of
incommensurate sinusoids — ~327k triangles at depth 7, bumpy enough that the
BVH is non-trivial and normals vary per vertex.
"""

from __future__ import annotations

import numpy as np

from raytpu_torch.io.obj import Mesh, compute_smooth_normals


def icosahedron():
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return v, f


def subdivide(v: np.ndarray, f: np.ndarray):
    """One loop of midpoint subdivision on the unit sphere (vectorized)."""
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    edges_sorted = np.sort(edges, axis=1)
    uniq, inv = np.unique(edges_sorted, axis=0, return_inverse=True)
    mid = v[uniq[:, 0]] + v[uniq[:, 1]]
    mid /= np.linalg.norm(mid, axis=1, keepdims=True)
    mid_idx = len(v) + np.arange(len(uniq))
    new_v = np.concatenate([v, mid], axis=0)

    n = len(f)
    m01 = mid_idx[inv[0:n]]
    m12 = mid_idx[inv[n : 2 * n]]
    m20 = mid_idx[inv[2 * n : 3 * n]]
    new_f = np.concatenate(
        [
            np.stack([f[:, 0], m01, m20], axis=1),
            np.stack([f[:, 1], m12, m01], axis=1),
            np.stack([f[:, 2], m20, m12], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ],
        axis=0,
    )
    return new_v, new_f


def displacement(v: np.ndarray, amplitude: float = 0.18) -> np.ndarray:
    """Deterministic bumpy radial displacement (sum of incommensurate
    sinusoids — enough spatial frequency content to make the BVH earn its
    keep on config 4)."""
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    d = (
        np.sin(7.1 * x + 1.3) * np.sin(6.3 * y + 0.7) * np.sin(5.7 * z + 2.1)
        + 0.5 * np.sin(13.7 * x) * np.sin(11.9 * y + 1.1)
        + 0.25 * np.sin(23.3 * z + 0.5) * np.sin(19.1 * x + 2.9)
    )
    return 1.0 + amplitude * d / 1.75


def generate_highpoly(depth: int = 7, radius: float = 1.0,
                      name: str = "armadillo_standin") -> Mesh:
    """~20·4^depth triangles (depth 7 → 327,680; armadillo-class)."""
    v, f = icosahedron()
    for _ in range(depth):
        v, f = subdivide(v, f)
    r = displacement(v)
    pos = (v * (r * radius)[:, None]).astype(np.float32)
    tris = f.astype(np.int32)
    normals = compute_smooth_normals(pos, tris)
    mesh = Mesh(positions=pos, normals=normals, triangles=tris, name=name)
    mesh.validate()
    return mesh


_STANDIN_CACHE = {}


def armadillo_standin(scale: float = 1.0, depth: int = 7) -> Mesh:
    """The config-4 stand-in, scaled to roughly unit size like the
    reference meshes (cube extent ±1, teapot ~±3).

    Cached per (scale, depth): the 327k-triangle generation costs tens of
    seconds and several presets (config4, reference) share the mesh in one
    benchmark process."""
    key = (float(scale), int(depth))
    if key not in _STANDIN_CACHE:
        _STANDIN_CACHE[key] = generate_highpoly(depth=depth, radius=scale)
    return _STANDIN_CACHE[key]
