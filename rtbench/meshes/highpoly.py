"""The asset-free high-poly stand-in, frozen here so that a change to the
port's generator cannot move the yardstick: a subdivided icosphere of
``20 * 4**depth`` triangles, radially displaced by a sum of
incommensurate sinusoids, with area-weighted smooth vertex normals. At
``depth`` 7 and radius 1 it is the armadillo stand-in (327,680
triangles); at ``depth`` 4 and radius 3 the teapot stand-in (5,120).
Copied from ``raytpu_torch/io/genmesh.py`` and ``io/obj.py``
(``compute_smooth_normals``)."""

from __future__ import annotations

import numpy as np


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
    """One loop of midpoint subdivision on the unit sphere."""
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    uniq, inv = np.unique(np.sort(edges, axis=1), axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    mid = v[uniq[:, 0]] + v[uniq[:, 1]]
    mid /= np.linalg.norm(mid, axis=1, keepdims=True)
    mid_idx = len(v) + np.arange(len(uniq))
    n = len(f)
    m01, m12, m20 = (mid_idx[inv[i * n:(i + 1) * n]] for i in range(3))
    new_f = np.concatenate(
        [
            np.stack([f[:, 0], m01, m20], axis=1),
            np.stack([f[:, 1], m12, m01], axis=1),
            np.stack([f[:, 2], m20, m12], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ],
        axis=0,
    )
    return np.concatenate([v, mid], axis=0), new_f


def displacement(v: np.ndarray, amplitude: float = 0.18) -> np.ndarray:
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    d = (
        np.sin(7.1 * x + 1.3) * np.sin(6.3 * y + 0.7) * np.sin(5.7 * z + 2.1)
        + 0.5 * np.sin(13.7 * x) * np.sin(11.9 * y + 1.1)
        + 0.25 * np.sin(23.3 * z + 0.5) * np.sin(19.1 * x + 2.9)
    )
    return 1.0 + amplitude * d / 1.75


def smooth_normals(positions: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    v0, v1, v2 = (positions[triangles[:, k]] for k in range(3))
    face_n = np.cross(v1 - v0, v2 - v0)
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, triangles[:, k], face_n)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    lens = np.where(lens > 0, lens, 1.0)
    return (normals / lens).astype(np.float32)


def make(params: dict):
    """``params``: ``depth`` and ``radius`` -> (positions (V, 3) f32,
    normals (V, 3) f32, triangles (T, 3) int32)."""
    v, f = icosahedron()
    for _ in range(int(params["depth"])):
        v, f = subdivide(v, f)
    r = displacement(v)
    pos = (v * (r * float(params["radius"]))[:, None]).astype(np.float32)
    tris = f.astype(np.int32)
    return pos, smooth_normals(pos, tris), tris
