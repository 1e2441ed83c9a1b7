"""The asset-free stand-in for upstream's ``cube.obj``, frozen here so that
a change to the port's generator cannot move the yardstick: an
axis-aligned cube of half extent 1 about the origin, 24 vertices and 12
triangles, each face with its own four vertices and its flat outward
normal, as ``cube.obj`` duplicates its corners for flat shading. A glass
cube with averaged corner normals would bend rays like a lens. Copied
from ``raytpu_torch/scenes.py`` (``cube_mesh``, ``_box_quads``,
``_quad_mesh``)."""

from __future__ import annotations

import numpy as np


def cube_quads() -> np.ndarray:
    """The six faces (6, 4, 3) of the cube, corners in order around each
    face so that the right-hand normal points outward."""
    quads = []
    for a in range(3):
        u, v = (a + 1) % 3, (a + 2) % 3
        for sign in (1.0, -1.0):
            corners = []
            for cu, cv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3)
                p[a], p[u], p[v] = sign, cu, cv
                corners.append(p)
            if sign < 0:   # corner order sets the normal
                corners.reverse()
            quads.append(corners)
    return np.asarray(quads, np.float32)


def make(params: dict):
    """``params``: the generator's name alone -> (positions (24, 3) f32,
    normals (24, 3) f32, triangles (12, 3) int32)."""
    if set(params) != {"generator"}:
        raise ValueError(f"box takes no parameters, not {sorted(params)}")
    q = cube_quads()
    n = np.cross(q[:, 1] - q[:, 0], q[:, 2] - q[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    base = 4 * np.arange(q.shape[0], dtype=np.int32)[:, None]
    tris = np.concatenate([base + [0, 1, 2], base + [0, 2, 3]], axis=1)
    return (q.reshape(-1, 3), np.repeat(n, 4, axis=0).astype(np.float32),
            tris.reshape(-1, 3).astype(np.int32))
