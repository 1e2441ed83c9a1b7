"""The asset-free Cornell-box stand-in for ``cube_scene.obj`` (eight
objects, 42 faces), frozen here so that a change to the port's generator
cannot move the yardstick: five walls of a 12 x 10 x 12 room centred at
(0, 0, -4), open toward +z (the default camera), normals inward, and
three boxes inside it, a tall and a short one turned about y and a cube
above them, sunk 0.2 into the floor so that no face of theirs lies in a
wall's plane; 23 quads, 46 triangles, each quad with its own four
vertices and its flat normal. Copied from ``raytpu_torch/scenes.py``
(``cornell_mesh``, ``_box_quads``, ``_quad_mesh``)."""

from __future__ import annotations

import numpy as np


def box_quads(center, half, yaw: float = 0.0, inward: bool = False) -> list:
    """The six faces (4, 3) of a box of half extents ``half`` turned by
    ``yaw`` radians about y, corners in order around each face, normals
    outward (or ``inward``)."""
    c, h = np.asarray(center, np.float64), np.asarray(half, np.float64)
    rot = np.array([[np.cos(yaw), 0.0, np.sin(yaw)], [0.0, 1.0, 0.0],
                    [-np.sin(yaw), 0.0, np.cos(yaw)]])
    quads = []
    for a in range(3):
        u, v = (a + 1) % 3, (a + 2) % 3
        for sign in (1.0, -1.0):
            corners = []
            for cu, cv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3)
                p[a], p[u], p[v] = sign * h[a], cu * h[u], cv * h[v]
                corners.append(p)
            if (sign < 0) != inward:   # corner order sets the normal
                corners.reverse()
            quads.append(c + np.asarray(corners) @ rot.T)
    return quads


def quad_mesh(quads):
    """Quads (Q, 4, 3) as 2Q triangles with flat normals, the right-hand
    normal of each quad's corner order -> (positions, normals, triangles)."""
    q = np.asarray(quads, np.float32)
    n = np.cross(q[:, 1] - q[:, 0], q[:, 2] - q[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    base = 4 * np.arange(q.shape[0], dtype=np.int32)[:, None]
    tris = np.concatenate([base + [0, 1, 2], base + [0, 2, 3]], axis=1)
    return (q.reshape(-1, 3), np.repeat(n, 4, axis=0),
            tris.reshape(-1, 3).astype(np.int32))


def make(params: dict):
    """``params``: the generator's name alone -> (positions (92, 3) f32,
    normals (92, 3) f32, triangles (46, 3) int32)."""
    if set(params) != {"generator"}:
        raise ValueError(f"cornell takes no parameters, not {sorted(params)}")
    room = box_quads((0.0, 0.0, -4.0), (6.0, 5.0, 6.0), inward=True)
    del room[4]                                   # the +z face: open
    boxes = (box_quads((-2.2, -2.2, -6.0), (1.4, 3.0, 1.4), yaw=0.3)
             + box_quads((2.4, -3.7, -2.5), (1.5, 1.5, 1.5), yaw=-0.3)
             + box_quads((1.0, 2.2, -5.0), (0.9, 0.9, 0.9), yaw=0.6))
    return quad_mesh(room + boxes)
