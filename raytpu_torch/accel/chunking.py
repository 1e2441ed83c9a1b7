"""Morton-ordered chunks of a mesh (the port's copy of
``raytpu/accel/chunking.py:43-89``, numpy only).

``RenderConfig.chunk_tris = N > 0`` splits every mesh of more than N
triangles into spatially compact chunks of at most N triangles, each with
its own tree and its own entry (``accel.attach_bvh``), as raytpu splits it
(``raytpu/accel/__init__.py:93-124``): the triangles sorted by the 30-bit
Morton code of their centroids (stable), then cut into
``ceil(T / N)`` chunks of balanced size.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of centroids normalized to their AABB."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    ext = np.maximum(hi - lo, 1e-30)
    q = np.clip(((centroids - lo) / ext) * 1023.0, 0, 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def chunk_order(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                chunk_tris: int) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Morton-sort a mesh's triangles and partition them into chunks of at
    most ``chunk_tris``. Returns ``(order, ranges)``: ``order`` permutes the
    mesh-local triangle indices into Morton order, ``ranges`` is one
    ``(start, count)`` into that order per chunk, the counts balanced (no
    small tail chunk)."""
    t = v0.shape[0]
    cent = v0 + (e1 + e2) / 3.0
    order = np.argsort(morton_codes(cent.astype(np.float64)), kind="stable")
    n_chunks = -(-t // chunk_tris)
    bounds = np.linspace(0, t, n_chunks + 1).astype(np.int64)
    ranges = [(int(bounds[i]), int(bounds[i + 1] - bounds[i]))
              for i in range(n_chunks)]
    return order.astype(np.int64), ranges
