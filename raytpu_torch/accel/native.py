"""ctypes binding of the native SAH BVH builder (counterpart of
``raytpu/accel/native.py``).

``native/bvh_build.cpp`` is compiled from source with ``g++ -O3 -mfma
-std=c++17 -fPIC -shared`` into ``build/raytpu_torch/`` at first use
(``_build.gxx_library``, which ``io/native.py`` shares). The
committed ``native/libraytpu_native.so`` is not loaded: it was built with
``-march=native`` on another host. ``raytpu.accel.native`` is not reused
either, because importing it runs ``raytpu/accel/__init__.py``, which
imports JAX.

Why ``-mfma`` (``gxx_library``): without FMA contraction some SAH splits
round to another choice than the committed library's. Built with it, the
source gives that library's trees bit for bit (``tests/
test_torch_meshwalk.py`` holds the two builds equal); a host whose CPU has
no FMA raises rather than build different trees.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np

from raytpu_torch._build import gxx_library, host_has_fma  # noqa: F401

SOURCE = Path(__file__).resolve().parents[2] / "native" / "bvh_build.cpp"

_lib = None
_lock = threading.Lock()


class Bvh(NamedTuple):
    """Threaded BVH of one mesh, in the layout of ``raytpu.accel.bvh.Bvh``:
    DFS node order, ``miss == num_nodes`` exits, leaves reference
    ``tri_order[first : first + count]``."""

    aabb_min: np.ndarray   # (M, 3) f32
    aabb_max: np.ndarray   # (M, 3) f32
    tri_first: np.ndarray  # (M,) int32, -1 for inner nodes
    tri_count: np.ndarray  # (M,) int32
    miss: np.ndarray       # (M,) int32
    tri_order: np.ndarray  # (T,) int32 original prim id per leaf slot

    @property
    def num_nodes(self) -> int:
        return int(self.aabb_min.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.tri_order.shape[0])


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(gxx_library(
                "libbvh_build", [SOURCE], "the native BVH builder")))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.bvh_build_sah.restype = ctypes.c_int64
            lib.bvh_build_sah.argtypes = [
                f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int32,
                f32p, f32p, i32p, i32p, i32p, i32p,
            ]
            _lib = lib
    return _lib


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              leaf_size: int) -> Bvh:
    """Binned-SAH threaded BVH over triangles given as corner + edges."""
    t = int(v0.shape[0])
    if t == 0:
        raise ValueError("cannot build a BVH over a mesh with no triangles")
    lib = _load()
    max_nodes = 2 * t
    aabb_min = np.empty((max_nodes, 3), np.float32)
    aabb_max = np.empty((max_nodes, 3), np.float32)
    tri_first = np.empty(max_nodes, np.int32)
    tri_count = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    tri_order = np.empty(t, np.int32)
    n = lib.bvh_build_sah(
        np.ascontiguousarray(v0, np.float32),
        np.ascontiguousarray(e1, np.float32),
        np.ascontiguousarray(e2, np.float32),
        t, int(leaf_size),
        aabb_min, aabb_max, tri_first, tri_count, miss, tri_order,
    )
    if n < 0:
        raise RuntimeError("native BVH build failed")
    n = int(n)
    return Bvh(aabb_min[:n].copy(), aabb_max[:n].copy(), tri_first[:n].copy(),
               tri_count[:n].copy(), miss[:n].copy(), tri_order)
