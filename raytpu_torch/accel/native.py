"""ctypes binding of the native SAH BVH builder (counterpart of
``raytpu/accel/native.py``).

``native/bvh_build.cpp`` is compiled from source with ``g++ -O3 -mfma
-std=c++17 -fPIC -shared`` into ``build/raytpu_torch/`` at first use. The
committed ``native/libraytpu_native.so`` is not loaded: it was built with
``-march=native`` on another host. ``raytpu.accel.native`` is not reused
either, because importing it runs ``raytpu/accel/__init__.py``, which
imports JAX.

Why ``-mfma``: with FMA instructions available, g++ contracts the builder's
``a*b + c`` into fused multiply-adds, as the committed library's
``-march=native`` build does, and some SAH splits round to another choice
than without them. Built with ``-mfma``, the source gives the committed
library's trees bit for bit; without it, other trees (``tests/
test_torch_meshwalk.py`` holds the two builds equal). A host whose CPU has no
FMA cannot build those trees, so the build raises there rather than build
different ones.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np

from raytpu_torch._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "bvh_build.cpp"
CXX_FLAGS = ("-O3", "-mfma", "-std=c++17", "-fPIC", "-shared")

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


def host_has_fma() -> bool:
    """Whether this is an x86-64 host whose CPU reports ``fma``."""
    if platform.machine() not in ("x86_64", "AMD64"):
        return False
    try:
        with open("/proc/cpuinfo") as f:
            return any(line.startswith("flags")
                       and "fma" in line.split(":", 1)[1].split() for line in f)
    except OSError:
        return False


def _build_library() -> Path:
    if not host_has_fma():
        raise RuntimeError(
            "the native BVH builder needs an x86-64 CPU with FMA: raytpu's "
            "trees come from a build whose float math is contracted into "
            f"fused multiply-adds, and this host ({platform.machine()}) "
            "reports no 'fma' in /proc/cpuinfo, so it would build other trees")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    out = BUILD_DIR / f"libbvh_build_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"g++ exited {res.returncode}:\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build_library()))
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
