"""ctypes binding of the native OBJ parser and JPEG decoder (counterpart of
``raytpu/io/native.py``).

``native/objparse.cpp`` and ``native/jpeg_decode.cpp`` are compiled from
source into one library with ``g++ -O3 -mfma -std=c++17 -fPIC -shared``
into ``build/raytpu_torch/`` at first use (``_build.gxx_library``, as the
BVH builder of ``accel/native.py`` is). The committed
``native/libraytpu_native.so`` is not loaded. ``-mfma`` matters for the
JPEG decoder's float IDCT: the committed library was built with
``-march=native``, so g++ contracted it into fused multiply-adds, and a
build without them decodes some pixels one apart.

:func:`available` says whether the library is built or can be built here
(g++ and an FMA CPU); the callers' policies are raytpu's:
``io/obj.load_obj`` takes the native parser when it is available, and
``io/image.read_image`` the native decoder only where PIL is missing.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from raytpu_torch._build import gxx_library

_NATIVE = Path(__file__).resolve().parents[2] / "native"
SOURCES = (_NATIVE / "objparse.cpp", _NATIVE / "jpeg_decode.cpp")

_lib = None
_failure = None   # why the library cannot be built here, once known
_lock = threading.Lock()


def _declare(lib: ctypes.CDLL) -> None:
    void_p = ctypes.c_void_p
    lib.obj_parse_file.restype = void_p
    lib.obj_parse_file.argtypes = [ctypes.c_char_p]
    lib.obj_error.restype = ctypes.c_char_p
    lib.obj_error.argtypes = [void_p]
    for name in ("obj_num_vertices", "obj_num_normals", "obj_num_triangles"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [void_p]
    for name, ty in (("obj_positions", ctypes.c_float),
                     ("obj_normals", ctypes.c_float),
                     ("obj_tri_v", ctypes.c_int32),
                     ("obj_tri_vn", ctypes.c_int32)):
        getattr(lib, name).restype = ctypes.POINTER(ty)
        getattr(lib, name).argtypes = [void_p]
    lib.jpeg_decode_file.restype = void_p
    lib.jpeg_decode_file.argtypes = [ctypes.c_char_p]
    lib.jpeg_error.restype = ctypes.c_char_p
    lib.jpeg_error.argtypes = [void_p]
    for name in ("jpeg_width", "jpeg_height"):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [void_p]
    lib.jpeg_rgb.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.jpeg_rgb.argtypes = [void_p]
    for name in ("obj_free", "jpeg_free"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [void_p]


def library() -> ctypes.CDLL:
    """The loaded library, built at first use; raises ``RuntimeError`` with
    the reason where it cannot be built (the reason is kept, so a later
    call does not run g++ again)."""
    global _lib, _failure
    with _lock:
        if _lib is None:
            if _failure is not None:
                raise RuntimeError(_failure)
            try:
                lib = ctypes.CDLL(str(gxx_library(
                    "libraytpu_io", SOURCES, "the native OBJ and JPEG loaders")))
            except (RuntimeError, OSError) as exc:
                _failure = f"the native loaders cannot be built here: {exc}"
                raise RuntimeError(_failure) from exc
            _declare(lib)
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library is built or can be built on this host."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def _array(ptr, shape, dtype) -> np.ndarray:
    """A copy of ``shape`` elements at the library's ``ptr`` (an empty
    array for no elements, whose pointer may be null)."""
    if not np.prod(shape):
        return np.zeros(shape, dtype)
    return np.ctypeslib.as_array(ptr, shape=shape).copy()


def load_obj(path: str):
    """Parse an OBJ file with the native parser -> :class:`raytpu_torch.io.obj.Mesh`,
    with the Python parser's normal policy (a position-aligned ``vn`` list
    as it is, else the ``vn`` indices scattered to the vertices, else
    computed smooth normals)."""
    from raytpu_torch.io.obj import Mesh, compute_smooth_normals

    lib = library()
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    handle = lib.obj_parse_file(os.fsencode(path))
    if not handle:
        raise IOError(f"native OBJ parse failed to open {path}")
    try:
        err = lib.obj_error(handle)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        nv = lib.obj_num_vertices(handle)
        nn = lib.obj_num_normals(handle)
        nt = lib.obj_num_triangles(handle)
        pos = _array(lib.obj_positions(handle), (nv, 3), np.float32)
        vns = _array(lib.obj_normals(handle), (nn, 3), np.float32)
        tris = _array(lib.obj_tri_v(handle), (nt, 3), np.int32)
        tri_vn = _array(lib.obj_tri_vn(handle), (nt, 3), np.int32)
    finally:
        lib.obj_free(handle)

    if len(vns) == len(pos):
        normals = vns
    elif len(vns) > 0 and nt and tri_vn.min() >= 0:
        if tri_vn.max() >= len(vns):
            raise ValueError(
                f"{path}: face references normal index {int(tri_vn.max()) + 1} "
                f"but file declares only {len(vns)} normals")
        normals = np.zeros_like(pos)
        normals[tris.reshape(-1).astype(np.int64)] = vns[
            tri_vn.reshape(-1).astype(np.int64)]
    else:
        normals = compute_smooth_normals(pos, tris)

    mesh = Mesh(positions=pos, normals=normals.astype(np.float32),
                triangles=tris, name=os.path.basename(path))
    mesh.validate()
    return mesh


def read_jpeg(path: str) -> np.ndarray:
    """Decode a baseline JPEG with the native decoder -> (H, W, 3) uint8.
    Raises ``ValueError`` on what it does not decode (progressive and other
    variants, a file that is no JPEG)."""
    lib = library()
    handle = lib.jpeg_decode_file(os.fsencode(path))
    try:
        err = lib.jpeg_error(handle)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        h, w = lib.jpeg_height(handle), lib.jpeg_width(handle)
        rgb = _array(lib.jpeg_rgb(handle), (h, w, 3), np.uint8)
    finally:
        lib.jpeg_free(handle)
    return rgb
