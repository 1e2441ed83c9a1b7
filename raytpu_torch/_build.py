"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into ONE shared library
with a plain C interface, under ``build/raytpu_torch/`` at the repository
root, named by a hash of the sources and flags (a changed source builds
anew): one nvcc process per source, all started together, then one link.
The library is loaded with ctypes. Pointers go in as
``ctypes.c_void_p``, the stream is PyTorch's current one, and every C entry
point returns ``cudaGetLastError()`` after its launch; :func:`launch` raises
on a non-zero code.

Flags: ``--fmad=false`` and no ``--use_fast_math``, so every float operation
rounds once, as a PyTorch eager op does (the sweeps then match their plain
versions bit for bit, and the raygen hash keeps the precise ``sinf``).

Each kernel has a launch counter (:func:`launch_counts`): :func:`launch`
adds one after a launch it issued, and nothing else touches it. A run shows
that the main path went through the kernels by resetting the counters,
rendering, and reading them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "raytpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argument types (the trailing _P is the stream)
_SIGNATURES = {
    # rays, (state | tmax, occ), n, tmin, the entries and w2o, the packed
    # nodes, bvh_miss, the packed triangles, (the normals and T)
    "closest_sweep": [_P, _L, _P, _L, _L, _F, _P, _I, _P, _P, _P, _P, _P, _L,
                      _P],
    "anyhit_sweep": [_P, _L, _P, _P, _L, _F, _P, _I, _P, _P, _P, _P, _P],
    "raygen": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    "sky": [_P, _I, _I, _P, _P, _P, _P, _L, _P],
    # K6's single-tap mode (raytpu/ops/sky_mxu.py:120 with bilinear=False,
    # :453 via :543): the same operands as "sky"
    "sky_nearest": [_P, _I, _I, _P, _P, _P, _P, _L, _P],
    "shade_epilogue": [_P, _L, _P, _L, _P, _P, _L, _P, _P, _L, _P, _P, _L,
                       _P, _P, _L, _F, _F, _F, _P],
    "accumulate_epilogue": [_P, _P, _L, _P, _P, _L, _P, _L, _I, _F, _P],
    "block_stats": [_P, _L, _P, _L, _L, _F, _P, _P],
    # rays, (state | tmax, occ), n, tmin, the schedule (block lanes, bits,
    # words, octs), the packed links, nodes M, the entries and w2o, the
    # packed nodes and triangles, (normals, T,) the work counters and their
    # number
    "perlane_closest_sweep": [_P, _L, _P, _L, _L, _F, _L, _P, _I, _P, _P,
                              _L, _P, _I, _P, _P, _P, _P, _L, _P, _I, _P],
    "perlane_anyhit_sweep": [_P, _L, _P, _P, _L, _F, _L, _P, _I, _P, _P, _L,
                             _P, _I, _P, _P, _P, _P, _I, _P],
    # rays, (state | tmax, occ), n, tmin, the schedule (block lanes, bits,
    # words, octs), the packed wide links, nodes M, the entries and w2o, the
    # packed nodes and triangles, (normals, T)
    "mega_closest_sweep": [_P, _L, _P, _L, _L, _F, _L, _P, _I, _P, _P, _L,
                           _P, _I, _P, _P, _P, _P, _L, _P],
    "mega_anyhit_sweep": [_P, _L, _P, _P, _L, _F, _L, _P, _I, _P, _P, _L,
                          _P, _I, _P, _P, _P, _P],
    # object-space rays, tmax, (out, its plane stride, slot | occ), n, tmin,
    # the mesh's node base, node count and slot base, the packed nodes,
    # bvh_miss, the packed triangles, (K11a: the normals and T)
    "mesh_closest": [_P, _L, _P, _P, _L, _P, _L, _F, _I, _I, _I, _P, _P, _P,
                     _P, _L, _P],
    "mesh_anyhit": [_P, _L, _P, _P, _L, _F, _I, _I, _I, _P, _P, _P, _P],
}
KERNELS = tuple(_SIGNATURES)
# C entry points that read kernels' attributes: (which kernel, int out[4])
_ATTRIBUTES = ("rt_perlane_attributes", "rt_consensus_attributes",
               "rt_traverse_attributes")

_launches = dict.fromkeys(KERNELS, 0)
_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libraytpu_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with the first failure's
    output once all have ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc exited {proc.returncode}:\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError(failed[0])


def build() -> Path:
    """Compile ``csrc/*.cu`` with nvcc unless this exact build exists: one
    object per source, compiled in parallel, linked into one library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources, objs)])
    tmp = out.with_name(f"{tag}.tmp.so")
    _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, "rt_" + name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            for name in _ATTRIBUTES:
                getattr(lib, name).argtypes = [ctypes.c_int, _P]
                getattr(lib, name).restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(kernel: str, *args) -> None:
    """Launch ``kernel`` on the current stream with ``args`` (ints, floats
    and pointers as the C signature lists them; the stream is appended),
    count the launch, and raise if CUDA reports an error."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{kernel}: CUDA is not available on this machine")
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, "rt_" + kernel)(*args, stream)
    if err != 0:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
    _launches[kernel] += 1


def kernel_attributes(entry: str, names) -> dict:
    """Per kernel of ``names``, read by the attributes entry point ``entry``
    (kernel ``i`` of ``names`` is its ``which`` = i): its registers and
    local bytes a thread (spills and local arrays, ``cudaFuncGetAttributes``),
    the CTAs of 256 threads resident per SM (the occupancy API, under its
    ``__launch_bounds__``) and the SMs."""
    fn = getattr(library(), entry)
    out = {}
    for which, name in enumerate(names):
        vals = (ctypes.c_int * 4)()
        err = fn(which, ctypes.cast(vals, ctypes.c_void_p))
        if err:
            raise RuntimeError(f"{name}: CUDA error {err} reading its attributes")
        out[name] = dict(zip(("registers", "local_bytes", "ctas_per_sm", "sms"),
                             vals))
    return out


def launch_counts() -> dict:
    """Launches issued per kernel since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def _check_layout(kernel: str, name: str, t: torch.Tensor, shape,
                  dtype) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} is {t.dtype}, needs {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{kernel}: {name} has shape {tuple(t.shape)}, needs "
            f"{tuple(shape)}")


def _check(kernel: str, name: str, t: torch.Tensor, shape, dtype) -> None:
    _check_layout(kernel, name, t, shape, dtype)
    if t.device.type != "cuda":
        raise ValueError(
            f"{kernel}: {name} lies on {t.device}; the kernel needs a CUDA "
            "tensor (CPU tensors take the plain PyTorch version)")


def check_operand(kernel: str, name: str, t: torch.Tensor, shape=None,
                  dtype=torch.float32) -> int:
    """Validate one kernel operand and return its device pointer: a
    contiguous CUDA tensor of ``dtype`` (and ``shape`` where given)."""
    _check(kernel, name, t, shape, dtype)
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")
    return t.data_ptr()


def check_operands(kernel: str, operands) -> list:
    """:func:`check_operand` on each ``(name, tensor, shape, dtype)`` of
    ``operands``, every type and shape before any device: a table of the
    wrong layout is named wherever it lies."""
    for op in operands:
        _check_layout(kernel, *op)
    return [check_operand(kernel, *op) for op in operands]


def check_planes(kernel: str, name: str, t: torch.Tensor, shape,
                 dtype=torch.float32):
    """Validate a multi-plane operand of ``shape`` (planes, P, K) and return
    ``(pointer, plane stride in elements)``. The planes need not be
    adjacent, so a wave ``x[:, s:s+b]`` of a larger buffer goes in without a
    copy; the lanes of each plane must be contiguous."""
    _check(kernel, name, t, shape, dtype)
    if not t[0].is_contiguous():
        raise ValueError(f"{kernel}: {name}'s planes are not contiguous")
    return t.data_ptr(), t.stride(0)
