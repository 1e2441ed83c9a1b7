"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into ONE shared library
with a plain C interface, under ``build/raytpu_torch/`` at the repository
root, named by a hash of the sources and flags (a changed source builds
anew): one nvcc process per source, all started together, then one link.
The library is loaded with ctypes. Pointers go in as
``ctypes.c_void_p``, each one a :class:`Pointer` that remembers its tensor's
device: :func:`launch` makes that device current for the call and appends
its current stream (so a launch on ``cuda:1`` goes to ``cuda:1``'s stream
whichever device the calling thread had current), and raises when the
operands of one launch lie on two devices. Every C entry point returns
``cudaGetLastError()`` after its launch; :func:`launch` raises on a non-zero
code.

Flags: ``--fmad=false`` and no ``--use_fast_math``, so every float operation
rounds once, as a PyTorch eager op does (the sweeps then match their plain
versions bit for bit, and the raygen hash keeps the precise ``sinf``).

Each kernel has a launch counter (:func:`launch_counts`): :func:`launch`
adds one after a launch it issued, under a lock (the slots of a sharded
frame launch from several host threads); a launch captured into a CUDA
graph counts at each of the graph's replays instead (:func:`captured_launches`,
:func:`add_launches`). A run shows that the main path went through the
kernels by resetting the counters, rendering, and reading them.

K1 and K2 (the per-lane sweeps) and K8 and K9 (the consensus sweeps) also
carry work counters (:func:`work_counts`, :data:`WORK_KEYS`): their node
visits and triangle tests, for K1 and K2 their record fetches (each walked
entry's root and each child-pair record), and for K8 and K9 the visits and
tests the lanes' own walks need, counted while a frame is rendered with ``stats``
(:func:`counting`, which ``integrator.render_packets`` turns on then).
Their wrappers then pass a slot of a per-device buffer that this module
owns, and the C entry point launches the kernels' counting instantiation,
which adds each warp's sums with one 64-bit ``atomicAdd`` each; otherwise
it passes none and the entry point launches the one that counts nothing.
Their plain versions add the plain walk's counts of the same numbers
(:func:`counted`). All four count the waves after the first bounce
(:func:`later_waves`) into slots of their own as well, read as the entries
``perlane_closest_sweep.later``, ``perlane_anyhit_sweep.later``,
``mega_closest_sweep.later`` and ``mega_anyhit_sweep.later``; the kernels'
own entries stay the sums over every wave.

:func:`gxx_library` builds the host libraries of ``native/`` (the BVH
builder, the OBJ parser and the JPEG decoder) with g++ into the same
directory, by the same rule: a hash of the sources and flags names the
library, and a changed source builds anew.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import platform
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
    # rays, window, blocks, block lanes, tmin, the stats rows; the
    # schedule: entries E, words, order, the light, the entry rows, o2w,
    # the node boxes, bits, octs, rows, keys, ranks, enter, the arrival
    # counter
    "block_stats": [_P, _L, _P, _L, _L, _F, _P, _L, _I, _I, _F, _F, _F, _P,
                    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # rays, (state | tmax, occ), n, tmin, the schedule (block lanes, bits,
    # words, octs), the entries and w2o, the packed nodes, child pairs and
    # triangles, (normals, T,) the CTAs' work counters and their number,
    # and the node-visit, triangle-test and fetch counters or null
    "perlane_closest_sweep": [_P, _L, _P, _L, _L, _F, _L, _P, _I, _P, _P,
                              _I, _P, _P, _P, _P, _P, _L, _P, _I, _P, _P],
    "perlane_anyhit_sweep": [_P, _L, _P, _P, _L, _F, _L, _P, _I, _P, _P, _I,
                             _P, _P, _P, _P, _P, _I, _P, _P],
    # rays, (state | tmax, occ), n, tmin, the schedule (block lanes, bits,
    # words, octs), the packed wide links, nodes M, the entries and w2o, the
    # packed nodes and triangles, (normals, T,) and the work counters or
    # null
    "mega_closest_sweep": [_P, _L, _P, _L, _L, _F, _L, _P, _I, _P, _P, _L,
                           _P, _I, _P, _P, _P, _P, _L, _P, _P],
    "mega_anyhit_sweep": [_P, _L, _P, _P, _L, _F, _L, _P, _I, _P, _P, _L,
                          _P, _I, _P, _P, _P, _P, _P],
    # object-space rays, tmax, (out, its plane stride, slot | occ), n, tmin,
    # the mesh's node base, node count and slot base, the packed nodes,
    # bvh_miss, the packed triangles, (K11a: the normals and T)
    "mesh_closest": [_P, _L, _P, _P, _L, _P, _L, _F, _I, _I, _I, _P, _P, _P,
                     _P, _L, _P],
    "mesh_anyhit": [_P, _L, _P, _P, _L, _F, _I, _I, _I, _P, _P, _P, _P],
    # object-space rays, tmax, the packed triangles and T, n, tmin, (the
    # t/u/v planes, their stride and prim | occ, the ray counter and the
    # grid)
    "brute_closest": [_P, _L, _P, _P, _I, _L, _F, _P, _L, _P, _P],
    "brute_anyhit": [_P, _L, _P, _P, _I, _L, _F, _P, _P, _I, _P],
}
KERNELS = tuple(_SIGNATURES)
# C entry points that read kernels' attributes: (which kernel, int out[4])
_ATTRIBUTES = ("rt_perlane_attributes", "rt_consensus_attributes",
               "rt_traverse_attributes", "rt_brute_attributes")

_launches = dict.fromkeys(KERNELS, 0)
_lib = None
_lock = threading.Lock()

# the entries of the work counts and what each counts, in the order of
# its counters: node visits and triangle tests, for the per-lane sweeps
# their record fetches (csrc/perlane.cu), and for the consensus sweeps the
# visits and tests the lanes' own walks need (csrc/walk.cuh, OwnWalk);
# a kernel's entry sums every wave, its LATER entry (each of the four
# sweeps has one) the waves after the first bounce alone
LATER = ".later"
WORK_KEYS = {
    "perlane_closest_sweep": ("nodes", "tests", "fetches"),
    "perlane_anyhit_sweep": ("nodes", "tests", "fetches"),
    "mega_closest_sweep": ("nodes", "tests", "own_nodes", "own_tests"),
    "mega_anyhit_sweep": ("nodes", "tests", "own_nodes", "own_tests"),
    "perlane_closest_sweep" + LATER: ("nodes", "tests", "fetches"),
    "perlane_anyhit_sweep" + LATER: ("nodes", "tests", "fetches"),
    "mega_closest_sweep" + LATER: ("nodes", "tests", "own_nodes", "own_tests"),
    "mega_anyhit_sweep" + LATER: ("nodes", "tests", "own_nodes", "own_tests"),
}
# the kernels that count: the entries that are no LATER entry
WORK_KERNELS = tuple(k for k in WORK_KEYS if not k.endswith(LATER))
_WORK_WIDTH = max(map(len, WORK_KEYS.values()))
# the counters, a slot (a device row) per entry: a kernel's own slot holds
# the waves its LATER slot does not
_ROW = {k: i for i, k in enumerate(WORK_KEYS)}
_work_plain = {k: dict.fromkeys(keys, 0) for k, keys in WORK_KEYS.items()}
_work_device = {}    # device -> (len(WORK_KEYS), _WORK_WIDTH) int64 counters
_count = threading.local()   # .on: this thread's frame counts its work;
                             # .later: its waves are past the first bounce
_capture = threading.local()  # .launches: this thread's graph capture's

# g++ flags of the host libraries of native/ (gxx_library)
CXX_FLAGS = ("-O3", "-mfma", "-std=c++17", "-fPIC", "-shared")


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


class Pointer(int):
    """A tensor's device pointer (an ``int``, as ctypes takes it) that
    remembers the tensor's device; :func:`check_operand` makes them."""

    device: torch.device

    def __new__(cls, t: torch.Tensor) -> "Pointer":
        ptr = super().__new__(cls, t.data_ptr())
        ptr.device = t.device
        return ptr


def _one_device(kernel: str, devices) -> torch.device:
    """The one device of ``devices``; raises if there are several."""
    found = sorted(set(devices), key=str)
    if len(found) > 1:
        raise ValueError(
            f"{kernel}: the operands of one launch lie on {len(found)} devices "
            f"({', '.join(map(str, found))}); a kernel reads one card's memory")
    if not found:
        raise ValueError(f"{kernel}: no tensor operand")
    return found[0]


def launch(kernel: str, *args) -> None:
    """Launch ``kernel`` with ``args`` (ints, floats and pointers as the C
    signature lists them) on the device of its tensor operands (the
    :class:`Pointer` arguments, which must all lie on one device), made
    current for the call, and on that device's current stream (appended);
    count the launch, and raise if CUDA reports an error."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{kernel}: CUDA is not available on this machine")
    dev = _one_device(kernel, (a.device for a in args if isinstance(a, Pointer)))
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, "rt_" + kernel)(*args, stream)
    if err != 0:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
    held = getattr(_capture, "launches", None)
    if held is not None:   # captured into a graph: counted at each replay
        held[kernel] = held.get(kernel, 0) + 1
        return
    with _lock:
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
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        for k in _launches:
            _launches[k] = 0


@contextlib.contextmanager
def captured_launches():
    """Within the block this thread's launches are held in the yielded
    dict (kernel -> launches) instead of counted: a CUDA graph captures
    them, and each replay counts them (:func:`add_launches`)."""
    saved = getattr(_capture, "launches", None)
    _capture.launches = held = {}
    try:
        yield held
    finally:
        _capture.launches = saved


def add_launches(counts: dict) -> None:
    """Count ``counts`` (kernel -> launches) as launched: a graph's replay."""
    with _lock:
        for k, n in counts.items():
            _launches[k] += n


@contextlib.contextmanager
def counting(on: bool = True):
    """Within the block, this thread's launches of :data:`WORK_KERNELS`
    and their plain versions count their work (``on``), or do not."""
    saved = getattr(_count, "on", False)
    _count.on = on
    try:
        yield
    finally:
        _count.on = saved


def counting_on() -> bool:
    """Whether this thread's sweeps count their work now."""
    return getattr(_count, "on", False)


@contextlib.contextmanager
def later_waves():
    """Within the block, this thread's waves are past the first bounce:
    the kernels with a :data:`LATER` entry count into its slot."""
    saved = getattr(_count, "later", False)
    _count.later = True
    try:
        yield
    finally:
        _count.later = saved


def _slot(kernel: str) -> str:
    """The slot ``kernel``'s work goes to now: its :data:`LATER` slot in
    a later wave, where it has one, else its own."""
    later = kernel + LATER
    return later if getattr(_count, "later", False) and later in WORK_KEYS else kernel


def work_pointer(kernel: str, device: torch.device) -> Pointer:
    """``kernel``'s int64 counters (:data:`WORK_KEYS`, in order) in
    ``device``'s work buffer, made zeroed at first use: its :data:`LATER`
    slot's in a later wave (:func:`later_waves`), where it has one."""
    with _lock:
        buf = _work_device.get(device)
        if buf is None:
            buf = _work_device[device] = torch.zeros(
                (len(WORK_KEYS), _WORK_WIDTH), dtype=torch.int64, device=device)
    return Pointer(buf[_ROW[_slot(kernel)]])


@contextlib.contextmanager
def counted(kernel: str, counts=None):
    """The ``counts`` dict for a plain version of ``kernel`` to fill: while
    this thread counts (:func:`counting`), ``counts`` or a new dict, whose
    added counts of ``kernel``'s :data:`WORK_KEYS` go to its work counts
    (its :data:`LATER` slot in a later wave) when the block ends;
    otherwise ``counts`` as given."""
    if not counting_on():
        yield counts
        return
    slot = _slot(kernel)
    c = {} if counts is None else counts
    before = {key: c.get(key, 0) for key in WORK_KEYS[kernel]}
    yield c
    with _lock:
        for key, n in before.items():
            _work_plain[slot][key] += c.get(key, 0) - n


def work_counts() -> dict:
    """The work counts per entry of :data:`WORK_KEYS` since the last
    reset: ``{entry: {key: n for key in WORK_KEYS[entry]}}``, summed over
    the plain versions and every device's counters (read after the
    device's queued work); a kernel's entry over every wave, its
    :data:`LATER` entry over the waves after the first bounce."""
    with _lock:
        slots = {k: dict(v) for k, v in _work_plain.items()}
        bufs = list(_work_device.values())
    for buf in bufs:
        for k, row in zip(WORK_KEYS, buf.cpu().tolist()):
            for key, n in zip(WORK_KEYS[k], row):
                slots[k][key] += n
    out = {k: dict(v) for k, v in slots.items()}
    for k in WORK_KEYS:
        if k.endswith(LATER):
            for key, n in slots[k].items():
                out[k[:-len(LATER)]][key] += n
    return out


def reset_work_counts() -> None:
    with _lock:
        for v in _work_plain.values():
            v.update(dict.fromkeys(v, 0))
        for buf in _work_device.values():
            buf.zero_()


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
                  dtype=torch.float32) -> Pointer:
    """Validate one kernel operand and return its device pointer: a
    contiguous CUDA tensor of ``dtype`` (and ``shape`` where given)."""
    _check(kernel, name, t, shape, dtype)
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} is not contiguous")
    return Pointer(t)


def check_operands(kernel: str, operands) -> list:
    """:func:`check_operand` on each ``(name, tensor, shape, dtype)`` of
    ``operands``, every type and shape before any device: a table of the
    wrong layout is named wherever it lies; then all on one device."""
    for op in operands:
        _check_layout(kernel, *op)
    ptrs = [check_operand(kernel, *op) for op in operands]
    _one_device(kernel, (p.device for p in ptrs))
    return ptrs


def check_planes(kernel: str, name: str, t: torch.Tensor, shape,
                 dtype=torch.float32):
    """Validate a multi-plane operand of ``shape`` (planes, P, K) and return
    ``(pointer, plane stride in elements)``. The planes need not be
    adjacent, so a wave ``x[:, s:s+b]`` of a larger buffer goes in without a
    copy; the lanes of each plane must be contiguous."""
    _check(kernel, name, t, shape, dtype)
    if not t[0].is_contiguous():
        raise ValueError(f"{kernel}: {name}'s planes are not contiguous")
    return Pointer(t), t.stride(0)


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


def gxx_library(stem: str, sources, what: str) -> Path:
    """Compile ``sources`` with ``g++`` and :data:`CXX_FLAGS` into one
    shared library in :data:`BUILD_DIR` unless this exact build exists
    (named ``<stem>_<hash of the sources and flags>.so``); return its path.

    Why ``-mfma``: raytpu's committed ``native/libraytpu_native.so`` was
    built with ``-march=native``, so g++ contracted its ``a*b + c`` into
    fused multiply-adds, and the same source built without FMA rounds
    otherwise (other SAH splits, JPEG pixels one apart). A host whose CPU
    has no FMA cannot build raytpu's results, so this raises there, naming
    ``what`` it would have built, rather than build different ones."""
    if not host_has_fma():
        raise RuntimeError(
            f"{what} needs an x86-64 CPU with FMA: raytpu's results come "
            "from a build whose float math is contracted into fused "
            f"multiply-adds, and this host ({platform.machine()}) reports no "
            "'fma' in /proc/cpuinfo, so it would compute other ones")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in sources:
        h.update(Path(src).name.encode())
        h.update(Path(src).read_bytes())
    out = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, sources)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"{what}: cannot run g++ ({exc})") from exc
    if res.returncode != 0:
        raise RuntimeError(
            f"g++ exited {res.returncode}:\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)
    return out
