#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``raytpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                # from the repository root
    python3 chip_smoke.py --profile DIR  # profiler tables into DIR
                                         # (default build/profile/)
    python3 chip_smoke.py --ab PARENT [--this-first]
                                         # frames and K1/K2/K8/K9/K10a/K10b/
                                         # K11a/K11b and brute kernel times
                                         # of the port in PARENT and in this
                                         # tree
    python3 chip_smoke.py --sweeps DIR [DIR ...]
                                         # K1/K2/K8/K9/K10a/K10b/K11a/K11b
                                         # and brute kernel times alone of
                                         # the ports in DIRs, in that order

Builds the sixteen hand-written CUDA kernels from ``raytpu_torch/csrc``
and the BVHs (the teapot stand-in's tree checked against a digest of the
tree raytpu builds), holds every kernel against its plain PyTorch version
on the card at the main path's shapes (and the per-lane sweeps K1/K2, the
consensus sweeps K8/K9 and the per-(instance, mesh) loop on the one-mesh
walks K11a/K11b against the chained sweeps K10a/K10b, bit for bit; K1/K2,
K10b, K11b and the loop on K11b also on config4's whole primary wave, K10b
and K11b against their plain versions there too, and K8/K9 against theirs
on config3's whole primary wave; the sweeps' registers,
local bytes and resident CTAs, and every kernel's registers and spills as
``cuobjdump`` reads them), then
renders through ``Renderer`` on the default fused and compacted bounce
loop:

* the config4 stand-in (1920x1080, 4 spp, 3 bounces, 327,680-triangle
  orbiting mesh) on its default tier, per-lane (``traversal="auto"``
  resolves so at 332,800 triangles): the frames must launch the prepass K7
  and the per-lane sweeps K1/K2 and not K10a/K10b;
* the same scene with ``traversal="pallas"``: K10a/K10b and not K7/K1/K2;
* one profiled frame of each tier, for the device's idle share;
* one per-lane config4 frame with every K1/K2 launch held against K10a/K10b
  on its wave, primary and bounce waves, the primary and first bounce
  waves also against K1/K2's plain versions (bit for bit), and its pixels
  against the pallas-tier frame of the same pose (only exact ties may
  differ);
* two config4 frames through the fused loop at full width (no
  compaction);
* two config4 frames with ``traversal="xla"``, which the JAX package renders
  through its XLA body: the compacted body
  (``body_compact``) on the per-(instance, mesh) loop, which must launch
  K11a/K11b and no packed sweep, prepass or fused shading kernel; from the
  same primary rays the frame within 1e-5 of the fused pallas-tier frame;
  one profiled frame;
* the reference-default stand-in (800x600, 4 spp, 63 bounces), per-lane;
* the config3 and config2 stand-ins (1280x720, 4 spp, 3 bounces,
  refractive Cornell-box mesh; 800x600, 4 spp, 2 bounces, mirror teapot
  stand-in), whose ``traversal="auto"`` resolves to the consensus tier:
  first K8/K9 on the primary wave (against their plain versions on a
  slice, and on config3's whole wave; against K1/K2 and K10a/K10b on the
  whole wave, only proven exact ties may differ, and timed beside them;
  their registers, local bytes and resident CTAs), then 5 frames that must
  launch K7/K8/K9 and not K1/K2/K10a/K10b, the same frames on the pallas tier
  (same rays, equal pixels), and one profiled frame of each tier;
* at 256x192 (P = 256, budget 64, so compaction engages): the compacted
  frame against the full-width fused frame and the chained and consensus
  tiers' frames (bit for bit), the "xla" tier's XLA body frame from the
  same rays (within 1e-5), and the plain path (SSIM, and max abs diff from
  the same primary rays); the XLA body's compacted "xla" frame against its
  full-width one, bit for bit;
* the tie scene (two coincident boxes of different materials) through
  every packed tier: no pixel may differ; on "xla" no lane of the primary
  wave may differ from K10a/K10b's, and the frame is within 1e-5 of the
  pallas tier's;
* the knobs phase (``knobs_phase``): ``brute_closest_kernel`` and
  ``brute_anyhit_kernel`` against their plain versions bit for bit on a
  slice of config2's primary wave (times and bounds; the any-hit's
  order-free floor of tests and its launch grid); the brute oracle (``brute_oracle``) on
  the primary waves of config1-3 and the 256x192 config4 frame: K1, K8,
  K10a and the loop on K11a equal to the brute loop on every lane but
  proven exact ties (config3's must include ``CONSENSUS_TIES``), K2, K9,
  K10b and the loop on K11b equal to the brute occlusion flag for flag on
  the shadow rays of K10a's hits; the brute loop's triangle at config4's
  ``EXACT_TIES`` lane one of the two tied ones; then frames, each against
  its reference at one pose, differing only in pixels of proven tie
  lanes, with frame ms, host syncs and idle share: config1 (512x512) and
  config3 with no BVH (``traversal="brute"``, which must launch the brute
  kernels and no sweep) against their ``"xla"`` frames and within 1e-5 of
  their fused default frames, and config4 at
  ``chunk_tris=11264`` (31 entries, its trees against
  :data:`CHUNK_DIGEST`) on the per-lane and pallas tiers against the
  unchunked frames;
* the render options and builders (``options_phase``): config4's trees
  by the LBVH built on the card (steps 1-4 timed, the tree equal to the
  same function's on CPU tensors, the teapot stand-in's against
  :data:`LBVH_DIGEST`), 5 timed frames on it and one profiled, and its
  256x192 frame against the plain path and the native tree's frame; the
  config2 stand-in on the SAH and median trees (:data:`SAH_DIGEST`,
  :data:`MEDIAN_DIGEST`), a frame each against the native tree's; config4
  unfolded (``fold_spp=False``) and in 4 ray chunks, timed, profiled and
  on the pallas tier within 1e-6 of the default frame; ``sky_nearest``
  (K6's single-tap mode) against its plain version bit for bit, and
  config4 frames with the "nearest" and "bilinear2x" filters; a config2
  frame with validation (no report; a NaN camera reports); and the
  viewer loop on the config1 stand-in under :class:`RecordingCv2`;
* the entry points (``entry_points``): the bench's ``run_matrix`` over the
  six stand-ins, 4 frames each on their default tiers (reusing the
  Renderers above; config1 and config5 built anew), its
  ``bit_identity_check`` (config2 stand-in at 128x96, and the tie scene),
  ``python -m raytpu_torch.cli render --preset config1_standin`` in a
  child process (the PNG, decoded with PIL, equal to the frame rendered
  here), ``Flythrough.run_benchmark`` on the config5 stand-in for 8
  frames, and ``python -m raytpu_torch.bench --frames 4`` in a child
  process, whose last line must be its whole JSON line;
* the sharded path (``sharding_phase``, ``raytpu_torch/parallel``) over
  meshes of repeated ``cuda:0`` slots (:data:`SHARDED_FRAMES`: config4
  over 4 slots on its per-lane tier and on the pallas tier, config2 over 3
  and config3 over 4 on the consensus tier, the 256x192 frame over 8 slots,
  two of them all padding, on "auto", "pallas" and "xla" and over 2 with
  the "nearest" filter, the tie scene on "pallas" and "mega", config1
  with no BVH over 2), each against the single-device frame: bit for bit
  on the pallas, "xla" and brute tiers, elsewhere differing only in
  known-tie pixels; every kernel must
  launch in those frames; their times and host syncs beside the
  single-device frames'; the Renderer's refusal of more cards than the
  machine has, ``run_benchmark`` over a 4-slot mesh, and the frames over
  distinct cards where the machine has several;
* the native loaders (``native_loaders``): ``raytpu_torch/io/native.py``
  built on this machine, the armadillo stand-in's OBJ parsed against the
  Python parser and a generated JPEG decoded against PIL.

Any failed check raises and exits non-zero. It imports nothing of JAX or
raytpu.

The last three lines: the frames and checks as one JSON object, the
per-kernel JSON line (launches counted during the frames of the path that
runs the kernel: the default config4 frames, the default config3 frames
for K8/K9, the config4 ``traversal="pallas"`` ones for K10a/K10b, or the
config4 ``traversal="xla"`` ones for K11a/K11b, the "nearest" ones for
``sky_nearest``, the brute config1 and config3 frames for the brute
kernels; errors against the plain
versions, times on the sweeps' slice (K11a and K11b a sweep over both
entries), bounds), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "closest_sweep": ("raytpu_torch/csrc/traverse.cu",
                      "raytpu/ops/traverse_pallas.py:504"),
    "anyhit_sweep": ("raytpu_torch/csrc/traverse.cu",
                     "raytpu/ops/traverse_pallas.py:693"),
    "raygen": ("raytpu_torch/csrc/raygen.cu", "raytpu/ops/raygen.py:70"),
    "sky": ("raytpu_torch/csrc/sky.cu", "raytpu/ops/sky_mxu.py:120"),
    # the same TPU kernel's single-tap mode (bilinear=False, :453 via :543)
    "sky_nearest": ("raytpu_torch/csrc/sky.cu", "raytpu/ops/sky_mxu.py:120"),
    "shade_epilogue": ("raytpu_torch/csrc/epilogue.cu",
                       "raytpu/ops/epilogue.py:86"),
    "accumulate_epilogue": ("raytpu_torch/csrc/epilogue.cu",
                            "raytpu/ops/epilogue.py:236"),
    "block_stats": ("raytpu_torch/csrc/mega.cu", "raytpu/ops/mega.py:360"),
    "perlane_closest_sweep": ("raytpu_torch/csrc/perlane.cu",
                              "raytpu/ops/perlane.py:1490"),
    "perlane_anyhit_sweep": ("raytpu_torch/csrc/perlane.cu",
                             "raytpu/ops/perlane.py:1720"),
    "mega_closest_sweep": ("raytpu_torch/csrc/consensus.cu",
                           "raytpu/ops/mega.py:719"),
    "mega_anyhit_sweep": ("raytpu_torch/csrc/consensus.cu",
                          "raytpu/ops/mega.py:1090"),
    "mesh_closest": ("raytpu_torch/csrc/traverse.cu",
                     "raytpu/ops/traverse_pallas.py:115"),
    "mesh_anyhit": ("raytpu_torch/csrc/traverse.cu",
                    "raytpu/ops/traverse_pallas.py:217"),
    # no Pallas kernel: raytpu's brute tracers are XLA (a lax.scan over
    # triangle blocks); the port's rule puts a kernel behind every CUDA call
    "brute_closest": ("raytpu_torch/csrc/brute.cu", "raytpu/ops/intersect.py:163"),
    "brute_anyhit": ("raytpu_torch/csrc/brute.cu", "raytpu/ops/intersect.py:226"),
}
CHAINED = ("closest_sweep", "anyhit_sweep")          # traversal="pallas"
PER_LANE = ("block_stats", "perlane_closest_sweep", "perlane_anyhit_sweep")
CONSENSUS = ("mega_closest_sweep", "mega_anyhit_sweep")  # after K7 ("mega")
MESH = ("mesh_closest", "mesh_anyhit")    # traversal="xla", the XLA body
FUSED = ("shade_epilogue", "accumulate_epilogue")    # the fused loop only
NEAREST = ("sky_nearest",)   # the "nearest" and "bilinear2x" filters only
BRUTE = ("brute_closest", "brute_anyhit")  # a scene with no BVH only
SWEEP_PACKETS = 256
# sha256 of the teapot stand-in's tree (generate_highpoly(depth=4,
# radius=3.0), leaf size 12): its aabb_min, aabb_max, tri_first, tri_count,
# miss and tri_order arrays, as raytpu's committed native library
# (native/libraytpu_native.so) builds them. A host whose g++ contracts the
# builder's float math otherwise builds another tree.
TREE_DIGEST = "b54354457d7dfc75827a60170abac49920449bbe756799d910f4a2b5607d5f17"
# The same digest of raytpu's trees of that mesh (the config2 stand-in's)
# from its other builders, leaf size 12: build_lbvh (raytpu/accel/lbvh.py),
# and build_bvh with method "sah" and "median" (raytpu/accel/bvh.py)
# (tests/test_torch_builders.py computes them from raytpu's builders).
LBVH_DIGEST = "b8ccde1e2b99425acf523012fc24f04975895723f6b34756313b2db159ee10f7"
SAH_DIGEST = "c0536b9d7101ad9deedbda7c9d82d179521e56dee99bdaa25431b39f6a9e5539"
MEDIAN_DIGEST = "1b865dce1c9a094d2f1b34e01430e361445c0defa1068a86a5f4acc4286d59d4"
# Lanes (packet, lane) of the config4 stand-in's primary wave
# (set_transforms(0.05), the raygen kernel's rays) where K1 and K10a keep two
# different triangles of the armadillo stand-in hit at exactly the same t, a
# tie that the walk order breaks (ROADMAP queue 3). The full-wave comparison
# allows exactly these lanes, each shown to be a tie by exact_ties().
EXACT_TIES = [(3983, 110)]
# The same for K8 against K1 and against K10a on the primary waves of the
# config3 and config2 stand-ins (their fixed pose): on config3, four rays
# that meet an edge where two walls of the room join (prims 5 and 9, 1 and
# 8, 2 and 9) hit both walls' triangles at the same t; K8 and K1 keep the
# one their octant's order reaches first, K10a the one build order does.
CONSENSUS_TIES = {
    "config3_standin": {"K1": [], "K10a": [(1037, 582), (1067, 582),
                                          (1560, 32), (1803, 480)]},
    "config2_standin": {"K1": [], "K10a": []},
}
RAYGEN_DIR_TOL = 1e-5  # kernel vs plain raygen, same f32 ops on one card
EPILOGUE_ULPS = 2      # shade/accumulate kernel vs plain version, f32 ulps

# Bounds: the larger of the bytes a call must move (each input read once,
# each output written once) over the H100's 3.35 TB/s (NVIDIA's H100 SXM
# data sheet, at a 700 W power limit) and its operations over the card's
# peak rate of f32 operations outside the tensor cores, f32_ops_per_s():
# SMs x 128 FP32 lanes x the maximum SM clock (nvidia-smi's clocks.max.sm),
# 3.3e13 a second on an H100 SXM. Not the data sheet's 67 TFLOP/s, which
# counts a fused multiply-add as two: the kernels are built with
# --fmad=false, so no operation fuses and each is one instruction on one
# lane. Operations per lane are counted from the sources, each arithmetic
# operation, comparison and libm call as one; the sweeps' from the node
# visits and triangle tests the plain walk counts. A sweep's bytes are what
# its lanes must read and write (closest_lane_bytes, anyhit_lane_bytes), the
# small tables it reads whole, and the distinct node, link and triangle rows
# its plain walk reads (traverse.rows_bytes), not the whole trees.
HBM_BYTES_PER_S = 3.35e12
F32_LANES_PER_SM = 128
OPS_PER_LANE = {"raygen": 55, "sky": 80, "sky_nearest": 50, "shade_epilogue": 100,
                "accumulate_epilogue": 18, "block_stats": 21}
SLAB_OPS, MT_OPS = 23, 51  # one node's box test, one Moller-Trumbore test


def check(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def import_port():
    """Every module of the port the phases use (nothing of JAX or raytpu)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import torch  # noqa: F401
    from raytpu_torch import _build, bench, cli, config, integrator, presets, render, scene, scenes  # noqa: F401
    from raytpu_torch.accel import bvh, lbvh  # noqa: F401
    from raytpu_torch.frontend import flythrough, headless, interactive  # noqa: F401
    from raytpu_torch.io import image, native  # noqa: F401
    from raytpu_torch.parallel import dist  # noqa: F401
    from raytpu_torch.accel import chunking  # noqa: F401
    from raytpu_torch.ops import consensus, epilogue, intersect, mega, perlane, raygen, sky, traverse, vec3  # noqa: F401
    from raytpu_torch.utils import log, ssim, timing, validation  # noqa: F401


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def max_sm_mhz() -> float:
    """The card's maximum SM clock in MHz (``nvidia-smi``'s ``clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def f32_ops_per_s() -> float:
    """The card's peak rate of unfused f32 operations: SMs x
    :data:`F32_LANES_PER_SM` x :func:`max_sm_mhz`."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * F32_LANES_PER_SM * max_sm_mhz() * 1e6


def cuda_ms(fn, warmup: int, iters: int) -> float:
    """Mean ms per call on the current stream (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def warm_card(ms: float = 50.0) -> None:
    """Keep the card busy for about ``ms`` of host time, so that a timed
    run that follows host-bound work (a plain walk, a scene build) does not
    start on clocks that fell while the card idled."""
    import torch

    a = torch.ones((2048, 2048), device="cuda")
    start = time.perf_counter()
    while (time.perf_counter() - start) * 1e3 < ms:
        for _ in range(8):
            a = (a @ a) / 2048.0
        torch.cuda.synchronize()


def cuda_ms_fresh(fn, make, warmup: int, iters: int) -> float:
    """Mean ms per call of ``fn(x)`` on inputs ``x = make()`` made before
    the timed run (a sweep updates its state in place, so each launch
    takes a fresh copy; the copies are not timed), after
    :func:`warm_card`."""
    import torch

    warm_card()
    for _ in range(warmup):
        fn(make())
    inputs = [make() for _ in range(iters)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for x in inputs:
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Mean device ms per call of ``fn()``, from ``torch.profiler``: the
    device time of the hand-written kernels the calls launch (PyTorch's own
    kernels, copies and memsets left out, so ``fn`` may copy its inputs).
    Small launches issued one by one from Python are bound by the host,
    and CUDA events around them measure the issue; this reads the kernels'
    own time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation
             and "at::native" not in e.key
             and not e.key.startswith(("Memcpy", "Memset")))
    return us / 1e3 / iters


def bound(nbytes: float, ops: float):
    """(bound ms, what bounds it) for a call moving ``nbytes`` and doing
    ``ops`` f32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / f32_ops_per_s()
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def differing_lanes(a, b) -> str:
    """Lanes where two (9, P, K) states differ, and how many of them are
    exact ties (same t bits, both valid): a walk order picked another of
    two triangles hit at the same t."""
    import torch

    ai, bi = a.view(torch.int32), b.view(torch.int32)
    diff = (ai != bi).any(dim=0)
    tied = diff & (ai[0] == bi[0]) & (ai[1] != 0) & (bi[1] != 0)
    return f"{int(diff.sum())} lanes differ, {int(tied.sum())} of them exact t ties"


def plain_closest(name: str):
    """The plain version of closest sweep ``name`` ("K1", "K8", "K10a")."""
    from raytpu_torch.ops import consensus, perlane, traverse

    return {"K1": perlane.perlane_closest_sweep_ref,
            "K8": consensus.mega_closest_sweep_ref,
            "K10a": traverse.closest_sweep_ref}[name]


def exact_ties(ts, rays, win, k1, k10, names=("K1", "K10a")) -> list:
    """The lanes where the states ``k1`` and ``k10`` of the closest sweeps
    ``names`` (default K1's and K10a's) differ, each shown to be an exact
    tie: the same t bits, both valid, and the triangle each walk kept (from
    the plain walks over the lane's block, which must reproduce the
    kernel's state there) hit by the ray at exactly that t. Returns one
    record per lane."""
    import torch
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops import traverse
    from raytpu_torch.ops.intersect import moller_trumbore

    a, b = k1.view(torch.int32), k10.view(torch.int32)
    ties = []
    for p, k in (a != b).any(dim=0).nonzero().tolist():
        lane = f"lane (packet {p}, {k})"
        check(a[0, p, k] == b[0, p, k] and a[1, p, k] != 0 and b[1, p, k] != 0,
              f"{lane}: {names[0]} and {names[1]} differ in t or validity, "
              f"not an exact tie")
        blk = slice(p - p % 8, p - p % 8 + 8)   # the lane's culling block
        r = rays[:, blk].contiguous()
        st = traverse.make_trace_state(win[blk].contiguous())
        rec = {"lane": [p, k], "t": float(k1[0, p, k])}
        for name, full in zip(names, (k1, k10)):
            slots = torch.full(st.shape[1:], -1, dtype=torch.long, device=st.device)
            got = plain_closest(name)(ts, r, RAY_TMIN, st.clone(), slots=slots)
            check(torch.equal(got.view(torch.int32)[:, p % 8, k],
                              full.view(torch.int32)[:, p, k]),
                  f"{lane}: the plain walk reproduces {name}'s state")
            inst, slot = int(full.view(torch.int32)[3, p, k]), int(slots[p % 8, k])
            _, o, d, _ = traverse._object_rays(
                ts, inst, tuple(r[c, p % 8, k:k + 1] for c in range(3)),
                tuple(r[3 + c, p % 8, k:k + 1] for c in range(3)))
            tri = [tuple(x[slot:slot + 1, c] for c in range(3))
                   for x in (ts.bvh_tri_v0, ts.bvh_tri_e1, ts.bvh_tri_e2)]
            t, _, _, hit = moller_trumbore(o, d, *tri, RAY_TMIN,
                                           torch.full_like(o[0], float("inf")))
            check(bool(hit[0]) and t.view(torch.int32)[0] == a[0, p, k],
                  f"{lane}: {name}'s triangle is hit at exactly t")
            rec[name] = {"inst": inst, "slot": slot,
                         "prim": int(ts.bvh_tri_prim[slot])}
        check(rec[names[0]] != rec[names[1]], f"{lane}: two different triangles")
        ties.append(rec)
    return ties


def ulps(a, b):
    """Per-element distance in f32 ulps (same-sign values)."""
    import torch

    ai = a.contiguous().view(torch.int32).long()
    bi = b.contiguous().view(torch.int32).long()
    return (ai - bi).abs()


def sweep_slice(rs, n_packets: int):
    """Packet indices of a frame's folded wave around the frame centre: a
    square block of tiles, every sample of each tile."""
    spp = rs.samples_per_pixel
    w_t = -(-rs.width // rs.tile)
    h_t = -(-rs.height // rs.tile)
    side = int(round((n_packets // spp) ** 0.5))
    y0, x0 = h_t // 2 - side // 2, w_t // 2 - side // 2
    tiles = [(y0 + y) * w_t + x0 + x for y in range(side) for x in range(side)]
    return [t * spp + s for t in tiles for s in range(spp)]


def sweep_bound(counts: dict, lane_bytes: int, whole: int):
    """Bound of a sweep call: ``lane_bytes``, the ``whole`` bytes of the
    small tables it reads whole (entries, transforms, the per-lane
    schedule) and the distinct table rows its plain walk read
    (``counts["rows"]``); operations from the walk's node visits and
    triangle tests."""
    from raytpu_torch.ops import traverse

    ops = counts["nodes"] * SLAB_OPS + counts["tests"] * MT_OPS
    return bound(lane_bytes + whole + traverse.rows_bytes(counts), ops)


def walk_work(counts: dict, live: int) -> dict:
    """The plain walk's work for the JSON line: node visits, triangle tests,
    live rays, bytes of the distinct table rows read."""
    from raytpu_torch.ops import traverse

    return {"nodes": counts["nodes"], "tests": counts["tests"], "rays": live,
            "table_bytes": traverse.rows_bytes(counts)}


def closest_lane_bytes(state0, state1, tmin: float) -> int:
    """What a closest sweep's lanes must move: t of every lane in, the rays
    of the live lanes in, all 9 planes of the lanes it improved out
    (``state0`` before the sweep, ``state1`` after)."""
    import torch

    live = int((state0[0] > tmin).sum())
    improved = int((state0.view(torch.int32) != state1.view(torch.int32))
                   .any(dim=0).sum())
    return 4 * state0[0].numel() + 24 * live + 36 * improved


def anyhit_lane_bytes(tmax, occ0, occ1, tmin: float) -> int:
    """What a shadow sweep's lanes must move: occ of every lane in, tmax of
    the lanes not yet occluded, the rays of the live ones, the flags it set
    out (``occ0`` before the sweep, ``occ1`` after)."""
    pend = occ0 == 0
    live = int((pend & (tmax > tmin)).sum())
    newly = int((pend & (occ1 != 0)).sum())
    return 4 * occ0.numel() + 4 * int(pend.sum()) + 24 * live + 4 * newly


def shadow_rays(ts, rays, state):
    """Shadow rays from the hits of ``state`` (a closest sweep of ``rays``)
    toward the light, every hit lane whatever its material: ``(rays (6, P,
    K), window (P, K))``, the window the light distance (0 off the hits)."""
    import torch
    from raytpu_torch.ops import traverse
    from raytpu_torch.ops import vec3 as v3

    t, vmask, _, _, nrm, _, _ = traverse.unpack_state(state)
    o = (rays[0], rays[1], rays[2])
    d = (rays[3], rays[4], rays[5])
    nrm = v3.normalize(nrm)
    pos = v3.add(o, v3.scale(torch.where(vmask, t, 0.0), d))
    so = v3.add(pos, v3.scale(1e-2, nrm))
    to_l = tuple(ts.light_pos[c] - pos[c] for c in range(3))
    dist = v3.norm(to_l)
    ld = v3.scale(1.0 / torch.clamp_min(dist, 1e-30), to_l)
    return (torch.stack((*so, *ld)).contiguous(),
            torch.where(vmask, dist, 0.0).contiguous())


def compare_epilogue(r, rk, full_st, act, s_row, res, gpu: str) -> None:
    """The shade and accumulate kernels against their plain versions on the
    full primary wave of the config4 stand-in, after its closest sweep."""
    import torch
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops import epilogue, traverse

    ts = r.tscene
    light = ts.light
    miss0 = torch.zeros(act.shape, dtype=torch.int32, device=act.device)
    st = traverse.closest_sweep(ts, rk, RAY_TMIN, full_st.clone())
    got = epilogue.shade_epilogue(rk.clone(), st, miss0.clone(), light[:3], light[3])
    want = epilogue.shade_epilogue_ref(rk.clone(), st, miss0.clone(), light[:3],
                                       light[3])
    names = ("srays", "swin", "ab", "lit", "nrays", "nwin", "miss")
    worst, err, bitwise = {}, 0.0, True
    for name, a, b in zip(names, got, want):
        if a.dtype == torch.int32:
            check(torch.equal(a, b), f"shade_epilogue {name} exact")
            continue
        worst[name] = ulps(a, b).max().item()
        err = max(err, (a - b).abs().max().item())
        bitwise &= torch.equal(a.view(torch.int32), b.view(torch.int32))
        check(worst[name] <= EPILOGUE_ULPS,
              f"shade_epilogue {name} within {EPILOGUE_ULPS} ulps ({worst[name]})")
    lit_frac = (got[3] != 0).float().mean().item()
    check(lit_frac > 0, f"shade_epilogue finds lit lanes ({lit_frac})")
    n = rk[0].numel()
    rc, mc = rk.clone(), miss0.clone()
    res["shade_epilogue"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: epilogue.shade_epilogue(rc, st, mc, light[:3], light[3]), 3, 10),
        plain_ms=cuda_ms(lambda: epilogue.shade_epilogue_ref(rc, st, mc, light[:3],
                                                             light[3]), 1, 3),
        # rays 24 B + the 24 B of t/valid/mat/n + miss 4 B in, 72 B out a lane
        bound=bound(124 * n, OPS_PER_LANE["shade_epilogue"] * n),
        shape=list(rk.shape))
    print(f"shade_epilogue {list(rk.shape)}: lit/miss exact, lit {lit_frac:.3f}, "
          f"max ulps {worst}, bitwise {bitwise}", flush=True)

    srays, swin, ab, lit = got[:4]
    occ = traverse.anyhit_sweep(ts, srays, RAY_TMIN, swin,
                                torch.zeros_like(lit))
    decay = torch.pow(0.9, s_row)
    tmp0 = torch.rand((3, *act.shape), device=act.device,
                      generator=torch.Generator(device=act.device).manual_seed(0))
    a = epilogue.accumulate_epilogue(occ, ab, lit, tmp0.clone(), decay, light[:3], light[3])
    b = epilogue.accumulate_epilogue_ref(occ, ab, lit, tmp0.clone(), decay, light[:3],
                                         light[3])
    acc_ulps = ulps(a, b).max().item()
    check(acc_ulps <= EPILOGUE_ULPS,
          f"accumulate_epilogue within {EPILOGUE_ULPS} ulps ({acc_ulps})")
    shaded = (a != tmp0).any(dim=0).float().mean().item()
    check(shaded > 0, f"accumulate_epilogue shades lanes ({shaded})")
    tc = tmp0.clone()
    res["accumulate_epilogue"] = dict(
        max_abs_err=(a - b).abs().max().item(),
        ms=cuda_ms(lambda: epilogue.accumulate_epilogue(occ, ab, lit, tc, decay,
                                                        light[:3], light[3]), 3, 10),
        plain_ms=cuda_ms(lambda: epilogue.accumulate_epilogue_ref(
            occ, ab, lit, tc, decay, light[:3], light[3]), 1, 3),
        # occ 4 + a/b 8 + lit 4 + radiance 12 in and 12 out a lane, decay
        bound=bound(40 * n + nbytes(decay), OPS_PER_LANE["accumulate_epilogue"] * n),
        shape=list(tmp0.shape))
    print(f"accumulate_epilogue {list(tmp0.shape)}: max ulps {acc_ulps}, "
          f"shaded {shaded:.3f}, bitwise {torch.equal(a, b)}", flush=True)


def compare_kernels(r, gpu: str) -> dict:
    """Each kernel against its plain version on the card, main-path shapes."""
    import torch
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.integrator import tiled_pixels
    from raytpu_torch.ops import perlane, raygen, sky, traverse

    ts, rs, dev = r.tscene, r.render_static, r.device
    spp = rs.samples_per_pixel
    (px, py), in_frame = tiled_pixels(rs, dev)
    pxs, pys = px.repeat_interleave(spp, 0), py.repeat_interleave(spp, 0)
    act = in_frame.repeat_interleave(spp, 0)
    s_row = torch.arange(spp, dtype=torch.float32, device=dev).repeat(px.shape[0])
    cam = r.camera_tensor()
    res = {}

    def rg_k():
        return raygen.raygen_packed(cam, s_row, pxs, pys, spp, rs.width, rs.height)

    def rg_p():
        return raygen.raygen_packed_ref(cam, s_row, pxs, pys, spp, rs.width, rs.height)

    rk, rp = rg_k(), rg_p()
    n = rk[0].numel()
    check(torch.equal(rk[:3], rp[:3]), "raygen origins exact")
    norm_err = (rk[3:].square().sum(0) - 1.0).abs().max().item()
    dir_err = (rk[3:] - rp[3:]).abs().max().item()
    jit_err = raygen.jitter_error(rk, cam, s_row, pxs, pys, spp, rs.width, rs.height)
    check(norm_err <= 1e-5, f"raygen unit directions ({norm_err})")
    check(dir_err <= 2.5 / rs.height, f"raygen directions within 2.5/H ({dir_err})")
    check(dir_err <= RAYGEN_DIR_TOL,
          f"raygen directions within {RAYGEN_DIR_TOL} of the plain version ({dir_err})")
    check(jit_err <= raygen.JITTER_TOL,
          f"raygen jitter is the shader hash's, every lane ({jit_err} px)")
    res["raygen"] = dict(max_abs_err=dir_err, ms=cuda_ms(rg_k, 3, 10),
                         plain_ms=cuda_ms(rg_p, 3, 10), shape=list(rk.shape),
                         bound=bound(nbytes(pxs, pys, s_row, cam, rk),
                                     OPS_PER_LANE["raygen"] * n))
    print(f"raygen  {list(rk.shape)}: origins exact, unit err {norm_err:.3g}, "
          f"dir err {dir_err:.3g} (<= {RAYGEN_DIR_TOL} and <= 2.5/H), jitter "
          f"recovered from the kernel's directions vs the hash: {jit_err:.3g} px "
          f"(<= {raygen.JITTER_TOL})", flush=True)

    h, w = ts.sky_hw
    dirs = (rk[3], rk[4], -rk[5])  # every lane, z-flipped, as the fetch does

    def sky_k():
        return sky.sample_cubemap_u32(ts.skybox_u32, h, w, dirs)

    def sky_p():
        return sky.sample_cubemap_u32_ref(ts.skybox_u32, h, w, dirs)

    sk_out = sky_k()
    sk_err = max((a - b).abs().max().item() for a, b in zip(sk_out, sky_p()))
    check(sk_err <= 1e-6, f"sky within 1e-6 ({sk_err})")
    res["sky"] = dict(max_abs_err=sk_err, ms=cuda_ms(sky_k, 3, 10),
                      plain_ms=cuda_ms(sky_p, 3, 10), shape=list(dirs[0].shape),
                      bound=bound(nbytes(*dirs, *sk_out, ts.skybox_u32),
                                  OPS_PER_LANE["sky"] * n))
    print(f"sky     {list(dirs[0].shape)} lanes, {h}x{w} faces: max err {sk_err:.3g}",
          flush=True)

    whole = nbytes(ts.entries, ts.w2o)   # read whole by the chained sweeps

    # the sweeps on a 256-packet slice of the primary wave
    idx = torch.tensor(sweep_slice(rs, SWEEP_PACKETS), device=dev)
    rays = rk[:, idx].contiguous()
    win = torch.where(act[idx], RAY_TMAX, 0.0).float().contiguous()
    st0 = traverse.make_trace_state(win)
    sk_ = traverse.closest_sweep(ts, rays, RAY_TMIN, st0.clone())
    counts = {"rows": {}}
    sp_ = traverse.closest_sweep_ref(ts, rays, RAY_TMIN, st0.clone(), counts=counts)
    ik, ip = sk_.view(torch.int32), sp_.view(torch.int32)
    for plane, name in ((traverse.ST_VALID, "valid"), (traverse.ST_MAT, "mat"),
                        (traverse.ST_INST, "inst")):
        check(torch.equal(ik[plane], ip[plane]), f"closest {name} exact")
    valid = ik[traverse.ST_VALID] != 0
    hit_frac = valid.float().mean().item()
    check(hit_frac > 0.05, f"closest slice hits something ({hit_frac})")
    for plane, name in ((traverse.ST_T, "t"), (traverse.ST_U, "u"), (traverse.ST_V, "v")):
        worst = ulps(sk_[plane], sp_[plane]).max().item()
        check(worst <= 4, f"closest {name} within 4 ulps ({worst})")
    cl_err = (sk_[[0, 4, 5, 6, 7, 8]] - sp_[[0, 4, 5, 6, 7, 8]]).abs().max().item()
    bitwise = torch.equal(ik, ip)
    live = int((win > RAY_TMIN).sum().item())
    res["closest_sweep"] = dict(
        max_abs_err=cl_err,
        ms=cuda_ms(lambda: traverse.closest_sweep(ts, rays, RAY_TMIN, st0.clone()), 3, 10),
        plain_ms=cuda_ms(lambda: traverse.closest_sweep_ref(ts, rays, RAY_TMIN, st0.clone()), 1, 2),
        shape=list(rays.shape),
        bound=sweep_bound(counts, closest_lane_bytes(st0, sk_, RAY_TMIN), whole),
        work=walk_work(counts, live))
    print(f"closest {list(rays.shape)}: valid/mat/inst exact, hit {hit_frac:.3f}, "
          f"t/u/v <= 4 ulps, bitwise {bitwise}; plain walk per live ray: "
          f"{counts['nodes'] / live:.1f} node visits, {counts['tests'] / live:.1f} "
          f"triangle tests", flush=True)

    srays, tmax = shadow_rays(ts, rays, sp_)
    occ0 = torch.zeros(tmax.shape, dtype=torch.int32, device=dev)
    ok_ = traverse.anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone())
    counts = {"rows": {}}
    op_ = traverse.anyhit_sweep_ref(ts, srays, RAY_TMIN, tmax, occ0.clone(), counts=counts)
    check(torch.equal(ok_, op_), "anyhit occlusion exact")
    occ_frac = (ok_ != 0).float().mean().item()
    live = int((tmax > RAY_TMIN).sum().item())
    res["anyhit_sweep"] = dict(
        max_abs_err=(ok_ - op_).abs().max().item(),
        ms=cuda_ms(lambda: traverse.anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone()), 3, 10),
        plain_ms=cuda_ms(lambda: traverse.anyhit_sweep_ref(ts, srays, RAY_TMIN, tmax, occ0.clone()), 1, 2),
        shape=list(srays.shape),
        bound=sweep_bound(counts, anyhit_lane_bytes(tmax, occ0, ok_, RAY_TMIN), whole),
        work=walk_work(counts, live))
    print(f"anyhit  {list(srays.shape)}: occ exact, occluded {occ_frac:.3f}; plain "
          f"walk per live ray: {counts['nodes'] / live:.1f} node visits, "
          f"{counts['tests'] / live:.1f} triangle tests", flush=True)

    compare_perlane(ts, rays, win, st0, sk_, srays, tmax, occ0, ok_, res)

    # the closest kernels alone on the full primary wave, and K7 there
    full_win = torch.where(act, RAY_TMAX, 0.0).float()
    full_st = traverse.make_trace_state(full_win)
    res["closest_sweep"]["full_wave_ms"] = cuda_ms_fresh(
        lambda st: traverse.closest_sweep(ts, rk, RAY_TMIN, st), full_st.clone, 1, 3)
    sched = perlane.prepass(ts, rk, full_win, RAY_TMIN, "origin")
    k1 = perlane.launch_closest(ts, rk, RAY_TMIN, full_st.clone(), sched)
    k10 = traverse.closest_sweep(ts, rk, RAY_TMIN, full_st.clone())
    ties = exact_ties(ts, rk, full_win, k1, k10)
    print(f"perlane_closest_sweep vs closest_sweep on the full primary wave: "
          f"{differing_lanes(k1, k10)}; exact ties {ties}", flush=True)
    check([tuple(t["lane"]) for t in ties] == EXACT_TIES,
          f"K1 and K10a differ on exactly the known tied lanes {EXACT_TIES}")
    res["perlane_closest_sweep"]["full_wave_ties"] = ties
    res["perlane_closest_sweep"]["full_wave_ms"] = cuda_ms_fresh(
        lambda st: perlane.launch_closest(ts, rk, RAY_TMIN, st, sched), full_st.clone,
        1, 3)
    res["perlane_closest_sweep"]["full_wave_prepass_ms"] = cuda_ms(
        lambda: perlane.prepass(ts, rk, full_win, RAY_TMIN, "origin"), 1, 3)
    # the shadow kernels alone on the shadow rays of K10a's hits there
    srays_f, tmax_f = shadow_rays(ts, rk, k10)
    del k1, k10
    compare_block_stats(ts, rk, full_win, srays_f, tmax_f, res)
    occ_f = torch.zeros(tmax_f.shape, dtype=torch.int32, device=dev)
    ssched = perlane.prepass(ts, srays_f, tmax_f, RAY_TMIN, "light")
    k2 = perlane.launch_anyhit(ts, srays_f, RAY_TMIN, tmax_f, occ_f.clone(), ssched)
    k10b = traverse.anyhit_sweep(ts, srays_f, RAY_TMIN, tmax_f, occ_f.clone())
    check(torch.equal(k2, k10b),
          "perlane_anyhit_sweep's occlusion equals anyhit_sweep's on the full "
          "primary wave's shadow rays")
    check(torch.equal(k10b, traverse.anyhit_sweep_ref(ts, srays_f, RAY_TMIN, tmax_f,
                                                      occ_f.clone())),
          "anyhit_sweep's occlusion equals its plain version's on the full primary "
          "wave's shadow rays")
    print(f"perlane_anyhit_sweep vs anyhit_sweep, and anyhit_sweep vs its plain "
          f"version, on the full primary wave's shadow rays: occlusion equal, "
          f"occluded {float((k2 != 0).float().mean()):.3f}", flush=True)
    for name, fn in (("perlane_anyhit_sweep", lambda occ: perlane.launch_anyhit(
                         ts, srays_f, RAY_TMIN, tmax_f, occ, ssched)),
                     ("anyhit_sweep", lambda occ: traverse.anyhit_sweep(
                         ts, srays_f, RAY_TMIN, tmax_f, occ))):
        res[name]["full_wave_ms"] = cuda_ms_fresh(fn, occ_f.clone, 1, 3)
    del k2, ssched, occ_f
    compare_meshwalk(ts, rays, win, srays, tmax, rk, act, (srays_f, tmax_f, k10b), res)
    del k10b, srays_f, tmax_f
    attributes = {**perlane.kernel_attributes(), **traverse.kernel_attributes()}
    for name, attrs in attributes.items():
        res[name]["attributes"] = attrs
        print(f"{name}: {attrs['registers']} registers and {attrs['local_bytes']} "
              f"local bytes a thread, {attrs['ctas_per_sm']} CTAs of 256 resident "
              f"per SM ({attrs['ctas_per_sm'] * 256 / 2048:.1%} occupancy)", flush=True)
    print(f"kernel resources (cuobjdump -res-usage): {kernel_resources()}", flush=True)
    compare_epilogue(r, rk, full_st, act, s_row, res, gpu)
    for name, v in res.items():
        print(f"time {name:21s} kernel {v['ms']:.4f} ms  plain {v['plain_ms']:.4f} ms"
              f"  bound {v['bound'][0]:.4f} ms ({v['bound'][1]})  shape {v['shape']}"
              f"  [{gpu}]", flush=True)
    for name in CHAINED + PER_LANE[1:]:
        v = res[name]
        print(f"time {name} full primary wave {list(rk.shape)}"
              f"{' (shadow rays)' if 'anyhit' in name else ''}: "
              f"{v['full_wave_ms']:.4f} ms [{gpu}]", flush=True)
    v = res["mesh_closest"]
    print(f"time closest_hit_loop (K11a per entry, the loop's PyTorch glue) full "
          f"primary wave {list(rk.shape)}: {v['full_wave_ms']:.4f} ms; closest_hit_wave "
          f"on K10a: {v['full_wave_chained_ms']:.4f} ms; K11a alone over both "
          f"entries: {v['full_wave_kernel_ms']:.4f} ms [{gpu}]", flush=True)
    v = res["mesh_anyhit"]
    print(f"time any_hit_loop (K11b per entry, the loop's PyTorch glue) full primary "
          f"wave's shadow rays {list(rk.shape)}: {v['full_wave_ms']:.4f} ms; K11b "
          f"alone over both entries: {v['full_wave_kernel_ms']:.4f} ms [{gpu}]",
          flush=True)
    for name in PER_LANE[1:]:
        print(f"time {name} prepass (one K7 launch with the schedule) on the "
              f"slice: {res[name]['prepass_ms']:.4f} ms [{gpu}]", flush=True)
    print(f"time perlane_closest_sweep prepass on the full primary wave: "
          f"{res['perlane_closest_sweep']['full_wave_prepass_ms']:.4f} ms [{gpu}]",
          flush=True)
    return res


def compare_block_stats(ts, rk, win, srays, tmax, res) -> None:
    """K7, the prepass's one launch (``mega.block_schedule``), on the full
    primary wave in both entry orders and on the shadow rays of its hits in
    both, against the plain prepass of the same rays on the CPU
    (``chunk_block_hits`` and ``entry_perm``): bits, octants, entry rows
    and all 17 stats columns bit for bit, the "origin" keys (mean entry
    depths) within 1e-6 relative and the "light" keys exact. K7's time is
    the "origin" launch on the primary wave (its device time, from the
    profiler), its bound that launch's bytes."""
    import torch
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops import mega, perlane

    cpu = ts.to("cpu")
    lo, hi = mega.world_root_boxes(cpu)
    lp = cpu.light_pos
    light_keys = (torch.minimum(torch.maximum(lp, lo), hi) - lp).square().sum(dim=1)
    for what, x, w in (("primary wave", rk, win), ("its shadow rays", srays, tmax)):
        xc, wc = x.cpu(), w.cpu()
        stats = mega.block_stats_ref(xc, wc, RAY_TMIN)
        _, _, depth = mega.chunk_block_hits(cpu, xc, wc, RAY_TMIN)
        for order in mega.ORDERS:
            got = mega.block_schedule(ts, x, w, RAY_TMIN, order)
            want = perlane.plain_prepass(cpu, xc, wc, RAY_TMIN, order)
            for name, g, v in zip(("bits", "octs", "entries"), got, want):
                check(torch.equal(g.cpu(), v), f"block_schedule {name} ({order}, "
                      f"{what}) equal the plain prepass's")
            check(torch.equal(got.stats.cpu().view(torch.int32), stats.view(torch.int32)),
                  f"block_schedule ({order}, {what}): all 17 stats columns equal "
                  f"the plain version's bit for bit")
            if order == "origin":
                check(bool(torch.allclose(got.keys.cpu(), depth, rtol=1e-6, atol=0)),
                      f"block_schedule ({what}): mean entry depths within 1e-6")
            else:
                check(torch.equal(got.keys.cpu(), light_keys),
                      f"block_schedule ({what}): light keys exact")
        n_live = int(stats[:, 16].sum().item())
        check(n_live == int((w > RAY_TMIN).sum().item()),
              f"block_schedule counts the live lanes of the {what}")
        print(f"block_schedule {list(x.shape)}, {what}: bits, octants, entry rows and "
              f"stats rows equal the plain prepass's in both orders, {n_live} live "
              f"lanes", flush=True)

    got = mega.block_schedule(ts, rk, win, RAY_TMIN, "origin")
    e, pb = got.bits.shape[0], got.octs.shape[0]
    n = rk[0].numel()
    warm_card()
    res["block_stats"] = dict(
        max_abs_err=0.0,
        ms=device_ms(lambda: mega.block_schedule(ts, rk, win, RAY_TMIN, "origin"), 10),
        light_ms=device_ms(lambda: mega.block_schedule(ts, rk, win, RAY_TMIN, "light"),
                           10),
        shadow_ms=device_ms(lambda: mega.block_schedule(ts, srays, tmax, RAY_TMIN,
                                                        "light"), 10),
        plain_ms=cuda_ms(lambda: perlane.plain_prepass(ts, rk, win, RAY_TMIN, "origin"),
                         1, 3),
        shape=list(rk.shape),
        # rays 24 B and the window 4 B a lane in; the stats rows, octants,
        # bit words and entry rows out; enter (E, PB) f32 written once and
        # read twice ("origin": the mean depth, then the bits)
        bound=bound(nbytes(rk, win, *got[:4]) + 3 * 4 * e * pb,
                    OPS_PER_LANE["block_stats"] * n))
    print(f"block_schedule device ms: origin {res['block_stats']['ms']:.4f}, light "
          f"{res['block_stats']['light_ms']:.4f} on the primary wave, light "
          f"{res['block_stats']['shadow_ms']:.4f} on its shadow rays ({e} entries, "
          f"{pb} blocks)", flush=True)


def prepass_ops(fn, label: str) -> dict:
    """What one call of ``fn`` (a prepass, after a first call) dispatches:
    the hand-written kernels it launches (``_build``'s launch counts), and
    from torch.profiler the PyTorch ops the host dispatches (top-level
    ``aten::`` calls, views included) and the kernels and memsets the
    device runs (the spans' annotations left out). The profiler records a
    warm-up call before the one it keeps: a profile of a single call has
    been seen to hold no device row for a K7 that ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from raytpu_torch import _build

    fn()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    launches = {k: n // 2 for k, n in _build.launch_counts().items() if n}
    _build.reset_launch_counts()
    events = prof.events()
    ops = sum(1 for e in events if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    device = [e.name for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("rt.")]
    kernels = [n for n in device if "memset" not in n.lower()]
    print(f"prepass ({label}): launches {launches}, {ops} PyTorch ops dispatched "
          f"(allocation and views), {len(device)} device kernels and memsets "
          f"{device}", flush=True)
    check(launches == {"block_stats": 1}
          and all("block_stats_kernel" in n for n in kernels),
          f"the {label} prepass is one K7 launch and no PyTorch kernel")
    return {"launches": launches, "torch_ops": ops, "device_kernels": len(device)}


def compare_perlane(ts, rays, win, st0, k10a, srays, tmax, occ0, k10b,
                    res) -> None:
    """K1 and K2 on the sweep slice: against their plain versions and
    against K10a/K10b's results on the same rays, bit for bit; the node
    visits and triangle tests of the plain walks; times of the kernels
    alone and of their prepass."""
    import torch
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops import perlane

    sched = perlane.prepass(ts, rays, win, RAY_TMIN, "origin")
    k1 = perlane.launch_closest(ts, rays, RAY_TMIN, st0.clone(), sched)
    work = {"rows": {}}
    p1 = perlane.perlane_closest_sweep_ref(ts, rays, RAY_TMIN, st0.clone(), counts=work)
    wrapped = perlane.perlane_closest_sweep(ts, rays, RAY_TMIN, st0.clone())
    for other, what in ((p1, "its plain version"), (k10a, "closest_sweep (K10a)"),
                        (wrapped, "its wrapper's launch")):
        check(torch.equal(k1.view(torch.int32), other.view(torch.int32)),
              f"perlane_closest_sweep equals {what} bit for bit "
              f"({differing_lanes(k1, other)})")
    live = int((win > RAY_TMIN).sum().item())
    res["perlane_closest_sweep"] = dict(
        max_abs_err=(k1 - p1)[[0, 4, 5, 6, 7, 8]].abs().max().item(),
        ms=cuda_ms(lambda: perlane.launch_closest(ts, rays, RAY_TMIN, st0.clone(), sched),
                   3, 10),
        prepass_ms=cuda_ms(lambda: perlane.prepass(ts, rays, win, RAY_TMIN, "origin"),
                           3, 10),
        plain_ms=cuda_ms(lambda: perlane.perlane_closest_sweep_ref(
            ts, rays, RAY_TMIN, st0.clone()), 1, 2),
        shape=list(rays.shape),
        bound=sweep_bound(work, closest_lane_bytes(st0, k1, RAY_TMIN),
                          nbytes(ts.w2o, *sched)),
        work=walk_work(work, live))
    res["perlane_closest_sweep"]["prepass_ops"] = prepass_ops(
        lambda: perlane.prepass(ts, rays, win, RAY_TMIN, "origin"), "closest")
    print(f"perlane_closest {list(rays.shape)}: bit for bit equal to its plain version "
          f"and to closest_sweep; plain walk per live ray: {work['nodes'] / live:.1f} "
          f"node visits, {work['tests'] / live:.1f} triangle tests", flush=True)

    sched = perlane.prepass(ts, srays, tmax, RAY_TMIN, "light")
    k2 = perlane.launch_anyhit(ts, srays, RAY_TMIN, tmax, occ0.clone(), sched)
    work = {"rows": {}}
    p2 = perlane.perlane_anyhit_sweep_ref(ts, srays, RAY_TMIN, tmax, occ0.clone(),
                                          counts=work)
    wrapped = perlane.perlane_anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone())
    for other, what in ((p2, "its plain version"), (k10b, "anyhit_sweep (K10b)"),
                        (wrapped, "its wrapper's launch")):
        check(torch.equal(k2, other), f"perlane_anyhit_sweep occlusion equals {what}")
    live = int((tmax > RAY_TMIN).sum().item())
    res["perlane_anyhit_sweep"] = dict(
        max_abs_err=(k2 - p2).abs().max().item(),
        ms=cuda_ms(lambda: perlane.launch_anyhit(ts, srays, RAY_TMIN, tmax, occ0.clone(),
                                                 sched), 3, 10),
        prepass_ms=cuda_ms(lambda: perlane.prepass(ts, srays, tmax, RAY_TMIN, "light"),
                           3, 10),
        plain_ms=cuda_ms(lambda: perlane.perlane_anyhit_sweep_ref(
            ts, srays, RAY_TMIN, tmax, occ0.clone()), 1, 2),
        shape=list(srays.shape),
        bound=sweep_bound(work, anyhit_lane_bytes(tmax, occ0, k2, RAY_TMIN),
                          nbytes(ts.w2o, *sched)),
        work=walk_work(work, live))
    res["perlane_anyhit_sweep"]["prepass_ops"] = prepass_ops(
        lambda: perlane.prepass(ts, srays, tmax, RAY_TMIN, "light"), "shadow")
    print(f"perlane_anyhit {list(srays.shape)}: occ equal to its plain version and to "
          f"anyhit_sweep; plain walk per live ray: {work['nodes'] / live:.1f} node "
          f"visits, {work['tests'] / live:.1f} triangle tests", flush=True)


def tree_digest(arrays) -> str:
    """sha256 of a tree's ``(aabb_min (M, 3) f32, aabb_max, tri_first (M,)
    int32, tri_count, miss, tri_order (T,) int32)`` numpy arrays, in that
    order (:data:`TREE_DIGEST`)."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def first_tree(ts):
    """The first entry's tree of ``ts`` (the config4 stand-in's teapot,
    whose prims start at 0) as :func:`tree_digest` takes it."""
    _, _, nb, nc, tb = ts.entry_rows[0]
    end = ts.entry_rows[1][4] if len(ts.entry_rows) > 1 else ts.bvh_tri_v0.shape[0]
    return tuple(a.contiguous().cpu().numpy() for a in (
        ts.bvh_aabb_min[nb:nb + nc], ts.bvh_aabb_max[nb:nb + nc],
        ts.bvh_tri_first[nb:nb + nc], ts.bvh_tri_count[nb:nb + nc],
        ts.bvh_miss[nb:nb + nc], ts.bvh_tri_prim[tb:end]))


def mesh_walk_inputs(ts, rays, win, walk):
    """What the loop hands the one-mesh walk ``walk`` (K11a's or K11b's
    wrapper) per entry of ``ts``: ``(mesh, object-space rays, window)``, the
    window narrowing from entry to entry as in the loop (closest walks; for
    occlusion, occluded lanes close)."""
    import torch
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops import trace

    out = []
    for inst, _mat, nb, nc, tb in ts.entry_rows:
        obj = trace.object_space(ts, inst, tuple(rays[:3]), tuple(rays[3:]))
        out.append(((nb, nc, tb), obj, win))
        res = walk(ts, (nb, nc, tb), obj, RAY_TMIN, win)
        if isinstance(res, tuple):
            win = torch.where((res[1] >= 0) & (res[0] < win), res[0], win)
        else:
            win = torch.where(res, 0.0, win)
    return out


def mesh_walks(ts, inputs, walk, **kw):
    """``walk`` on each entry's inputs (:func:`mesh_walk_inputs`)."""
    from raytpu_torch.config import RAY_TMIN

    return [walk(ts, mesh, obj, RAY_TMIN, win, **kw) for mesh, obj, win in inputs]


def mesh_lane_bytes(inputs, per_lane: int) -> int:
    """What the one-mesh walks' lanes must move over the entries: the
    window and the outputs (``per_lane`` bytes) of every lane, the rays of
    the live ones."""
    from raytpu_torch.config import RAY_TMIN

    return sum(per_lane * w.numel() + 24 * int((w > RAY_TMIN).sum())
               for _, _, w in inputs)


def compare_meshwalk(ts, rays, win, srays, tmax, rk, act, shadow_wave,
                     res) -> None:
    """K11a and K11b, the one-mesh walks of the per-(instance, mesh) loop:

    * on the sweep slice moved to each entry's object space (both entries
      of config4), and on the shadow rays of the slice: against their plain
      versions, bit for bit; the kernels alone timed over both entries (one
      sweep of the loop); the bound from the work of each lane walking
      alone, as K10a's and K10b's lanes walk (the plain walks with
      ``consensus=0``), the warps' votes beside it in ``work``;
    * the loop (``trace.closest_hit_loop`` on K11a) on the whole primary
      wave against K10a's chained sweep: valid and inst equal on every
      lane, mat, t, u, v and the normal bit for bit, but for lanes proven
      exact ties (:func:`loop_ties`); K11a alone over both entries of the
      whole wave timed;
    * ``shadow_wave`` = (rays, window, K10b's flags) of the whole primary
      wave's shadow rays: K11b against its plain version on each entry's
      inputs, the loop (``trace.any_hit_loop`` on K11b) against K10b's
      flags, every lane; K11b alone over both entries, and the loop,
      timed."""
    import functools

    import torch
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.ops import trace, traverse

    live = int((win > RAY_TMIN).sum())
    counts = {"rows": {}}
    inputs = mesh_walk_inputs(ts, rays, win, traverse.mesh_closest)
    got = mesh_walks(ts, inputs, traverse.mesh_closest)
    want = mesh_walks(ts, inputs, traverse.mesh_closest_ref, counts=counts)
    err = 0.0
    for e, (a, b) in enumerate(zip(got, want)):
        for x, y in zip((*a[:4], *a[4]), (*b[:4], *b[4])):
            check(torch.equal(x.view(torch.int32), y.view(torch.int32)),
                  f"mesh_closest equals its plain version bit for bit (entry {e})")
            if x.dtype == torch.float32:
                err = max(err, (x - y).abs().max().item())
    hit = sum(float((a[1] >= 0).float().mean()) for a in got)
    check(hit > 0.05, f"mesh_closest hits something on the slice ({hit})")
    alone = {"rows": {}}
    mesh_walks(ts, inputs, traverse.mesh_closest_ref, counts=alone, consensus=0)
    res["mesh_closest"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: mesh_walks(ts, inputs, traverse.mesh_closest),
                                    3, 10),
        plain_ms=cuda_ms(lambda: mesh_walks(ts, inputs, traverse.mesh_closest_ref),
                         1, 2),
        shape=list(rays.shape), entries=len(got),
        # per entry: the window in, the t, u, v, normal and slot planes out
        bound=sweep_bound(alone, mesh_lane_bytes(inputs, 32), 0),
        work=dict(walk_work(counts, live), alone=walk_work(alone, live)))
    print(f"mesh_closest {list(rays.shape)} x {len(got)} entries: bit for bit equal to "
          f"its plain version; per live ray, the warp's walk {counts['nodes'] / live:.1f} "
          f"node visits and {counts['tests'] / live:.1f} triangle tests, each lane alone "
          f"{alone['nodes'] / live:.1f} and {alone['tests'] / live:.1f} (the bound's)",
          flush=True)

    counts = {"rows": {}}
    slive = int((tmax > RAY_TMIN).sum())
    inputs = mesh_walk_inputs(ts, srays, tmax, traverse.mesh_anyhit)
    got = mesh_walks(ts, inputs, traverse.mesh_anyhit)
    want = mesh_walks(ts, inputs, traverse.mesh_anyhit_ref, counts=counts)
    alone = {"rows": {}}
    mesh_walks(ts, inputs, traverse.mesh_anyhit_ref, counts=alone, consensus=0)
    for e, (a, b) in enumerate(zip(got, want)):
        check(torch.equal(a, b), f"mesh_anyhit equals its plain version (entry {e})")
    occ = functools.reduce(torch.logical_or, got)
    check(torch.equal(occ, traverse.anyhit_sweep(
        ts, srays, RAY_TMIN, tmax, torch.zeros(tmax.shape, dtype=torch.int32,
                                               device=tmax.device)) != 0),
          "the loop's occlusion on K11b equals K10b's")
    res["mesh_anyhit"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: mesh_walks(ts, inputs, traverse.mesh_anyhit),
                                    3, 10),
        plain_ms=cuda_ms(lambda: mesh_walks(ts, inputs, traverse.mesh_anyhit_ref),
                         1, 2),
        shape=list(srays.shape), entries=len(got),
        # per entry: the window in, the flag out
        bound=sweep_bound(alone, mesh_lane_bytes(inputs, 8), 0),
        work=dict(walk_work(counts, slive), alone=walk_work(alone, slive)))
    print(f"mesh_anyhit {list(srays.shape)} x {len(got)} entries: equal to its plain "
          f"version, the loop's occlusion equal to K10b's, occluded "
          f"{float(occ.float().mean()):.3f}; per live ray, the warp's walk "
          f"{counts['nodes'] / slive:.1f} node visits and {counts['tests'] / slive:.1f} "
          f"triangle tests, each lane alone {alone['nodes'] / slive:.1f} and "
          f"{alone['tests'] / slive:.1f} (the bound's)", flush=True)

    # the loop against K10a on the whole primary wave
    full_win = torch.where(act, RAY_TMAX, 0.0).float()
    o, d = tuple(rk[:3]), tuple(rk[3:])
    slots_l = torch.full(act.shape, -1, dtype=torch.long, device=act.device)
    loop = trace.closest_hit_loop(ts, o, d, RAY_TMIN, full_win,
                                  walk=traverse.mesh_closest, slots=slots_l)
    chained = trace.closest_hit_wave(ts, o, d, RAY_TMIN, full_win)
    ties = loop_ties(ts, rk, full_win, loop, slots_l, chained)
    res["mesh_closest"]["full_wave_ties"] = ties
    res["mesh_closest"]["full_wave_ms"] = cuda_ms(
        lambda: trace.closest_hit_loop(ts, o, d, RAY_TMIN, full_win), 1, 3)
    res["mesh_closest"]["full_wave_chained_ms"] = cuda_ms(
        lambda: trace.closest_hit_wave(ts, o, d, RAY_TMIN, full_win), 1, 3)
    inputs = mesh_walk_inputs(ts, rk, full_win, traverse.mesh_closest)
    res["mesh_closest"]["full_wave_kernel_ms"] = cuda_ms_fresh(
        lambda _: mesh_walks(ts, inputs, traverse.mesh_closest), lambda: None, 1, 3)
    del loop, chained, slots_l, inputs

    # K11b and the loop on it against K10b, the whole wave's shadow rays
    srays_f, tmax_f, k10b = shadow_wave
    inputs = mesh_walk_inputs(ts, srays_f, tmax_f, traverse.mesh_anyhit)
    got = mesh_walks(ts, inputs, traverse.mesh_anyhit)
    want = mesh_walks(ts, inputs, traverse.mesh_anyhit_ref)
    for e, (a, b) in enumerate(zip(got, want)):
        check(torch.equal(a, b), f"mesh_anyhit equals its plain version on the full "
              f"primary wave's shadow rays (entry {e})")
    so, sd = tuple(srays_f[:3]), tuple(srays_f[3:])
    check(torch.equal(trace.any_hit_loop(ts, so, sd, RAY_TMIN, tmax_f), k10b != 0),
          "the loop's occlusion on K11b equals K10b's on the full primary wave's "
          "shadow rays")
    print(f"mesh_anyhit {list(srays_f.shape)} x {len(got)} entries, the full primary "
          f"wave's shadow rays: equal to its plain version, the loop's occlusion "
          f"equal to K10b's on every lane", flush=True)
    del got, want
    res["mesh_anyhit"]["full_wave_kernel_ms"] = cuda_ms_fresh(
        lambda _: mesh_walks(ts, inputs, traverse.mesh_anyhit), lambda: None, 1, 3)
    res["mesh_anyhit"]["full_wave_ms"] = cuda_ms(
        lambda: trace.any_hit_loop(ts, so, sd, RAY_TMIN, tmax_f), 1, 3)


def loop_ties(ts, rk, win, loop, slots_l, chained) -> list:
    """The lanes where the loop's hit wave ``loop`` (its BVH slots
    ``slots_l``) and K10a's ``chained`` (both of the rays ``rk`` in the
    window ``win``) differ, each shown to be an exact tie: both valid with
    the same instance and the same t bits, two different triangles (K10a's
    from the plain walk of the lane's packet, which must reproduce K10a's
    hit there), each hit by the lane's object-space ray at exactly that t.
    Everywhere else valid, inst, mat, t, u, v and the normal are equal, bit
    for bit, which leaves no room for another triangle but a tie."""
    import functools

    import torch
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops import trace, traverse
    from raytpu_torch.ops.intersect import moller_trumbore

    def planes(h):
        return (h.t, h.u, h.v, *h.n, h.mat)

    check(torch.equal(loop.valid, chained.valid), "loop and K10a: valid equal on every lane")
    check(torch.equal(loop.inst, chained.inst), "loop and K10a: inst equal on every lane")
    check(bool(loop.valid.any()), "the loop hits something on the primary wave")
    diff = functools.reduce(torch.logical_or, [
        a.view(torch.int32) != b.view(torch.int32)
        for a, b in zip(planes(loop), planes(chained))])
    ties = []
    for p, k in diff.nonzero().tolist():
        lane = f"lane (packet {p}, {k})"
        check(bool(loop.valid[p, k]) and loop.t[p, k].view(torch.int32)
              == chained.t[p, k].view(torch.int32),
              f"{lane}: the loop and K10a differ, and not as an exact tie")
        slot_c = torch.full((1, rk.shape[2]), -1, dtype=torch.long, device=rk.device)
        plain = trace.closest_hit_wave(
            ts, tuple(rk[:3, p:p + 1]), tuple(rk[3:, p:p + 1]), RAY_TMIN,
            win[p:p + 1], functools.partial(traverse.closest_sweep_ref, slots=slot_c))
        check(all(torch.equal(a[0, k].view(torch.int32), b[p, k].view(torch.int32))
                  for a, b in zip(planes(plain), planes(chained))),
              f"{lane}: the plain walk reproduces K10a's hit")
        check(int(slots_l[p, k]) != int(slot_c[0, k]), f"{lane}: two different triangles")
        inst = int(loop.inst[p, k])
        _, o, d, _ = traverse._object_rays(
            ts, inst, tuple(rk[c, p, k:k + 1] for c in range(3)),
            tuple(rk[3 + c, p, k:k + 1] for c in range(3)))
        prims = {}
        for name, slot in (("loop", int(slots_l[p, k])), ("K10a", int(slot_c[0, k]))):
            tri = [tuple(x[slot:slot + 1, c] for c in range(3))
                   for x in (ts.bvh_tri_v0, ts.bvh_tri_e1, ts.bvh_tri_e2)]
            t, _, _, hit = moller_trumbore(o, d, *tri, RAY_TMIN,
                                           torch.full_like(o[0], float("inf")))
            check(bool(hit[0]) and t.view(torch.int32)[0] == loop.t[p, k].view(torch.int32),
                  f"{lane}: {name}'s triangle is hit at exactly t")
            prims[name] = int(ts.bvh_tri_prim[slot])
        ties.append({"lane": [p, k], "t": float(loop.t[p, k]), "inst": inst,
                     "prims": prims})
    print(f"closest_hit_loop (K11a) vs closest_sweep (K10a) on the full primary wave "
          f"{list(rk.shape)}: valid, inst equal on every lane; {len(ties)} lanes "
          f"differ, each a proven exact tie: {ties}", flush=True)
    return ties


def primary_wave(r):
    """The raygen kernel's folded primary wave of ``r``'s frame and its
    in-frame lanes: ``(rays (6, P, K), act (P, K))``."""
    import torch
    from raytpu_torch.integrator import tiled_pixels
    from raytpu_torch.ops import raygen

    rs, dev = r.render_static, r.device
    spp = rs.samples_per_pixel
    (px, py), in_frame = tiled_pixels(rs, dev)
    s_row = torch.arange(spp, dtype=torch.float32, device=dev).repeat(px.shape[0])
    rays = raygen.raygen_packed(r.camera_tensor(), s_row, px.repeat_interleave(spp, 0),
                                py.repeat_interleave(spp, 0), spp, rs.width, rs.height)
    return rays, in_frame.repeat_interleave(spp, 0)


def compare_consensus(r, label: str, gpu: str, whole_plain: bool = False):
    """K8 and K9 on the primary wave of the consensus-tier stand-in ``r``
    (the raygen kernel's rays, shadow rays from K8's hits toward the
    light):

    * on a ``SWEEP_PACKETS`` slice: against their plain versions and their
      wrappers' launches, bit for bit; the plain walks' work (K8's, warps
      over the wide links, beside K1's, lanes over the octant links); the
      kernels alone timed beside K1/K2 and K10a/K10b;
    * on the whole wave: against K1/K2 and K10a/K10b, where only proven
      exact ties may differ (:func:`exact_ties`), exactly those pinned in
      ``CONSENSUS_TIES[label]``; with ``whole_plain`` also against their
      plain versions, bit for bit; timed beside them.

    Returns the two kernels' results (with their registers, local bytes
    and resident CTAs) and the tied lanes."""
    import torch
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.ops import consensus, perlane, traverse

    ts = r.tscene
    rk, act = primary_wave(r)
    idx = torch.tensor(sweep_slice(r.render_static, SWEEP_PACKETS), device=r.device)
    rays = rk[:, idx].contiguous()
    win = torch.where(act[idx], RAY_TMAX, 0.0).float().contiguous()
    st0 = traverse.make_trace_state(win)
    res = {}

    def timed(k8, k1, k10):
        return dict(ms=cuda_ms(k8, 3, 10), perlane_ms=cuda_ms(k1, 3, 10),
                    chained_ms=cuda_ms(k10, 3, 10))

    sched = perlane.prepass(ts, rays, win, RAY_TMIN, "origin")
    k8 = consensus.launch_closest(ts, rays, RAY_TMIN, st0.clone(), sched)
    work, work1 = {"rows": {}}, {"rows": {}}
    p8 = consensus.mega_closest_sweep_ref(ts, rays, RAY_TMIN, st0.clone(), counts=work)
    perlane.perlane_closest_sweep_ref(ts, rays, RAY_TMIN, st0.clone(), counts=work1)
    wrapped = consensus.mega_closest_sweep(ts, rays, RAY_TMIN, st0.clone())
    for other, what in ((p8, "its plain version"), (wrapped, "its wrapper's launch")):
        check(torch.equal(k8.view(torch.int32), other.view(torch.int32)),
              f"{label}: mega_closest_sweep equals {what} bit for bit "
              f"({differing_lanes(k8, other)})")
    hit_frac = (k8[traverse.ST_VALID].view(torch.int32) != 0).float().mean().item()
    check(hit_frac > 0.05, f"{label}: the closest slice hits something ({hit_frac})")
    live = int((win > RAY_TMIN).sum().item())
    res["mega_closest_sweep"] = dict(
        max_abs_err=(k8 - p8)[[0, 4, 5, 6, 7, 8]].abs().max().item(),
        **timed(lambda: consensus.launch_closest(ts, rays, RAY_TMIN, st0.clone(), sched),
                lambda: perlane.launch_closest(ts, rays, RAY_TMIN, st0.clone(), sched),
                lambda: traverse.closest_sweep(ts, rays, RAY_TMIN, st0.clone())),
        plain_ms=cuda_ms(lambda: consensus.mega_closest_sweep_ref(
            ts, rays, RAY_TMIN, st0.clone()), 1, 2),
        shape=list(rays.shape),
        bound=sweep_bound(work, closest_lane_bytes(st0, k8, RAY_TMIN),
                          nbytes(ts.w2o, *sched)),
        work=walk_work(work, live), perlane_work=walk_work(work1, live))

    srays, tmax = shadow_rays(ts, rays, k8)
    occ0 = torch.zeros(tmax.shape, dtype=torch.int32, device=r.device)
    ssched = perlane.prepass(ts, srays, tmax, RAY_TMIN, "light")
    k9 = consensus.launch_anyhit(ts, srays, RAY_TMIN, tmax, occ0.clone(), ssched)
    work, work2 = {"rows": {}}, {"rows": {}}
    p9 = consensus.mega_anyhit_sweep_ref(ts, srays, RAY_TMIN, tmax, occ0.clone(),
                                         counts=work)
    perlane.perlane_anyhit_sweep_ref(ts, srays, RAY_TMIN, tmax, occ0.clone(),
                                     counts=work2)
    wrapped = consensus.mega_anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone())
    for other, what in ((p9, "its plain version"), (wrapped, "its wrapper's launch")):
        check(torch.equal(k9, other), f"{label}: mega_anyhit_sweep equals {what}")
    occ_frac = (k9 != 0).float().mean().item()
    slive = int((tmax > RAY_TMIN).sum().item())
    res["mega_anyhit_sweep"] = dict(
        max_abs_err=(k9 - p9).abs().max().item(),
        **timed(lambda: consensus.launch_anyhit(ts, srays, RAY_TMIN, tmax, occ0.clone(),
                                                ssched),
                lambda: perlane.launch_anyhit(ts, srays, RAY_TMIN, tmax, occ0.clone(),
                                              ssched),
                lambda: traverse.anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone())),
        plain_ms=cuda_ms(lambda: consensus.mega_anyhit_sweep_ref(
            ts, srays, RAY_TMIN, tmax, occ0.clone()), 1, 2),
        shape=list(srays.shape),
        bound=sweep_bound(work, anyhit_lane_bytes(tmax, occ0, k9, RAY_TMIN),
                          nbytes(ts.w2o, *ssched)),
        work=walk_work(work, slive), perlane_work=walk_work(work2, slive))
    for name, what in (("mega_closest_sweep", f"hit {hit_frac:.3f}"),
                       ("mega_anyhit_sweep", f"occluded {occ_frac:.3f}")):
        v = res[name]
        n = v["work"]["rays"]
        print(f"{label} {name} {v['shape']}: bit for bit equal to its plain version "
              f"and its wrapper, {what}; per live ray, plain consensus walk over the "
              f"wide links {v['work']['nodes'] / n:.1f} node visits and "
              f"{v['work']['tests'] / n:.1f} triangle tests, plain per-lane walk over "
              f"the octant links {v['perlane_work']['nodes'] / n:.1f} and "
              f"{v['perlane_work']['tests'] / n:.1f}; kernel {v['ms']:.4f} ms, per-lane "
              f"{v['perlane_ms']:.4f} ms, chained {v['chained_ms']:.4f} ms, plain "
              f"{v['plain_ms']:.4f} ms, bound {v['bound'][0]:.4f} ms ({v['bound'][1]}) "
              f"[{gpu}]", flush=True)

    # the whole primary wave
    full_win = torch.where(act, RAY_TMAX, 0.0).float()
    full_st = traverse.make_trace_state(full_win)
    fsched = perlane.prepass(ts, rk, full_win, RAY_TMIN, "origin")
    k8 = consensus.launch_closest(ts, rk, RAY_TMIN, full_st.clone(), fsched)
    if whole_plain:
        p8 = consensus.mega_closest_sweep_ref(ts, rk, RAY_TMIN, full_st.clone())
        check(torch.equal(k8.view(torch.int32), p8.view(torch.int32)),
              f"{label}: mega_closest_sweep equals its plain version bit for bit on "
              f"the whole primary wave ({differing_lanes(k8, p8)})")
        del p8
    k1 = perlane.launch_closest(ts, rk, RAY_TMIN, full_st.clone(), fsched)
    k10 = traverse.closest_sweep(ts, rk, RAY_TMIN, full_st.clone())
    ties = {}
    for name, other in (("K1", k1), ("K10a", k10)):
        found = exact_ties(ts, rk, full_win, k8, other, ("K8", name))
        print(f"{label} mega_closest_sweep vs {name} on the full primary wave "
              f"{list(rk.shape)}: {differing_lanes(k8, other)}; exact ties {found}",
              flush=True)
        pinned = CONSENSUS_TIES[label][name]
        check([tuple(t["lane"]) for t in found] == pinned,
              f"{label}: K8 and {name} differ on exactly the known tied lanes "
              f"{pinned}")
        ties[name] = found
    res["mega_closest_sweep"]["full_wave"] = timed(
        lambda: consensus.launch_closest(ts, rk, RAY_TMIN, full_st.clone(), fsched),
        lambda: perlane.launch_closest(ts, rk, RAY_TMIN, full_st.clone(), fsched),
        lambda: traverse.closest_sweep(ts, rk, RAY_TMIN, full_st.clone()))
    srays, tmax = shadow_rays(ts, rk, k8)
    occ0 = torch.zeros(tmax.shape, dtype=torch.int32, device=r.device)
    fss = perlane.prepass(ts, srays, tmax, RAY_TMIN, "light")
    k9 = consensus.launch_anyhit(ts, srays, RAY_TMIN, tmax, occ0.clone(), fss)
    others = [(perlane.launch_anyhit(ts, srays, RAY_TMIN, tmax, occ0.clone(), fss), "K2"),
              (traverse.anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone()), "K10b")]
    if whole_plain:
        others.append((consensus.mega_anyhit_sweep_ref(ts, srays, RAY_TMIN, tmax,
                                                       occ0.clone()), "its plain version"))
    for other, what in others:
        check(torch.equal(k9, other),
              f"{label}: K9's occlusion equals {what}'s on the full primary wave")
    del others
    if whole_plain:
        print(f"{label} mega_closest_sweep and mega_anyhit_sweep vs their plain versions "
              f"on the whole primary wave {list(rk.shape)}: bit for bit, occluded "
              f"{float((k9 != 0).float().mean()):.3f}", flush=True)
    res["mega_anyhit_sweep"]["full_wave"] = timed(
        lambda: consensus.launch_anyhit(ts, srays, RAY_TMIN, tmax, occ0.clone(), fss),
        lambda: perlane.launch_anyhit(ts, srays, RAY_TMIN, tmax, occ0.clone(), fss),
        lambda: traverse.anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone()))
    for name in CONSENSUS:
        v = res[name]["full_wave"]
        print(f"time {label} {name} full primary wave {list(rk.shape)}: kernel "
              f"{v['ms']:.4f} ms, per-lane {v['perlane_ms']:.4f} ms, chained "
              f"{v['chained_ms']:.4f} ms [{gpu}]", flush=True)
    for name, attrs in consensus.kernel_attributes().items():
        res[name]["attributes"] = attrs
        print(f"{name}: {attrs['registers']} registers and {attrs['local_bytes']} "
              f"local bytes a thread, {attrs['ctas_per_sm']} CTAs of 256 resident "
              f"per SM ({attrs['ctas_per_sm'] * 256 / 2048:.1%} occupancy)", flush=True)
    return res, ties


def render_frames(r, n_frames: int, t0: float, dt: float, label: str, gpu: str,
                  tier: str) -> dict:
    """Warm-up frame, then ``n_frames`` with advancing transforms, from the
    scene's initial pose (the spin accumulates over ``set_transforms``
    calls, so runs with the same arguments render the same frames). Each
    pose renders through ``render(stats=)`` (eager: its sweeps must take
    ``tier``; rays traced, host syncs) and then through the main path,
    ``render()`` (from the second frame of a shape on a replay of its CUDA
    graphs where ``graphs.graphable``), whose image must equal
    ``integrator.render_frame``'s at that pose bit for bit. The main path's
    frames give the frame ms and the launch counts (``launches``: summed
    over them, the counters reset just before each)."""
    import collections

    import torch
    from raytpu_torch import _build
    from raytpu_torch.integrator import render_frame
    from raytpu_torch.scene import AnimationState

    r.animation = AnimationState(r.scene.instances)
    r.set_transforms(t0)
    r.render()
    torch.cuda.synchronize()
    ms, rays, syncs = [], [], []
    launches = collections.Counter()
    for i in range(n_frames):
        r.set_transforms(t0 + dt * (i + 1))
        stats = {}
        r.render(stats=stats)
        check(stats["tier"] == tier, f"{label} frame {i} on the {tier} tier ({stats['tier']})")
        rays.append(sum(int(stats[k].item()) for k in ("closest_rays", "shadow_rays")
                        if k in stats))
        syncs.append(stats["host_syncs"])
        want = render_frame(r.tscene, r.render_static, r.camera_tensor())
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        start = time.perf_counter()
        img = r.render()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - start) * 1e3)
        launches.update(_build.launch_counts())
        check(bool(torch.isfinite(img).all()), f"{label} frame {i} finite")
        std = img.std().item()
        check(std > 1e-3, f"{label} frame {i} not constant (std {std})")
        check(torch.equal(img, want),
              f"{label} frame {i}: the main path's frame equals the eager frame bit for bit")
    med = statistics.median(ms)
    ray_med = int(statistics.median(rays))
    rs = r.render_static
    print(f"{label}: {rs.width}x{rs.height} spp {rs.samples_per_pixel} bounces "
          f"{rs.max_bounce_count} wavefront {rs.wavefront} tier {tier}: "
          f"frame ms {[round(x, 3) for x in ms]} median {med:.3f} ms (main path), rays "
          f"traced {ray_med}, {ray_med / med / 1e3:.2f} Mrays/s, host syncs per frame "
          f"{syncs} [{gpu}]", flush=True)
    return dict(tier=tier, frame_ms=ms, median_ms=med, rays=ray_med,
                mrays_per_s=ray_med / med / 1e3, host_syncs=syncs,
                launches={k: launches[k] for k in _build.launch_counts()})


def check_launches(counts: dict, label: str, idle, brute: bool = False) -> dict:
    """The launches of one path's frames: every kernel but those of the
    ``idle`` tier must have launched, those of ``idle`` never; the brute
    kernels count as idle unless ``brute`` (the frames include a scene
    with no BVH)."""
    if not brute:
        idle = tuple(idle) + BRUTE
    print(f"launches during {label}: {counts}", flush=True)
    for name, n in counts.items():
        if name in idle:
            check(n == 0, f"{name} not launched during the {label} ({n})")
        else:
            check(n > 0, f"{name} launched during the {label}")
    return counts


def standin_tiers(r, label: str, gpu: str, prof_dir: Path, n_tied: int):
    """A consensus-tier stand-in's default frames (they must launch K7,
    K8 and K9 and none of K1/K2/K10a/K10b), the same frames on the pallas
    tier (the same rays, and no pixel differing but for the ``n_tied``
    lanes proven exact ties), and one profiled frame of each, and of the
    per-lane tier. Returns the record and the default frames' launch
    counts."""
    from raytpu_torch import _build

    ts = r.tscene
    check((ts.traversal, ts.auto_tier) == ("auto", "mega"),
          f"{label} resolves to the consensus tier ({ts.traversal}, {ts.auto_tier})")
    mega = render_frames(r, 5, 0.0, 0.0, label, gpu, "mega")
    counts = mega["launches"]
    mega["launches"] = check_launches(counts, f"{label} frames",
                                      idle=CHAINED + PER_LANE[1:] + MESH + NEAREST)
    mega["profile"] = profile_frame(r, prof_dir / f"profile_{label}.txt", label, gpu)
    img = r.render()
    r.tscene = dataclasses.replace(ts, traversal="pallas")
    pal = render_frames(r, 5, 0.0, 0.0, f"{label}_pallas", gpu, "pallas")
    check(pal["rays"] == mega["rays"], f"{label}: both tiers trace the same rays")
    pal["launches"] = check_launches(pal["launches"],
                                     f"{label} pallas-tier frames",
                                     idle=PER_LANE + CONSENSUS + MESH + NEAREST)
    pal["profile"] = profile_frame(r, prof_dir / f"profile_{label}_pallas.txt",
                                   f"{label}_pallas", gpu)
    n_diff = int((r.render() != img).any(dim=-1).sum().item())
    # K1/K2 per launch on the same waves, beside K8/K9 and K10a/K10b
    r.tscene = dataclasses.replace(ts, traversal="perlane")
    perlane_profile = profile_frame(r, prof_dir / f"profile_{label}_perlane.txt",
                                    f"{label}_perlane", gpu)
    r.tscene = ts
    print(f"{label}: pixels differing between the consensus and the pallas tier "
          f"{n_diff} (lanes proven exact ties on the primary wave: {n_tied})",
          flush=True)
    check(n_diff <= n_tied, f"{label}: the consensus and pallas frames differ only "
          f"in tied pixels ({n_diff} pixels)")
    return {"mega": mega, "pallas": pal, "perlane_profile": perlane_profile,
            "pixels_differing": n_diff}, counts


def tie_check(r) -> dict:
    """The tie scene (two coincident boxes, mirror and diffuse) through the
    pallas tier and the per-lane, hybrid, consensus and auto (consensus)
    tiers: the pixels that differ (the JAX bench's ``tie_check``, whose bar
    is 0). "xla" (the XLA body on the per-(instance, mesh) loop) on the
    primary wave: the lanes where the loop on K11a/K11b and the chained
    sweeps K10a/K10b differ (bar 0), and its frame within 1e-5 of the
    pallas tier's (the fused loop's shading kernels round apart from the
    body)."""
    import torch
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.integrator import render_frame
    from raytpu_torch.ops import trace

    def frame(trav):
        return render_frame(dataclasses.replace(r.tscene, traversal=trav),
                            r.render_static, r.camera_tensor())

    frames = {trav: frame(trav)
              for trav in ("pallas", "perlane", "hybrid", "mega", "auto")}
    n_diff = {trav: int((img != frames["pallas"]).any(dim=-1).sum().item())
              for trav, img in frames.items() if trav != "pallas"}
    rays, act = primary_wave(r)
    o, d = tuple(rays[:3]), tuple(rays[3:])
    win = torch.where(act, RAY_TMAX, 0.0)
    loop = trace.closest_hit_loop(r.tscene, o, d, RAY_TMIN, win)
    chained = trace.closest_hit_wave(r.tscene, o, d, RAY_TMIN, win)
    lanes = torch.zeros_like(win, dtype=torch.bool)
    for field in loop._fields:
        for a, b in zip(*((getattr(loop, field), getattr(chained, field))
                          if field == "n" else
                          ((getattr(loop, field),), (getattr(chained, field),)))):
            lanes |= a != b
    lanes |= (trace.any_hit_loop(r.tscene, o, d, RAY_TMIN, win)
              != trace.any_hit_wave(r.tscene, o, d, RAY_TMIN, win))
    n_diff["xla_primary_lanes"] = int(lanes.sum().item())
    far = (frame("xla") - frames["pallas"]).abs().max().item()
    rs = r.render_static
    print(f"tie scene {rs.width}x{rs.height} spp {rs.samples_per_pixel} bounces "
          f"{rs.max_bounce_count}: pixels differing from the pallas tier {n_diff}; "
          f"xla frame max abs diff to it {far:.3g}", flush=True)
    check(frames["pallas"].std().item() > 1e-3, "the tie scene's frame is not constant")
    check(not any(n_diff.values()), f"tie check n_diff 0 ({n_diff})")
    check(far <= 1e-5, f"tie scene xla frame within 1e-5 of the pallas tier's ({far})")
    return {"n_diff": n_diff, "xla_max_abs_diff": far}


def tier_waves(r, t0: float) -> dict:
    """The config4 frame of pose ``t0`` on the per-lane tier with each K1
    and K2 launch held against K10a/K10b on the same wave (the primary wave,
    then the compacted bounce waves): K2's occlusion equal, and every lane
    where K1 and K10a differ an exact tie (:func:`exact_ties`), those of the
    primary wave exactly ``EXACT_TIES``. Then the same pose on the pallas
    tier: the two frames may differ only in the pixels of tied lanes (a
    lane's sample stays in its pixel), so the differing pixels are at most
    the tied lanes."""
    import torch
    from raytpu_torch.integrator import kernels
    from raytpu_torch.ops import perlane, traverse
    from raytpu_torch.scene import AnimationState

    waves = []

    def plain_checked(sweep: str) -> bool:
        """Whether this call of ``sweep`` is on the primary or the first
        bounce wave, which are also held against the plain version."""
        return sum(w["sweep"] == sweep for w in waves) < 2

    def closest(ts, rays, tmin, state):
        win = state[traverse.ST_T].clone()
        k10 = traverse.closest_sweep(ts, rays, tmin, state.clone())
        plain = (perlane.perlane_closest_sweep_ref(ts, rays, tmin, state.clone())
                 if plain_checked("closest") else None)
        perlane.perlane_closest_sweep(ts, rays, tmin, state)
        if plain is not None:
            check(torch.equal(state.view(torch.int32), plain.view(torch.int32)),
                  f"perlane_closest_sweep equals its plain version bit for bit on "
                  f"the frame's wave {len(waves)} ({rays.shape[1]} packets; "
                  f"{differing_lanes(state, plain)})")
        ties = exact_ties(ts, rays, win, state, k10)
        waves.append({"sweep": "closest", "packets": rays.shape[1],
                      "tied_lanes": [t["lane"] for t in ties],
                      "plain_equal": plain is not None})
        return state

    def anyhit(ts, rays, tmin, tmax, occ, order):
        k10 = traverse.anyhit_sweep(ts, rays, tmin, tmax, occ.clone())
        plain = (perlane.perlane_anyhit_sweep_ref(ts, rays, tmin, tmax, occ.clone(),
                                                  order)
                 if plain_checked("anyhit") else None)
        perlane.perlane_anyhit_sweep(ts, rays, tmin, tmax, occ, order)
        check(torch.equal(occ, k10), f"perlane_anyhit_sweep equals anyhit_sweep "
              f"on the frame's wave {len(waves)} ({rays.shape[1]} packets)")
        check(plain is None or torch.equal(occ, plain),
              f"perlane_anyhit_sweep equals its plain version on the frame's wave "
              f"{len(waves)} ({rays.shape[1]} packets)")
        waves.append({"sweep": "anyhit", "packets": rays.shape[1],
                      "plain_equal": plain is not None})
        return occ

    def frame(traversal):
        r.animation = AnimationState(r.scene.instances)
        r.tscene = dataclasses.replace(r.tscene, traversal=traversal)
        r.set_transforms(t0)
        stats = {}
        img = r.render(stats=stats)
        r.tscene = dataclasses.replace(r.tscene, traversal="auto")
        return img, stats["tier"]

    with kernels(perlane_closest=closest, perlane_anyhit=anyhit):
        img, tier = frame("auto")
    check(tier == "perlane", f"the checked frame is per-lane ({tier})")
    pal, tier = frame("pallas")
    check(tier == "pallas", f"the compared frame is on the pallas tier ({tier})")
    closest_waves = [w for w in waves if w["sweep"] == "closest"]
    check(len(closest_waves) > 1 and len(waves) > len(closest_waves),
          f"the frame swept bounce waves and shadows ({waves})")
    check(sum(w["plain_equal"] for w in waves) == 4,
          "K1 and K2 held against their plain versions on the primary and the "
          "first bounce wave")
    check([tuple(x) for x in closest_waves[0]["tied_lanes"]] == EXACT_TIES,
          f"the primary wave's K1/K10a differences are exactly {EXACT_TIES}")
    n_tied = sum(len(w["tied_lanes"]) for w in closest_waves)
    n_diff = int((img != pal).any(dim=-1).sum().item())
    print(f"config4 frame (pose {t0}) per-lane, each sweep against the chained "
          f"sweep on its wave: waves {[(w['sweep'], w['packets']) for w in waves]}, "
          f"K1 and K2 bit for bit equal to their plain versions on the primary and "
          f"first bounce waves, "
          f"K2 occlusion equal on every wave, K1/K10a exact ties per closest wave "
          f"{[w['tied_lanes'] for w in closest_waves]}; pixels differing from the "
          f"pallas-tier frame: {n_diff} (tied lanes {n_tied})", flush=True)
    check(n_diff <= n_tied, f"per-lane and pallas frames differ only in tied "
          f"pixels ({n_diff} pixels, {n_tied} tied lanes)")
    return {"waves": waves, "tied_lanes": n_tied, "pixels_differing": n_diff}


def same_rays_frames(r, rs_a, rs_b, plain_b: bool = False, ts_b=None):
    """The frames of render statics ``rs_a`` and ``rs_b`` from the plain
    raygen's primary rays (``rs_b`` through the plain versions if
    ``plain_b``, and on the scene ``ts_b`` if given)."""
    import torch
    from raytpu_torch.integrator import plain_kernels, render_packets, tiled_pixels
    from raytpu_torch.ops.raygen import raygen_packed_ref

    cam = r.camera_tensor()
    spp = rs_a.samples_per_pixel
    (px, py), in_frame = tiled_pixels(rs_a, r.device)
    s_row = torch.arange(spp, dtype=torch.float32, device=r.device).repeat(px.shape[0])
    rays6 = raygen_packed_ref(cam, s_row, px.repeat_interleave(spp, 0),
                              py.repeat_interleave(spp, 0), spp, rs_a.width,
                              rs_a.height)
    ts_b = r.tscene if ts_b is None else ts_b
    got = render_packets(r.tscene, rs_a, cam, px, py, in_frame, rays6=rays6)
    if plain_b:
        with plain_kernels():
            want = render_packets(ts_b, rs_b, cam, px, py, in_frame, rays6=rays6)
    else:
        want = render_packets(ts_b, rs_b, cam, px, py, in_frame, rays6=rays6)
    return got, want


def kernel_named(name: str, key: str) -> bool:
    """Whether profiler event ``key`` is kernel ``name``'s ``__global__``
    (whole names: closest_sweep_kernel is not perlane_closest_...)."""
    return re.search(rf"(?<!\w){name}_kernel\b", key) is not None


def kernel_resources() -> dict:
    """Per kernel of the built library (:data:`KERNELS`, in the port that
    is imported), its registers and stack, local and shared bytes a thread
    as ``cuobjdump -res-usage`` reads them from the compiled code, or the
    reason there are none. Works on any checkout's library: the kernels'
    attributes entry points need not exist there."""
    from raytpu_torch import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {"unavailable": f"no {tool}"}
    out = subprocess.run([str(tool), "-res-usage", str(_build.library_path())],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        return {"unavailable": out.stderr.strip()[-300:]}
    found, function = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            function = m.group(1)
        elif function and "REG:" in line:
            fields = dict(re.findall(r"([A-Z]+):(\d+)", line))
            for name in KERNELS:   # a length-prefixed name in the mangled one
                ident = f"{name}_kernel"
                if f"{len(ident)}{ident}" in function:
                    found[name] = {k: int(fields[k]) for k in
                                   ("REG", "STACK", "LOCAL", "SHARED") if k in fields}
            function = None
    return found


def profile_frame(r, path: Path, label: str, gpu: str) -> dict:
    """torch.profiler table of one frame, its device busy time and idle
    share, the share of each hand-written kernel in it, and each sweep
    launch's device time in launch order."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # a profiler session has once come back with no device event at all,
    # mid-run, on a frame that profiled fine before: profile one more frame
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            r.render()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - start) * 1e3
        events = prof.key_averages()
        device = [e for e in events
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        busy = sum(e.self_device_time_total for e in device) / 1e3
        if busy > 0:
            break
        print(f"{label}: the profiler saw no device time; profiling another frame",
              flush=True)
    check(busy > 0, f"{label}: the profiler saw device time")
    per_kernel = {name: sum(e.self_device_time_total for e in device
                            if kernel_named(name, e.key)) / 1e3
                  for name in KERNELS}
    launches = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    launches.sort(key=lambda e: e.time_range.start)
    sweep_ms = {name: [e.time_range.elapsed_us() / 1e3 for e in launches
                       if kernel_named(name, e.name)]
                for name in CHAINED + PER_LANE[1:] + CONSENSUS + MESH}
    sweep_ms = {k: v for k, v in sweep_ms.items() if v}
    table = events.table(sort_by="device_time_total", row_limit=40)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"{gpu}\n{table}\n")
    idle = 1.0 - busy / wall
    print(f"{label} profiled frame: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"device idle {idle:.1%}, kernels ms {per_kernel}, other device ms "
          f"{busy - sum(per_kernel.values()):.3f}; sweep launches ms {sweep_ms}; "
          f"table in {path} [{gpu}]", flush=True)
    return dict(wall_ms=wall, busy_ms=busy, idle_share=idle, kernels_ms=per_kernel,
                sweep_launch_ms=sweep_ms)


class RecordingCv2:
    """A stand-in for the ``cv2`` module of the viewer loop: ``waitKey``
    answers from ``keys`` in turn, ``imshow`` records a copy of each image,
    ``namedWindow`` raises ``error`` if ``display`` is False."""

    class error(Exception):
        pass

    EVENT_MOUSEMOVE, EVENT_RBUTTONDOWN, EVENT_RBUTTONUP = 0, 2, 5

    def __init__(self, keys, display: bool = True):
        self.keys = list(keys)
        self.display = display
        self.shown = []
        self.closed = False

    def namedWindow(self, name):
        if not self.display:
            raise self.error("no display")

    def setMouseCallback(self, name, fn):
        self.on_mouse = fn

    def waitKey(self, delay):
        return self.keys.pop(0)

    def imshow(self, name, img):
        self.shown.append(img.copy())

    def destroyAllWindows(self):
        self.closed = True


def viewer_loop(scene, device, clock=(0.0, 0.5, 1.0, 1.5)) -> dict:
    """``run_interactive`` on ``scene`` under :class:`RecordingCv2` (put in
    ``sys.modules`` for the call only), which presses ``w`` for two frames
    and then ESC, with the module's clock fixed to ``clock``; each image
    shown must be, byte for byte, raytpu's conversion of the frame a
    ``Renderer`` gives at that frame's pose (the camera moved forward by
    ``camera_speed`` times the time step, the instances at the time)."""
    import types

    import numpy as np
    from raytpu_torch.camera import MoveDirection
    from raytpu_torch.frontend import interactive
    from raytpu_torch.render import Renderer

    cv2 = RecordingCv2([ord("w"), ord("w"), 27])
    ticks = iter(clock)
    saved_cv2, saved_time = sys.modules.get("cv2"), interactive.time
    sys.modules["cv2"] = cv2
    interactive.time = types.SimpleNamespace(perf_counter=lambda: next(ticks))
    try:
        interactive.run_interactive(scene, device=device)
    finally:
        interactive.time = saved_time
        if saved_cv2 is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved_cv2
    check(cv2.closed and not cv2.keys, "the viewer left on ESC and closed its window")
    check(len(cv2.shown) == 2, f"the viewer showed two frames ({len(cv2.shown)})")
    r = Renderer(scene, device)
    cfg, last = scene.config, 0.0
    for shown, t in zip(cv2.shown, clock[1:]):
        tp = (t - clock[0]) * 0.1
        r.camera.move(MoveDirection.FORWARD, cfg.camera_speed * (tp - last))
        last = tp
        img = r.step(tp)
        want = (np.clip(img, 0, 1)[..., ::-1] * 255).astype(np.uint8)
        check(shown.dtype == np.uint8 and np.array_equal(shown, want),
              "the viewer shows raytpu's bytes of the Renderer's frame at its pose")
        check(want.std() > 1.0, "the viewer's frame is not constant")
    return {"frames": len(cv2.shown), "shape": list(cv2.shown[0].shape)}


def tree_arrays(bvh) -> tuple:
    return (bvh.aabb_min, bvh.aabb_max, bvh.tri_first, bvh.tri_count, bvh.miss,
            bvh.tri_order)


def lbvh_checks(r4, t_bvh: float, gpu: str, prof_dir: Path) -> tuple:
    """The config4 stand-in on LBVH trees built on the card: the build
    times of steps 1-4 and of the threading (the armadillo stand-in)
    beside the native build's ``t_bvh``, the card's tree against the same
    function on CPU tensors, the teapot stand-in's tree against
    :data:`LBVH_DIGEST`, five timed frames on the per-lane tier and one
    profiled. Returns the record and the LBVH Renderer."""
    import numpy as np
    import torch
    from raytpu_torch.accel import lbvh
    from raytpu_torch.device_scene import corner_tables
    from raytpu_torch.render import Renderer
    from raytpu_torch.scene import load_scene

    scene4 = r4.scene
    v0, e1, e2, _ = corner_tables(scene4)
    _, ps = scene4.geometry.mesh_slice(scene4.geometry.num_meshes - 1)
    big = (v0[ps], e1[ps], e2[ps])
    lbvh.device_steps(*(x[:4096] for x in big), r4.device)   # warm the ops
    torch.cuda.synchronize()
    start = time.perf_counter()
    steps = lbvh.device_steps(*big, r4.device)
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - start
    start = time.perf_counter()
    card = lbvh.thread(steps, scene4.config.leaf_size)
    t_thread = time.perf_counter() - start
    start = time.perf_counter()
    host = lbvh.thread(lbvh.device_steps(*big, "cpu"), scene4.config.leaf_size)
    t_cpu = time.perf_counter() - start
    same = all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(tree_arrays(card), tree_arrays(host)))
    print(f"LBVH of the config4 stand-in's {big[0].shape[0]} triangles: steps 1-4 on "
          f"the card {t_steps * 1e3:.3f} ms, threading on the host "
          f"{t_thread * 1e3:.3f} ms ({card.num_nodes} nodes); the same on CPU "
          f"tensors {t_cpu:.2f} s; native builder (the whole scene, BVH build + "
          f"upload) {t_bvh:.2f} s [{gpu}]", flush=True)
    check(same, "the card's LBVH equals the LBVH from CPU tensors, bit for bit")

    start = time.perf_counter()
    rl = Renderer(load_scene(scene4.config.replace(bvh_builder="lbvh"),
                             meshes=scene4.meshes, skybox=scene4.skybox), r4.device)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - start
    digest = tree_digest(first_tree(rl.tscene))
    print(f"config4 stand-in on LBVH trees: Renderer build {t_build:.2f} s "
          f"({rl.tscene.bvh_aabb_min.shape[0]} nodes); teapot stand-in LBVH sha256 "
          f"{digest} (raytpu's {LBVH_DIGEST})", flush=True)
    check(digest == LBVH_DIGEST, "the port builds raytpu's LBVH of the teapot stand-in")
    frames = render_frames(rl, 5, 0.05, 0.05, "config4_standin_lbvh", gpu, "perlane")
    frames["profile"] = profile_frame(rl, prof_dir / "profile_config4_lbvh.txt",
                                      "config4_standin_lbvh", gpu)
    return dict(steps_ms=t_steps * 1e3, thread_ms=t_thread * 1e3, cpu_s=t_cpu,
                renderer_s=t_build, nodes=card.num_nodes, native_bvh_s=t_bvh,
                frames=frames), rl


def small_frames(r4, rl, gpu: str) -> dict:
    """At 256x192, the LBVH tree's frame: the kernel path against the
    plain path from the same primary rays, and against the native tree's
    frame (SSIM, and the pixels over 1e-5)."""
    from raytpu_torch.integrator import render_frame
    from raytpu_torch.scene import AnimationState
    from raytpu_torch.utils.ssim import ssim

    for r in (r4, rl):   # the same pose on both trees
        r.animation = AnimationState(r.scene.instances)
        r.set_transforms(0.1)
    rs = dataclasses.replace(r4.render_static, width=256, height=192)
    got, want = same_rays_frames(rl, rs, rs, plain_b=True)
    same = max((a - b).abs().max().item() for a, b in zip(got, want))
    img_l = render_frame(rl.tscene, rs, rl.camera_tensor())
    img_n = render_frame(r4.tscene, rs, r4.camera_tensor())
    over = int(((img_l - img_n).abs() > 1e-5).any(dim=-1).sum().item())
    s = ssim(img_l.cpu().numpy(), img_n.cpu().numpy())
    print(f"256x192 on the LBVH tree: kernel vs plain path from the same primary rays "
          f"max abs diff {same:.3g}; vs the native tree's frame SSIM {s:.6f}, "
          f"{over} pixels over 1e-5 [{gpu}]", flush=True)
    check(same <= 1e-6, f"LBVH 256x192 kernel vs plain path within 1e-6 ({same})")
    check(s > 0.98, f"LBVH vs native 256x192 SSIM > 0.98 ({s})")
    return dict(same_rays_max_abs_diff=same, ssim_to_native=s, pixels_over_1e5=over)


def host_builders(rc2, gpu: str) -> dict:
    """The config2 stand-in on the SAH and median trees: their digests, one
    frame each on the consensus tier against the native tree's frame."""
    import torch
    from raytpu_torch.render import Renderer
    from raytpu_torch.scene import AnimationState, load_scene
    from raytpu_torch.utils.ssim import ssim

    out = {}
    rc2.animation = AnimationState(rc2.scene.instances)
    rc2.set_transforms(0.0)
    base = rc2.render().cpu().numpy()
    for method, pinned in (("sah", SAH_DIGEST), ("median", MEDIAN_DIGEST)):
        start = time.perf_counter()
        rb = Renderer(load_scene(rc2.scene.config.replace(bvh_builder=method),
                                 meshes=rc2.scene.meshes, skybox=rc2.scene.skybox),
                      rc2.device)
        t_build = time.perf_counter() - start
        digest = tree_digest(first_tree(rb.tscene))
        check(digest == pinned, f"the port builds raytpu's {method} tree of the "
              f"teapot stand-in ({digest})")
        rb.set_transforms(0.0)
        stats = {}
        torch.cuda.synchronize()
        start = time.perf_counter()
        img = rb.render(stats=stats)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3
        check(stats["tier"] == "mega", f"the {method} frame is on the consensus tier")
        img = img.cpu().numpy()
        s = ssim(img, base)
        over = int((abs(img - base) > 1e-5).any(axis=-1).sum())
        print(f"config2 stand-in on the {method} tree: build {t_build:.2f} s "
              f"({rb.tscene.bvh_aabb_min.shape[0]} nodes), digest equals raytpu's; "
              f"frame {ms:.3f} ms on the consensus tier, SSIM {s:.6f} to the native "
              f"tree's frame, {over} pixels over 1e-5 [{gpu}]", flush=True)
        check(s > 0.98, f"{method} vs native frame SSIM > 0.98 ({s})")
        out[method] = dict(build_s=t_build, frame_ms=ms, ssim_to_native=s,
                           pixels_over_1e5=over)
    return out


def option_frames(r4, gpu: str, prof_dir: Path) -> tuple:
    """config4 at full width with ``fold_spp=False`` and with
    ``ray_chunk`` = a quarter of the frame: 2 timed frames each on the
    default tier and one profiled, and on the pallas tier their equality (within 1e-6) to
    the folded and unchunked frame; then the two new filters: ``sky_nearest``
    against its plain version on the primary wave, bit for bit, and one timed
    frame each, whose launches of it are counted, against the same frame
    with the single tap's plain version. Returns the record and the
    ``sky_nearest`` row."""
    import torch
    from raytpu_torch import _build
    from raytpu_torch.device_scene import pack_skybox_2x
    from raytpu_torch.integrator import kernels, render_frame
    from raytpu_torch.ops import sky

    rs4, ts4 = r4.render_static, r4.tscene
    out = {}
    rs_u = dataclasses.replace(rs4, fold_spp=False)
    rs_c = dataclasses.replace(rs4, ray_chunk=rs4.width * rs4.height // 4)
    folded = render_frames(r4, 2, 0.05, 0.05, "config4_standin", gpu, "perlane")
    for key, rs in (("unfolded", rs_u), ("chunked", rs_c)):
        r4.render_static = rs
        out[key] = render_frames(r4, 2, 0.05, 0.05, f"config4_standin_{key}", gpu,
                                 "perlane")
        out[key]["profile"] = profile_frame(
            r4, prof_dir / f"profile_config4_{key}.txt", f"config4_standin_{key}", gpu)
        r4.render_static = rs4
    r4.tscene = dataclasses.replace(ts4, traversal="pallas")
    got, want = same_rays_frames(r4, rs_u, rs4)
    out["unfolded"]["same_rays_max_abs_diff_to_folded"] = max(
        (a - b).abs().max().item() for a, b in zip(got, want))
    cam = r4.camera_tensor()
    stats = {}
    chunked = render_frame(r4.tscene, rs_c, cam, stats=stats)
    out["chunked"]["max_abs_diff_to_whole"] = (
        chunked - render_frame(r4.tscene, rs4, cam)).abs().max().item()
    r4.tscene = ts4
    del got, want, chunked
    print(f"config4 unfolded (one wave a sample): pallas-tier frame vs the folded "
          f"frame from the same rays max abs diff "
          f"{out['unfolded']['same_rays_max_abs_diff_to_folded']:.3g}; host syncs "
          f"{out['unfolded']['host_syncs']} against folded {folded['host_syncs']}; "
          f"chunked ({stats['host_syncs']} host syncs on the pallas tier): vs the "
          f"whole frame {out['chunked']['max_abs_diff_to_whole']:.3g}", flush=True)
    check(out["unfolded"]["same_rays_max_abs_diff_to_folded"] <= 1e-6,
          "config4 unfolded frame within 1e-6 of the folded one (pallas tier)")
    check(out["chunked"]["max_abs_diff_to_whole"] <= 1e-6,
          "config4 chunked frame within 1e-6 of the whole frame (pallas tier)")
    out["folded"] = folded

    # the single tap, K6's second mode, on every lane of the primary wave
    rays, _ = primary_wave(r4)
    h, w = ts4.sky_hw
    dirs = (rays[3], rays[4], -rays[5])

    def near_k():
        return sky.sample_cubemap_u32_nearest(ts4.skybox_u32, h, w, dirs)

    def near_p():
        return sky.sample_cubemap_u32_nearest_ref(ts4.skybox_u32, h, w, dirs)

    nk = near_k()
    exact = all(torch.equal(a, b) for a, b in zip(nk, near_p()))
    err = max((a - b).abs().max().item() for a, b in zip(nk, near_p()))
    texels = int(sky.nearest_index(h, w, dirs).unique().numel())
    n = dirs[0].numel()
    row = dict(max_abs_err=err, ms=cuda_ms(near_k, 3, 10), plain_ms=cuda_ms(near_p, 3, 10),
               shape=list(dirs[0].shape),
               bound=bound(nbytes(*dirs, *nk) + 4 * texels,
                           OPS_PER_LANE["sky_nearest"] * n))
    print(f"sky_nearest {list(dirs[0].shape)} lanes, {h}x{w} faces: bit for bit "
          f"{exact}; {row['ms']:.4f} ms (CUDA events), plain {row['plain_ms']:.4f} ms, "
          f"bound {row['bound'][0]:.4f} ms by {row['bound'][1]} ({texels} distinct "
          f"texels) [{gpu}]", flush=True)
    check(exact, "sky_nearest equals its plain version bit for bit")

    ts2x = dataclasses.replace(ts4, skybox_u32_2x=torch.as_tensor(
        pack_skybox_2x(r4.scene.skybox), device=r4.device))
    for f in ("nearest", "bilinear2x"):
        r4.tscene = ts2x
        r4.render_static = dataclasses.replace(rs4, skybox_filter=f)
        out[f] = render_frames(r4, 1, 0.05, 0.05, f"config4_standin_{f}", gpu, "perlane")
        out[f]["launches"] = check_launches(
            out[f]["launches"], f"config4 {f} frames",
            idle=CHAINED + CONSENSUS + MESH + ("sky",))
        cam = r4.camera_tensor()
        img = render_frame(r4.tscene, r4.render_static, cam)
        with kernels(sky_nearest=sky.sample_cubemap_u32_nearest_ref):
            plain = render_frame(r4.tscene, r4.render_static, cam)
        out[f]["max_abs_diff_to_plain_tap"] = (img - plain).abs().max().item()
        check(out[f]["max_abs_diff_to_plain_tap"] <= 1e-6,
              f"config4 {f} frame within 1e-6 of the frame with the plain single tap")
        if f == "nearest":
            row["launches"] = out[f]["launches"]["sky_nearest"]
    r4.tscene, r4.render_static = ts4, rs4
    del ts2x
    print(f"sky_nearest launches per frame {row['launches'] / 2:.1f} (2 frames); "
          f"nearest and bilinear2x frames within 1e-6 of the plain single tap's "
          f"({out['nearest']['max_abs_diff_to_plain_tap']:.3g}, "
          f"{out['bilinear2x']['max_abs_diff_to_plain_tap']:.3g})", flush=True)
    return out, row


def validation_checks(rc2, gpu: str) -> dict:
    """A config2 frame with ``validation=True``: no report, its host syncs
    beside the frame's without; a NaN camera makes the guard report."""
    import torch
    from raytpu_torch.integrator import render_frame
    from raytpu_torch.utils import log, validation

    errors = []
    saved = log.error
    log.error = errors.append
    try:
        validation.check_scene(rc2.tscene)
        rs = dataclasses.replace(rc2.render_static, validation=True)
        cam = rc2.camera_tensor()
        on, off = {}, {}
        render_frame(rc2.tscene, rs, cam, stats=on)
        render_frame(rc2.tscene, rc2.render_static, cam, stats=off)
        check(not errors, f"no validation report on a clean frame ({errors})")
        bad = cam.clone()
        bad[3] = float("nan")
        render_frame(rc2.tscene, rs, bad)
        torch.cuda.synchronize()
    finally:
        log.error = saved
    print(f"config2 validation: clean frame reports nothing, host syncs "
          f"{on['host_syncs']} (without validation {off['host_syncs']}); NaN camera "
          f"reports {errors} [{gpu}]", flush=True)
    check(errors and all(re.fullmatch(
        r"validation: \d+ non-finite values in (bounce-loop radiance|final ray "
        r"directions)", e) for e in errors)
        and any(e.endswith("final ray directions") for e in errors),
        f"the guard reports the NaN camera ({errors})")
    return dict(host_syncs=on["host_syncs"], host_syncs_without=off["host_syncs"],
                nan_reports=errors)


def options_phase(r4, rc2, t_bvh: float, gpu: str, prof_dir: Path) -> tuple:
    """The render options and builders: the LBVH on the card
    (:func:`lbvh_checks`, :func:`small_frames`), the SAH and median trees
    (:func:`host_builders`), the unfolded loop, ray chunks and the two
    single-tap filters at full width (:func:`option_frames`), validation
    (:func:`validation_checks`) and the viewer loop (:func:`viewer_loop`).
    Returns the record and the ``sky_nearest`` row."""
    from raytpu_torch import scenes

    start = time.perf_counter()
    lb, rl = lbvh_checks(r4, t_bvh, gpu, prof_dir)
    lb["small_frame"] = small_frames(r4, rl, gpu)
    del rl
    rec = {"lbvh": lb, "host_builders": host_builders(rc2, gpu)}
    rec["options"], row = option_frames(r4, gpu, prof_dir)
    rec["validation"] = validation_checks(rc2, gpu)
    rec["viewer"] = viewer_loop(scenes.config1_standin(width=64, height=64), r4.device)
    rec["seconds"] = time.perf_counter() - start
    print(f"render-options phase: {rec['seconds']:.2f} s", flush=True)
    return rec, row


# the tier "auto" resolves each stand-in to (raytpu_torch.accel.resolve_auto_tier)
STANDIN_TIERS = {"config1_standin": "mega", "config2_standin": "mega",
                 "config3_standin": "mega", "config4_standin": "perlane",
                 "config5_standin": "perlane", "reference_standin": "perlane"}
MATRIX_FRAMES = 4   # timed frames a stand-in in the entry-points phase
BENCH_KEYS = ("metric", "value", "unit", "configs", "bit_identical", "tie_check",
              "device", "cache")


def run_module(args, label: str, timeout: int = 600) -> str:
    """``python -m <args>`` from the repository root in a child process;
    its standard output. A non-zero exit fails the run."""
    res = subprocess.run([sys.executable, "-m", *args], cwd=REPO, capture_output=True,
                         text=True, timeout=timeout)
    check(res.returncode == 0, f"{label} exits 0 ({res.returncode}): "
          f"{res.stderr[-3000:]}")
    return res.stdout


def entry_points(renderers: dict, gpu: str) -> dict:
    """The user's entry points on the card: the bench's matrix over the six
    stand-ins (``run_matrix``, reusing ``renderers``, each at the pose
    ``set_transforms(0.0)``), its bit-identity and tie checks, a PNG
    written by ``python -m raytpu_torch.cli render`` against the frame
    rendered here, ``Flythrough.run_benchmark`` on the config5 stand-in, and
    ``python -m raytpu_torch.bench``'s JSON line."""
    import numpy as np
    import torch
    from PIL import Image
    from raytpu_torch import bench, presets, scenes
    from raytpu_torch.frontend.flythrough import Flythrough
    from raytpu_torch.integrator import RenderStatic
    from raytpu_torch.io.image import _to_uint8
    from raytpu_torch.scene import AnimationState

    for name, r in renderers.items():
        check(r.render_static == RenderStatic.from_config(r.scene.config)
              and r.tscene.traversal == r.scene.config.traversal,
              f"{name}: the Renderer is back on its default path")
        r.animation = AnimationState(r.scene.instances)
        r.set_transforms(0.0)
    configs = bench.run_matrix(frames=MATRIX_FRAMES, renderers=renderers)
    print(gpu)
    print(json.dumps({"configs": configs, "gpu": gpu}), flush=True)
    check(list(configs) == list(presets.STANDINS), f"the matrix rows ({list(configs)})")
    for name, row in configs.items():
        check("frame_ms" in row and not row.get("suspect"),
              f"{name}: a numeric, plausible matrix row ({row})")
        check(row["tier"] == STANDIN_TIERS[name],
              f"{name} renders on its default tier ({row['tier']})")
        check(row["rays_per_frame"] >= row["width"] * row["height"] * row["spp"],
              f"{name}: every primary ray counted ({row['rays_per_frame']})")
    check(bench.matrix_complete(configs, need=len(configs)), "the matrix is complete")

    bit = bench.bit_identity_check()
    tie = bench.bit_identity_check(preset=bench.tie_scene_config())
    print(f"bit_identical (config2 stand-in {bit['width']}x{bit['height']}, per-lane "
          f"and consensus against the pallas tier): {bit}; tie_check: {tie} [{gpu}]",
          flush=True)
    check(bit["ok"], f"bit_identical ({bit})")
    check(tie["ok"], f"tie_check ({tie})")

    out = REPO / "build" / "entry_points" / "config1_standin.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    run_module(["raytpu_torch.cli", "render", "--preset", "config1_standin",
                "-o", str(out)], "the CLI's render")
    with Image.open(out) as im:
        png = np.asarray(im.convert("RGB"))
    want = _to_uint8(renderers["config1_standin"].step(0.0))
    n_diff = int((png != want).any(axis=-1).sum())
    print(f"CLI render of config1_standin: {out.name} {png.shape}, mean "
          f"{png.mean():.3f}, pixels differing from the frame rendered here "
          f"{n_diff}", flush=True)
    check(png.shape == want.shape and n_diff == 0,
          "the CLI's PNG equals the frame rendered here")
    check(png.std() > 1.0, "the config1 stand-in's image is not constant")

    fly = Flythrough(scenes.config5_standin())
    fly_stats = fly.run_benchmark(max_frames=8)
    img = fly.renderer.render()
    print(f"flythrough of config5_standin: {fly_stats} [{gpu}]", flush=True)
    check(fly_stats["frames"] == 8 and fly_stats["fps"] > 0, "the flythrough ran 8 frames")
    check(bool(torch.isfinite(img).all()) and img.std().item() > 1e-3,
          "the flythrough's frame is finite and not constant")
    del fly, img

    line = run_module(["raytpu_torch.bench", "--frames", "4"],
                      "python -m raytpu_torch.bench").strip().splitlines()[-1]
    print(f"bench line: {line}", flush=True)
    res = json.loads(line)
    missing = [k for k in BENCH_KEYS if k not in res]
    check(not missing, f"the bench line has every key (missing {missing})")
    check("vs_baseline" not in res and not res.get("artifact_incomplete"),
          f"the bench line is whole ({res})")
    check(sorted(res["configs"]) == sorted(presets.STANDINS), "the bench's six rows")
    check(res["bit_identical"] and res["tie_check"]["ok"], "the bench's checks pass")
    check(res["device"]["name"] in gpu and res["device"]["power_limit_w"] > 0,
          f"the bench names the card ({res['device']})")
    return {"configs": configs, "bit_identical": bit, "tie_check": tie,
            "cli_png_pixels_differing": n_diff, "flythrough": fly_stats,
            "bench_line": res}


# The sharding phase's frames: (label, the Renderer's key in the phase's
# dict, traversal (None: the scene's default), skybox filter (None: the
# config's), mesh slots, all on the Renderer's device, cuda:0)
SHARDED_FRAMES = (
    ("config4_perlane", "config4_standin", None, None, 4),
    ("config4_pallas", "config4_standin", "pallas", None, 4),
    ("config2_consensus", "config2_standin", None, None, 3),   # 19 tile rows -> 21
    ("config3_consensus", "config3_standin", None, None, 4),
    ("small_auto", "small", None, None, 8),                   # 6 rows: 2 dead slots
    ("small_pallas", "small", "pallas", None, 8),
    ("small_xla", "small", "xla", None, 8),
    ("small_nearest", "small", None, "nearest", 2),
    ("tie_pallas", "tie", "pallas", None, 2),
    ("tie_mega", "tie", "mega", None, 2),
    ("config1_brute", "config1_brute", None, None, 2),          # no BVH
)
SHARD_TIMED = 3   # timed frames of each, single-device and sharded


def host_ms(fn, n: int) -> list:
    """Host ms of ``n`` calls of ``fn``, each drained, after one more."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - start) * 1e3)
    return ms


def sharding_phase(renderers: dict, gpu: str) -> dict:
    """The sharded path (``raytpu_torch.parallel``) on one card, its slots
    repeated on ``cuda:0`` (:data:`SHARDED_FRAMES`): each frame against the
    single-device frame of the same pose on the same card, bit for bit on
    the pallas and "xla" tiers; on the per-lane and consensus tiers every
    differing pixel must be a known tie, a pixel where the single-device
    frame and its pallas-tier frame differ too. The sharded frames run
    with the launch counters reset, and every kernel must launch there.
    Then the times of both (median of :data:`SHARD_TIMED`, host clock,
    drained) with their host syncs, the sharded Renderer's refusal of more
    cards than the machine has, ``run_benchmark`` over an explicit 4-slot
    mesh, and frames over distinct cards where there are several."""
    import torch
    from raytpu_torch import _build, bench, scenes
    from raytpu_torch.integrator import _wave_budget, _wave_rungs, render_frame
    from raytpu_torch.parallel import Mesh, make_mesh, render_sharded, replicate
    from raytpu_torch.render import Renderer

    start = time.perf_counter()
    cases = []
    for label, key, trav, sky_filter, n in SHARDED_FRAMES:
        r = renderers[key]
        ts = dataclasses.replace(r.tscene, traversal=trav) if trav else r.tscene
        rs = r.render_static
        if sky_filter:
            rs = dataclasses.replace(rs, skybox_filter=sky_filter)
        mesh = Mesh((r.device,) * n)
        cam = r.camera_tensor()
        stats = {}
        single = render_frame(ts, rs, cam, stats=stats)
        tier = stats["tier"]
        # the pixels of known ties: where this tier's frame and the pallas
        # tier's differ on one device
        tied = None
        if tier not in ("pallas", "xla", "brute"):
            pal = render_frame(dataclasses.replace(ts, traversal="pallas"), rs, cam)
            tied = (single != pal).any(dim=-1)
        cases.append(dict(label=label, ts=ts, rs=rs, cam=cam, mesh=mesh,
                          replicas=replicate(ts, mesh), single=single, tier=tier,
                          tied=tied, single_syncs=stats["host_syncs"]))
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    for c in cases:
        c["stats"] = {}
        c["sharded"] = render_sharded(c["replicas"], c["rs"], c["cam"], c["mesh"],
                                      stats=c["stats"])
    torch.cuda.synchronize()
    counts = check_launches(_build.launch_counts(), "sharded frames", idle=(),
                            brute=True)

    rec = {"gpu": gpu, "frames": {}}
    for c in cases:
        label, st = c["label"], c["stats"]
        check(st["tier"] == c["tier"], f"{label}: the slots take the frame's tier "
              f"({st['tier']}, {c['tier']})")
        got, want = c["sharded"], c["single"]
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{label}: a finite frame of the frame's shape")
        diff = (got != want).any(dim=-1)
        n_diff = int(diff.sum().item())
        if c["tied"] is None:
            n_tie = 0
            check(n_diff == 0, f"{label}: the sharded frame equals the single-device "
                  f"frame bit for bit ({n_diff} pixels differ)")
        else:
            n_tie = int(c["tied"].sum().item())
            outside = int((diff & ~c["tied"]).sum().item())
            check(outside == 0, f"{label}: every differing pixel is a known tie "
                  f"({outside} of {n_diff} are not)")
        c["ms_single"] = host_ms(lambda: render_frame(c["ts"], c["rs"], c["cam"]),
                                 SHARD_TIMED)
        c["ms_sharded"] = host_ms(lambda: render_sharded(
            c["replicas"], c["rs"], c["cam"], c["mesh"]), SHARD_TIMED)
        slots = [dict(s, rungs=_wave_rungs(s["packets"], _wave_budget(s["packets"]))
                      if _wave_budget(s["packets"]) else [])
                 for s in st["slots"]]
        rs = c["rs"]
        row = {"size": f"{rs.width}x{rs.height}", "tier": c["tier"],
               "slots": c["mesh"].size, "pixels_differing": n_diff,
               "known_tie_pixels": n_tie, "single_ms": c["ms_single"],
               "sharded_ms": c["ms_sharded"],
               "single_median_ms": statistics.median(c["ms_single"]),
               "sharded_median_ms": statistics.median(c["ms_sharded"]),
               "single_syncs": c["single_syncs"], "sharded_syncs": st["host_syncs"],
               "slot_packets_rungs_syncs": [(s["packets"], s["rungs"], s["host_syncs"])
                                            for s in slots]}
        rec["frames"][label] = row
        print(f"sharded {label} ({row['size']}, tier {row['tier']}, {row['slots']} "
              f"slots on {c['mesh'].devices[0]}): pixels differing from the single-device frame "
              f"{n_diff} (known-tie pixels of this tier {n_tie}"
              f"{'' if c['tied'] is not None else ', none allowed'}); frame ms "
              f"single {[round(x, 3) for x in row['single_ms']]} median "
              f"{row['single_median_ms']:.3f}, sharded "
              f"{[round(x, 3) for x in row['sharded_ms']]} median "
              f"{row['sharded_median_ms']:.3f}; host syncs {row['single_syncs']} "
              f"-> {row['sharded_syncs']}; slots (packets a wave, rungs, syncs) "
              f"{row['slot_packets_rungs_syncs']} [{gpu}]", flush=True)
    del cases

    cards = torch.cuda.device_count()
    tie_scene = scenes.tie_scene(devices=cards + 1)
    try:
        Renderer(tie_scene)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    print(f"Renderer with devices={cards + 1} on {cards} card(s): {refused!r}", flush=True)
    check(f"requested {cards + 1} devices, have {cards}" in refused,
          "the sharded Renderer refuses more cards than the machine has, naming the count")

    rc2 = renderers["config2_standin"]
    out = bench.run_benchmark(preset=rc2.scene, frames=4, renderer=rc2,
                              mesh=Mesh((rc2.device,) * 4))
    print(json.dumps(out), flush=True)
    check(out["devices"] == 4 and out["frame_ms"] > 0 and out["rays_per_frame"] > 0,
          "run_benchmark over 4 slots says devices 4")
    rec["run_benchmark"] = {k: out[k] for k in ("devices", "tier", "rays_per_frame",
                                                "frame_ms")}

    if cards > 1:
        n = min(cards, 4)
        r4 = renderers["config4_standin"]
        ts = dataclasses.replace(r4.tscene, traversal="pallas")
        cam = r4.camera_tensor()
        want = render_frame(ts, r4.render_static, cam)
        got = render_sharded(ts, r4.render_static, cam, make_mesh(n))
        check(torch.equal(got, want), f"config4 pallas over {n} distinct cards equals "
              "the single-device frame bit for bit")
        rec["distinct_cards"] = n
        print(f"config4 pallas over {n} distinct cards: bit for bit [{gpu}]", flush=True)
    else:
        rec["distinct_cards"] = "not run: one card"
        print("frames over distinct cards: not run (one card)", flush=True)
    rec["seconds"] = time.perf_counter() - start
    rec["launches"] = counts
    print(f"sharding phase: {rec['seconds']:.2f} s", flush=True)
    return rec


def native_loaders(mesh, gpu: str) -> dict:
    """The native OBJ parser and JPEG decoder (``raytpu_torch/io/native.py``)
    built on this machine: the armadillo stand-in written as an OBJ file
    (positions and normals to 9 digits) parsed natively and in Python,
    equal within ``tests/test_native.py``'s bounds, and a smooth generated
    1024x1024 face written by PIL as a JPEG, decoded natively and by PIL
    within those bounds; seconds of each."""
    import numpy as np
    from PIL import Image
    from raytpu_torch.io import native, obj

    start = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - start
    out = REPO / "build" / "native_check"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "armadillo.obj"

    def rows(tag, a):
        return [f"{tag} {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in a.tolist()]

    path.write_text("".join(rows("v", mesh.positions) + rows("vn", mesh.normals)
                            + [f"f {a} {b} {c}\n" for a, b, c
                               in (mesh.triangles + 1).tolist()]))
    start = time.perf_counter()
    got = native.load_obj(str(path))
    parse_s = time.perf_counter() - start
    start = time.perf_counter()
    want = obj.load_obj_numpy(str(path))
    python_s = time.perf_counter() - start
    check(np.array_equal(got.triangles, want.triangles), "native OBJ triangles")
    check(np.allclose(got.positions, want.positions, rtol=1e-7, atol=0)
          and np.allclose(got.normals, want.normals, rtol=1e-7, atol=1e-6),
          "native OBJ positions and normals within test_native.py's bounds")
    y, x = np.mgrid[0:1024, 0:1024].astype(np.float32)
    rgb = np.stack([128 + 100 * np.sin(x / 80.0), 128 + 90 * np.cos(y / 80.0),
                    (x + y) * 0.12], axis=-1)
    jpg = out / "face.jpg"
    Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).save(jpg, quality=92)
    start = time.perf_counter()
    ours = native.read_jpeg(str(jpg))
    decode_s = time.perf_counter() - start
    start = time.perf_counter()
    with Image.open(jpg) as im:
        ref = np.asarray(im.convert("RGB"))
    pil_s = time.perf_counter() - start
    d = np.abs(ours.astype(int) - ref.astype(int))
    check(ours.shape == ref.shape and d.mean() < 0.5 and (d > 16).mean() < 1e-4,
          f"native JPEG decode within test_native.py's bounds of PIL ({d.mean()})")
    rec = {"build_s": build_s, "obj_triangles": int(got.num_triangles),
           "obj_bytes": path.stat().st_size, "parse_native_s": parse_s,
           "parse_python_s": python_s, "decode_native_s": decode_s,
           "decode_pil_s": pil_s, "jpeg_mean_abs_diff": float(d.mean())}
    print(f"native loaders: {rec} [{gpu}; host CPU]", flush=True)
    return rec



# ---------------------------------------------------------------------------
# the knobs phase: the brute tracers, the oracle, chunks
# ---------------------------------------------------------------------------

# the triangles config4's EXACT_TIES lanes keep: K10a's (build order) and
# K1's (near child first), both hit at the same t (ROADMAP queue 3)
EXACT_TIE_PRIMS = {(3983, 110): (22500, 27620)}
CHUNK_TRIS = 11264   # raytpu.accel.chunking.CHUNK_TRIS: raytpu's config4 chunks
# sha256 of the config4 stand-in's chunked trees at chunk_tris=11264 (leaf
# size 12, the native builder): bvh_aabb_min, bvh_aabb_max, bvh_tri_first,
# bvh_tri_count, bvh_miss and bvh_tri_prim of all entries, then the entry
# rows as int32, as raytpu's attach_bvh builds them on the CPU
CHUNK_DIGEST = "f3d28b7b7d8b3c9b775f8a876db4af1715d2cae9c6178b78af9f1730241f0985"
ORACLE_CAP = 64     # differing lanes a sweep may have before the oracle fails
KNOB_POSE = 0.05    # the pose of the knobs phase's comparison frames


def chunk_digest(ts) -> str:
    """:data:`CHUNK_DIGEST` of a scene's trees and entries."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in (ts.bvh_aabb_min, ts.bvh_aabb_max, ts.bvh_tri_first,
              ts.bvh_tri_count, ts.bvh_miss, ts.bvh_tri_prim):
        h.update(a.contiguous().cpu().numpy().tobytes())
    h.update(np.asarray(ts.entry_rows, np.int32).tobytes())
    return h.hexdigest()


def pose(r, t: float) -> None:
    """``r`` at the pose of time ``t`` from its initial pose (the spin
    accumulates over ``set_transforms`` calls)."""
    from raytpu_torch.scene import AnimationState

    r.animation = AnimationState(r.scene.instances)
    r.set_transforms(t)


def hit_bits(ts, inst: int, prim: int, rays, p: int, k: int):
    """(hit, t bits) of triangle ``prim`` (primitive order) for the world
    ray of lane (p, k) in instance ``inst``'s object space, the transform
    and test the sweeps and the loop make."""
    import torch
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.device_scene import prim_tris
    from raytpu_torch.ops import traverse
    from raytpu_torch.ops.intersect import moller_trumbore

    _, o, d, _ = traverse._object_rays(
        ts, inst, tuple(rays[c, p, k:k + 1] for c in range(3)),
        tuple(rays[3 + c, p, k:k + 1] for c in range(3)))
    tri = prim_tris(ts)[prim]
    corner = [tuple(tri[4 * w + c:4 * w + c + 1] for c in range(3)) for w in range(3)]
    t, _, _, hit = moller_trumbore(o, d, *corner, RAY_TMIN,
                                   torch.full_like(o[0], float("inf")))
    return bool(hit[0]), int(t.view(torch.int32)[0])


def prove_tie(ts, rays, lane, a, b, what: str) -> None:
    """Raise unless ``a`` and ``b`` ((inst, prim) each) are two different
    triangles hit by lane ``lane``'s ray at exactly the same f32 t."""
    ha, ta = hit_bits(ts, *a, rays, *lane)
    hb, tb = hit_bits(ts, *b, rays, *lane)
    check(a != b and ha and hb and ta == tb,
          f"{what}: lane {lane} keeps {a}, the other {b}: not an exact tie "
          f"(hits {ha} {hb}, t bits {ta} {tb})")


def sweep_prim(ts, name: str, rays, win, state, p: int, k: int):
    """(inst, prim) the closest sweep ``name`` ("K1", "K8", "K10a") kept on
    lane (p, k): from its plain version over the lane's block, which must
    reproduce ``state`` there."""
    import torch
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops import traverse

    b0 = p - p % 8
    r = rays[:, b0:b0 + 8].contiguous()
    st = traverse.make_trace_state(win[b0:b0 + 8].contiguous())
    slots = torch.full(st.shape[1:], -1, dtype=torch.long, device=st.device)
    got = plain_closest(name)(ts, r, RAY_TMIN, st, slots=slots)
    check(torch.equal(got.view(torch.int32)[:, p - b0, k],
                      state.view(torch.int32)[:, p, k]),
          f"{name}: the plain walk reproduces the kernel's state on lane {(p, k)}")
    return (int(state.view(torch.int32)[3, p, k]),
            int(ts.bvh_tri_prim[int(slots[p - b0, k])]))


def oracle_check(ts, name: str, rays, win, got: dict, brute: dict, prim_of) -> dict:
    """Hold one walk's closest hits ``got`` (valid, inst, t, u, v of (P, K))
    to the brute loop's ``brute`` (the same and ``prim``): a lane agrees
    where valid, inst and the t, u and v bits match; every other lane must
    have a hit in both, and ``prim_of(p, k)`` gives the walk's (inst,
    prim) there: the brute triangle with t within 4 ulps, or another one
    hit at exactly the same t (a proven tie)."""
    import torch

    def bits(x):
        return x.contiguous().view(torch.int32)

    vg, vb = got["valid"], brute["valid"]
    same = (vg == vb) & (~vb | ((got["inst"] == brute["inst"])
                                & (bits(got["t"]) == bits(brute["t"]))
                                & (bits(got["u"]) == bits(brute["u"]))
                                & (bits(got["v"]) == bits(brute["v"]))))
    lanes = (~same).nonzero().tolist()
    check(len(lanes) <= ORACLE_CAP, f"{name}: {len(lanes)} lanes differ from the "
          f"brute oracle (at most {ORACLE_CAP} may be looked at)")
    ties, max_ulps = [], 0
    for p, k in lanes:
        check(bool(vg[p, k]) and bool(vb[p, k]),
              f"{name}: lane {(p, k)} hits in one walk only")
        a = prim_of(p, k)
        b = (int(brute["inst"][p, k]), int(brute["prim"][p, k]))
        if a == b:
            n = int(ulps(got["t"][p, k:k + 1], brute["t"][p, k:k + 1])[0])
            check(n <= 4, f"{name}: lane {(p, k)} the same triangle, t {n} ulps apart")
            max_ulps = max(max_ulps, n)
        else:
            prove_tie(ts, rays, (p, k), a, b, name)
            ties.append([p, k])
    return {"lanes_differing": len(lanes), "ties": ties, "same_prim_max_ulps": max_ulps}


def brute_oracle(r, label: str, gpu: str) -> dict:
    """The brute loop (no tree, ``brute_closest_kernel``) as the oracle of
    every closest sweep on ``r``'s primary wave: K1, K8 and K10a (their
    states) and the per-(instance, mesh) loop on K11a (its triangles), each
    lane the brute hit or a proven exact tie; then on the shadow rays of
    K10a's hits, K2, K9, K10b and the loop on K11b against the brute
    occlusion (``brute_anyhit_kernel``), flag for flag."""
    import functools

    import torch
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.device_scene import brute_scene
    from raytpu_torch.ops import consensus, intersect, perlane, trace, traverse
    from raytpu_torch.ops.intersect import BIG_T

    ts = r.tscene
    rays, act = primary_wave(r)
    win = torch.where(act, RAY_TMAX, 0.0)
    o, d = (rays[0], rays[1], rays[2]), (rays[3], rays[4], rays[5])
    bts = brute_scene(ts)
    walk_b = functools.partial(trace.brute_mesh_closest, closest=intersect.brute_closest)
    prim_b = torch.full(win.shape, -1, dtype=torch.long, device=win.device)
    hb = trace.closest_hit_loop(bts, o, d, RAY_TMIN, win, walk=walk_b, slots=prim_b)
    brute_ms = cuda_ms(lambda: trace.closest_hit_loop(bts, o, d, RAY_TMIN, win,
                                                      walk=walk_b), 0, 1)
    brute = dict(valid=hb.valid, inst=hb.inst, t=hb.t, u=hb.u, v=hb.v, prim=prim_b)
    live = int(act.sum())
    check(int(hb.valid.sum()) > 0, f"{label}: the brute oracle finds hits")

    st0 = traverse.make_trace_state(win)
    states = {"K1": perlane.perlane_closest_sweep(ts, rays, RAY_TMIN, st0.clone()),
              "K8": consensus.mega_closest_sweep(ts, rays, RAY_TMIN, st0.clone()),
              "K10a": traverse.closest_sweep(ts, rays, RAY_TMIN, st0.clone())}
    res = {"lanes": live, "hits": int(hb.valid.sum()), "brute_loop_ms": brute_ms}
    for name, st in states.items():
        t, valid, _, inst, _, u, v = traverse.unpack_state(st)
        got = dict(valid=valid, inst=inst, t=torch.where(valid, t, BIG_T), u=u, v=v)
        res[name] = oracle_check(ts, name, rays, win, got, brute, functools.partial(
            sweep_prim, ts, name, rays, win, st))
    slots_l = torch.full(win.shape, -1, dtype=torch.long, device=win.device)
    hl = trace.closest_hit_loop(ts, o, d, RAY_TMIN, win, walk=traverse.mesh_closest,
                                slots=slots_l)
    prim_l = ts.bvh_tri_prim[slots_l.clamp_min(0)]
    res["K11a loop"] = oracle_check(
        ts, "K11a loop", rays, win,
        dict(valid=hl.valid, inst=hl.inst, t=hl.t, u=hl.u, v=hl.v), brute,
        lambda p, k: (int(hl.inst[p, k]), int(prim_l[p, k])))
    check(bool(((slots_l >= 0) == hl.valid).all()), f"{label}: the loop's slots")

    srays, swin = shadow_rays(ts, rays, states["K10a"])
    so, sd = (srays[0], srays[1], srays[2]), (srays[3], srays[4], srays[5])
    occ0 = torch.zeros(swin.shape, dtype=torch.int32, device=swin.device)
    occ_b, shadow_ms = brute_shadow_loop(bts, srays, swin)
    flags = {
        "K2": perlane.perlane_anyhit_sweep(ts, srays, RAY_TMIN, swin, occ0.clone()) != 0,
        "K9": consensus.mega_anyhit_sweep(ts, srays, RAY_TMIN, swin, occ0.clone()) != 0,
        "K10b": traverse.anyhit_sweep(ts, srays, RAY_TMIN, swin, occ0.clone()) != 0,
        "K11b loop": trace.any_hit_loop(ts, so, sd, RAY_TMIN, swin,
                                        walk=traverse.mesh_anyhit)}
    for name, f in flags.items():
        n = int((f != occ_b).sum())
        check(n == 0, f"{label}: {name}'s occlusion flags equal the brute oracle's "
              f"({n} differ)")
    res["shadow"] = {"rays": int((swin > RAY_TMIN).sum()), "occluded": int(occ_b.sum()),
                     "flags_differing": 0, "brute_loop_ms": shadow_ms}
    ties = {name: res[name]["ties"] for name in (*states, "K11a loop")}
    print(f"brute oracle, {label} primary wave ({rays.shape[1]} packets, {live} "
          f"live lanes, {res['hits']} hits; brute loop {brute_ms:.3f} ms): lanes "
          f"differing {({n: res[n]['lanes_differing'] for n in ties})}, all proven "
          f"exact ties {ties} or the brute triangle (t within "
          f"{max(res[n]['same_prim_max_ulps'] for n in ties)} ulps); shadow flags of "
          f"K2, K9, K10b and the K11b loop equal the brute occlusion on "
          f"{res['shadow']['rays']} shadow rays ({res['shadow']['occluded']} occluded; "
          f"brute loop {shadow_ms:.3f} ms) [{gpu}]", flush=True)
    res["tie_lanes"] = sorted({tuple(x) for v in ties.values() for x in v})
    return res


def brute_shadow_loop(bts, srays, swin):
    """The brute loop's occlusion of shadow rays ``srays`` (6, P, K) with
    windows ``swin`` over the entries of the brute scene ``bts`` (the
    oracle of the shadow sweeps), and the ms of one more such loop."""
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops import intersect, trace

    so, sd = (srays[0], srays[1], srays[2]), (srays[3], srays[4], srays[5])
    walk = functools.partial(trace.brute_mesh_anyhit, anyhit=intersect.brute_anyhit)

    def loop():
        return trace.any_hit_loop(bts, so, sd, RAY_TMIN, swin, walk=walk)

    return loop(), cuda_ms(loop, 0, 1)


def check_wave_times(scene4) -> dict:
    """The brute oracle's shadow loop (:func:`brute_shadow_loop`) on the
    256x192 config4 check wave at :data:`KNOB_POSE`, as
    :func:`brute_oracle` runs it: the shadow rays of K10a's hits on the
    primary wave against both entries' 332,800 triangles; ms of one loop
    (the median of three)."""
    import torch
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.device_scene import brute_scene
    from raytpu_torch.ops import traverse
    from raytpu_torch.render import Renderer
    from raytpu_torch.scene import load_scene

    small = Renderer(load_scene(scene4.config.replace(width=256, height=192),
                                meshes=scene4.meshes, skybox=scene4.skybox))
    pose(small, KNOB_POSE)
    rays, act = primary_wave(small)
    win = torch.where(act, RAY_TMAX, 0.0)
    st = traverse.closest_sweep(small.tscene, rays, RAY_TMIN,
                                traverse.make_trace_state(win))
    srays, swin = shadow_rays(small.tscene, rays, st)
    bts = brute_scene(small.tscene)
    ms = [brute_shadow_loop(bts, srays, swin)[1] for _ in range(3)]
    return {"brute_anyhit_config4_check_loop_ms": statistics.median(ms)}


def brute_known_ties(r4, gpu: str) -> dict:
    """On config4's full primary wave (:data:`EXACT_TIES`' pose), the brute
    loop over each known tie lane's warp keeps one of the two tied
    triangles (:data:`EXACT_TIE_PRIMS`), both hit at its t."""
    import functools

    import torch
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.device_scene import brute_scene
    from raytpu_torch.ops import intersect, trace

    pose(r4, 0.05)
    rays, act = primary_wave(r4)
    bts = brute_scene(r4.tscene)
    out = {}
    for (p, k), prims in EXACT_TIE_PRIMS.items():
        k0 = k - k % 32
        r = rays[:, p:p + 1, k0:k0 + 32].contiguous()
        win = torch.where(act[p:p + 1, k0:k0 + 32], RAY_TMAX, 0.0)
        slots = torch.full(win.shape, -1, dtype=torch.long, device=win.device)
        hb = trace.closest_hit_loop(
            bts, (r[0], r[1], r[2]), (r[3], r[4], r[5]), RAY_TMIN, win,
            walk=functools.partial(trace.brute_mesh_closest,
                                   closest=intersect.brute_closest), slots=slots)
        prim, inst = int(slots[0, k - k0]), int(hb.inst[0, k - k0])
        check(prim in prims, f"config4 lane {(p, k)}: the brute loop keeps one of the "
              f"tied triangles {prims} ({prim})")
        prove_tie(r4.tscene, rays, (p, k), (inst, prims[0]), (inst, prims[1]),
                  f"config4 lane {(p, k)}")
        out[f"{p},{k}"] = {"brute_prim": prim, "tied_prims": list(prims)}
    print(f"config4's known exact ties on its full primary wave: the brute loop keeps "
          f"{out} [{gpu}]", flush=True)
    return out


def brute_equal(name: str, got, want, what: str) -> None:
    """Raise unless a brute kernel's outputs equal its plain version's bit
    for bit."""
    import torch

    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    for a, b in zip(outs, wants):
        a = a.view(torch.int32) if a.dtype == torch.float32 else a
        b = b.view(torch.int32) if b.dtype == torch.float32 else b
        check(torch.equal(a, b), f"{name} equals its plain version bit for bit "
              f"({what})")


def brute_tests(name: str, x, tmax, tris) -> int:
    """The Moller-Trumbore tests of a brute query, computed from its data:
    every live lane (window above ``RAY_TMIN``) against every triangle for
    ``brute_closest``; for ``brute_anyhit`` each live lane's tests up to and
    including its first hit in index order (all of them on a miss), the
    work of the kernel's scan, from one chunked (lanes x triangles) scan."""
    import torch
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops.intersect import moller_trumbore

    tm = tmax.reshape(-1)
    live = (tm > RAY_TMIN).nonzero().squeeze(1)
    n_tris = tris.shape[0]
    if name == "brute_closest":
        return live.numel() * n_tris
    r = x.reshape(6, -1)[:, live]
    tm = tm[live]
    corner = [tuple(tris[None, :, 4 * w + c] for c in range(3)) for w in range(3)]
    step = max(1, (1 << 22) // n_tris)
    tests = 0
    for s0 in range(0, live.numel(), step):
        sl = slice(s0, s0 + step)
        o = tuple(r[c, sl, None] for c in range(3))
        d = tuple(r[3 + c, sl, None] for c in range(3))
        hit = moller_trumbore(o, d, *corner, RAY_TMIN, tm[sl, None])[3]
        first = hit.int().argmax(dim=1) + 1
        tests += int(torch.where(hit.any(dim=1), first, n_tris).sum())
    return tests


def brute_slice(r):
    """The brute kernels' inputs on a :data:`SWEEP_PACKETS` slice of
    ``r``'s primary wave (config2's) in its first entry's object space:
    ``(tris, rays, windows, shadow rays, shadow windows)``, the entry's
    packed triangles, and the shadow rays of the slice's K10a hits."""
    import torch
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.device_scene import brute_scene
    from raytpu_torch.ops import trace, traverse

    ts, rs = r.tscene, r.render_static
    rays, act = primary_wave(r)
    idx = torch.tensor(sweep_slice(rs, SWEEP_PACKETS), device=r.device)
    rays, act = rays[:, idx].contiguous(), act[idx]
    win = torch.where(act, RAY_TMAX, 0.0)
    bts = brute_scene(ts)
    inst, _, _, count, start = bts.entry_rows[0]
    tris = bts.tri_packed[start:start + count]
    obj = trace.object_space(ts, inst, (rays[0], rays[1], rays[2]),
                             (rays[3], rays[4], rays[5]))
    st = traverse.closest_sweep(ts, rays, RAY_TMIN, traverse.make_trace_state(win))
    srays, swin = shadow_rays(ts, rays, st)
    sobj = trace.object_space(ts, inst, (srays[0], srays[1], srays[2]),
                              (srays[3], srays[4], srays[5]))
    return tris, obj, win, sobj, swin


BRUTE_RINGS = (46, 128, 384, 1024)  # triangles of the any-hit's shorter rings


def brute_times(r) -> dict:
    """Both brute kernels alone on :func:`brute_slice` of the config2
    stand-in ``r``, ms a launch; and the any-hit's device ms a launch
    (:func:`device_ms`: these launches are short enough for CUDA events to
    time the host) on the same rays against the entry's first
    :data:`BRUTE_RINGS` triangles (keys ``brute_anyhit_slice_T{n}_dev_ms``:
    shorter rings, as the brute frames' meshes give it)."""
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops import intersect

    tris, obj, win, sobj, swin = brute_slice(r)
    out = {"brute_closest_slice_ms": cuda_ms(
               lambda: intersect.brute_closest(obj, win, tris, RAY_TMIN), 3, 10),
           "brute_anyhit_slice_ms": cuda_ms(
               lambda: intersect.brute_anyhit(sobj, swin, tris, RAY_TMIN), 3, 10)}
    for n in BRUTE_RINGS:
        part = tris[:n].contiguous()
        out[f"brute_anyhit_slice_T{n}_dev_ms"] = device_ms(
            lambda: intersect.brute_anyhit(sobj, swin, part, RAY_TMIN))
    return out


def compare_brute(r, gpu: str) -> dict:
    """``brute_closest_kernel`` and ``brute_anyhit_kernel`` against their
    plain versions, bit for bit, on :func:`brute_slice` of ``r`` (the
    config2 stand-in); times and bounds (:func:`brute_tests`
    Moller-Trumbore tests at :data:`MT_OPS` operations each; for the
    any-hit the tests to each lane's first hit in index order, and beside
    them the order-free floor: an unoccluded live lane's tests of every
    triangle and one test an occluded lane); the kernels' registers, local
    bytes and resident CTAs, and the any-hit's launch grid. The brute
    frames' own shapes are checked by :func:`compare_brute_waves`."""
    import torch
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops import intersect

    tris, obj, win, sobj, swin = brute_slice(r)
    count = tris.shape[0]
    res = {}
    for name, wrap, ref, x, tmax in (
            ("brute_closest", intersect.brute_closest, intersect.brute_closest_ref,
             obj, win),
            ("brute_anyhit", intersect.brute_anyhit, intersect.brute_anyhit_ref,
             sobj, swin)):
        got = wrap(x, tmax, tris, RAY_TMIN)
        torch.cuda.synchronize()
        start_t = time.perf_counter()
        want = ref(x, tmax, tris, RAY_TMIN)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - start_t) * 1e3
        brute_equal(name, got, want, "config2 slice")
        hit = (got[1] >= 0) if name == "brute_closest" else got
        check(bool(hit.any()) and not bool(hit.all()), f"{name}: the slice mixes "
              "hits and misses")
        tests = brute_tests(name, x, tmax, tris)
        n = tmax.numel()
        live = int((tmax > RAY_TMIN).sum())
        out_bytes = 16 * n if name == "brute_closest" else 4 * n
        res[name] = dict(
            max_abs_err=0.0, ms=cuda_ms(lambda: wrap(x, tmax, tris, RAY_TMIN), 3, 10),
            plain_ms=plain_ms, tests=tests, lanes=n, live=live, triangles=count,
            bound=bound(24 * live + 4 * n + 48 * count + out_bytes, tests * MT_OPS))
        work = f"{tests} tests"
        if name == "brute_anyhit":
            occluded = int(got.sum())
            floor = (live - occluded) * count + occluded
            res[name].update(occluded=occluded, order_free_tests=floor,
                             grid=intersect.anyhit_grid(n, count, x.device))
            work = (f"{tests} tests to each lane's first hit in index order, "
                    f"order-free floor {floor} ({occluded} occluded); launch grid "
                    f"{res[name]['grid']} CTAs of {intersect.ANYHIT_THREADS} threads")
        print(f"{name} on a {SWEEP_PACKETS}-packet slice of the config2 stand-in's "
              f"primary wave ({live} live lanes x {count} triangles, {work}): bit for "
              f"bit against the plain version; {res[name]['ms']:.4f} ms, plain "
              f"{plain_ms:.2f} ms, bound {res[name]['bound'][0]:.4f} ms "
              f"({res[name]['bound'][1]}) [{gpu}]", flush=True)
    res["attributes"] = intersect.kernel_attributes()
    print(f"brute kernels' registers, local bytes, resident CTAs an SM: "
          f"{res['attributes']}", flush=True)
    return res


def compare_brute_waves(r, label: str, gpu: str) -> dict:
    """``brute_closest_kernel`` and ``brute_anyhit_kernel`` against their
    plain versions, bit for bit, at the shapes ``r``'s brute frame gives
    them: for every entry of ``brute_scene(r.tscene)``, the full primary
    wave in the entry's object space against the entry's triangles, and
    the shadow rays of K10a's hits on that wave (a brute frame's first
    closest and any-hit waves)."""
    import torch
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.device_scene import brute_scene
    from raytpu_torch.ops import intersect, trace, traverse

    ts = r.tscene
    rays, act = primary_wave(r)
    win = torch.where(act, RAY_TMAX, 0.0)
    st = traverse.closest_sweep(ts, rays, RAY_TMIN, traverse.make_trace_state(win))
    srays, swin = shadow_rays(ts, rays, st)
    bts = brute_scene(ts)
    out = []
    for inst, _, _, count, start in bts.entry_rows:
        tris = bts.tri_packed[start:start + count]
        obj = trace.object_space(ts, inst, (rays[0], rays[1], rays[2]),
                                 (rays[3], rays[4], rays[5]))
        sobj = trace.object_space(ts, inst, (srays[0], srays[1], srays[2]),
                                  (srays[3], srays[4], srays[5]))
        what = f"{label}, instance {inst}, {count} triangles, {list(win.shape)} lanes"
        got = intersect.brute_closest(obj, win, tris, RAY_TMIN)
        brute_equal("brute_closest", got,
                    intersect.brute_closest_ref(obj, win, tris, RAY_TMIN), what)
        occ = intersect.brute_anyhit(sobj, swin, tris, RAY_TMIN)
        brute_equal("brute_anyhit", occ,
                    intersect.brute_anyhit_ref(sobj, swin, tris, RAY_TMIN), what)
        hits, occluded = int((got[1] >= 0).sum()), int(occ.sum())
        check(hits > 0, f"brute_closest finds hits ({what})")
        out.append({"inst": inst, "triangles": count, "hits": hits,
                    "occluded": occluded})
    print(f"{label}: both brute kernels equal their plain versions bit for bit on "
          f"the full primary wave {list(win.shape)} and its shadow rays, per entry "
          f"{out} [{gpu}]", flush=True)
    return {"lanes": list(win.shape), "entries": out}


def lane_pixels(rs, lanes) -> set:
    """The pixels (y, x) of folded primary-wave lanes (packet, lane)."""
    spp, t = rs.samples_per_pixel, rs.tile
    w_t = -(-rs.width // t)
    out = set()
    for p, k in lanes:
        ty, tx = divmod(p // spp, w_t)
        y, x = ty * t + k // t, tx * t + k % t
        if y < rs.height and x < rs.width:
            out.add((y, x))
    return out


def frame_diff(got, want, allowed: set, what: str) -> int:
    """Pixels where two frames differ; raises unless each is in
    ``allowed`` (the pixels of proven tie lanes)."""
    diff = set(map(tuple, (got != want).any(dim=-1).nonzero().tolist()))
    outside = diff - allowed
    check(not outside, f"{what}: {len(outside)} of {len(diff)} differing pixels are "
          f"not proven ties ({sorted(outside)[:8]})")
    return len(diff)


def timed_frames(r, label: str, gpu: str, tier: str, prof_dir: Path,
                 n: int = 2) -> dict:
    """:func:`render_frames` and :func:`profile_frame` of ``r`` as it is
    set up."""
    rec = render_frames(r, n, KNOB_POSE, KNOB_POSE, label, gpu, tier)
    rec["profile"] = profile_frame(r, prof_dir / f"profile_{label}.txt", label, gpu)
    return rec


def knob_row(rec: dict, n_diff: int, against: str) -> dict:
    return {"median_ms": rec["median_ms"], "frame_ms": rec["frame_ms"],
            "host_syncs": rec["host_syncs"],
            "idle_share": rec["profile"]["idle_share"],
            "busy_ms": rec["profile"]["busy_ms"],
            "pixels_differing": n_diff, "against": against}


def knobs_phase(renderers: dict, scene4, gpu: str, prof_dir: Path):
    """The RenderConfig values of the knobs slice on the card: the brute
    kernels against their plain versions (:func:`compare_brute` on a
    config2 slice, :func:`compare_brute_waves` at the brute frames' shapes
    on config1 and config3), the brute oracle on the primary waves of
    config1-3 and the 256x192 config4 frame (:func:`brute_oracle`),
    config4's known ties
    (:func:`brute_known_ties`), then frames: brute config1 (512x512) and
    config3 (1280x720) against their "xla" frames (the XLA body) and
    within 1e-5 of their fused default frames, config4 chunked on the
    per-lane and pallas tiers against the unchunked frames.
    Each at :data:`KNOB_POSE`, differing only
    in pixels of proven tie lanes; frame ms, host syncs and idle share.
    Returns ``(record, the brute kernels' records with their launches in
    the brute frames, the brute config1 Renderer)``."""
    import torch
    from raytpu_torch import _build, scenes
    from raytpu_torch.device_scene import brute_scene
    from raytpu_torch.integrator import render_frame
    from raytpu_torch.render import Renderer
    from raytpu_torch.scene import load_scene

    start = time.perf_counter()
    rc1 = Renderer(scenes.config1_standin())
    rb1 = Renderer(scenes.config1_standin(traversal="brute"))
    rb3 = Renderer(scenes.config3_standin(traversal="brute"))
    rc2, rc3 = renderers["config2_standin"], renderers["config3_standin"]
    kern = compare_brute(rc2, gpu)
    rec = {"gpu": gpu, "oracle": {}, "frames": {}, "plain_waves": {}}
    for label, r in (("config1_standin", rc1), ("config2_standin", rc2),
                     ("config3_standin", rc3), ("config4_256x192", renderers["small"])):
        pose(r, KNOB_POSE)
        rec["oracle"][label] = brute_oracle(r, label, gpu)
    for label, r in (("config1_standin", rc1), ("config3_standin", rc3)):
        rec["plain_waves"][label] = compare_brute_waves(r, label, gpu)
    known = CONSENSUS_TIES["config3_standin"]
    lanes3 = set(rec["oracle"]["config3_standin"]["tie_lanes"])
    check({tuple(x) for x in known["K10a"] + known["K1"]} <= lanes3,
          f"config3's known ties {known} are among the oracle's proven ties {lanes3}")
    rec["config4_known_ties"] = brute_known_ties(renderers["config4_standin"], gpu)

    def allowed(label, r):
        return lane_pixels(r.render_static, rec["oracle"][label]["tie_lanes"])

    # brute frames: the launches of the brute kernels
    _build.reset_launch_counts()
    brute_rec = {}
    for label, rb in (("config1_standin", rb1), ("config3_standin", rb3)):
        brute_rec[label] = timed_frames(rb, f"{label}_brute", gpu, "brute", prof_dir)
    counts = check_launches(_build.launch_counts(), "brute frames",
                            idle=CHAINED + PER_LANE + CONSENSUS + MESH + FUSED + NEAREST,
                            brute=True)
    for label, r, rb in (("config1_standin", rc1, rb1), ("config3_standin", rc3, rb3)):
        pose(r, KNOB_POSE)
        cam, rs = r.camera_tensor(), r.render_static
        got = render_frame(brute_scene(r.tscene), rs, cam)
        ok = allowed(label, r)
        n_xla = frame_diff(got, render_frame(dataclasses.replace(
            r.tscene, traversal="xla"), rs, cam), ok, f"{label} brute vs xla")
        fused = render_frame(r.tscene, rs, cam)
        tie_mask = torch.zeros(got.shape[:2], dtype=torch.bool, device=got.device)
        for y, x in ok:
            tie_mask[y, x] = True
        far = float(torch.where(tie_mask, 0.0, (got - fused).abs().max(dim=-1).values)
                    .max())
        check(far <= 1e-5, f"{label} brute vs the fused default frame within 1e-5 off "
              f"the tie pixels ({far})")
        rec["frames"][f"{label}_brute"] = dict(
            knob_row(brute_rec[label], n_xla, "xla (the XLA body)"),
            max_abs_diff_fused=far, tie_pixels=len(ok))
        print(f"{label} brute frame at pose {KNOB_POSE}: {n_xla} pixels differ from "
              f"the xla frame (proven tie pixels {len(ok)}), max abs diff to the "
              f"fused default frame off them {far:.3g} [{gpu}]", flush=True)

    # chunked trees: config4 at raytpu's chunk size
    r4 = renderers["config4_standin"]
    t_build = time.perf_counter()
    rk4 = Renderer(load_scene(scene4.config.replace(chunk_tris=CHUNK_TRIS),
                              meshes=scene4.meshes, skybox=scene4.skybox))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t_build
    digest = chunk_digest(rk4.tscene)
    n_entries = len(rk4.tscene.entry_rows)
    print(f"config4 stand-in at chunk_tris={CHUNK_TRIS}: {n_entries} entries, "
          f"{rk4.tscene.bvh_aabb_min.shape[0]} nodes, built in {t_build:.2f} s; trees "
          f"sha256 {digest} (raytpu's {CHUNK_DIGEST}) [{gpu}]", flush=True)
    check(digest == CHUNK_DIGEST, "the port's chunked config4 trees are raytpu's")
    rec["chunked"] = {"entries": n_entries, "nodes": rk4.tscene.bvh_aabb_min.shape[0],
                      "build_s": t_build, "digest": digest}
    for trav in ("auto", "pallas"):
        tier = r4.tscene.auto_tier if trav == "auto" else trav
        name = {"perlane": "K1", "mega": "K8", "pallas": "K10a"}[tier]
        pose(r4, KNOB_POSE)
        pose(rk4, KNOB_POSE)
        ts_a = dataclasses.replace(r4.tscene, traversal=trav)
        ts_c = dataclasses.replace(rk4.tscene, traversal=trav)
        ties = chunk_ties(r4, ts_a, ts_c, name)
        cam = r4.camera_tensor()
        n_diff = frame_diff(render_frame(ts_c, r4.render_static, cam),
                            render_frame(ts_a, r4.render_static, cam),
                            lane_pixels(r4.render_static, ties),
                            f"config4 chunked vs unchunked, {trav}")
        rk4.tscene = ts_c
        row = knob_row(timed_frames(rk4, f"config4_standin_chunked_{tier}", gpu, tier,
                                    prof_dir), n_diff, f"unchunked, {tier}")
        row["primary_tie_lanes"] = ties
        rec["frames"][f"config4_chunked_{tier}"] = row
        print(f"config4 chunked ({n_entries} entries) on the {tier} tier: {n_diff} "
              f"pixels differ from the unchunked frame; {name}'s primary wave differs "
              f"from the unchunked one's on {len(ties)} lanes, each a proven exact tie "
              f"[{gpu}]", flush=True)
    del rk4
    rec["seconds"] = time.perf_counter() - start
    print(f"knobs phase: {rec['seconds']:.2f} s", flush=True)
    for name in BRUTE:
        kern[name]["launches"] = counts[name]
    return rec, kern, rb1


def chunk_ties(r4, ts_a, ts_c, name: str) -> list:
    """On config4's full primary wave, the lanes where the closest sweep
    ``name`` on the chunked scene ``ts_c`` and on the unchunked ``ts_a``
    keep different hits, each a proven exact tie."""
    import torch
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.ops import consensus, perlane, traverse

    sweep = {"K1": perlane.perlane_closest_sweep, "K8": consensus.mega_closest_sweep,
             "K10a": traverse.closest_sweep}[name]
    rays, act = primary_wave(r4)
    win = torch.where(act, RAY_TMAX, 0.0)
    st0 = traverse.make_trace_state(win)
    a, c = sweep(ts_a, rays, RAY_TMIN, st0.clone()), sweep(ts_c, rays, RAY_TMIN, st0.clone())
    lanes = (a.view(torch.int32) != c.view(torch.int32)).any(dim=0).nonzero().tolist()
    check(len(lanes) <= ORACLE_CAP, f"{name}: {len(lanes)} lanes differ chunked vs not")
    for p, k in lanes:
        check(bool(a.view(torch.int32)[1, p, k]) and bool(c.view(torch.int32)[1, p, k]),
              f"{name}: lane {(p, k)} hits in one scene only")
        prove_tie(ts_a, rays, (p, k), sweep_prim(ts_a, name, rays, win, a, p, k),
                  sweep_prim(ts_c, name, rays, win, c, p, k),
                  f"{name} chunked vs unchunked")
    return lanes


AB_FRAMES = (  # (stand-in, its tiers, the first its default, frames, t0 = dt)
    ("config4_standin", ("perlane", "pallas"), 7, 0.05),
    ("reference_standin", ("perlane",), 3, 0.05),
    ("config3_standin", ("mega", "pallas"), 7, 0.0),
    ("config2_standin", ("mega", "pallas"), 7, 0.0),
)


def consensus_times(ts, rays, win, key: str, sched=None) -> dict:
    """K8 and K9 alone on ``rays`` with windows ``win``: K8
    (``consensus.launch_closest``) on the closest sweep's schedule
    (``sched`` if given), K9 (``consensus.launch_anyhit``) on the shadow
    rays of K8's hits and their schedule, made beforehand; ms per launch
    under ``K8_{key}_ms`` and ``K9_{key}_ms``, fresh state and flag copies
    made outside the timed launches, and the kernels' device ms per launch
    (:func:`device_ms`) under ``K8_{key}_dev_ms`` and ``K9_{key}_dev_ms``."""
    import torch
    from raytpu_torch.config import RAY_TMIN
    from raytpu_torch.ops import consensus, perlane, traverse

    st0 = traverse.make_trace_state(win)
    if sched is None:
        sched = perlane.prepass(ts, rays, win, RAY_TMIN, "origin")
    def k8(st):
        return consensus.launch_closest(ts, rays, RAY_TMIN, st, sched)

    out = {f"K8_{key}_ms": cuda_ms_fresh(k8, st0.clone, 3, 10),
           f"K8_{key}_dev_ms": device_ms(lambda: k8(st0.clone()))}
    srays, tmax = shadow_rays(ts, rays, k8(st0.clone()))
    del st0
    ssched = perlane.prepass(ts, srays, tmax, RAY_TMIN, "light")
    occ0 = torch.zeros(tmax.shape, dtype=torch.int32, device=rays.device)

    def k9(occ):
        return consensus.launch_anyhit(ts, srays, RAY_TMIN, tmax, occ, ssched)

    out[f"K9_{key}_ms"] = cuda_ms_fresh(k9, occ0.clone, 3, 10)
    out[f"K9_{key}_dev_ms"] = device_ms(lambda: k9(occ0.clone()))
    return out


def standin_sweep_times(r, label: str) -> dict:
    """K8 and K9 alone (:func:`consensus_times`) on the primary wave of the
    consensus-tier stand-in ``r`` at its pose, on the ``SWEEP_PACKETS``
    slice and on the whole wave, under ``K8_{label}_slice_ms`` and so on
    (``label`` without ``_standin``)."""
    import torch
    from raytpu_torch.config import RAY_TMAX

    rk, act = primary_wave(r)
    idx = torch.tensor(sweep_slice(r.render_static, SWEEP_PACKETS), device=r.device)
    tag = label.removesuffix("_standin")
    out = consensus_times(r.tscene, rk[:, idx].contiguous(),
                          torch.where(act[idx], RAY_TMAX, 0.0).float().contiguous(),
                          f"{tag}_slice")
    out.update(consensus_times(r.tscene, rk, torch.where(act, RAY_TMAX, 0.0).float(),
                               f"{tag}_wave"))
    torch.cuda.empty_cache()
    return out


def sweep_times(r) -> dict:
    """K1, K2, K8, K9, K10a, K10b, K11a and K11b alone on the config4
    stand-in's primary wave at pose 0.05, on the ``SWEEP_PACKETS`` slice and
    on the whole wave: K1/K2 (``perlane.launch_closest``/``launch_anyhit``)
    on a schedule made beforehand, K2 on the shadow rays of K1's hits; K8
    and K9 (:func:`consensus_times`) on K1's schedule, K9 on the shadow
    rays of K8's hits; K10a (``traverse.closest_sweep``), and K10b
    (``traverse.anyhit_sweep``) on the shadow rays of K10a's hits; K11a
    (``traverse.mesh_closest``) and K11b (``traverse.mesh_anyhit``, on
    K10b's rays) over both entries, on the inputs the loop hands them
    (:func:`mesh_walk_inputs`). ms per launch (K11a and K11b per sweep of
    the loop), fresh state and flag copies made outside the timed
    launches."""
    import torch
    from raytpu_torch.config import RAY_TMAX, RAY_TMIN
    from raytpu_torch.ops import perlane, traverse

    ts = r.tscene
    r.set_transforms(0.05)
    rk, act = primary_wave(r)
    idx = torch.tensor(sweep_slice(r.render_static, SWEEP_PACKETS), device=r.device)
    out = {}
    for label, rays, win in (
            ("slice", rk[:, idx].contiguous(),
             torch.where(act[idx], RAY_TMAX, 0.0).float().contiguous()),
            ("wave", rk, torch.where(act, RAY_TMAX, 0.0).float())):
        st0 = traverse.make_trace_state(win)
        sched = perlane.prepass(ts, rays, win, RAY_TMIN, "origin")
        out[f"K1_{label}_ms"] = cuda_ms_fresh(
            lambda st: perlane.launch_closest(ts, rays, RAY_TMIN, st, sched),
            st0.clone, 3, 10)
        srays, tmax = shadow_rays(
            ts, rays, perlane.launch_closest(ts, rays, RAY_TMIN, st0.clone(), sched))
        ssched = perlane.prepass(ts, srays, tmax, RAY_TMIN, "light")
        occ0 = torch.zeros(tmax.shape, dtype=torch.int32, device=r.device)
        out[f"K2_{label}_ms"] = cuda_ms_fresh(
            lambda occ: perlane.launch_anyhit(ts, srays, RAY_TMIN, tmax, occ, ssched),
            occ0.clone, 3, 10)
        del srays, tmax, occ0
        out.update(consensus_times(ts, rays, win, label, sched))
        out[f"K10a_{label}_ms"] = cuda_ms_fresh(
            lambda st: traverse.closest_sweep(ts, rays, RAY_TMIN, st), st0.clone, 3, 10)
        srays, tmax = shadow_rays(
            ts, rays, traverse.closest_sweep(ts, rays, RAY_TMIN, st0.clone()))
        del st0
        occ0 = torch.zeros(tmax.shape, dtype=torch.int32, device=r.device)
        out[f"K10b_{label}_ms"] = cuda_ms_fresh(
            lambda occ: traverse.anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ),
            occ0.clone, 3, 10)
        del occ0
        for key, walk, w_rays, w_win in (
                ("K11a", traverse.mesh_closest, rays, win),
                ("K11b", traverse.mesh_anyhit, srays, tmax)):
            inputs = mesh_walk_inputs(ts, w_rays, w_win, walk)
            out[f"{key}_{label}_ms"] = cuda_ms_fresh(
                lambda _: mesh_walks(ts, inputs, walk), lambda: None, 3, 10)
            del inputs
        del srays, tmax
        torch.cuda.empty_cache()
    return out


def frames_of(root: Path, sweeps_only: bool = False) -> dict:
    """The stand-ins' frames (:data:`AB_FRAMES`) rendered by the port in
    ``root``, a checkout of any commit since the consensus tier: its
    kernels built there, then per stand-in and tier the median frame ms of
    :func:`render_frames` (none if ``sweeps_only``); the times of its K1,
    K2, K8, K9, K10a, K10b, K11a and K11b on config4 (:func:`sweep_times`),
    of its K8 and K9 on the consensus tier's stand-ins
    (:func:`standin_sweep_times`), of its brute kernels on the config2
    slice (:func:`brute_times`) and of the brute oracle's shadow loop on
    the 256x192 config4 check wave (:func:`check_wave_times`); and its
    kernels' resources (:func:`kernel_resources`, under
    ``"resources"``)."""
    import torch

    sys.path.insert(0, str(root))
    import raytpu_torch
    from raytpu_torch import _build, scenes
    from raytpu_torch.render import Renderer

    check(Path(raytpu_torch.__file__).resolve().is_relative_to(root.resolve()),
          f"the port is imported from {root} ({raytpu_torch.__file__})")
    _build.build()
    _build.library()
    gpu = gpu_line()
    out = {}
    for label, tiers, n, dt in AB_FRAMES:
        if sweeps_only and label == "reference_standin":
            continue       # no sweep is timed there
        r = Renderer(getattr(scenes, label)())
        if label == "config4_standin":
            out.update(sweep_times(r))
            out.update(check_wave_times(r.scene))
        elif tiers[0] == "mega":
            out.update(standin_sweep_times(r, label))
        if label == "config2_standin":
            out.update(brute_times(r))
        base = r.tscene
        for tier in () if sweeps_only else tiers:
            r.tscene = dataclasses.replace(
                base, traversal="auto" if tier == tiers[0] else tier)
            out[f"{label}_{tier}"] = render_frames(
                r, n, dt, dt, f"{label}_{tier}", gpu, tier)["median_ms"]
        del r
        torch.cuda.empty_cache()
    out["resources"] = kernel_resources()
    return out


def compare_trees(roots, labels, sweeps_only: bool) -> int:
    """:func:`frames_of` each tree of ``roots`` (named by ``labels``) in a
    child process of its own, one after the other on the one card, and
    print the results of the runs side by side: the frame medians and sweep
    times, then each sweep's registers and local and stack bytes."""
    gpu = gpu_line()
    print(gpu, flush=True)
    runs = []
    for root in roots:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--frames-of", str(root)]
        proc = subprocess.run(cmd + ["--sweeps-only"] * sweeps_only,
                              capture_output=True, text=True, timeout=600)
        print(proc.stdout, proc.stderr[-3000:], sep="", flush=True)
        check(proc.returncode == 0, f"the port in {root} ran")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"{'frame or sweep':38s} " + " ".join(f"{f'{who}, run {i + 1}':>14s}"
                                                for i, who in enumerate(labels))
          + f" (median frame ms; sweep ms a launch) [{gpu}]")
    for key in runs[0]:
        if key != "resources":
            print(f"{key:38s} " + " ".join(f"{run.get(key, float('nan')):14.4f}"
                                           for run in runs))
    def regs(run, name):
        res = run["resources"].get(name, {})
        return "/".join(str(res.get(k, "-")) for k in ("REG", "LOCAL", "STACK"))

    for name in CHAINED + PER_LANE[1:] + CONSENSUS + MESH + BRUTE:
        print(f"{name + ' REG/LOCAL/STACK':38s} "
              + " ".join(f"{regs(run, name):>14s}" for run in runs))
    print(json.dumps({"gpu": gpu, "order": labels, "runs": runs}))
    return 0


def ab(parent: Path, this_first: bool = False) -> int:
    """The frames of :data:`AB_FRAMES`, the sweep and brute kernel times of
    :func:`frames_of` and the kernels' resources with the port in
    ``parent`` and with this one, alternately in four child processes on
    the one card (parent, this, this, parent; or this, parent, parent, this
    if ``this_first``)."""
    order = ["this", "parent", "parent", "this"] if this_first else \
        ["parent", "this", "this", "parent"]
    return compare_trees([REPO if who == "this" else parent for who in order],
                         order, sweeps_only=False)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=str(REPO / "build" / "profile"),
                    help="where the torch.profiler tables of one frame of each "
                    "stand-in go (default: build/profile/)")
    ap.add_argument("--ab", metavar="PARENT",
                    help="instead of the smoke run, time the stand-ins' frames with "
                    "the port of PARENT (a checkout of another commit) and with "
                    "this one, alternately in child processes (parent first)")
    ap.add_argument("--this-first", action="store_true",
                    help="with --ab: this checkout's run first (this, parent, "
                    "parent, this)")
    ap.add_argument("--sweeps", metavar="DIR", nargs="+",
                    help="instead of the smoke run, time K1, K2, K8, K9, K10a, K10b, "
                    "K11a, K11b and the brute kernels alone with the port of each DIR "
                    "(a checkout, or a variant tree), in child processes in the order "
                    "given")
    ap.add_argument("--frames-of", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--sweeps-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    if not (REPO / "raytpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} holds no raytpu_torch package", file=sys.stderr)
        return 1
    if args.frames_of:
        print(json.dumps(frames_of(Path(args.frames_of), args.sweeps_only)))
        return 0
    if args.ab:
        return ab(Path(args.ab), args.this_first)
    if args.sweeps:
        return compare_trees([Path(d) for d in args.sweeps], args.sweeps,
                             sweeps_only=True)
    import_port()
    from raytpu_torch import _build, scenes
    from raytpu_torch.integrator import PACKET_K, frame_tier, plain_kernels, render_frame
    from raytpu_torch.render import Renderer
    from raytpu_torch.scene import load_scene
    from raytpu_torch.utils.ssim import ssim

    gpu = gpu_line()
    print(gpu)
    print(f"{gpu}, max SM clock {max_sm_mhz():.0f} MHz: bounds at "
          f"{f32_ops_per_s():.4g} unfused f32 operations/s and "
          f"{HBM_BYTES_PER_S:.4g} B/s", flush=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} | nvcc: {nvcc.splitlines()[-1]}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prof_dir = Path(args.profile)

    start = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"kernel build: {time.perf_counter() - start:.2f} s -> {lib.name}", flush=True)

    start = time.perf_counter()
    scene4 = scenes.config4_standin()
    t_gen = time.perf_counter() - start
    start = time.perf_counter()
    r4 = Renderer(scene4)
    torch.cuda.synchronize()
    t_bvh = time.perf_counter() - start
    ts = r4.tscene
    print(f"config4 stand-in: scene generation {t_gen:.2f} s, BVH build + upload "
          f"{t_bvh:.2f} s ({ts.bvh_aabb_min.shape[0]} nodes, "
          f"{ts.bvh_tri_v0.shape[0]} triangles, {len(ts.traversal_list)} entries; "
          f"packed records of K1/K2, K8/K9 and K10a-K11b "
          f"{nbytes(ts.packed_nodes, ts.packed_pairs, ts.packed_wide, ts.packed_tris)} "
          f"bytes)", flush=True)
    digest = tree_digest(first_tree(ts))
    print(f"teapot stand-in tree sha256 {digest} (raytpu's {TREE_DIGEST})", flush=True)
    check(digest == TREE_DIGEST, "the port builds raytpu's tree of the teapot stand-in")
    rs4 = r4.render_static
    check(rs4.wavefront == "compact",
          f"the stand-ins render the default path ({rs4})")

    r4.set_transforms(0.05)
    kern = compare_kernels(r4, gpu)

    # the main path: config4's default tier, per-lane
    check((ts.traversal, ts.auto_tier) == ("auto", "perlane"),
          f"config4 resolves to the per-lane tier ({ts.traversal}, {ts.auto_tier})")
    c4 = render_frames(r4, 5, 0.05, 0.05, "config4_standin", gpu, "perlane")
    counts = c4["launches"]
    check(set(counts) == set(KERNELS), f"chip_smoke lists every kernel ({counts})")
    c4["launches"] = check_launches(counts, "config4 frames",
                                    idle=CHAINED + CONSENSUS + MESH + NEAREST)
    c4["profile"] = profile_frame(r4, prof_dir / "profile_config4.txt",
                                  "config4_standin", gpu)

    # the chained tier on the same scene, the same frames
    r4.tscene = dataclasses.replace(r4.tscene, traversal="pallas")
    pal4 = render_frames(r4, 5, 0.05, 0.05, "config4_standin_pallas", gpu, "pallas")
    check(pal4["rays"] == c4["rays"], "both tiers trace the same rays in the same frames")
    pal_counts = pal4["launches"]
    pal4["launches"] = check_launches(pal_counts, "config4 pallas-tier frames",
                                      idle=PER_LANE + CONSENSUS + MESH + NEAREST)
    pal4["profile"] = profile_frame(r4, prof_dir / "profile_config4_pallas.txt",
                                    "config4_standin_pallas", gpu)
    r4.tscene = dataclasses.replace(r4.tscene, traversal="auto")
    waves4 = tier_waves(r4, 0.05)

    r4.render_static = dataclasses.replace(rs4, wavefront="full")
    full4 = render_frames(r4, 2, 0.05, 0.05, "config4_standin_full_width", gpu,
                          "perlane")
    r4.render_static = rs4

    # traversal="xla": the XLA body, compacted, on the per-(instance, mesh)
    # loop (K11a/K11b)
    r4.tscene = dataclasses.replace(r4.tscene, traversal="xla")
    xla4 = render_frames(r4, 2, 0.05, 0.05, "config4_standin_xla", gpu, "xla")
    mesh_counts = xla4["launches"]
    xla4["launches"] = check_launches(mesh_counts, "config4 xla frames",
                                      idle=CHAINED + PER_LANE + CONSENSUS + FUSED + NEAREST)
    xla4["profile"] = profile_frame(r4, prof_dir / "profile_config4_xla.txt",
                                    "config4_standin_xla", gpu)
    got, want = same_rays_frames(r4, rs4, rs4, ts_b=dataclasses.replace(
        r4.tscene, traversal="pallas"))
    xla4["same_rays_max_abs_diff_to_pallas"] = max(
        (a - b).abs().max().item() for a, b in zip(got, want))
    print(f"config4 xla frame (the body on K11a/K11b) vs the fused pallas-tier frame "
          f"from the same primary rays: max abs diff "
          f"{xla4['same_rays_max_abs_diff_to_pallas']:.3g}", flush=True)
    check(xla4["same_rays_max_abs_diff_to_pallas"] <= 1e-5,
          "config4 xla frame within 1e-5 of the fused pallas-tier frame")
    del got, want
    r4.tscene = dataclasses.replace(r4.tscene, traversal="auto")

    start = time.perf_counter()
    ref_scene = scenes.reference_standin()
    rr = Renderer(ref_scene)
    print(f"reference stand-in: scene + BVH {time.perf_counter() - start:.2f} s", flush=True)
    ref = render_frames(rr, 2, 0.05, 0.05, "reference_standin", gpu, "perlane")
    ref["launches"] = check_launches(ref["launches"], "reference frames",
                                     idle=CHAINED + CONSENSUS + MESH + NEAREST)
    ref["profile"] = profile_frame(rr, prof_dir / "profile_reference.txt",
                                   "reference_standin", gpu)
    renderers = {"config4_standin": r4, "reference_standin": rr}

    # the consensus tier's stand-ins: config3 (its frames count K8/K9's
    # launches for the kernels line), then config2
    cons, cons_kern, cons_counts = {}, {}, None
    for label, make in (("config3_standin", scenes.config3_standin),
                        ("config2_standin", scenes.config2_standin)):
        start = time.perf_counter()
        rc = Renderer(make())
        torch.cuda.synchronize()
        tsc = rc.tscene
        print(f"{label}: scene + BVH {time.perf_counter() - start:.2f} s "
              f"({tsc.bvh_aabb_min.shape[0]} nodes, {tsc.bvh_tri_v0.shape[0]} "
              f"triangles, {len(tsc.traversal_list)} entries)", flush=True)
        check(rc.render_static.wavefront == "compact",
              f"{label} renders the default path")
        res, ties = compare_consensus(rc, label, gpu,
                                      whole_plain=label == "config3_standin")
        cons[label], counts_c = standin_tiers(rc, label, gpu, prof_dir,
                                              len(ties["K10a"]))
        cons[label]["full_wave_ties"] = ties
        cons[label]["kernels"] = res
        if cons_counts is None:
            cons_kern, cons_counts = res, counts_c
        renderers[label] = rc

    small = Renderer(load_scene(scene4.config.replace(width=256, height=192),
                                meshes=scene4.meshes, skybox=scene4.skybox))
    small.set_transforms(0.1)
    rs_s = small.render_static
    cam = small.camera_tensor()
    check(frame_tier(small.tscene, 256, PACKET_K) == "perlane", "256x192 renders per-lane")
    img_k = render_frame(small.tscene, rs_s, cam)
    img_full = render_frame(small.tscene, dataclasses.replace(rs_s, wavefront="full"), cam)
    check(torch.equal(img_k, img_full),
          "256x192 compacted frame equals the full-width fused frame bit for bit")
    img_pal = render_frame(dataclasses.replace(small.tscene, traversal="pallas"), rs_s, cam)
    check(torch.equal(img_k, img_pal),
          "256x192 per-lane frame equals the pallas-tier frame bit for bit")
    img_mega = render_frame(dataclasses.replace(small.tscene, traversal="mega"), rs_s, cam)
    check(torch.equal(img_mega, img_k),
          "256x192 consensus-tier frame equals the per-lane frame bit for bit")
    print("256x192 compacted per-lane frame vs full-width fused frame and vs the "
          "pallas-tier and consensus-tier frames on the card: bit for bit", flush=True)
    ts_x = dataclasses.replace(small.tscene, traversal="xla")
    body = render_frame(ts_x, rs_s, cam)
    check(torch.equal(body, render_frame(ts_x, dataclasses.replace(
        rs_s, wavefront="full"), cam)),
          "256x192 xla: the compacted XLA body equals the full-width body bit for bit")
    print("256x192 XLA body on the xla tier, compacted vs full width: bit for bit",
          flush=True)
    with plain_kernels():
        img_p = render_frame(small.tscene, rs_s, cam).cpu().numpy()
    img_k = img_k.cpu().numpy()
    s = ssim(img_k, img_p)
    diff = float(abs(img_k - img_p).max())
    print(f"256x192 kernel path vs plain path on the card: SSIM {s:.6f}, "
          f"max abs diff {diff:.3g}", flush=True)
    check(s > 0.99, f"256x192 kernel vs plain SSIM > 0.99 ({s})")
    got, want = same_rays_frames(small, rs_s, rs_s, plain_b=True)
    same = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f"256x192 kernel path vs plain path from the same primary rays: "
          f"max abs diff {same:.3g}", flush=True)
    check(same <= 1e-6, f"same-rays frames within 1e-6 ({same})")
    got, want = same_rays_frames(small, rs_s, rs_s, ts_b=ts_x)
    body_diff = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f"256x192 fused per-lane frame vs the xla tier's XLA body frame from the "
          f"same primary rays: max abs diff {body_diff:.3g}", flush=True)
    check(body_diff <= 1e-5, f"fused vs XLA body frame within 1e-5 ({body_diff})")
    tie_r = Renderer(scenes.tie_scene())
    tie = tie_check(tie_r)

    knobs, kern_brute, rb1 = knobs_phase({**renderers, "small": small}, scene4, gpu,
                                         prof_dir)

    opts, kern_near = options_phase(r4, renderers["config2_standin"], t_bvh, gpu,
                                    prof_dir)

    start = time.perf_counter()
    entry = entry_points(renderers, gpu)
    print(f"entry-points phase: {time.perf_counter() - start:.2f} s", flush=True)
    sharding = sharding_phase({**renderers, "small": small, "tie": tie_r,
                               "config1_brute": rb1}, gpu)
    del renderers, small, tie_r, rb1
    loaders = native_loaders(scene4.meshes[1], gpu)

    print(json.dumps({"gpu": gpu, "config4_standin": c4,
                      "config4_standin_pallas": pal4, "config4_tier_waves": waves4,
                      "config4_standin_full_width": full4,
                      "config4_standin_xla": xla4, "reference_standin": ref,
                      **cons,
                      "small_frame": {"ssim": s, "max_abs_diff": diff,
                                      "same_rays_max_abs_diff": same,
                                      "body_same_rays_max_abs_diff": body_diff,
                                      "compact_equals_full": True,
                                      "perlane_equals_pallas": True,
                                      "mega_equals_perlane": True,
                                      "body_compact_equals_full": True},
                      "tie_check": tie, "knobs": knobs, "render_options": opts,
                      "entry_points": entry, "sharding": sharding,
                      "native_loaders": loaders,
                      "full_wave_ties": kern["perlane_closest_sweep"]["full_wave_ties"],
                      "loop_full_wave_ties": kern["mesh_closest"]["full_wave_ties"],
                      "kernel_work": {k: v["work"] for k, v in kern.items() if "work" in v},
                      "prepass": {k: {f: v[f] for f in v if "prepass" in f or "ops" in f}
                                  for k, v in kern.items() if "prepass_ms" in v}}))
    kern.update(cons_kern)
    kern.update({name: kern_brute[name] for name in BRUTE})
    kern["sky_nearest"] = kern_near

    def launches(name):
        if name in NEAREST:
            return kern_near["launches"]
        if name in BRUTE:
            return kern_brute[name]["launches"]
        return (pal_counts if name in CHAINED else cons_counts if name in CONSENSUS
                else mesh_counts if name in MESH else counts)[name]

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches(name),
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"], "bound_ms": kern[name]["bound"][0],
         "bound_by": kern[name]["bound"][1], "library_ms": None}
        for name in _build.KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
