#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``raytpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                # from the repository root
    python3 chip_smoke.py --profile DIR  # profiler tables into DIR
                                         # (default build/profile/)

Builds the six hand-written CUDA kernels from ``raytpu_torch/csrc`` and the
BVHs, holds every kernel against its plain PyTorch version on the card at
the main path's shapes, renders the config4 stand-in (1920x1080, 4 spp,
3 bounces, 327,680-triangle orbiting mesh) and the reference-default
stand-in (800x600, 4 spp, 63 bounces) through ``Renderer`` on the default
fused and compacted bounce loop, checks that the frames went through all
six kernels and are sane, profiles one frame of each for the device's idle
share, renders two config4 frames through the eager ``fused="off"`` body
and two through the fused loop at full width (no compaction), and at 256x192 (P = 256, budget 64, so compaction engages) holds the
compacted frame against the full-width fused frame (bit for bit), the eager
frame from the same rays, and the plain path (SSIM, and max abs diff from
the same primary rays). Any failed check raises and exits non-zero. It
imports nothing of JAX or raytpu.

The last three lines: the frames and checks as one JSON object, the
per-kernel JSON line (launches counted during the config4 frames, errors
against the plain versions, times, bounds), and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    "shade_epilogue": ("raytpu_torch/csrc/epilogue.cu",
                       "raytpu/ops/epilogue.py:86"),
    "accumulate_epilogue": ("raytpu_torch/csrc/epilogue.cu",
                            "raytpu/ops/epilogue.py:236"),
}
SWEEP_PACKETS = 256
RAYGEN_DIR_TOL = 1e-5  # kernel vs plain raygen, same f32 ops on one card
EPILOGUE_ULPS = 2      # shade/accumulate kernel vs plain version, f32 ulps

# Bounds: the larger of the bytes a call must move (each input read once,
# each output written once) over the H100's 3.35 TB/s and its operations
# over 67 TFLOP/s of f32 outside the tensor cores (NVIDIA's H100 SXM data
# sheet, at a 700 W power limit). Operations per lane are counted from the
# sources, each arithmetic operation, comparison and libm call as one; the
# sweeps' from the node visits and triangle tests the plain walk counts.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_LANE = {"raygen": 55, "sky": 80, "shade_epilogue": 100,
                "accumulate_epilogue": 18}
SLAB_OPS, MT_OPS = 23, 51  # one node's box test, one Moller-Trumbore test


def check(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def import_port():
    """Every module of the port the phases use (nothing of JAX or raytpu)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import torch  # noqa: F401
    from raytpu_torch import _build, config, integrator, render, scene, scenes  # noqa: F401
    from raytpu_torch.ops import epilogue, raygen, sky, traverse, vec3  # noqa: F401
    from raytpu_torch.utils import ssim  # noqa: F401


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def bound(nbytes: float, ops: float):
    """(bound ms, what bounds it) for a call moving ``nbytes`` and doing
    ``ops`` f32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ulps(a, b):
    """Per-element distance in f32 ulps (same-sign values)."""
    import torch

    ai = a.contiguous().view(torch.int32).long()
    bi = b.contiguous().view(torch.int32).long()
    return (ai - bi).abs()


def sweep_slice(rs, n_packets: int):
    """Packet indices of the folded config4 wave around the frame centre:
    a square block of tiles, every sample of each tile."""
    spp = rs.samples_per_pixel
    w_t = -(-rs.width // rs.tile)
    h_t = -(-rs.height // rs.tile)
    side = int(round((n_packets // spp) ** 0.5))
    y0, x0 = h_t // 2 - side // 2, w_t // 2 - side // 2
    tiles = [(y0 + y) * w_t + x0 + x for y in range(side) for x in range(side)]
    return [t * spp + s for t in tiles for s in range(spp)]


def sweep_bound(counts: dict, lane_bytes: int, tables: int):
    """Bound of a sweep call from the plain walk's node visits and tests."""
    ops = counts.get("nodes", 0) * SLAB_OPS + counts.get("tests", 0) * MT_OPS
    return bound(lane_bytes + tables, ops)


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
    from raytpu_torch.ops import raygen, sky, traverse
    from raytpu_torch.ops import vec3 as v3

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

    tables = nbytes(ts.entries, ts.w2o, ts.bvh_aabb_min, ts.bvh_aabb_max,
                    ts.bvh_tri_first, ts.bvh_tri_count, ts.bvh_miss,
                    ts.bvh_tri_v0, ts.bvh_tri_e1, ts.bvh_tri_e2)

    # the sweeps on a 256-packet slice of the primary wave
    idx = torch.tensor(sweep_slice(rs, SWEEP_PACKETS), device=dev)
    rays = rk[:, idx].contiguous()
    win = torch.where(act[idx], RAY_TMAX, 0.0).float().contiguous()
    st0 = traverse.make_trace_state(win)
    sk_ = traverse.closest_sweep(ts, rays, RAY_TMIN, st0.clone())
    counts = {}
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
        bound=sweep_bound(counts, nbytes(rays, st0, sk_) + nbytes(ts.bvh_tri_n_soa), tables),
        work=dict(counts, rays=live))
    print(f"closest {list(rays.shape)}: valid/mat/inst exact, hit {hit_frac:.3f}, "
          f"t/u/v <= 4 ulps, bitwise {bitwise}; plain walk per live ray: "
          f"{counts['nodes'] / live:.1f} node visits, {counts['tests'] / live:.1f} "
          f"triangle tests", flush=True)

    # shadow rays from the hits toward the light, window = light distance
    t, vmask, _, _, nrm, _, _ = traverse.unpack_state(sp_)
    o = (rays[0], rays[1], rays[2])
    d = (rays[3], rays[4], rays[5])
    nrm = v3.normalize(nrm)
    pos = v3.add(o, v3.scale(torch.where(vmask, t, 0.0), d))
    so = v3.add(pos, v3.scale(1e-2, nrm))
    to_l = tuple(ts.light_pos[c] - pos[c] for c in range(3))
    dist = v3.norm(to_l)
    ld = v3.scale(1.0 / torch.clamp_min(dist, 1e-30), to_l)
    srays = torch.stack((*so, *ld)).contiguous()
    tmax = torch.where(vmask, dist, 0.0).contiguous()
    occ0 = torch.zeros(tmax.shape, dtype=torch.int32, device=dev)
    ok_ = traverse.anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone())
    counts = {}
    op_ = traverse.anyhit_sweep_ref(ts, srays, RAY_TMIN, tmax, occ0.clone(), counts=counts)
    check(torch.equal(ok_, op_), "anyhit occlusion exact")
    occ_frac = (ok_ != 0).float().mean().item()
    live = int((tmax > RAY_TMIN).sum().item())
    res["anyhit_sweep"] = dict(
        max_abs_err=(ok_ - op_).abs().max().item(),
        ms=cuda_ms(lambda: traverse.anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone()), 3, 10),
        plain_ms=cuda_ms(lambda: traverse.anyhit_sweep_ref(ts, srays, RAY_TMIN, tmax, occ0.clone()), 1, 2),
        shape=list(srays.shape),
        bound=sweep_bound(counts, nbytes(srays, tmax, occ0, ok_), tables),
        work=dict(counts, rays=live))
    print(f"anyhit  {list(srays.shape)}: occ exact, occluded {occ_frac:.3f}; plain "
          f"walk per live ray: {counts['nodes'] / live:.1f} node visits, "
          f"{counts['tests'] / live:.1f} triangle tests", flush=True)

    # the closest kernel alone on the full primary wave
    full_st = traverse.make_trace_state(torch.where(act, RAY_TMAX, 0.0).float())
    res["closest_sweep"]["full_wave_ms"] = cuda_ms(
        lambda: traverse.closest_sweep(ts, rk, RAY_TMIN, full_st.clone()), 1, 3)
    compare_epilogue(r, rk, full_st, act, s_row, res, gpu)
    for name, v in res.items():
        print(f"time {name:19s} kernel {v['ms']:.4f} ms  plain {v['plain_ms']:.4f} ms"
              f"  bound {v['bound'][0]:.4f} ms ({v['bound'][1]})  shape {v['shape']}"
              f"  [{gpu}]", flush=True)
    print(f"time closest_sweep full primary wave {list(rk.shape)}: "
          f"{res['closest_sweep']['full_wave_ms']:.4f} ms [{gpu}]", flush=True)
    return res


def render_frames(r, n_frames: int, t0: float, dt: float, label: str, gpu: str) -> dict:
    """Warm-up frame, then ``n_frames`` with advancing transforms; checks."""
    import torch

    r.set_transforms(t0)
    r.render()
    torch.cuda.synchronize()
    ms, rays, syncs = [], [], []
    for i in range(n_frames):
        r.set_transforms(t0 + dt * (i + 1))
        stats = {}
        torch.cuda.synchronize()
        start = time.perf_counter()
        img = r.render(stats=stats)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - start) * 1e3)
        check(bool(torch.isfinite(img).all()), f"{label} frame {i} finite")
        std = img.std().item()
        check(std > 1e-3, f"{label} frame {i} not constant (std {std})")
        rays.append(sum(int(stats[k].item()) for k in ("closest_rays", "shadow_rays")
                        if k in stats))
        syncs.append(stats["host_syncs"])
    med = statistics.median(ms)
    ray_med = int(statistics.median(rays))
    rs = r.render_static
    print(f"{label}: {rs.width}x{rs.height} spp {rs.samples_per_pixel} bounces "
          f"{rs.max_bounce_count} fused {rs.fused} wavefront {rs.wavefront}: "
          f"frame ms {[round(x, 3) for x in ms]} median {med:.3f} ms, rays traced "
          f"{ray_med}, {ray_med / med / 1e3:.2f} Mrays/s, host syncs per frame "
          f"{syncs} [{gpu}]", flush=True)
    return dict(frame_ms=ms, median_ms=med, rays=ray_med,
                mrays_per_s=ray_med / med / 1e3, host_syncs=syncs)


def same_rays_frames(r, rs_a, rs_b, plain_b: bool = False):
    """The frames of render statics ``rs_a`` and ``rs_b`` from the plain
    raygen's primary rays (``rs_b`` through the plain versions if
    ``plain_b``)."""
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
    got = render_packets(r.tscene, rs_a, cam, px, py, in_frame, rays6=rays6)
    if plain_b:
        with plain_kernels():
            want = render_packets(r.tscene, rs_b, cam, px, py, in_frame, rays6=rays6)
    else:
        want = render_packets(r.tscene, rs_b, cam, px, py, in_frame, rays6=rays6)
    return got, want


def profile_frame(r, path: Path, label: str, gpu: str) -> dict:
    """torch.profiler table of one frame, its device busy time and idle
    share, and the share of each hand-written kernel in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    check(busy > 0, f"{label}: the profiler saw device time")
    per_kernel = {
        name: sum(e.self_device_time_total for e in device
                  if f"{name}_kernel" in e.key) / 1e3
        for name in KERNELS
    }
    table = events.table(sort_by="device_time_total", row_limit=40)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"{gpu}\n{table}\n")
    idle = 1.0 - busy / wall
    print(f"{label} profiled frame: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"device idle {idle:.1%}, kernels ms {per_kernel}, other device ms "
          f"{busy - sum(per_kernel.values()):.3f}; table in {path} [{gpu}]",
          flush=True)
    return dict(wall_ms=wall, busy_ms=busy, idle_share=idle, kernels_ms=per_kernel)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=str(REPO / "build" / "profile"),
                    help="where the torch.profiler tables of one frame of each "
                    "stand-in go (default: build/profile/)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    if not (REPO / "raytpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} holds no raytpu_torch package", file=sys.stderr)
        return 1
    import_port()
    from raytpu_torch import _build, scenes
    from raytpu_torch.integrator import plain_kernels, render_frame
    from raytpu_torch.render import Renderer
    from raytpu_torch.scene import load_scene
    from raytpu_torch.utils.ssim import ssim

    gpu = gpu_line()
    print(gpu)
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
          f"{ts.bvh_tri_v0.shape[0]} triangles, {len(ts.traversal_list)} entries)",
          flush=True)
    rs4 = r4.render_static
    check(rs4.fused == "on" and rs4.wavefront == "compact",
          f"the stand-ins render the default path ({rs4})")

    r4.set_transforms(0.05)
    kern = compare_kernels(r4, gpu)

    _build.reset_launch_counts()
    c4 = render_frames(r4, 5, 0.05, 0.05, "config4_standin", gpu)
    counts = _build.launch_counts()
    print(f"launches during config4 frames: {counts}", flush=True)
    check(set(counts) == set(KERNELS), f"chip_smoke lists every kernel ({counts})")
    for name in _build.KERNELS:
        check(counts[name] > 0, f"{name} launched during the config4 frames")
    c4["profile"] = profile_frame(r4, prof_dir / "profile_config4.txt",
                                  "config4_standin", gpu)

    r4.render_static = dataclasses.replace(rs4, fused="off", wavefront="full")
    eager4 = render_frames(r4, 2, 0.05, 0.05, "config4_standin_eager", gpu)
    r4.render_static = dataclasses.replace(rs4, wavefront="full")
    full4 = render_frames(r4, 2, 0.05, 0.05, "config4_standin_full_width", gpu)
    r4.render_static = rs4

    start = time.perf_counter()
    ref_scene = scenes.reference_standin()
    rr = Renderer(ref_scene)
    print(f"reference stand-in: scene + BVH {time.perf_counter() - start:.2f} s", flush=True)
    _build.reset_launch_counts()
    ref = render_frames(rr, 2, 0.05, 0.05, "reference_standin", gpu)
    ref_counts = _build.launch_counts()
    print(f"launches during reference frames: {ref_counts}", flush=True)
    for name in _build.KERNELS:
        check(ref_counts[name] > 0, f"{name} launched during the reference frames")
    ref["profile"] = profile_frame(rr, prof_dir / "profile_reference.txt",
                                   "reference_standin", gpu)
    del rr

    small = Renderer(load_scene(scene4.config.replace(width=256, height=192),
                                meshes=scene4.meshes, skybox=scene4.skybox))
    small.set_transforms(0.1)
    rs_s = small.render_static
    cam = small.camera_tensor()
    img_k = render_frame(small.tscene, rs_s, cam)
    img_full = render_frame(small.tscene, dataclasses.replace(rs_s, wavefront="full"), cam)
    check(torch.equal(img_k, img_full),
          "256x192 compacted frame equals the full-width fused frame bit for bit")
    print("256x192 compacted frame vs full-width fused frame on the card: bit for bit",
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
    got, want = same_rays_frames(
        small, rs_s, dataclasses.replace(rs_s, fused="off", wavefront="full"))
    eager_diff = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f"256x192 fused compacted frame vs eager frame from the same primary "
          f"rays: max abs diff {eager_diff:.3g}", flush=True)
    check(eager_diff <= 1e-5, f"fused vs eager frame within 1e-5 ({eager_diff})")

    print(json.dumps({"gpu": gpu, "config4_standin": c4, "config4_standin_eager": eager4,
                      "config4_standin_full_width": full4, "reference_standin": ref,
                      "small_frame": {"ssim": s, "max_abs_diff": diff,
                                      "same_rays_max_abs_diff": same,
                                      "eager_same_rays_max_abs_diff": eager_diff,
                                      "compact_equals_full": True},
                      "kernel_work": {k: v["work"] for k, v in kern.items() if "work" in v}}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": counts[name],
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
