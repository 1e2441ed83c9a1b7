#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``raytpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile DIR  # also torch.profiler tables

Builds the four hand-written CUDA kernels from ``raytpu_torch/csrc`` and the
BVHs, holds every kernel against its plain PyTorch version on the card at
the main path's shapes, renders the config4 stand-in (1920x1080, 4 spp,
3 bounces, 327,680-triangle orbiting mesh) and the reference-default
stand-in (800x600, 4 spp, 63 bounces) through ``Renderer``, checks that the
frames went through all four kernels and are sane, and compares a 256x192
frame of the kernel path with the plain path, end to end (SSIM) and from
the same primary rays (max abs diff). Any failed check raises and exits
non-zero. It imports no JAX.

The line before the last is one JSON object with per-kernel launches
(counted during the config4 stand-in frames), errors against the plain
versions and times; the line before it holds the frame times, rays and
host syncs of both stand-ins; the last line is ``{"ok": true, "device":
{...}}``.
``--profile DIR`` also writes a torch.profiler table of one frame of each
stand-in into DIR and prints each frame's device busy time.
"""

from __future__ import annotations

import argparse
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
}
SWEEP_PACKETS = 256
RAYGEN_DIR_TOL = 1e-5  # kernel vs plain raygen, same f32 ops on one card


def check(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


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


def compare_kernels(r, gpu: str) -> dict:
    """Each kernel against its plain version on the card, main-path shapes."""
    import torch
    from raytpu.config import RAY_TMAX, RAY_TMIN
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
                         plain_ms=cuda_ms(rg_p, 3, 10), shape=list(rk.shape))
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

    sk_err = max((a - b).abs().max().item() for a, b in zip(sky_k(), sky_p()))
    check(sk_err <= 1e-6, f"sky within 1e-6 ({sk_err})")
    res["sky"] = dict(max_abs_err=sk_err, ms=cuda_ms(sky_k, 3, 10),
                      plain_ms=cuda_ms(sky_p, 3, 10), shape=list(dirs[0].shape))
    print(f"sky     {list(dirs[0].shape)} lanes, {h}x{w} faces: max err {sk_err:.3g}",
          flush=True)

    # the sweeps on a 256-packet slice of the primary wave
    idx = torch.tensor(sweep_slice(rs, SWEEP_PACKETS), device=dev)
    rays = rk[:, idx].contiguous()
    win = torch.where(act[idx], RAY_TMAX, 0.0).float().contiguous()
    st0 = traverse.make_trace_state(win)
    sk_ = traverse.closest_sweep(ts, rays, RAY_TMIN, st0.clone())
    sp_ = traverse.closest_sweep_ref(ts, rays, RAY_TMIN, st0.clone())
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
    res["closest_sweep"] = dict(
        max_abs_err=cl_err,
        ms=cuda_ms(lambda: traverse.closest_sweep(ts, rays, RAY_TMIN, st0.clone()), 3, 10),
        plain_ms=cuda_ms(lambda: traverse.closest_sweep_ref(ts, rays, RAY_TMIN, st0.clone()), 1, 2),
        shape=list(rays.shape))
    print(f"closest {list(rays.shape)}: valid/mat/inst exact, hit {hit_frac:.3f}, "
          f"t/u/v <= 4 ulps, bitwise {bitwise}", flush=True)

    # shadow rays from the hits toward the light, window = light distance
    t, vmask, _, _, n, _, _ = traverse.unpack_state(sp_)
    o = (rays[0], rays[1], rays[2])
    d = (rays[3], rays[4], rays[5])
    n = v3.normalize(n)
    pos = v3.add(o, v3.scale(torch.where(vmask, t, 0.0), d))
    so = v3.add(pos, v3.scale(1e-2, n))
    to_l = tuple(ts.light_pos[c] - pos[c] for c in range(3))
    dist = v3.norm(to_l)
    ld = v3.scale(1.0 / torch.clamp_min(dist, 1e-30), to_l)
    srays = torch.stack((*so, *ld)).contiguous()
    tmax = torch.where(vmask, dist, 0.0).contiguous()
    occ0 = torch.zeros(tmax.shape, dtype=torch.int32, device=dev)
    ok_ = traverse.anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone())
    op_ = traverse.anyhit_sweep_ref(ts, srays, RAY_TMIN, tmax, occ0.clone())
    check(torch.equal(ok_, op_), "anyhit occlusion exact")
    occ_frac = (ok_ != 0).float().mean().item()
    res["anyhit_sweep"] = dict(
        max_abs_err=(ok_ - op_).abs().max().item(),
        ms=cuda_ms(lambda: traverse.anyhit_sweep(ts, srays, RAY_TMIN, tmax, occ0.clone()), 3, 10),
        plain_ms=cuda_ms(lambda: traverse.anyhit_sweep_ref(ts, srays, RAY_TMIN, tmax, occ0.clone()), 1, 2),
        shape=list(srays.shape))
    print(f"anyhit  {list(srays.shape)}: occ exact, occluded {occ_frac:.3f}", flush=True)

    # the closest kernel alone on the full primary wave
    full_st = traverse.make_trace_state(torch.where(act, RAY_TMAX, 0.0).float())
    res["closest_sweep"]["full_wave_ms"] = cuda_ms(
        lambda: traverse.closest_sweep(ts, rk, RAY_TMIN, full_st.clone()), 1, 3)
    for name, v in res.items():
        print(f"time {name:13s} kernel {v['ms']:.4f} ms  plain {v['plain_ms']:.4f} ms"
              f"  shape {v['shape']}  [{gpu}]", flush=True)
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
    print(f"{label}: {r.render_static.width}x{r.render_static.height} "
          f"spp {r.render_static.samples_per_pixel} bounces "
          f"{r.render_static.max_bounce_count}: frame ms {[round(x, 3) for x in ms]}"
          f" median {med:.3f} ms, rays traced {ray_med}, "
          f"{ray_med / med / 1e3:.2f} Mrays/s, host syncs per frame {syncs} [{gpu}]",
          flush=True)
    return dict(frame_ms=ms, median_ms=med, rays=ray_med,
                mrays_per_s=ray_med / med / 1e3, host_syncs=syncs)


def same_rays_diff(r) -> float:
    """Max abs difference of the kernel path's and the plain path's frame
    when both trace the plain raygen's primary rays (the sweeps and the sky
    match their plain versions bit for bit, so the frames should too)."""
    import torch
    from raytpu_torch.integrator import plain_kernels, render_packets, tiled_pixels
    from raytpu_torch.ops.raygen import raygen_packed_ref

    rs, cam = r.render_static, r.camera_tensor()
    spp = rs.samples_per_pixel
    (px, py), in_frame = tiled_pixels(rs, r.device)
    s_row = torch.arange(spp, dtype=torch.float32, device=r.device).repeat(px.shape[0])
    rays6 = raygen_packed_ref(cam, s_row, px.repeat_interleave(spp, 0),
                              py.repeat_interleave(spp, 0), spp, rs.width, rs.height)
    got = render_packets(r.tscene, rs, cam, px, py, in_frame, rays6=rays6)
    with plain_kernels():
        want = render_packets(r.tscene, rs, cam, px, py, in_frame, rays6=rays6)
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def profile_frame(r, path: Path, label: str, gpu: str) -> None:
    """torch.profiler table of one frame, plus its device busy time and the
    share of each hand-written kernel in it."""
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
    per_kernel = {
        name: sum(e.self_device_time_total for e in device
                  if f"{name}_kernel" in e.key) / 1e3
        for name in KERNELS
    }
    table = events.table(sort_by="device_time_total", row_limit=40)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(f"{gpu}\n{table}\n")
    print(f"{label} profiled frame: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"kernels ms {per_kernel}, other device ms "
          f"{busy - sum(per_kernel.values()):.3f}; table in {path} [{gpu}]",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", help="write a torch.profiler "
                    "table of one frame of each stand-in into DIR")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    if not (REPO / "raytpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} holds no raytpu_torch package", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))

    from raytpu.scene import load_scene
    from raytpu.utils.ssim import ssim
    from raytpu_torch import _build, scenes
    from raytpu_torch.integrator import plain_kernels, render_frame
    from raytpu_torch.render import Renderer

    gpu = gpu_line()
    print(gpu)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} | nvcc: {nvcc.splitlines()[-1]}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"kernel build: {time.perf_counter() - start:.2f} s -> {lib.name}", flush=True)

    start = time.perf_counter()
    scene4 = scenes.config4_standin()
    t_gen = time.perf_counter() - start
    start = time.perf_counter()
    r4 = Renderer(scene4, "cuda")
    torch.cuda.synchronize()
    t_bvh = time.perf_counter() - start
    ts = r4.tscene
    print(f"config4 stand-in: scene generation {t_gen:.2f} s, BVH build + upload "
          f"{t_bvh:.2f} s ({ts.bvh_aabb_min.shape[0]} nodes, "
          f"{ts.bvh_tri_v0.shape[0]} triangles, {len(ts.traversal_list)} entries)",
          flush=True)

    r4.set_transforms(0.05)
    kern = compare_kernels(r4, gpu)

    _build.reset_launch_counts()
    c4 = render_frames(r4, 5, 0.05, 0.05, "config4_standin", gpu)
    counts = _build.launch_counts()
    print(f"launches during config4 frames: {counts}", flush=True)
    for name in _build.KERNELS:
        check(counts[name] > 0, f"{name} launched during the config4 frames")

    if args.profile:
        profile_frame(r4, Path(args.profile) / "profile_config4.txt",
                      "config4_standin", gpu)

    start = time.perf_counter()
    ref_scene = scenes.reference_standin()
    rr = Renderer(ref_scene, "cuda")
    print(f"reference stand-in: scene + BVH {time.perf_counter() - start:.2f} s", flush=True)
    _build.reset_launch_counts()
    ref = render_frames(rr, 2, 0.05, 0.05, "reference_standin", gpu)
    ref_counts = _build.launch_counts()
    for name in _build.KERNELS:
        check(ref_counts[name] > 0, f"{name} launched during the reference frames")
    if args.profile:
        profile_frame(rr, Path(args.profile) / "profile_reference.txt",
                      "reference_standin", gpu)
    del rr

    small = Renderer(load_scene(scene4.config.replace(width=256, height=192),
                                meshes=scene4.meshes, skybox=scene4.skybox), "cuda")
    small.set_transforms(0.1)
    cam = small.camera_tensor()
    img_k = render_frame(small.tscene, small.render_static, cam).cpu().numpy()
    with plain_kernels():
        img_p = render_frame(small.tscene, small.render_static, cam).cpu().numpy()
    s = ssim(img_k, img_p)
    diff = float(abs(img_k - img_p).max())
    print(f"256x192 kernel path vs plain path on the card: SSIM {s:.6f}, "
          f"max abs diff {diff:.3g}", flush=True)
    check(s > 0.99, f"256x192 kernel vs plain SSIM > 0.99 ({s})")
    same = same_rays_diff(small)
    print(f"256x192 kernel path vs plain path from the same primary rays: "
          f"max abs diff {same:.3g}", flush=True)
    check(same <= 1e-6, f"same-rays frames within 1e-6 ({same})")

    print(json.dumps({"gpu": gpu, "config4_standin": c4, "reference_standin": ref,
                      "small_frame": {"ssim": s, "max_abs_diff": diff,
                                      "same_rays_max_abs_diff": same}}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": counts[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"]}
        for name in _build.KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
