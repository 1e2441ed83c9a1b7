"""Benchmark harness of the port (counterpart of ``raytpu/bench.py`` and of
the root ``bench.py``): frame time, traced Mrays/s and FPS per preset on
one card, printed as one JSON line.

    python -m raytpu_torch.bench                    # config4 stand-in, the card
    python -m raytpu_torch.bench --preset config1_standin --no-matrix --cpu

Rays are counted as the JAX package counts them (``raytpu/bench.py:80``,
after the reference's ``traceRayEXT`` calls, ``src/shader.rgen:86,111``):
the live closest-hit lanes of every bounce plus the shadow rays of the
diffuse front-face hits. The port reads that count from one frame's
``stats`` (:func:`count_rays_frame`), so no count is cached on disk.

Frame times are the host clock around frames that end with the device
drained (``raytpu_torch.utils.timing``): what a viewer waits. Where a
frame's time goes, phase by phase, a profiler around it shows, by the
``rt.*`` spans of ``raytpu_torch.utils.spans``.

The line has no ``vs_baseline``: the JAX package's 500 Mrays/s was a
target set for the TPU, and no speed target carries over to the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Dict, Optional

import torch

from raytpu_torch import _build, scenes
from raytpu_torch.integrator import render_frame
from raytpu_torch.parallel import Mesh, make_mesh, render_sharded, replicate
from raytpu_torch.presets import STANDINS, load_preset_scene
from raytpu_torch.render import Renderer
from raytpu_torch.scene import Scene
from raytpu_torch.utils import log
from raytpu_torch.utils.timing import measure_frame


def count_rays_frame(ts, rs, camera, stats: Optional[dict] = None) -> int:
    """Exact traced-ray count of one frame (closest-hit plus shadow rays),
    read from the frame's device counters (``stats["closest_rays"]`` and
    ``stats["shadow_rays"]``). The definition of ``raytpu/bench.py:80``:
    every bounce iteration counts its active lanes, and every diffuse
    front-face hit one shadow ray (a wave whose shadow sweep the skip rule
    drops has none). ``stats``, if a dict, receives the frame's stats
    (:func:`render_frame`), its ``tier`` among them."""
    stats = {} if stats is None else stats
    render_frame(ts, rs, camera, stats=stats)
    return sum(int(stats[k]) for k in ("closest_rays", "shadow_rays")
               if k in stats)


def tie_scene_config(width: int = 128, height: int = 96) -> Scene:
    """The deliberately tie-prone scene of ``raytpu/bench.py:366``: two
    instances of the same box at the identity, mirror and diffuse, so every
    triangle is hit at exactly the same t through two entries and any
    difference in how two tiers break a tie shows as a pixel; spp 2, 2
    bounces. Asset-free: ``scenes.tie_scene``."""
    return scenes.tie_scene(width, height)


def bit_identity_check(preset="config2_standin", width: int = 128,
                       height: int = 96, highpoly_depth: int = 5,
                       device="cuda") -> Dict:
    """Validation gate: one low-res frame of ``preset`` (a name, a
    RenderConfig or a Scene) on the consensus (``"mega"``) and the
    per-lane (``"perlane"``) tiers against the chained sweeps
    (``"pallas"``, K10a/K10b), compared bit for bit.

    Returns ``{"ok": bool, "n_diff": int, "n_diff_<tier>": int,
    "max_abs_diff_<tier>": float, ...}``; ``n_diff`` counts differing
    channel values, as raytpu's does.

    Known caveat: where a ray hits two triangles at exactly the same t,
    the tiers' visit orders (octant near-first with depth-sorted entries
    against build order) may keep different ones. The config3 stand-in's
    four proven exact ties (``chip_smoke.CONSENSUS_TIES``, ROADMAP queue
    3) are the documented exception: this check reports such pixels, it
    does not hide them. ``preset=tie_scene_config()`` measures the caveat
    on purpose (the bench's ``tie_check``)."""
    scene = load_preset_scene(preset, highpoly_depth=highpoly_depth)
    scene.config = scene.config.replace(width=width, height=height)
    renderer = Renderer(scene, device)
    renderer.set_transforms(0.0)
    cam = renderer.camera_tensor()
    modes = ("pallas", "mega", "perlane")
    imgs = {mode: render_frame(dataclasses.replace(renderer.tscene, traversal=mode),
                               renderer.render_static, cam)
            for mode in modes}
    out = {"preset": preset if isinstance(preset, str) else "tie_scene",
           "width": width, "height": height}
    ok = True
    for mode in modes[1:]:
        n_diff = int((imgs[mode] != imgs["pallas"]).sum())
        out[f"n_diff_{mode}"] = n_diff
        out[f"max_abs_diff_{mode}"] = float((imgs[mode] - imgs["pallas"]).abs().max())
        ok = ok and n_diff == 0
    out["ok"] = ok
    out["n_diff"] = sum(out[f"n_diff_{m}"] for m in modes[1:])
    return out


# A full frame implying more than this many Mrays/s of PRIMARY rays alone
# was timed before the card finished it. The highest primary-ray rate on
# record for the port is about 1,119 Mrays/s (the config4 stand-in on the
# pallas tier, 8,294,400 primary rays in 7.4 ms; PERF.md section 5, one
# H100 80GB HBM3 at 700 W); this is under three times that, so a frame
# must run well over twice as fast as any measured to pass unflagged,
# while a corrupted row like the JAX package's (about 9,100 Mrays/s) is
# caught. The JAX package's 2,000 was set for a TPU.
PLAUSIBLE_MRAYS = 3000.0


def _plausibility_guard(out: Dict, frame, frames: int, devices=()) -> None:
    """Guard a measured frame time against timing artifacts: if the PRIMARY
    rays alone (width*height*spp, a lower bound on the traced rays) imply
    more than ``PLAUSIBLE_MRAYS``, re-measure with ``pipelined=False``
    (every frame drained, on each of ``devices`` too, before the next
    timestamp) and record both numbers with ``suspect: true``."""
    min_rays = out["width"] * out["height"] * out["spp"]
    implied_mrays = min_rays / max(out["frame_ms"], 1e-9) / 1e3
    if implied_mrays <= PLAUSIBLE_MRAYS:
        return
    mean2, _ = measure_frame(frame, warmup=0, iters=max(4, frames // 4),
                             pipelined=False, devices=devices)
    out["suspect"] = True
    out["suspect_pipelined_ms"] = out["frame_ms"]
    out["suspect_implied_mrays"] = implied_mrays
    out["frame_ms"] = mean2 * 1e3
    out["fps"] = 1.0 / mean2
    if out.get("mrays_per_s"):
        out["mrays_per_s"] = out["rays_per_frame"] / mean2 / 1e6


def build_preset_renderer(preset, highpoly_depth: int = 7,
                          device="cuda") -> Renderer:
    """Build a preset's Renderer (scene, BVH, device upload) once, at the
    pose ``set_transforms(0.0)``, so a bench can reuse it across the
    matrix and headline phases."""
    scene = load_preset_scene(preset, highpoly_depth=highpoly_depth)
    renderer = Renderer(scene, device)
    renderer.set_transforms(0.0)
    return renderer


def run_benchmark(preset="config4_standin", frames: int = 24,
                  highpoly_depth: int = 7, devices: int = 1,
                  renderer: Optional[Renderer] = None,
                  device="cuda", mesh: Optional[Mesh] = None) -> Dict:
    """Benchmark a preset (a name, a RenderConfig or a Scene): steady-state
    frame time after one warm-up frame, exact Mrays/s (the count costs one
    more frame), FPS, and the tier the frame's sweeps took. ``renderer``: a
    pre-built Renderer (:func:`build_preset_renderer`) to reuse; it renders
    at its current pose and on its own device.

    ``devices > 1`` times the sharded frame (``parallel.render_sharded``)
    over ``make_mesh(devices)`` of the renderer's device type, or over
    ``mesh`` where given (``raytpu/bench.py:555-582``); the rays are
    counted on one device's frame, as the JAX package counts them, and the
    line gets ``"devices"``."""
    if mesh is None and devices < 1:
        log.fail(f"devices={devices}: use 1 device or more")
    if renderer is None:
        renderer = build_preset_renderer(preset, highpoly_depth, device)
    if mesh is None and devices > 1:
        mesh = make_mesh(devices, renderer.device)
    rs = renderer.render_static
    cam = renderer.camera_tensor()

    t0 = time.perf_counter()
    stats: dict = {}
    rays = count_rays_frame(renderer.tscene, rs, cam, stats)
    count_s = time.perf_counter() - t0

    if mesh is not None:
        replicas = replicate(renderer.tscene, mesh)
        sync = mesh.distinct()

        def frame():
            return render_sharded(replicas, rs, cam, mesh)
    else:
        sync = ()

        def frame():
            return render_frame(renderer.tscene, rs, cam)

    mean_s, times = measure_frame(frame, warmup=1, iters=frames, devices=sync)
    out = {
        "preset": preset if isinstance(preset, str) else "custom",
        "backend": renderer.device.type,
        **({"devices": mesh.size} if mesh is not None and mesh.size > 1 else {}),
        "width": rs.width,
        "height": rs.height,
        "spp": rs.samples_per_pixel,
        "max_bounces": rs.max_bounce_count,
        "tier": stats["tier"],
        "rays_per_frame": rays,
        "frame_ms": mean_s * 1e3,
        "fps": 1.0 / mean_s,
        "mrays_per_s": rays / mean_s / 1e6,
        "count_overhead_s": count_s,
        "frame_times_ms": [t * 1e3 for t in times],
    }
    _plausibility_guard(out, frame, frames, sync)
    return out


_MATRIX_KEYS = ("width", "height", "spp", "max_bounces", "tier",
                "rays_per_frame", "frame_ms", "fps", "mrays_per_s",
                "suspect", "suspect_pipelined_ms")


def _row(r: Dict) -> Dict:
    return {k: (round(v, 2) if isinstance(v, float) else v)
            for k, v in r.items() if v is not None and k in _MATRIX_KEYS}


def run_matrix(presets=tuple(STANDINS), frames: int = 4,
               highpoly_depth: int = 7, budget_s: float = 600.0,
               renderers: Optional[Dict] = None, device="cuda") -> Dict[str, Dict]:
    """Benchmark every preset (by default the six stand-ins) in one
    process within a wall-clock budget. Returns {preset: row, or a skip or
    error reason}.

    Budget admission as in the JAX package: a preset runs only if the
    remaining budget exceeds the cost of the last completed preset (60 s
    before the first), and a skipped row says which limit it met.
    ``renderers``: an optional {name: Renderer} cache shared with the
    caller; presets in it are reused as they are (their pose included), and
    newly built ones are added. Unlike the JAX package's matrix, every row
    counts its rays (:func:`run_benchmark`)."""
    t0 = time.perf_counter()
    out: Dict[str, Dict] = {}
    last_cost = 60.0
    for name in presets:
        elapsed = time.perf_counter() - t0
        remaining = budget_s - elapsed
        if remaining <= 0:
            out[name] = {"skipped": f"budget exhausted ({elapsed:.0f}s)"}
            continue
        if remaining < min(last_cost, 300.0) * 0.8:
            out[name] = {
                "skipped": f"remaining budget {remaining:.0f}s below "
                           f"estimate {last_cost:.0f}s"
            }
            continue
        t_preset = time.perf_counter()
        try:
            rr = renderers.get(name) if renderers is not None else None
            if rr is None:
                rr = build_preset_renderer(name, highpoly_depth, device=device)
                if renderers is not None:
                    renderers[name] = rr
            out[name] = _row(run_benchmark(preset=name, frames=frames,
                                           renderer=rr))
        except Exception as e:  # one preset's failure is its row
            out[name] = {"error": repr(e)}
        last_cost = time.perf_counter() - t_preset
    return out


def matrix_complete(configs: Dict[str, Dict], need: int = 5) -> bool:
    """Did the matrix produce at least ``need`` numeric (non-skipped,
    non-error, non-suspect) rows? The bench line records the negation as
    ``artifact_incomplete``, so a starved run never looks complete."""
    numeric = [
        r for r in configs.values()
        if isinstance(r, dict) and "frame_ms" in r and not r.get("suspect")
    ]
    return len(numeric) >= need


def device_info(device) -> Dict:
    """The bench's device: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them, and the torch and CUDA versions."""
    device = torch.device(device)
    info = {"type": device.type, "torch": torch.__version__,
            "cuda": torch.version.cuda}
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, **info}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[device.index or 0]
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0]),
            "nvidia_smi": line, **info}


def _cache_entries() -> int:
    """Entries of the kernel build directory (-1 if it does not exist)."""
    try:
        return len(list(_build.BUILD_DIR.iterdir()))
    except OSError:
        return -1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytpu_torch.bench",
        description="Benchmark the port on the card; prints one JSON line.")
    ap.add_argument("--preset", default="config4_standin",
                    help="headline preset (a stand-in, or a preset whose "
                    "assets exist)")
    ap.add_argument("--frames", type=int, default=24,
                    help="timed frames of the headline (the matrix times half "
                    "as many frames, at least 2)")
    ap.add_argument("--highpoly-depth", type=int, default=7,
                    help="subdivision depth of the armadillo stand-in")
    ap.add_argument("--no-matrix", action="store_true",
                    help="skip the matrix over the six stand-ins")
    ap.add_argument("--budget", type=float, default=900.0,
                    help="wall-clock budget in seconds for the matrix and the "
                    "checks after it")
    ap.add_argument("--cpu", action="store_true",
                    help="bench on the CPU, with the kernels' plain versions")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        log.fail("no CUDA device (torch.cuda.is_available() is false); "
                 "pass --cpu to bench on the CPU")
    preset, depth, budget = args.preset, args.highpoly_depth, args.budget
    entries_before = _cache_entries()

    t0 = time.perf_counter()
    renderers = {preset: build_preset_renderer(preset, depth, device=device)}
    r = run_benchmark(preset=preset, frames=args.frames, renderer=renderers[preset])
    out = {
        "metric": f"traced Mrays/s ({preset}: {r['width']}x{r['height']}, "
                  f"{r['spp']}spp, {r['max_bounces']}-bounce, "
                  f"{r['rays_per_frame'] / 1e6:.1f}M rays/frame, "
                  f"{r['fps']:.1f} FPS, tier {r['tier']}, "
                  f"device={r['backend']})",
        "value": round(r["mrays_per_s"], 2),
        "unit": "Mrays/s",
    }
    if r.get("suspect"):
        out["suspect"] = True
    if not args.no_matrix:
        # the reference's 63-bounce default first, so a tight budget never
        # drops the preset that defines the reference workload
        others = [p for p in ("reference_standin", "config1_standin",
                              "config2_standin", "config3_standin",
                              "config5_standin", "config4_standin")
                  if p != preset]
        left = budget - (time.perf_counter() - t0)
        out["configs"] = run_matrix(
            presets=others, frames=max(2, args.frames // 2),
            highpoly_depth=depth, budget_s=max(0.0, left),
            renderers=renderers, device=device)
        out["configs"][preset] = _row(r)
        if not matrix_complete(out["configs"], need=5):
            out["artifact_incomplete"] = True
    elapsed = time.perf_counter() - t0
    if elapsed < budget * 0.75:
        bi = bit_identity_check(device=device)
        out["bit_identical"] = bi["ok"]
        if not bi["ok"]:
            out["bit_identity_detail"] = bi
        tie = bit_identity_check(preset=tie_scene_config(), device=device)
        out["tie_check"] = {k: v for k, v in tie.items() if k != "preset"}
    else:
        out["bit_identity_error"] = (f"skipped: {elapsed:.0f} s of the "
                                     f"{budget:.0f} s budget spent")
    out["device"] = device_info(device)
    out["cache"] = {"dir": str(_build.BUILD_DIR), "entries_before": entries_before,
                    "entries_after": _cache_entries()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
