#!/usr/bin/env python3
"""Run one cell of the benchmark of ``raytpu_torch``:

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.

Set-up (``setup_s``, from process start to the first timed frame): the
imports, the card, the kernel library (built into ``build/raytpu_torch/``
on a checkout's first run), the configuration's meshes and the seed's sky,
the port's scene and ``Renderer`` (BVH build and upload), and warm-up
frames at every fourth pose of the path. The window: the viewer's frame
loop, one viewer in a closed loop, each frame ``Renderer.step`` at pose
``i % loop`` of the seed's camera path after the previous frame's image
reached the host, for whole loops of the path until ``--seconds`` have
passed. ``frame_ms`` is the window's wall time over its frames,
``frame_p95_ms`` the 95th percentile of every frame's wall time.

With ``--trace 1`` the run then profiles one more loop of the path
(``torch.profiler``, host and device) and renders one loop through
``Renderer.render(stats=...)`` at the same poses, and prints the cell's
per-layer metrics, each read by ``metrics/<name>.py``, in place of the
end-to-end ones, with the breakdown of device time and idle gaps.

Then the port's state is freed and the plain reference (``reference/``)
renders the checked frames' sampled pixels, which ``check.py`` compares
with the frames the window delivered. The numbers compared and their
limits are the last lines on standard error; the result is the last line
on standard output. The run fails, and prints no result, without enough
cards, without the port in the checkout, or if JAX or the JAX package was
imported.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if sys.path and Path(sys.path[0] or ".").resolve() == BENCH:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "raytpu")
WARM_STRIDE = 4     # warm-up frames: every fourth pose of the path
MESH_CACHE = ROOT / "build" / "rtbench" / "meshes"


class RunError(Exception):
    """A run that must end without a result."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _generator(bench_dir: Path, kind: str, name: str):
    from rtbench import manifest

    return manifest.load_module(bench_dir / kind / f"{name}.py",
                                f"{kind[:-1]} generator").make


def make_mesh(bench_dir: Path, params: dict, cache_dir: Path = None):
    """(positions, normals, triangles) of a configuration's mesh, from the
    cache under ``cache_dir`` when the generator's source and parameters
    made it before."""
    import hashlib

    import numpy as np

    src = bench_dir / "meshes" / f"{params['generator']}.py"
    key = hashlib.sha256(src.read_bytes() + json.dumps(params, sort_keys=True)
                         .encode()).hexdigest()[:20]
    path = cache_dir / f"{params['generator']}-{key}.npz" if cache_dir else None
    if path is not None and path.exists():
        with np.load(path) as z:
            return z["positions"], z["normals"], z["triangles"]
    mesh = _generator(bench_dir, "meshes", params["generator"])(params)
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
        np.savez(tmp, positions=mesh[0], normals=mesh[1], triangles=mesh[2])
        os.replace(tmp, path)
    return mesh


def make_sky(config: dict, seed: int, device, bench_dir: Path = BENCH):
    """The seed's sky of the configuration, (6, S, S, 3) f32 on the host."""
    sky = config["skybox"]
    return _generator(bench_dir, "skies", sky["generator"])(sky, seed, device).cpu().numpy()


def port_renderer(config: dict, meshes, sky, device):
    """The port's ``Renderer`` of the configuration, built through its
    public ``load_scene``."""
    from raytpu_torch.config import MaterialType, ObjectConfig, RenderConfig
    from raytpu_torch.io.obj import Mesh
    from raytpu_torch.render import Renderer
    from raytpu_torch.scene import load_scene

    objects = tuple(ObjectConfig(f"rtbench://object{i}",
                                 MaterialType[o["material"].upper()], o["animation"])
                    for i, o in enumerate(config["objects"]))
    cfg = RenderConfig(
        objects=objects, skybox_dir=None, width=config["width"],
        height=config["height"], samples_per_pixel=config["samples_per_pixel"],
        max_bounce_count=config["max_bounce_count"],
        camera_position=tuple(config["camera_position"]),
        camera_speed=config["camera_speed"],
        camera_mouse_sensitivity=config["camera_mouse_sensitivity"],
        light_position=tuple(config["light_position"]),
        light_intensity=config["light_intensity"])
    port_meshes = [Mesh(positions=p, normals=n, triangles=t, name=f"object{i}")
                   for i, (p, n, t) in enumerate(meshes)]
    return Renderer(load_scene(cfg, meshes=port_meshes, skybox=sky), device)


class Viewer:
    """The viewer's frame: the camera set to a pose, then
    ``Renderer.step`` (animation step, frame, readback). ``history`` holds
    the time parameter of every animation step, in order."""

    def __init__(self, renderer):
        from raytpu_torch.camera import Camera

        self.renderer, self._camera = renderer, Camera
        self.history = []

    def pose(self, pose: dict) -> None:
        self.renderer.camera = self._camera.from_state_dict(pose)

    def frame(self, pose: dict, time_param: float):
        self.pose(pose)
        self.history.append(time_param)
        return self.renderer.step(time_param)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def traced_loop(viewer, poses, tps, device):
    """Profile one loop of the path -> :class:`profiling.Trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from rtbench import profiling

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities, record_shapes=True) as prof:
        with record_function(profiling.WINDOW):
            for pose, tp in zip(poses, tps):
                with record_function(profiling.FRAME):
                    viewer.frame(pose, tp)
        _sync(device)
    return profiling.Trace(prof.profiler.kineto_results.events(), len(poses))


def stats_loop(viewer, poses, tps) -> dict:
    """The program's counters summed over one loop rendered through
    ``Renderer.render(stats=...)`` at the path's poses."""
    total = {"frames": len(poses)}
    r = viewer.renderer
    for pose, tp in zip(poses, tps):
        viewer.pose(pose)
        viewer.history.append(tp)
        r.set_transforms(tp)
        st = {}
        r.render(stats=st)
        for key in ("closest_rays", "shadow_rays", "host_syncs"):
            if key in st:
                total[key] = total.get(key, 0) + int(st[key])
        total["tier"] = st.get("tier")
    return total


def port_kernels() -> set:
    """The ``__global__`` functions of the port's CUDA sources."""
    import re

    names = set()
    for src in sorted((ROOT / "raytpu_torch" / "csrc").glob("*.cu*")):
        text = re.sub(r"__launch_bounds__\s*\([^)]*\)", "", src.read_text())
        names.update(re.findall(r"__global__[^(]*?\b(\w+)\s*\(", text))
    return names


class LayerContext:
    """What a per-layer metric's reader reads."""

    def __init__(self, trace, stats, image_shape, ops_per_s):
        from rtbench import roofline

        self.trace, self.stats = trace, stats
        self.image_shape, self.ops_per_s = list(image_shape), ops_per_s
        self.port_kernels = port_kernels()
        self.roofline = roofline


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float = None, min_loops: int = 1, log=print,
             cache_dir: Path = MESH_CACHE) -> dict:
    """One run of ``cell`` on ``device``: set-up, window, optional traced
    loop, then the reference check. Returns ``{"result": the result line's
    dict, "check": the frames compared (pose, pixels, reference colours,
    animation steps)}``."""
    import numpy as np
    import torch

    from rtbench import camerapath, check
    from rtbench.reference import scene_math
    from rtbench.reference.whitted import Reference

    t0 = time.perf_counter() if t0 is None else t0
    cfg, limits = cell.config, cell.limits
    t_start = time.perf_counter()
    meshes = [make_mesh(cell.bench_dir, o["mesh"], cache_dir) for o in cfg["objects"]]
    t_meshes = time.perf_counter()
    sky = make_sky(cfg, seed, device, cell.bench_dir)
    t_inputs = time.perf_counter()
    viewer = Viewer(port_renderer(cfg, meshes, sky, device))
    t_scene = time.perf_counter()
    poses, tps, start = camerapath.make(cell.traffic, cfg, seed, cell.bench_dir)
    loop = len(poses)
    for k in range(loop):   # the path's every WARM_STRIDE-th pose
        if (k + start) % WARM_STRIDE == 0:
            viewer.frame(poses[k], tps[k])
    _sync(device)
    t_window = time.perf_counter()
    setup_s = t_window - t0
    log(f"setup: {setup_s:.3f} s (imports and card {t_start - t0:.3f}, meshes "
        f"{t_meshes - t_start:.3f}, sky {t_inputs - t_meshes:.3f}, scene and "
        f"renderer {t_scene - t_inputs:.3f}, warm-up {t_window - t_scene:.3f})")

    checked = set(check.checked_frames(seed, loop, limits["frames"]))
    kept, times = {}, []
    i, t = 0, t_window
    while True:
        img = viewer.frame(poses[i % loop], tps[i % loop])
        now = time.perf_counter()
        times.append(now - t)
        t = now
        if i in checked:
            kept[i] = (img, len(viewer.history))
        i += 1
        if i % loop == 0 and t - t_window >= seconds and i >= min_loops * loop:
            break
    window_s = t - t_window
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    frame_ms = window_s / i * 1e3
    p95_ms = float(np.percentile(np.asarray(times) * 1e3, 95))
    loop_ms = [round(float(np.sum(times[j:j + loop])) * 1e3 / loop, 4)
               for j in range(0, i, loop)]
    log(f"window: {i} frames, {i // loop} loops of {loop} from path frame {start}, "
        f"{window_s:.3f} s, ms a frame by loop {loop_ms}; "
        f"frame_ms {frame_ms:.4f}, frame_p95_ms {p95_ms:.4f}")

    metrics, extra = {}, {}
    if not trace:
        values = {"frame_ms": frame_ms, "frame_p95_ms": p95_ms, "setup_s": setup_s}
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        from rtbench import profiling, roofline

        tr = traced_loop(viewer, poses, tps, device)
        stats = stats_loop(viewer, poses, tps)
        ctx = LayerContext(tr, stats, (cfg["height"], cfg["width"], 3),
                           roofline.f32_ops_per_s() if cuda else 0.0)
        for m in cell.per_layer():
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        kinds = {k: sum(d.kind == k for d in tr.device)
                 for k in ("kernel", "memcpy", "memset")}
        log(f"traced loop: {loop} frames, device operations {kinds}, image "
            f"readbacks {len(tr.copies_during(ctx.image_shape))}, busy "
            f"{tr.busy_s():.6f} s of {tr.window_s:.6f} s, tier {stats.get('tier')}, "
            f"stats {stats}")
        breakdown = profiling.breakdown(tr)

    history = viewer.history
    del viewer, img
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = Reference(cfg, meshes, torch.as_tensor(sky), device)
    frame_gaps, compared, hit_shares = [], [], []
    for i_frame in sorted(kept):
        img, steps = kept[i_frame]
        pose = poses[i_frame % loop]
        pixels = check.sample_pixels(seed, i_frame, cfg["width"], cfg["height"],
                                     limits["pixels"])
        ref.set_history(history[:steps])
        st = {}
        want = ref.render(scene_math.basis(pose["position"], pose["yaw"],
                                           pose["pitch"]), pixels, st).cpu().numpy()
        got = img[pixels[:, 1], pixels[:, 0]]
        frame_gaps.append(check.gaps(got, want))
        hit_shares.append(st.get("primary_hit_share"))
        compared.append({"frame": i_frame, "pixels": pixels, "want": want,
                         "history": history[:steps], "pose": pose})
    found = check.numbers(frame_gaps, limits["gap_threshold"])
    judged = check.judge(found, limits["limits"])
    failed = sum(not check.passed(check.judge(check.numbers([g], limits["gap_threshold"]),
                                              limits["limits"]))
                 for g in frame_gaps)
    log(f"reference: frames {sorted(kept)} checked, {limits['pixels']} pixels "
        f"each, primary hit share of their samples {hit_shares}, "
        f"{time.perf_counter() - t_ref:.3f} s")

    result = {"correct": check.passed(judged), "attempted": i, "failed": failed,
              "metrics": metrics}
    if cuda:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": cell.chips, "memory_peak_bytes": int(peak),
                            **extra}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0, **extra}
    if trace:
        result["breakdown"] = breakdown
    result["check"] = judged
    return {"result": result, "check": compared}


def emit(result: dict) -> None:
    """The compared numbers as the last lines on standard error, the
    result as the last line on standard output."""
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"check correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from rtbench import manifest

    try:
        cell = manifest.Cell(manifest.load(), args.workload)
        if not (ROOT / "raytpu_torch" / "__init__.py").exists():
            raise RunError(f"the port raytpu_torch is not in {ROOT}")
        import torch

        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark measures the card only")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"{args.workload} needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} found")
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                       t0=T0, log=lambda m: print(m, flush=True))
        from rtbench import devinfo

        print(f"device: {devinfo.device_info()}", flush=True)
    except (RunError, manifest.ManifestError) as e:
        print(f"rtbench: {e}", file=sys.stderr)
        return 2
    leaked = forbidden_modules()
    if leaked:
        print(f"rtbench: the run imported {leaked}, which the port must not load",
              file=sys.stderr)
        return 3
    emit(out["result"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
