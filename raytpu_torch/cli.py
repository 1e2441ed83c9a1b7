"""Command-line interface of the port (counterpart of ``raytpu/cli.py``).

The reference is configured at compile time (``include/config.h``) and run
as ``./main``; the port exposes the same knobs as flags over the preset
system, and renders on the card unless ``--cpu`` is given:

    python -m raytpu_torch.cli render     --preset config2_standin -o out.png
    python -m raytpu_torch.cli render     --mesh a.obj:mirror --mesh b.obj:diffuse:orbit
    python -m raytpu_torch.cli flythrough --preset config5_standin --frames 120 -o frames/
    python -m raytpu_torch.cli bench      --preset config4_standin
    python -m raytpu_torch.cli interactive --preset config1_standin   # cv2 + a display
    python -m raytpu_torch.cli render     --preset config1_standin --width 64 --height 64 --cpu

Presets are the JAX package's (``config1`` ... ``config5``,
``reference``), which read their assets from files, and their asset-free
stand-ins (``config1_standin`` ... ``config5_standin``,
``reference_standin``); without ``--preset`` or ``--mesh`` the commands
take the reference default's stand-in (``bench``: config4's). The JAX
package's CLI stays ``python -m raytpu.cli``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from raytpu_torch.config import MaterialType, ObjectConfig, RenderConfig
from raytpu_torch.io.image import load_skybox, write_image
from raytpu_torch.presets import PRESETS, STANDINS, load_preset_scene
from raytpu_torch.scene import Scene
from raytpu_torch.utils import log

_MATERIALS = {
    "diffuse": MaterialType.DIFFUSE,
    "mirror": MaterialType.MIRROR,
    "refractive": MaterialType.REFRACTIVE,
    "0": MaterialType.DIFFUSE,
    "1": MaterialType.MIRROR,
    "2": MaterialType.REFRACTIVE,
}


def _parse_mesh_spec(spec: str) -> ObjectConfig:
    """``path[:material[:animation]]`` -> ObjectConfig.

    The path may itself contain a URI scheme (``generated://armadillo``),
    so the split skips past any ``://``.
    """
    scheme_end = spec.find("://")
    tail_start = scheme_end + 3 if scheme_end >= 0 else 0
    tail = spec[tail_start:].split(":")
    parts = [spec[:tail_start] + tail[0]] + tail[1:]
    path = parts[0]
    if len(parts) > 1 and parts[1].lower() not in _MATERIALS:
        raise SystemExit(
            f"unknown material {parts[1]!r}; use diffuse/mirror/refractive (or 0/1/2)"
        )
    material = _MATERIALS[parts[1].lower()] if len(parts) > 1 else MaterialType.DIFFUSE
    animation = parts[2] if len(parts) > 2 else "static"
    if animation not in ("static", "spin", "orbit"):
        raise SystemExit(f"unknown animation {animation!r}; use static/spin/orbit")
    return ObjectConfig(path, material, animation)


def _overrides(args) -> dict:
    """The RenderConfig fields set on the command line."""
    overrides = {}
    for field in ("width", "height", "samples_per_pixel", "max_bounce_count",
                  "ray_chunk", "devices", "traversal", "wavefront",
                  "chunk_tris"):
        v = getattr(args, field, None)
        if v is not None:
            overrides[field] = v
    if args.light is not None:
        overrides["light_position"] = tuple(args.light)
    return overrides


def _build_scene(args, default: str = "reference_standin") -> Scene:
    """The scene the flags describe: ``--mesh`` specs, or a preset (by
    default ``default``), with the flags' RenderConfig fields. A stand-in's
    meshes and sky come from code; ``--skybox`` replaces its sky. The
    values the port does not implement raise when the Renderer reads the
    config (``RenderStatic.from_config``)."""
    overrides = _overrides(args)
    depth = args.highpoly_depth
    if args.mesh:
        cfg = RenderConfig(
            objects=tuple(_parse_mesh_spec(m) for m in args.mesh),
            skybox_dir=args.skybox,
        )
        return load_preset_scene(cfg.replace(**overrides), highpoly_depth=depth)
    name = args.preset or default
    if name in STANDINS:
        scene = load_preset_scene(name, highpoly_depth=depth)
        if args.skybox:
            scene.skybox = load_skybox(args.skybox)
            overrides["skybox_dir"] = args.skybox
        scene.config = scene.config.replace(**overrides)
        return scene
    if name not in PRESETS:
        raise SystemExit(f"unknown preset {name!r}; available: "
                         f"{sorted(PRESETS) + sorted(STANDINS)}")
    cfg = PRESETS[name]()
    if args.skybox:
        cfg = cfg.replace(skybox_dir=args.skybox)
    return load_preset_scene(cfg.replace(**overrides), highpoly_depth=depth)


def _add_scene_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset",
                   help=f"scene preset: {sorted(PRESETS) + sorted(STANDINS)}")
    p.add_argument(
        "--mesh",
        action="append",
        help="mesh spec path[:material[:animation]] (repeatable; overrides preset)",
    )
    p.add_argument("--skybox", help="cubemap directory (6 faces)")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--samples-per-pixel", type=int, dest="samples_per_pixel")
    p.add_argument("--max-bounce-count", type=int, dest="max_bounce_count")
    p.add_argument("--ray-chunk", type=int, dest="ray_chunk")
    p.add_argument("--chunk-tris", type=int, dest="chunk_tris",
                   help="triangles per BLAS chunk (0 = one tree a mesh)")
    p.add_argument("--traversal",
                   choices=("auto", "perlane", "mega", "xla", "pallas",
                            "brute"),
                   help="traversal backend (default auto)")
    p.add_argument("--wavefront", choices=("full", "compact"),
                   help="bounce-loop scheduling (see RenderConfig)")
    p.add_argument("--light", type=float, nargs=3, metavar=("X", "Y", "Z"))
    p.add_argument("--devices", type=int,
                   help="shard pixel tiles across N devices")
    p.add_argument("--highpoly-depth", type=int, default=7,
                   help="subdivision depth for generated:// meshes")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the kernels' plain versions)")
    p.add_argument("-v", "--verbose", action="store_true")


def _device(args) -> str:
    """The device the command renders on (the card unless ``--cpu``), after
    setting the log level."""
    if getattr(args, "verbose", False):
        log.set_level("verbose")
    return "cpu" if args.cpu else "cuda"


def cmd_render(args) -> int:
    device = _device(args)
    from raytpu_torch.frontend.headless import render_still

    render_still(_build_scene(args), args.output, time_param=args.time,
                 highpoly_depth=args.highpoly_depth, device=device)
    return 0


def cmd_flythrough(args) -> int:
    device = _device(args)
    from raytpu_torch.frontend.flythrough import Flythrough

    fly = Flythrough(_build_scene(args), device=device)
    if args.output:
        os.makedirs(args.output, exist_ok=True)
    n = 0
    for idx, img in fly.frames():
        if args.output:
            write_image(f"{args.output}/frame_{idx:05d}.png", img)
        n += 1
        if args.frames and n >= args.frames:
            break
    log.info(f"flythrough rendered {n} frames")
    return 0


def cmd_bench(args) -> int:
    device = _device(args)
    from raytpu_torch.bench import run_benchmark, run_matrix

    if args.matrix:
        result = run_matrix(frames=args.frames or 4,
                            highpoly_depth=args.highpoly_depth,
                            budget_s=args.budget, device=device)
    else:
        result = run_benchmark(preset=_build_scene(args, "config4_standin"),
                               frames=args.frames or 8,
                               highpoly_depth=args.highpoly_depth,
                               devices=args.devices or 1, device=device)
    print(json.dumps(result))
    return 0


def cmd_interactive(args) -> int:
    device = _device(args)
    from raytpu_torch.frontend.interactive import run_interactive

    run_interactive(_build_scene(args), device=device)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m raytpu_torch.cli",
                                     description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one frame to an image file")
    _add_scene_args(p)
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--time", type=float, default=0.0,
                   help="animation timeParam (reference: elapsed*0.1)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("flythrough", help="scripted WASD/mouse camera trace")
    _add_scene_args(p)
    p.add_argument("-o", "--output", help="directory for frames (omit to skip IO)")
    p.add_argument("--frames", type=int, help="max frames")
    p.set_defaults(fn=cmd_flythrough)

    p = sub.add_parser("bench", help="throughput benchmark (prints one JSON line)")
    _add_scene_args(p)
    p.add_argument("--frames", type=int)
    p.add_argument(
        "--matrix", action="store_true",
        help="benchmark the six stand-ins in one run",
    )
    p.add_argument(
        "--budget", type=float, default=900.0,
        help="wall-clock budget in seconds for --matrix",
    )
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("interactive",
                       help="windowed WASD+mouse viewer (needs cv2 and a display)")
    _add_scene_args(p)
    p.set_defaults(fn=cmd_interactive)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
