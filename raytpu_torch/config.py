"""The port's own copy of ``raytpu/config.py`` (the port imports nothing of
``raytpu``).

Runtime configuration for the raytpu renderer.

TPU-native equivalent of the reference's compile-time configuration header
(``include/config.h:4-27``): scene mesh selection, per-object material type,
skybox directory, camera speed/sensitivity, bounce count, samples-per-pixel and
debug toggles. The reference bakes these in as ``#define``s; here they form a
frozen dataclass so a scene is a *value* — hashable, jit-static where needed,
and overridable from the CLI (``raytpu/cli.py``).

Material type encoding matches ``include/config.h:9-16`` and the uniform
struct consumed by the raygen shader (``src/shader.rgen:34-41``):
0 = diffuse, 1 = mirror, 2 = refractive.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional, Tuple


class MaterialType(enum.IntEnum):
    """Per-object material type (``include/config.h:9-16``)."""

    DIFFUSE = 0
    MIRROR = 1
    REFRACTIVE = 2


# Shading constants hard-coded in the reference raygen shader
# (``src/shader.rgen:51-55``). Kept as module-level constants because they are
# part of the *semantics* being reproduced, not user knobs.
INDEX_OF_REFRACTION = 1.52
AMBIENT_INTENSITY = (0.8, 0.8, 0.8)   # Iamb
DIFFUSE_COEFF = (0.2, 1.0, 0.2)       # kd
AMBIENT_COEFF = (0.1, 0.3, 0.1)       # ka
SPECULAR_COEFF = (0.8, 0.8, 0.8)      # ks
SPECULAR_EXPONENT = 100.0             # src/shader.rgen:126
FOCAL_LENGTH = 2.5                    # src/shader.rgen:79
RAY_TMIN = 1e-3                       # src/shader.rgen:87
RAY_TMAX = 1e4                        # src/shader.rgen:87
HIT_EPSILON = 1e-2                    # offset along normal, src/shader.rgen:107,136,158,164
SAMPLE_DECAY = 0.9                    # pow(0.9, sample_index) quirk, src/shader.rgen:128


@dataclasses.dataclass(frozen=True)
class ObjectConfig:
    """One mesh instance in the scene.

    The reference supports exactly two objects — a "center" mesh and an
    "orbiting" mesh (``include/config.h:6-7``) with animated instance
    transforms (``src/main.cpp:2836-2844``). raytpu generalises to N objects;
    ``animation`` selects the built-in transform track.
    """

    path: str
    material: MaterialType = MaterialType.DIFFUSE
    # Built-in animation tracks mirroring src/main.cpp:2836-2844:
    #  "static"  — identity transform
    #  "spin"    — accumulate slow Y-rotation per frame (center mesh)
    #  "orbit"   — circle of radius 10 about (0, 0, -5) (orbiting mesh)
    animation: str = "static"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Full renderer configuration (reference: ``include/config.h`` +
    hard-coded values in ``src/main.cpp:805,1847-1873``)."""

    # --- scene (config.h:4-17) ---
    objects: Tuple[ObjectConfig, ...] = ()
    skybox_dir: Optional[str] = None          # SKYBOX_TEXTURE_DIR
    skybox_size: int = 2048                   # face resolution used by reference assets

    # --- camera (config.h:18-19; initial pose src/main.cpp:1848-1851) ---
    camera_position: Tuple[float, float, float] = (0.0, 0.0, 20.0)
    camera_mouse_sensitivity: float = 0.0005
    camera_speed: float = 50.0

    # --- lighting (src/main.cpp:1853-1854) ---
    light_position: Tuple[float, float, float] = (5.0, 5.0, 5.0)
    light_intensity: float = 1.0

    # --- integrator (config.h:26-27) ---
    max_bounce_count: int = 63
    samples_per_pixel: int = 4

    # --- framebuffer (src/main.cpp:805) ---
    width: int = 800
    height: int = 600

    # --- debug / perf toggles (config.h:21-24) ---
    test_fps: bool = False                    # uncapped frame loop + FPS print
    validation: bool = False                  # NaN/finite guards on the render path

    # skybox filter: "bilinear" (default: the reference's LINEAR-sampler
    # semantics — on TPU this rides the MXU texture unit, ops/sky_mxu.py,
    # at single-tap cost; 4 gathers on the fallback/CPU path), "bilinear2x"
    # (one gather into a 2x-prefiltered map — max quarter-texel error vs
    # true bilinear), "nearest" (1 gather, unfiltered)
    skybox_filter: str = "bilinear"
    # deferred-sky sampler: "auto" (MXU texture unit on TPU when the map and
    # packet shape allow, else gather), "gather", or "mxu" (forced)
    sky_sampler: str = "auto"
    # window-cell lane re-binning of the deferred MXU sky fetch's
    # compacted fallback sub-wave (sky_mxu._rebin_subwave): "auto"
    # (currently resolves OFF — both rebin designs measured-REJECTED on
    # chip, see integrator._use_sky_rebin), "on" (experiment), "off".
    # Same ≤1 u8 LSB sampler contract either way (path assignment
    # shifts across the sort).
    sky_rebin: str = "auto"

    # --- TPU-specific knobs (no reference analog; tuning surface) ---
    # divergence scheduling for sparse/divergent waves (shadow + bounce
    # sweeps; ops/rebin.py). Both alternatives to "off" were implemented,
    # measured on v5e, and REJECTED for the reference workloads — kept as
    # recorded experiments (docs/roadmap.md):
    #   "split" / "split_all": static sub-tile regrouping (reshape/
    #     transpose; spp sample copies of a 1/spp tile as one packet,
    #     quartering each walk's footprint at spp=4) — bit-identical but
    #     config4 185→320 ms, config2 28→38 ms: 4× walk count (root
    #     parks, per-group overhead) beats the narrower cones.
    #   "sort": segmented octant/liveness lane sort — pathological
    #     (config4 frame 185 ms → 6.2 s; XLA sorts inside the bounce
    #     while_loop).
    divergence: str = "off"
    # bounce-loop scheduling: "full" runs every loop iteration at frame
    # width; "compact" sorts packets live-first after the (peeled) primary
    # bounce and runs later iterations over ~P/4-packet waves — packet
    # moves are contiguous row copies (measured ~bandwidth speed), the
    # elementwise shading/bookkeeping and sweeps shrink 4×, and waves
    # iterate when more packets survive than the budget. Bit-identical
    # (per-lane results are permutation-invariant). Default "compact"
    # since round 3f: it measured ~neutral in round 3b when sweep cost
    # dominated, but after the per-lane tier + round-3e sky/shadow cuts it
    # wins every preset on-chip (tools/r5_compact_ab.py, same-session
    # A/B over the pair walk: config5 18.9 → 17.9 ms, config2 22.9 →
    # 22.1, config4 137.9 → 136.0, reference 75.4 → 72.5).
    wavefront: str = "compact"
    ray_chunk: int = 0            # rays per traversal chunk; 0 = whole frame
    # statically unroll the bounce loop (max_bounce_count <= 8 only):
    # identical math to the lax.while_loop, measured as an A/B knob for
    # the loop's structural overhead (carried-buffer copies around the
    # aliased sweep kernels). Larger executable; default off.
    bounce_unroll: bool = False
    # triangles per BLAS chunk for the closest-hit set; 0 = SMEM-sized
    # default (accel/chunking.CHUNK_TRIS). Small-mesh scenes with divergent
    # bounce waves measure faster with FINER chunks (config5: 2048 → ~2.5 ms
    # off a 34 ms frame, tools/r4_finechunk.py): shorter per-chunk walks
    # beat the extra prepass entries once trees are shallow. The
    # anyhit-specialized shadow set keeps its own coarser partition.
    chunk_tris: int = 0
    # max triangles per BVH leaf (default 12, the measured optimum — see
    # ops/intersect.LEAF_UNROLL for the A/B table; the pair link word's
    # 4-bit cnt field caps it at 15; RAYTPU_LEAF_SIZE overrides BOTH this
    # and the traversal unroll — one env var keeps them consistent)
    leaf_size: int = int(os.environ.get("RAYTPU_LEAF_SIZE", "12"))
    bvh_builder: str = "auto"     # "auto" | "native" | "sah" | "median" | "lbvh"
    # "auto" | "hybrid" | "perlane" | "mega" | "xla" | "pallas" | "brute"
    # ("hybrid": per-lane tier for the peeled primary sweeps, megakernel
    # for bounce sweeps — see ops/trace.py:_use_perlane)
    traversal: str = "auto"
    dtype: str = "float32"
    devices: int = 1              # pixel-tile sharding degree (parallel/dist.py)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    @property
    def primary_rays_per_frame(self) -> int:
        return self.num_pixels * self.samples_per_pixel

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def reference_default(resource_dir: str = "resources") -> RenderConfig:
    """The reference's default compile-time scene (``include/config.h:4-16``):
    mirror teapot (center) + diffuse armadillo (orbiting), sea skybox.

    ``armadillo.obj`` is not among the reference's shipped assets; callers
    should substitute a stand-in high-poly mesh (see
    ``raytpu_torch/io/genmesh.py``).
    """
    return RenderConfig(
        objects=(
            ObjectConfig(f"{resource_dir}/teapot.obj", MaterialType.MIRROR, "spin"),
            ObjectConfig(f"{resource_dir}/armadillo.obj", MaterialType.DIFFUSE, "orbit"),
        ),
        skybox_dir=f"{resource_dir}/skybox_texture_sea",
    )
